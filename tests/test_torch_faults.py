"""racon_tpu_torch's fault seams and watchdog, on the CPU.

The fault grammar against racon_tpu's (the same specs accepted and
rejected, for the points both packages have); the CLI's one-line exit 1
on a malformed spec; the drills that keep the bytes (band.hit drives
every banded job and window to flat, mem.pressure forces the hard
watermark, mem.spill aborts the parks, journal.replay recomputes); an
injected raise at a run point ends the polish with that error (no
fallback hides the card); and the watchdog, tested without a race: the
wrapped call blocks on a threading.Event until the deadline has fired.
"""

import ast
import os
import re
import threading
import time

import pytest

from racon_tpu.resilience import faults as jax_faults
from racon_tpu_torch import TorchPolisher, cli
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.resilience.watchdog import (WatchdogTimeout,
                                                 call_with_watchdog)
from racon_tpu_torch.tools import simulate
from tests.test_torch_polish import KW, ROOT, _paf_dataset

SPECS = [
    "poa.run.ls",
    "poa.run.v2:raise=RuntimeError",
    "align.run:batch=1:count=1,poa.run.v2:hang=2",
    "journal.append:batch=40:kill=1",
    "band.hit:window=3",
    "mem.pressure:count=2, mem.spill",
    "watchdog.call:raise=TimeoutError:count=1",
    "journal.replay:raise=OSError",
    "poa.run.ls:window=x",
    "poa.run.ls:batch=",
    "poa.run.ls:count=two",
    "poa.run.ls:hang=soon",
    "poa.run.ls:raise=KeyError",
    "poa.run.ls:bogus=1",
    "poa.run.ls:batch",
    "nowhere.run",
    "",
]


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.configure(None)
    yield
    faults.configure(None)


def _parse(mod, text):
    try:
        return [(s.point, s.batch, s.window, s.count, s.hang, s.kill,
                 s.raise_name) for s in mod.parse_spec(text)]
    except ValueError:
        return "rejected"


@pytest.mark.parametrize("spec", SPECS)
def test_grammar_equals_jax(spec):
    assert _parse(faults, spec) == _parse(jax_faults, spec)


def test_known_points_are_the_jax_packages():
    assert faults.KNOWN_POINTS <= jax_faults.KNOWN_POINTS


def test_cli_rejects_a_malformed_spec(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(faults.ENV, "poa.run.ls:count=two")
    paths = _paf_dataset(tmp_path)
    assert cli.main(["--device", "cpu", *paths]) == 1
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and err[0].startswith(faults.ENV)


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    paths = _paf_dataset(tmp_path_factory.mktemp("faults"))
    return paths, _run(paths)[0]


def _run(paths, **kw):
    p = TorchPolisher(*paths, device="cpu", **KW, **kw)
    p.initialize()
    return p.polish(True), p


def test_band_hit_drill_runs_every_banded_job_flat(flat):
    paths, want = flat
    faults.configure("band.hit")
    out, p = _run(paths, band=True, band_slack=8)
    assert out == want
    for phase in ("align", "consensus"):
        b = p.stats[phase]["band"]
        assert b["jobs"] > 0 and b["fallbacks"] == b["jobs"], (phase, b)


@pytest.mark.parametrize("point", ["align.run", "poa.run.ls"])
def test_injected_raise_ends_the_polish(flat, point):
    paths, _ = flat
    faults.configure(f"{point}:raise=RuntimeError")
    with pytest.raises(RuntimeError, match="injected fault"):
        _run(paths)


def test_failed_replay_recomputes(flat, tmp_path):
    paths, want = flat
    j = str(tmp_path / "j")
    _run(paths, journal_path=j)
    faults.configure("journal.replay")
    out, p = _run(paths, journal_path=j, resume_journal=True)
    assert out == want
    phases = p.report.as_dict()["phases"]
    assert all(ph["served"]["journal"] == 0 for ph in phases.values())
    assert "journal" in phases["consensus"]["causes"]


@pytest.fixture(scope="module")
def contigs(tmp_path_factory):
    d = simulate.generate(str(tmp_path_factory.mktemp("contigs")),
                          mbp=0.003, contigs=3)
    paths = (d["reads"], d["overlaps"], d["draft"])
    return paths, _run(paths)[0]


def test_pressure_and_spill_drills_keep_the_bytes(contigs):
    """mem.pressure forces the hard watermark at each synchronous poll
    (the pipeline and the feeder collapse); mem.spill aborts the parks
    that soft-or-worse pressure asks for."""
    paths, want = contigs
    faults.configure("mem.pressure,mem.spill")
    out, p = _run(paths, pipeline_phases=True, memory_budget_mb=1 << 20)
    assert out == want
    assert p.stats["collapsed"] and p.stats["chunks"] == 3
    mem = p.report.as_dict()["phases"]["memory"]
    assert mem["degradations"][0]["to"] == "sequential"
    assert mem["extra"]["streamed"]


def test_watchdog_fires_on_a_blocked_call():
    release = threading.Event()
    t0 = time.perf_counter()
    with pytest.raises(WatchdogTimeout, match="0.2s device watchdog") as e:
        call_with_watchdog(release.wait, 0.2, "a blocked wait")
    assert time.perf_counter() - t0 < 10
    assert e.value.what == "a blocked wait"
    release.set()


def test_watchdog_passes_a_prompt_call():
    assert call_with_watchdog(lambda: 7, 0.2, "a prompt call") == 7
    assert call_with_watchdog(lambda: 8) == 8
    with pytest.raises(KeyError):
        call_with_watchdog(lambda: {}["x"], 0.2)


def test_hung_batch_hits_the_watchdog(flat):
    """poa.run.ls:hang=60 against a 2 s deadline: the waits it bounds
    take microseconds here, so the deadline is far above 10x the call;
    the same deadline without the fault polishes to the same bytes."""
    paths, want = flat
    assert _run(paths, device_timeout_s=2.0)[0] == want
    faults.configure("poa.run.ls:hang=60")
    t0 = time.perf_counter()
    with pytest.raises(WatchdogTimeout, match="ls POA batch"):
        _run(paths, device_timeout_s=2.0)
    assert time.perf_counter() - t0 < 55


def _env_names(path):
    """String constants of a module that are whole RACON_TPU_* names,
    docstrings left out."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and \
                    isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs and re.fullmatch(r"RACON_TPU_\w+",
                                                    n.value)]


def test_port_reads_no_jax_knob():
    pkg = os.path.join(ROOT, "racon_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    assert any(f.endswith(os.path.join("resilience", "faults.py"))
               for f in files)
    for path in files + [os.path.join(ROOT, "chip_smoke.py")]:
        assert _env_names(path) == [], path
