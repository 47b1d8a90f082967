"""racon_tpu_torch's journal and resume against racon_tpu's, on the CPU.

TorchPolisher(device="cpu") runs the kernels' plain versions; racon_tpu's
TpuPolisher runs on the JAX CPU backend with its Hirschberg aligner
(RACON_TPU_DEVICE_ALIGNER=hirschberg), journaled, once for the module.
The port's journal must hold the JAX journal's records (every window's
payload, polished flag and sha; every CIGAR the kernels served); a polish
interrupted at a journal append (a raise that disarms the journal, or a
SIGKILL of a CLI process) and resumed gives the uninterrupted bytes.
"""

import json
import os
import subprocess
import sys

import pytest

import racon_tpu
from racon_tpu_torch import CpuPolisher, TorchPolisher
from racon_tpu_torch.fingerprint import journal_fingerprint
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.resilience.journal import Journal, JournalError
from tests.test_torch_polish import KW, ROOT, _paf_dataset


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _by_kind(path):
    recs = _records(path)
    return ({r["i"]: r for r in recs if r["kind"] == "window"},
            {r["i"]: r for r in recs if r["kind"] == "cigar"})


def _torch_run(paths, **kw):
    p = TorchPolisher(*paths, device="cpu", **KW, **kw)
    p.initialize()
    return p.polish(True), p


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The data set, the port's uninterrupted journaled run, and the JAX
    package's journaled run."""
    d = tmp_path_factory.mktemp("journal")
    paths = _paf_dataset(d)
    jj = str(d / "jax.journal")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
        mp.delenv("RACON_TPU_FAULT", raising=False)
        p = racon_tpu.TpuPolisher(*paths, journal_path=jj, **KW)
        p.initialize()
        jax_out = p.polish(True)
    tj = str(d / "torch.journal")
    out, tp = _torch_run(paths, journal_path=tj)
    return dict(dir=d, paths=paths, jax_out=jax_out, jax_journal=jj,
                jax_report=p.report.as_dict(), out=out, journal=tj,
                report=tp.report.as_dict())


@pytest.fixture(autouse=True)
def _no_fault(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.configure(None)
    yield
    faults.configure(None)


def test_journaled_polish_equals_jax_and_unjournaled(ref):
    assert ref["out"] == ref["jax_out"]
    assert _torch_run(ref["paths"])[0] == ref["out"]


def test_journal_holds_the_jax_records(ref):
    """Every window's payload, polished flag and sha; every CIGAR the JAX
    kernels served."""
    tw, tc = _by_kind(ref["journal"])
    jw, jc = _by_kind(ref["jax_journal"])
    assert sorted(tw) == sorted(jw) and jw
    for i, rec in jw.items():
        for key in ("payload", "polished", "sha", "contig", "rank"):
            assert tw[i][key] == rec[key], (i, key)
    assert jc
    for job, rec in jc.items():
        assert tc[job]["cigar"] == rec["cigar"]
        assert tc[job]["tier"] == "hirschberg"
    head = _records(ref["journal"])[0]
    assert head["kind"] == "header" and head["version"] == 1


@pytest.mark.parametrize("changed", [
    {"window_length": 90}, {"match": 4}, {"trim": False}])
def test_fingerprint_follows_the_parameters(ref, changed):
    paths = ref["paths"]
    base = journal_fingerprint(paths, KW, "torch")
    assert journal_fingerprint(paths, {**KW, **changed}, "torch") != base


def test_fingerprint_follows_the_input_bytes(ref, tmp_path):
    paths = list(ref["paths"])
    base = journal_fingerprint(paths, KW, "torch")
    with open(paths[2]) as f:
        draft = f.read()
    edited = tmp_path / "t.fasta"
    edited.write_text(draft.replace("A", "C", 1))
    assert journal_fingerprint(paths[:2] + [str(edited)], KW,
                               "torch") != base
    assert journal_fingerprint(paths, KW, "host") != base


@pytest.mark.parametrize("setting", [
    {"num_threads": 4}, {"device": "cpu"}, {"poa_kernel": "v2"},
    {"band": True, "band_slack": 8}])
def test_fingerprint_ignores_the_schedule(ref, tmp_path, setting):
    """num_threads, device, poa_kernel and the band leave the journal's
    header as it is."""
    kw = dict(setting)
    racon = {k: kw.pop(k) for k in ("num_threads",) if k in kw}
    kw.setdefault("device", "cpu")
    j = str(tmp_path / "j")
    TorchPolisher(*ref["paths"], journal_path=j, **kw, **KW, **racon)
    assert _records(j)[0]["fingerprint"] == \
        _records(ref["journal"])[0]["fingerprint"]


def test_torn_tail_is_truncated_and_resumed(ref, tmp_path):
    j = tmp_path / "torn"
    data = open(ref["journal"], "rb").read()
    lines = data.splitlines(keepends=True)
    keep = b"".join(lines[:7])
    j.write_bytes(keep + lines[7][:20])
    out, p = _torch_run(ref["paths"], journal_path=str(j),
                        resume_journal=True)
    assert out == ref["out"]
    reps = p.report.as_dict()["phases"]
    assert sum(r["served"]["journal"] for r in reps.values()) == 6
    # the torn bytes are gone and every record is whole again
    assert all(line.endswith(b"\n") for line in
               j.read_bytes().splitlines(keepends=True))
    assert len(_records(str(j))) == len(lines)


def test_mismatched_fingerprint_is_refused(ref, tmp_path):
    j = str(tmp_path / "j")
    with open(ref["journal"]) as f, open(j, "w") as g:
        g.write(f.read())
    with pytest.raises(JournalError, match="refusing to resume"):
        TorchPolisher(*ref["paths"], device="cpu", journal_path=j,
                      resume_journal=True, **{**KW, "window_length": 90})
    missing = str(tmp_path / "none")
    Journal(missing, "f" * 64, resume=True).close()
    assert _records(missing)[0]["fingerprint"] == "f" * 64


def test_v2_journal_resumes_under_ls(ref, tmp_path):
    """A journal written with poa_kernel="v2", cut after half its
    windows, resumes under "ls" with the same bytes."""
    j = tmp_path / "v2"
    out, _ = _torch_run(ref["paths"], journal_path=str(j), poa_kernel="v2")
    assert out == ref["out"]
    lines = j.read_bytes().splitlines(keepends=True)
    windows = [ln for ln in lines if b'"kind": "window"' in ln]
    assert windows and all(b'"tier": "v2"' in ln for ln in windows)
    j.write_bytes(b"".join(lines[:len(lines) - len(windows) // 2]))
    out, p = _torch_run(ref["paths"], journal_path=str(j),
                        resume_journal=True, poa_kernel="ls")
    assert out == ref["out"]
    served = p.report.as_dict()["phases"]["consensus"]["served"]
    assert served["journal"] == len(windows) - len(windows) // 2
    assert served["ls"] == len(windows) // 2


@pytest.mark.parametrize("where", ["align", "consensus"])
def test_interrupted_append_resumes_to_the_same_bytes(ref, tmp_path,
                                                      where):
    """journal.append:batch=N:count=1 raises at record N: the journal
    disarms at N records (inside phase 1, or inside consensus) and the
    polish completes; a resume from that file gives the uninterrupted
    bytes, with N records served from the journal and served summing to
    the total in both phases."""
    n_cigars = len(_by_kind(ref["journal"])[1])
    n = 2 if where == "align" else n_cigars + 2
    j = str(tmp_path / "j")
    faults.configure(f"journal.append:batch={n}:count=1")
    out, _ = _torch_run(ref["paths"], journal_path=j)
    faults.configure(None)
    assert out == ref["out"]
    assert len(_records(j)) == 1 + n
    out, p = _torch_run(ref["paths"], journal_path=j, resume_journal=True)
    assert out == ref["out"] == ref["jax_out"]
    phases = p.report.as_dict()["phases"]
    assert sum(r["served"]["journal"] for r in phases.values()) == n
    assert phases["alignment"]["served"]["journal"] == min(n, n_cigars)
    for rep in phases.values():
        assert sum(rep["served"].values()) == rep["total"]


def test_sigkilled_cli_resumes_to_the_same_bytes(ref, tmp_path):
    """The CLI killed by SIGKILL at a journal append (kill=1) mid-
    consensus, then --resume-journal: the uninterrupted FASTA."""
    d = ref["dir"]
    n = len(_by_kind(ref["journal"])[1]) + 2
    j = str(tmp_path / "j")
    args = [sys.executable, "-m", "racon_tpu_torch.cli", "--device", "cpu",
            "-w", "100", "-m", "5", "-x", "-4", "-g", "-8"]
    env = {**os.environ, faults.ENV: f"journal.append:batch={n}:kill=1"}
    r = subprocess.run(args + ["--journal", j, *ref["paths"]], cwd=ROOT,
                       env=env, capture_output=True, timeout=600)
    assert r.returncode == -9, r.stderr.decode()[-2000:]
    assert len(_records(j)) == 1 + n
    env.pop(faults.ENV)
    rep = str(d / "resumed_report.json")
    r = subprocess.run(args + ["--resume-journal", j, "--report", rep,
                               *ref["paths"]],
                       cwd=ROOT, env=env, capture_output=True, timeout=600)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    want = "".join(f">{name}\n{seq}\n" for name, seq in ref["out"])
    assert r.stdout.decode() == want
    with open(rep) as f:
        phases = json.load(f)["phases"]
    assert sum(p["served"]["journal"] for p in phases.values()) == n


def test_host_polisher_journaled_and_resumed_equals_jax(ref, tmp_path):
    paths = ref["paths"]
    jp = racon_tpu.CpuPolisher(*paths, **KW)
    jp.initialize()
    want = jp.polish(True)
    j = str(tmp_path / "host")
    faults.configure("journal.append:batch=2:count=1")
    p = CpuPolisher(*paths, journal_path=j, **KW)
    p.initialize()
    assert p.polish(True) == want
    faults.configure(None)
    p = CpuPolisher(*paths, journal_path=j, resume_journal=True, **KW)
    p.initialize()
    assert p.polish(True) == want
    served = p.report.as_dict()["phases"]["consensus"]["served"]
    assert served["journal"] == 2
    assert served["journal"] + served["host"] == \
        p.report.phases["consensus"].total


def test_journal_sets_the_chunked_modes_aside(ref, tmp_path, capfd):
    out, p = _torch_run(ref["paths"], journal_path=str(tmp_path / "j"),
                        pipeline_phases=True, stream_input=True)
    assert out == ref["out"]
    assert "journal needs run-global window indices" in \
        capfd.readouterr().err
    assert "chunks" not in p.stats
