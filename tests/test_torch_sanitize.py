"""The port's runtime sanitizer (racon_tpu_torch/analysis/sanitize.py)
against the JAX package's (racon_tpu/analysis/sanitize.py).

* The checkers give the JAX module's findings (kind and detail) on the
  same numpy inputs, made from a seed: ``check_align_outputs``,
  ``check_consensus_outputs`` (with the ``sanitize.nan`` fault too),
  ``check_parity``, ``GuardedStats`` and the launch-output check.
* An armed CPU polish (``device="cpu"``, ``sanitize_parity=1``) is
  byte-identical to the unarmed one and to ``racon_tpu.TpuPolisher`` (the
  Hirschberg setup of tests/test_torch_polish.py), with no finding.
* Alone: each sanitizer fault gives its finding with the bytes untouched;
  a parity mismatch is a finding and the card's bytes stay installed; a
  pipelined armed run reports no ``racy-stats``.

The JAX polish runs once, in a module fixture; one torch thread.
"""

import json
import os
import pickle
import random
import threading

import numpy as np
import pytest
import torch

import racon_tpu
from racon_tpu.analysis import sanitize as jax_sanitize
from racon_tpu.resilience import faults as jax_faults

import racon_tpu_torch
from racon_tpu_torch.analysis import sanitize
from racon_tpu_torch.ops import poa_driver
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.tools import simulate

KW = dict(window_length=100, match=5, mismatch=-4, gap=-8)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.delenv(faults.ENV, raising=False)
    monkeypatch.delenv("RACON_TPU_FAULT", raising=False)
    sanitize.arm(False)
    jax_sanitize.reset()
    faults.reset()
    yield
    sanitize.arm(False)
    jax_sanitize.reset()
    faults.reset()


def _both():
    """(port, JAX) findings as (kind, where, detail, count) lists."""
    port = [(f.kind, f.where, f.detail, f.count) for f in sanitize.findings()]
    jx = [(f.kind, f.where, f.detail, f.count)
          for f in jax_sanitize.findings()]
    return port, jx


# ------------------------------------------------ the checkers, against JAX

def _align_case(seed):
    rng = np.random.default_rng(seed)
    B, L = 12, 40
    ops = rng.integers(0, 3, size=(B, L)).astype(np.uint8)
    cnt = rng.integers(0, L + 1, size=B).astype(np.int32)
    ok = rng.random(B) < 0.7
    for bi in rng.choice(B, size=4, replace=False):
        ops[bi, rng.integers(0, L)] = 3       # the failure marker
    return ops, cnt, ok


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_check_align_outputs_matches_jax(seed):
    ops, cnt, ok = _align_case(seed)
    sanitize.check_align_outputs(ops, cnt, ok, "align")
    jax_sanitize.check_align_outputs(ops, cnt, ok, "align")
    port, jx = _both()
    assert port == jx


def _consensus_case(seed):
    rng = np.random.default_rng(seed)
    B, N = 10, 24
    cons_base = rng.integers(0, 5, size=(B, N)).astype(np.int32)
    cons_cov = rng.integers(0, 9, size=(B, N)).astype(np.int32)
    cons_len = rng.integers(0, N + 1, size=B).astype(np.int32)
    failed = (rng.random(B) < 0.2).astype(np.int32)
    cons_base[rng.integers(0, B), rng.integers(0, N)] = 9
    cons_len[rng.integers(0, B)] = N + 7
    cons_len[rng.integers(0, B)] = -1
    failed[rng.integers(0, B)] = 2
    return (cons_base, cons_cov, cons_len, failed), list(range(B))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_check_consensus_outputs_matches_jax(seed):
    results, idxs = _consensus_case(seed)
    sanitize.check_consensus_outputs(results, idxs, "poa")
    jax_sanitize.check_consensus_outputs(results, idxs, "poa")
    port, jx = _both()
    assert port == jx and port


def test_nan_fault_matches_jax_and_leaves_the_arrays(monkeypatch):
    results, idxs = _consensus_case(5)
    before = [a.copy() for a in results]
    monkeypatch.setenv(faults.ENV, "sanitize.nan")
    monkeypatch.setenv("RACON_TPU_FAULT", "sanitize.nan")
    faults.reset()
    jax_faults.reset()
    sanitize.check_consensus_outputs(results, idxs, "poa")
    jax_sanitize.check_consensus_outputs(results, idxs, "poa")
    port, jx = _both()
    assert port == jx
    assert "nonfinite" in {k for k, *_ in port}
    for a, b in zip(results, before):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dev,host,kinds", [
    (b"ACGT", b"ACGT", []), ("ACGT", b"ACGA", ["parity"]),
    (b"ACG", "ACGTT", ["parity"])])
def test_check_parity_matches_jax(dev, host, kinds):
    sanitize.check_parity(dev, host, 7, "poa")
    jax_sanitize.check_parity(dev, host, 7, "poa")
    port, jx = _both()
    assert port == jx and [k for k, *_ in port] == kinds


def test_guarded_stats_matches_jax():
    g = sanitize.GuardedStats({"a": 0}, "drv")
    gj = jax_sanitize.GuardedStats({"a": 0}, "drv")
    g["a"] = 1
    gj["a"] = 1
    t = threading.Thread(target=lambda: (g.__setitem__("b", 2),
                                         gj.__setitem__("b", 2)))
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    port, jx = _both()
    assert port == jx and [k for k, *_ in port] == ["racy-stats"]
    assert dict(g) == dict(gj) == {"a": 1, "b": 2}


def test_kernel_outputs_match_jax_and_count_rows():
    rng = np.random.default_rng(7)
    outs = (rng.random((4, 3)).astype(np.float32),
            rng.integers(0, 9, size=4).astype(np.int32))
    outs[0][2, 1] = np.inf
    sanitize.check_kernel_outputs("k", outs)
    jax_sanitize.check_kernel_outputs("k", outs)
    port, jx = _both()
    assert port == jx and [k for k, *_ in port] == ["nonfinite"]
    sanitize.reset()
    sanitize.check_kernel_outputs("k", outs[1:], rows=5)
    assert [f.kind for f in sanitize.findings()] == ["stripe-rows"]


# ----------------------------------------------------------- the module alone

def test_record_dedup_and_cap():
    for _ in range(3):
        sanitize.record("nonfinite", "k[out 0]", "nan")
    fs = sanitize.findings()
    assert len(fs) == 1 and fs[0].count == 3
    for i in range(2 * sanitize._MAX_FINDINGS):
        sanitize.record("parity", f"w{i}", "d")
    assert len(sanitize.findings()) == sanitize._MAX_FINDINGS
    sanitize.reset()
    assert sanitize.findings() == []


def test_arming_is_by_argument_and_clears_findings(monkeypatch):
    monkeypatch.setenv("RACON_TPU_SANITIZE", "1")
    assert not sanitize.enabled()
    sanitize.record("parity", "w", "d")
    sanitize.arm(True, 3)
    assert sanitize.enabled()
    assert sanitize.findings() == []
    assert [sanitize.parity_due(n) for n in range(4)] == [True, False,
                                                         False, True]
    sanitize.arm(True, 0)
    assert not sanitize.parity_due(0)
    with pytest.raises(ValueError):
        sanitize.arm(True, -1)


def test_guard_stats_passthrough_unarmed_and_pickles_plain():
    d = {"a": 1}
    assert sanitize.guard_stats(d, "drv") is d
    sanitize.arm(True)
    g = sanitize.guard_stats(d, "drv")
    assert isinstance(g, sanitize.GuardedStats) and g == d
    back = pickle.loads(pickle.dumps(g))
    assert type(back) is dict and back == d


# ------------------------------------------------------- armed CPU polishes

def _paf_dataset(root):
    """400 bp draft, 5 reads at 5% error, PAF overlaps without CIGARs (as
    tests/test_torch_polish.py builds it)."""
    rng = random.Random(11)
    truth = "".join(rng.choice("ACGT") for _ in range(400))

    def mut(s, rate):
        out = []
        for c in s:
            r = rng.random()
            if r < rate / 2:
                out.append(rng.choice("ACGT"))
            elif r >= rate:
                out.append(c)
        return "".join(out)

    draft = mut(truth, 0.02)
    reads = [mut(truth, 0.05) for _ in range(5)]
    with open(os.path.join(root, "t.fasta"), "w") as f:
        f.write(f">t\n{draft}\n")
    with open(os.path.join(root, "r.fasta"), "w") as rf, \
            open(os.path.join(root, "o.paf"), "w") as of:
        for i, r in enumerate(reads):
            rf.write(f">r{i}\n{r}\n")
            of.write(f"r{i}\t{len(r)}\t0\t{len(r)}\t+\tt\t{len(draft)}\t0\t"
                     f"{len(draft)}\t{min(len(r), len(draft))}\t"
                     f"{max(len(r), len(draft))}\t60\n")
    return tuple(os.path.join(root, n) for n in ("r.fasta", "o.paf",
                                                  "t.fasta"))


@pytest.fixture(scope="module")
def paf(tmp_path_factory):
    """The PAF set and racon_tpu.TpuPolisher's FASTA of it (once)."""
    paths = _paf_dataset(str(tmp_path_factory.mktemp("paf")))
    saved = os.environ.get("RACON_TPU_DEVICE_ALIGNER")
    os.environ["RACON_TPU_DEVICE_ALIGNER"] = "hirschberg"
    try:
        p = racon_tpu.TpuPolisher(*paths, **KW)
        p.initialize()
        want = p.polish(True)
    finally:
        if saved is None:
            os.environ.pop("RACON_TPU_DEVICE_ALIGNER", None)
        else:
            os.environ["RACON_TPU_DEVICE_ALIGNER"] = saved
    return paths, want


def _polish(paths, **kw):
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", **KW, **kw)
    p.initialize()
    out = p.polish(True)
    return out, p.report.as_dict().get("sanitize"), p.stats


def test_armed_polish_equals_unarmed_and_jax(paf):
    paths, want = paf
    plain, section, _ = _polish(paths)
    assert section is None     # an unarmed report has no sanitize key
    armed, section, stats = _polish(paths, sanitize=True, sanitize_parity=1)
    assert armed == plain == want
    assert section == {"armed": True, "findings": []}
    assert stats["align"]["device"] == 5 and stats["consensus"]["device"] > 0


@pytest.mark.parametrize("point,kind", [("sanitize.nan", "nonfinite"),
                                        ("sanitize.stats", "racy-stats")])
def test_fault_gives_its_finding_and_the_same_bytes(paf, monkeypatch, point,
                                                    kind):
    paths, want = paf
    monkeypatch.setenv(faults.ENV, point)
    got, section, _ = _polish(paths, sanitize=True, sanitize_parity=1)
    assert got == want
    assert section["armed"] is True
    assert {f["kind"] for f in section["findings"]} == {kind}
    if point == "sanitize.stats":
        # one finding a guarded stats dict: the alignment's and the
        # consensus phase's
        assert sorted(f["where"] for f in section["findings"]) == [
            "align_cuda.run_jobs", "poa_driver.run_consensus_phase"]


def test_fault_is_inert_unarmed(paf, monkeypatch):
    paths, want = paf
    monkeypatch.setenv(faults.ENV, "sanitize.nan,sanitize.stats")
    got, section, _ = _polish(paths)
    assert got == want and section is None


def test_parity_mismatch_is_a_finding_and_keeps_the_card_bytes(paf,
                                                               monkeypatch):
    """A card result that differs from the host recompute: the finding is
    recorded and the card's bytes are what the polish installs (never the
    host's), in every window the parity checks."""
    paths, _ = paf
    real = poa_driver.decode
    monkeypatch.setattr(poa_driver, "decode",
                        lambda codes: real(codes)[:-1] + b"T"
                        if len(codes) else real(codes))
    tweaked, _, _ = _polish(paths)
    got, section, stats = _polish(paths, sanitize=True, sanitize_parity=1)
    assert got == tweaked
    parity = [f for f in section["findings"] if f["kind"] == "parity"]
    assert len(parity) == 1 and parity[0]["where"] == "poa._install[ls]"
    assert stats["consensus"]["host_fallback"] == 0


def test_pipelined_armed_run_reports_no_racy_stats(tmp_path):
    d = simulate.generate(str(tmp_path), mbp=0.002, coverage=6,
                          mean_read=500, seed=5, contigs=2)
    paths = (d["reads"], d["overlaps"], d["draft"])
    plain, _, _ = _polish(paths)
    got, section, stats = _polish(paths, sanitize=True,
                                  pipeline_phases=True, stream_input=True)
    assert stats["chunks"] == 2
    assert got == plain
    assert section == {"armed": True, "findings": []}


def test_cli_arms_and_reports(paf, tmp_path, capsys):
    from racon_tpu_torch import cli
    from racon_tpu_torch.analysis.__main__ import main as analysis_main

    paths, want = paf
    rep = str(tmp_path / "rep.json")
    assert cli.main(["--device", "cpu", "-w", "100", "-m", "5", "-x", "-4",
                     "-g", "-8", "--sanitize", "--sanitize-parity", "2",
                     "--report", rep, *paths]) == 0
    out = capsys.readouterr().out
    assert out == "".join(f">{n}\n{s}\n" for n, s in want)
    with open(rep) as f:
        assert json.load(f)["sanitize"] == {"armed": True, "findings": []}
    assert analysis_main(["--sanitize-report", rep]) == 0
    assert cli.main(["--device", "cpu", "--sanitize-parity", "-1",
                     *paths]) == 1


def test_host_backend_refuses_sanitize_and_runs_unarmed(paf, capsys):
    """The host backend passes no seam the sanitizer checks: arming it
    is refused, by the factory and by the CLI, and a host polisher
    leaves the sanitizer unarmed, so its report has no section."""
    from racon_tpu_torch import cli, create_polisher

    paths, _ = paf
    with pytest.raises(ValueError, match="cuda backend"):
        create_polisher(*paths, backend="host", sanitize=True)
    assert cli.main(["--host", "--sanitize", *paths]) == 1
    assert "--sanitize" in capsys.readouterr().err
    sanitize.arm(True)
    p = create_polisher(*paths, backend="host")
    assert not sanitize.enabled()
    assert "sanitize" not in p.report.as_dict()
