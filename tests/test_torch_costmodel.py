"""racon_tpu_torch's cost model, critical path and DP-cell counters against
the JAX package's, on the CPU.

* The cost model's grid constants are the port's ops modules' values, and
  chip_smoke.py bounds its kernels with the cost model's own constants.
* ``window_class``, ``band_need``, ``roofline``, the span math,
  ``predict_from_counters``, ``validate_trace``, ``bench_cost_model`` and
  the POA rows of ``model_rows`` equal racon_tpu.obs.costmodel's on
  synthetic counters and traces, under one profile given field for field
  to both packages' MachineProfile, with the JAX module's per-cell
  constants set to the port's (monkeypatch; tolerance 0).
* ``critpath.analyze`` equals the JAX function on the merged fleet trace
  of tests/test_slo.py.
* The obs reader's exit codes: ``model``, ``validate``, ``critpath`` and
  ``--overlap``; its obs modules import no torch (one subprocess).
* One traced CPU polish pair, flat and banded, at the parity tests' size:
  the port's ``poa.windows.*``, ``poa.cells.*`` and ``align.cells.*``
  counters equal racon_tpu.TpuPolisher's (RACON_TPU_DEVICE_ALIGNER=
  hirschberg; banded: RACON_TPU_BAND=1 with the v2 Pallas kernel in
  interpret mode), each JAX polish once for the module.
* tools/fit_profile.py's readings: cpu-host's fitted rates explain each
  phase, h100's aligner step bills the device track's aligner time.
* tools/kernel_bench.py: ``make_batch`` gives the JAX tool's arrays for a
  seed, the tool raises without a card, and ``--device cpu`` runs.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import racon_tpu
from racon_tpu.obs import costmodel as jcm
from racon_tpu.obs import critpath as jcp
from racon_tpu.ops import poa_driver as jpd
from racon_tpu.tools import kernel_bench as jkb
from racon_tpu_torch import TorchPolisher
from racon_tpu_torch.obs import __main__ as reader
from racon_tpu_torch.obs import costmodel as cm
from racon_tpu_torch.obs import critpath as cp
from racon_tpu_torch.ops import align_cuda, band, colstep, poa_driver
from racon_tpu_torch.tools import fit_profile
from racon_tpu_torch.tools import kernel_bench as kb
from tests.test_slo import _merged_doc
from tests.test_torch_polish import KW, _paf_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: One machine profile, given field for field to both MachineProfiles.
SHARED = dict(name="shared", description="test", clock_hz=1.5e9,
              peak_flops=3.0e12, hbm_bytes_per_s=2.0e11,
              serial_step_s=1.0e-7, host_poa_cells_per_s=1.0e9,
              host_align_cells_per_s=5.0e8, error_bound_ratio=3.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions on one core: this file shares the machine with
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def shared(monkeypatch):
    """(port profile, JAX profile): SHARED in both, registered under its
    name and as cpu-host; the JAX module's per-cell constants set to the
    port's. The JAX ls tier divides its steps by LS_GROUP x the colstep
    pack, the port's by LS_GROUP alone (its ls kernel has no colstep), so
    the JAX LS_GROUP is set to the port's over the pack. The JAX model's
    Hirschberg steps are its cells x (4 / ALIGN_ROW_PACK) / 256, so the
    port's profile takes the cells a step that gives
    (``align_step_cells``, a field the JAX profile lacks)."""
    for name in ("POA_COLSTEP_PACK", "NODE_GROWTH", "POA_LAYER_BYTES"):
        monkeypatch.setattr(jcm, name, getattr(cm, name))
    monkeypatch.setattr(jcm, "POA_FLOPS_PER_CELL", cm.POA_OPS_PER_CELL)
    monkeypatch.setattr(jcm, "ALIGN_FLOPS_PER_CELL", cm.EDGE_OPS_PER_CELL)
    monkeypatch.setattr(jcm, "LS_GROUP", cm.LS_GROUP / cm.POA_COLSTEP_PACK)
    pp = cm.MachineProfile(**SHARED,
                           align_step_cells=256.0 * jcm.ALIGN_ROW_PACK / 4)
    jp = jcm.MachineProfile(**SHARED)
    for mod, prof in ((cm, pp), (jcm, jp)):
        monkeypatch.setattr(mod, "PROFILES", {**mod.PROFILES, "shared": prof,
                                              "cpu-host": prof})
    return pp, jp


# ------------------------------------------------------ constants and units

def test_grid_constants_are_the_ports():
    assert cm.DEPTH_BUCKETS == poa_driver.DEPTH_BUCKETS
    assert cm.BAND_BUCKETS == band.BAND_BUCKETS
    assert cm.POA_COLSTEP_PACK == colstep.PACK
    assert cm.ALIGN_BANDS == align_cuda.BANDS
    assert cm.LS_GROUP == 1
    assert set(cm.DEVICE_POA_TIERS) == set(poa_driver.POA_KERNELS)
    assert cm.POA_TIERS == poa_driver.POA_KERNELS + ("host",)
    for n in (1, 127, 128, 129, 500, 2500, 11000):
        assert cm.window_class(n) == poa_driver.window_class(n)
    rng = np.random.default_rng(3)
    for n, m in rng.integers(1, 25000, (200, 2)):
        want = next((b for b in cm.ALIGN_BANDS
                     if cm.band_need(n, m) <= b), 0)
        assert align_cuda.band_for(int(n), int(m)) == want
    # the rule's one definition takes arrays too (align_driver's counter)
    L = rng.integers(0, 25000, (200, 2))
    assert cm.band_need(L[:, 0], L[:, 1]).tolist() == \
        [cm.band_need(int(n), int(m)) for n, m in L]


def test_chip_smoke_bounds_with_the_cost_models_constants():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("INT32_OPS_S", "HBM_BYTES_S", "POA_OPS_PER_CELL",
                 "EDGE_OPS_PER_CELL", "BASE_OPS_PER_CELL"):
        assert getattr(smoke, name) is getattr(cm, name), name
    assert cm.INT32_OPS_S == 132 * 64 * 1.98e9 and cm.HBM_BYTES_S == 3.35e12
    h100 = cm.profile("h100")
    assert (h100.peak_flops, h100.hbm_bytes_per_s) == (cm.INT32_OPS_S,
                                                      cm.HBM_BYTES_S)
    assert cm.resolve_profile("auto", "cuda") is h100
    assert cm.resolve_profile("auto", None).name == "cpu-host"


@pytest.mark.parametrize("n", [1, 100, 128, 129, 513, 3000])
def test_window_class_and_band_need_equal_jax(n):
    assert cm.window_class(n) == jcm.window_class(n)
    for m in (0, n // 2, n, 2 * n + 7):
        assert cm.band_need(n, m) == jcm.band_need(n, m)


@pytest.mark.parametrize("est", [(1e12, 1.0, 1.0), (1.0, 1e12, 1.0),
                                 (1.0, 1.0, 1e12), (0.0, 0.0, 0.0)])
def test_roofline_equals_jax(shared, est):
    pp, jp = shared
    assert cm.roofline(cm.CostEstimate(*est), pp) == \
        jcm.roofline(jcm.CostEstimate(*est), jp)


@pytest.mark.parametrize("tier", ["ls", "v2"])
def test_model_rows_poa_equal_jax(shared, tier):
    pp, jp = shared
    got = cm.model_rows(pp, window_lengths=(500, 1500), tiers=(tier,))
    want = jcm.model_rows(jp, window_lengths=(500, 1500), tiers=(tier,))
    assert [r for r in got if r["kind"] == "poa"] == \
        [r for r in want if r["kind"] == "poa"]
    assert [r["band"] for r in got if r["kind"] == "align"] == \
        list(cm.ALIGN_BANDS)


# --------------------------------------------------- synthetic traces

def _counters(tier="ls", host=3, shards=0, banded=True):
    c = {f"served.consensus.{tier}": 40, "served.consensus.host": host,
         "served.consensus.backbone": 2,
         "poa.windows.d8.c512": 10, "poa.cells.d8.c512": 10 * 7 * 512,
         "poa.windows.d32.c512": 30, "poa.cells.d32.c512": 30 * 25 * 512,
         "poa.windows.d32.c1024": 3, "poa.cells.d32.c1024": 3 * 30 * 1024,
         "align.cells.hirschberg": 2 * 8000 * 1024 * 50,
         "align.cells.total": 8000 * 850 * 70}
    if banded:
        c.update({"align.cells.banded": 2 * 8000 * 256 * 20,
                  "poa.cells.banded": 12345})
    for d in range(shards):
        c[f"shard.rows.d{d}"] = 17
    return c


def _trace(counters, align_s=2.0, poa_s=0.5, overlap=False):
    """A trace doc: the five phases (align and poa at the given walls;
    poa overlapping align by half its wall where `overlap`), two
    poa.bucket spans, two align.cohort spans, and the counters."""
    ev, t = [], 0
    for name, dur in (("parse", 0.1), ("align", align_s),
                      ("window_assign", 0.05), ("poa", poa_s),
                      ("stitch", 0.01)):
        us = int(dur * 1e6)
        if name == "poa" and overlap:
            t -= us // 2
        ev.append({"name": f"phase.{name}", "ph": "X", "ts": t, "dur": us,
                   "pid": 1, "tid": 1})
        t += us
    ev += [{"name": "poa.bucket", "ph": "X", "ts": 10, "dur": 300,
            "pid": 1, "tid": 1, "args": {"depth": 8, "wl_class": 512}},
           {"name": "poa.bucket", "ph": "X", "ts": 400, "dur": 500,
            "pid": 1, "tid": 1, "args": {"depth": 32, "wl_class": 512}},
           {"name": "align.cohort", "ph": "X", "ts": 20, "dur": 700,
            "pid": 1, "tid": 1, "args": {"tier": "hirschberg", "jobs": 5}},
           {"name": "align.cohort", "ph": "X", "ts": 900, "dur": 50,
            "pid": 1, "tid": 1, "args": {"tier": "hirschberg", "jobs": 1}},
           {"name": "serve.shed", "ph": "i", "ts": 5, "pid": 1, "tid": 1}]
    return {"traceEvents": ev, "displayTimeUnit": "ms",
            "otherData": {"dropped_events": 0},
            "racon_tpu": {"metrics": {"counters": counters}}}


@pytest.mark.parametrize("tier", ["ls", "v2"])
@pytest.mark.parametrize("host,shards,banded", [(3, 0, True), (0, 2, False),
                                                (40, 4, True)])
def test_predict_from_counters_equals_jax(shared, tier, host, shards,
                                          banded):
    pp, jp = shared
    c = _counters(tier, host, shards, banded)
    assert cm.predict_from_counters(c, pp) == \
        jcm.predict_from_counters(c, jp)
    assert cm.predict_from_counters(c, pp, n_devices=3) == \
        jcm.predict_from_counters(c, jp, n_devices=3)
    assert cm.infer_n_devices(c) == jcm.infer_n_devices(c) == max(1, shards)


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("align_s", [1e-4, 2.0, 500.0])
def test_validate_trace_equals_jax(shared, overlap, align_s):
    pp, jp = shared
    doc = _trace(_counters("ls"), align_s=align_s, overlap=overlap)
    got, want = cm.validate_trace(doc, pp), jcm.validate_trace(doc, jp)
    assert got == want
    assert ("phase_overlap_s" in got) == overlap


def test_span_math_equals_jax():
    doc = _trace(_counters(), overlap=True)
    doc["traceEvents"] += [
        {"name": "a", "ph": "X", "ts": s, "dur": d, "pid": 1, "tid": 1}
        for s, d in ((0, 10), (5, 10), (40, 5))] + [
        {"name": "b", "ph": "X", "ts": s, "dur": d, "pid": 1, "tid": 1}
        for s, d in ((12, 30), (100, 1))]
    for name in ("a", "b", "phase.poa", "none"):
        assert cm.span_intervals(doc, name) == jcm.span_intervals(doc, name)
    ivs = [(5, 9), (0, 3), (2, 4), (9, 12)]
    assert cm.union_intervals(ivs) == jcm.union_intervals(ivs)
    assert cm.overlap_us(doc, "a", "b") == jcm.overlap_us(doc, "a", "b") \
        == 5.0
    assert cm.phase_overlaps_us(doc) == jcm.phase_overlaps_us(doc) != {}
    assert reader.phase_overlaps_us is cm.phase_overlaps_us
    assert reader.union_intervals is cm.union_intervals


def test_bench_cost_model_equals_jax(shared):
    c = {"counters": _counters("v2")}
    walls = {"alignment": 3.0, "consensus": 0.4}
    assert cm.bench_cost_model(c, walls, "shared") == \
        jcm.bench_cost_model(c, walls, "shared")
    assert cm.bench_cost_model(None, walls) is None


@pytest.mark.parametrize("counters", [False, True])
def test_critpath_analyze_equals_jax(shared, counters):
    doc = _merged_doc()
    if counters:
        doc["otherData"] = {"platform": "cpu"}
        doc["racon_tpu"] = {"metrics": {"counters": _counters()}}
    got = cp.analyze(doc)
    assert got == jcp.analyze(doc)
    assert got["jobs"][0]["attributed_us"] == got["jobs"][0]["wall_us"]
    assert (got["costmodel"] is not None) == counters


# ------------------------------------------------------------ the reader

def _write(path, doc):
    path.write_text(json.dumps(doc))
    return str(path)


def test_obs_cli_model_validate_critpath_overlap(tmp_path, capsys):
    assert reader.main(["model"]) == 0
    assert "machine profile: cpu-host" in capsys.readouterr().out
    assert reader.main(["model", "--profile", "h100", "--json",
                        "--window-length", "500"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert {r["tier"] for r in rows} == {"ls", "v2", "hirschberg"}
    assert reader.main(["model", "--profile", "tpu-v4-lite"]) == 2
    assert "unknown machine profile" in capsys.readouterr().err
    assert reader.main(["model", "--lowered"]) == 2

    # validate: 0 when the prediction is within the bound, 3 past it
    counters = _counters(banded=False)
    pred = cm.predict_from_counters(counters, cm.profile("cpu-host"))
    ph = pred["phases"]
    ok = _write(tmp_path / "ok.json", _trace(
        counters, align_s=ph["align"]["predicted_s"],
        poa_s=ph["poa"]["predicted_s"]))
    assert reader.main(["validate", ok, "--profile", "cpu-host"]) == 0
    assert "verdict: OK" in capsys.readouterr().out
    assert reader.main(["validate", ok]) == 0      # auto: no platform
    capsys.readouterr()
    far = _write(tmp_path / "far.json", _trace(
        counters, align_s=100 * ph["align"]["predicted_s"],
        poa_s=ph["poa"]["predicted_s"]))
    assert reader.main(["validate", far, "--profile", "cpu-host",
                        "--json"]) == 3
    v = json.loads(capsys.readouterr().out)
    assert v["ok"] is False and v["phases"]["align"]["within_bound"] is False
    bad = _trace(counters)
    bad["traceEvents"].append({"name": "x", "ph": "Q", "pid": 1, "tid": 1})
    assert reader.main(["validate", _write(tmp_path / "bad.json", bad)]) == 1
    assert reader.main(["validate", str(tmp_path / "missing.json")]) == 2
    assert reader.main(["validate", ok, "--profile", "nope"]) == 2
    capsys.readouterr()

    # critpath: 0 attributed, 3 past --max-unattributed
    merged = _write(tmp_path / "merged.json", _merged_doc())
    assert reader.main(["critpath", merged]) == 0
    assert "OK: every job attributed" in capsys.readouterr().out
    assert reader.main(["critpath", merged, "--max-unattributed",
                        "-0.5"]) == 3
    assert "UNATTRIBUTED" in capsys.readouterr().err
    assert reader.main(["critpath", str(tmp_path / "missing.json")]) == 2

    # --overlap: 0 where the spans overlap, 3 where they never do, 2 bad
    ov = _trace(counters, overlap=True)
    path = _write(tmp_path / "ov.json", ov)
    assert reader.main(["--overlap", "phase.align:phase.poa", path]) == 0
    assert "overlap for" in capsys.readouterr().out
    assert reader.main(["--overlap", "phase.parse:phase.stitch", path]) == 3
    assert "NO OVERLAP" in capsys.readouterr().err
    assert reader.main(["--overlap", "phase.parse", path]) == 2
    assert reader.main(["--overlap", "phase.align:phase.poa", "--json",
                        path]) == 0
    j = json.loads(capsys.readouterr().out)
    assert j["overlap_us"] > 0 and j["spans_a"] == 1


def test_obs_modules_import_without_torch():
    code = ("import sys\n"
            "import racon_tpu_torch.obs.costmodel, "
            "racon_tpu_torch.obs.critpath\n"
            "from racon_tpu_torch.obs import __main__ as m\n"
            "rc = m.main(['model', '--profile', 'h100'])\n"
            "bad = [k for k in sys.modules if k == 'torch' or "
            "k.startswith(('torch.', 'jax', 'racon_tpu.'))]\n"
            "print(bad)\n"
            "sys.exit(rc or (1 if bad else 0))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "machine profile: h100" in r.stdout


# ------------------------------------------------- counters of a polish

COUNTED = ("poa.windows.", "poa.cells.", "align.cells.")


def _counted(path):
    with open(path) as f:
        c = json.load(f)["racon_tpu"]["metrics"]["counters"]
    return {k: v for k, v in c.items() if k.startswith(COUNTED)}


@pytest.fixture(scope="module")
def polish_pair(tmp_path_factory):
    """{flat, band}: (the port's trace, its counters, TpuPolisher's
    counters); each JAX polish runs once."""
    d = tmp_path_factory.mktemp("costmodel")
    paths = _paf_dataset(d)
    out = {}
    for name, env, kw in (
            ("flat", {}, {}),
            ("band", {"RACON_TPU_BAND": "1", "RACON_TPU_BAND_SLACK": "8",
                      "RACON_TPU_PALLAS": "1", "RACON_TPU_POA_KERNEL": "v2"},
             dict(band=True, band_slack=8, poa_kernel="v2"))):
        jt, tt = str(d / f"jax.{name}.json"), str(d / f"torch.{name}.json")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
            for k, v in env.items():
                mp.setenv(k, v)
            p = racon_tpu.TpuPolisher(*paths, trace_path=jt, **KW)
            p.initialize()
            jax_out = p.polish(True)
        q = TorchPolisher(*paths, device="cpu", trace_path=tt, **KW, **kw)
        q.initialize()
        assert q.polish(True) == jax_out
        out[name] = (tt, _counted(tt), _counted(jt))
    return out


@pytest.mark.parametrize("name", ["flat", "band"])
def test_polish_counts_the_jax_packages_cells(polish_pair, name):
    _, got, want = polish_pair[name]
    assert got == want
    assert {k.split(".d")[0] for k in got if ".d" in k} == \
        {"poa.windows", "poa.cells"}
    assert got["align.cells.hirschberg"] > 0 and got["align.cells.total"] > 0
    assert ("poa.cells.banded" in got) == ("align.cells.banded" in got) \
        == (name == "band")


def test_port_trace_validates(polish_pair):
    trace, counters, _ = polish_pair["flat"]
    doc, errors = reader.load_trace(trace)
    assert errors == []
    v = cm.validate_trace(doc, cm.resolve_profile(
        "auto", doc["otherData"].get("platform")))
    assert v["profile"] == "cpu-host"
    for name in ("align", "poa"):
        ph = v["phases"][name]
        assert ph["measured_s"] > 0 and ph["predicted_s"] > 0
    windows = sum(n for k, n in counters.items()
                  if k.startswith("poa.windows."))
    assert {b.get("windows") for b in v["buckets"]
            if b["kind"] == "poa"} == {windows}


# ---------------------------------------------------------- fit_profile

def test_fit_profile_readings():
    """cpu-host's fitted rates make each modeled phase read its own wall;
    h100's align_step_cells bills the aligner kernels' busy time on the
    device track at the profile's serial step."""
    counters = _counters(host=0, banded=False)
    doc = _trace(counters, align_s=2.0, poa_s=0.5)
    host = {"initialize_s": 4.0, "consensus_s": 2.0}
    r = fit_profile.readings("cpu-host", doc, host)
    assert r["host_align_cells_per_s"] == counters["align.cells.total"] / 4
    prof = cm.MachineProfile(**{**SHARED, "hbm_bytes_per_s": float("inf"),
                                **{k: r[k] for k in (
                                    "serial_step_s", "peak_flops",
                                    "align_step_cells",
                                    "host_poa_cells_per_s",
                                    "host_align_cells_per_s")}})
    v = cm.validate_trace(doc, prof)
    for name, wall in (("align", 2.0), ("poa", 0.5)):
        assert v["phases"][name]["ratio"] == pytest.approx(1.0, rel=1e-9)
        assert v["phases"][name]["measured_s"] == pytest.approx(wall)
    doc["traceEvents"] += [
        {"name": n, "ph": "X", "cat": "device", "ts": t, "dur": us,
         "pid": 2, "tid": 1}
        for n, t, us in (("hirschberg_edge", 100, 3000),
                         ("hirschberg_base", 5000, 1000),
                         ("poa_consensus", 2_200_000, 9000))]
    r = fit_profile.readings("h100", doc, host)
    assert r["aligner_device_s"] == pytest.approx(0.004)
    assert r["align_step_cells"] == pytest.approx(
        counters["align.cells.hirschberg"]
        * cm.profile("h100").serial_step_s / 0.004)
    assert fit_profile.main([]) == 2 and fit_profile.main(["tpu"]) == 2


# ---------------------------------------------------------- kernel_bench

def test_kernel_bench_batch_equals_jax_tools():
    cfg = poa_driver.make_config(500, 4, 5, -4, -8)
    jcfg = jpd.make_config(500, 4, 5, -4, -8)
    assert tuple(cfg) == tuple(jcfg)
    got = kb.make_batch(cfg, 3, np.random.default_rng(5))
    want = jkb.make_batch(jcfg, 3, np.random.default_rng(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_kernel_bench_needs_a_card_unless_told_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        kb.main(["1", "2", "1"])
    assert kb.main(["1", "2", "1", "--device", "cpu",
                    "--poa-kernel", "ls"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["device"] == "cpu" and line["B"] == 1
    assert line["poa_kernel"] == "ls" and line["failed"] == 0
    assert line["over_bound"] is None and line["card"] is None
    assert line["bound_ms"] > 0 and line["cells"] > 0
