"""racon_tpu_torch's span tracing and run report against racon_tpu's
readers and reports, on the CPU.

A traced polish gives the untraced bytes; the port's trace passes both
the port's and the JAX package's ``load_trace`` and gives the same
breakdown and phase walls under both; the report's served counts sum to
each phase's total, agree with the metrics, and its per-phase totals and
backbone counts are those of racon_tpu.TpuPolisher's report (run once for
the module, with its Hirschberg aligner: RACON_TPU_DEVICE_ALIGNER=
hirschberg).
"""

import json
import os

import pytest

import racon_tpu
from racon_tpu.obs import __main__ as jax_reader
from racon_tpu_torch import TorchPolisher, obs
from racon_tpu_torch.obs import __main__ as reader
from racon_tpu_torch.obs.tracer import Tracer
from tests.test_torch_polish import KW, _paf_dataset


def _torch_run(paths, **kw):
    p = TorchPolisher(*paths, device="cpu", **KW, **kw)
    p.initialize()
    return p.polish(True), p


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    paths = _paf_dataset(d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
        p = racon_tpu.TpuPolisher(*paths, **KW)
        p.initialize()
        jax_out = p.polish(True)
    trace = str(d / "trace.json")
    out, tp = _torch_run(paths, trace_path=trace)
    return dict(dir=d, paths=paths, jax_out=jax_out,
                jax_report=p.report.as_dict(), out=out, trace=trace,
                report=tp.report.as_dict(), polisher=tp)


def test_traced_polish_equals_untraced(ref, tmp_path):
    before = set(os.listdir(ref["dir"]))
    out, p = _torch_run(ref["paths"])
    assert out == ref["out"] == ref["jax_out"]
    assert not obs.enabled() and obs.trace_path() is None
    assert set(os.listdir(ref["dir"])) == before
    assert p.report.as_dict()["obs"] == {"armed": False}


@pytest.mark.parametrize("load", [reader.load_trace, jax_reader.load_trace],
                         ids=["port", "jax"])
def test_trace_passes_both_readers(ref, load):
    doc, errors = load(ref["trace"])
    assert errors == []
    assert doc["otherData"]["dropped_events"] == 0


def test_both_readers_give_the_same_breakdown(ref):
    doc, _ = reader.load_trace(ref["trace"])
    assert reader.phase_walls_us(doc) == jax_reader.phase_walls_us(doc)
    assert reader.breakdown(doc) == jax_reader.breakdown(doc)
    assert reader.render(doc, "t") == jax_reader.render(doc, "t")
    assert set(reader.phase_walls_us(doc)) == set(obs.PHASES)


def test_phase_spans_in_order(ref):
    doc, _ = reader.load_trace(ref["trace"])
    starts = {}
    for ev in doc["traceEvents"]:
        if ev.get("ph") == "X" and ev["name"].startswith("phase."):
            starts[ev["name"][6:]] = ev["ts"]
    assert sorted(starts, key=lambda n: starts[n]) == list(obs.PHASES)


def test_trace_holds_the_driver_spans_and_counters(ref):
    doc, _ = reader.load_trace(ref["trace"])
    names = {ev["name"] for ev in doc["traceEvents"] if ev.get("ph") == "X"}
    assert {"align.cohort", "align.host", "poa.bucket", "poa.batch",
            "poa.host_fallback", "poa.metadata"} <= names
    counters = doc["racon_tpu"]["metrics"]["counters"]
    windows = sum(v for k, v in counters.items()
                  if k.startswith("poa.windows.d"))
    assert windows == ref["report"]["phases"]["consensus"]["served"]["ls"]


def test_report_sums_and_matches_jax(ref):
    rep, jrep = ref["report"], ref["jax_report"]
    assert set(rep["phases"]) == {"alignment", "consensus"}
    for name, phase in rep["phases"].items():
        assert sum(phase["served"].values()) == phase["total"]
        assert phase["total"] == jrep["phases"][name]["total"]
    assert rep["phases"]["consensus"]["served"]["backbone"] == \
        jrep["phases"]["consensus"]["served"]["backbone"]
    check = rep["obs"]["served_sum"]
    assert check and all(v["ok"] for v in check.values())
    counters = rep["obs"]["metrics"]["counters"]
    for name, phase in rep["phases"].items():
        assert check[name]["metrics"] == sum(
            v for k, v in counters.items() if k.startswith(f"served.{name}."))
    extra = rep["phases"]["consensus"]["extra"]
    for key in ("device_rejected", "layers_dropped_maxlen", "band",
                "pack_wall_s", "kernel_wall_s", "depth_collapsed"):
        assert key in extra
    assert set(rep) == {"phases", "fault_spec", "obs", "wall_s"}


def test_stats_keep_their_keys(ref):
    st = ref["polisher"].stats
    assert {"parse_s", "align_s", "windows_s", "consensus_s",
            "stitch_s"} <= set(st)
    assert set(st["align"]) == {"device", "host", "host_seconds", "band"}
    assert "report" not in st["consensus"]


def test_report_writes_json(ref, tmp_path):
    p = ref["polisher"]
    path = str(tmp_path / "r.json")
    p.report.write(path)
    with open(path) as f:
        assert json.load(f)["phases"]["consensus"]["total"] > 0


def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


def test_obs_cli_exit_codes(ref, tmp_path, capsys):
    trace = ref["trace"]
    assert reader.main([trace]) == 0
    assert reader.main(["--validate", trace]) == 0
    assert reader.main(["--device", trace]) == 0
    bad = _write(tmp_path / "bad.json",
                 {"traceEvents": [{"ph": "X", "name": "x", "pid": 1,
                                   "tid": 1, "ts": -1, "dur": 1}]})
    assert reader.main([bad]) == 1
    assert reader.main([str(tmp_path / "none.json")]) == 2
    (tmp_path / "junk.json").write_text("not json")
    assert reader.main([str(tmp_path / "junk.json")]) == 2
    doc, _ = reader.load_trace(trace)
    slow = json.loads(json.dumps(doc))
    for ev in slow["traceEvents"]:
        if ev.get("name") == "phase.poa":
            ev["dur"] = ev["dur"] * 10 + 10_000_000
    slow = _write(tmp_path / "slow.json", slow)
    assert reader.main(["--diff", trace, slow]) == 3
    assert reader.main(["--diff", trace, trace]) == 0
    assert reader.main(["--diff", trace]) == 2
    capsys.readouterr()


def test_device_track_reader():
    """Busy share and host gaps of a made-up trace: two launches inside a
    phase span, a batch span holding the gap between them."""
    ev = [{"name": "phase.poa", "ph": "X", "ts": 0, "dur": 100, "pid": 1,
           "tid": 1, "cat": "span"},
          {"name": "poa.batch", "ph": "X", "ts": 15, "dur": 55, "pid": 1,
           "tid": 1, "cat": "span"},
          {"name": "poa_consensus", "ph": "X", "ts": 20.0, "dur": 10.0,
           "pid": 1, "tid": 5, "cat": "device"},
          {"name": "poa_consensus", "ph": "X", "ts": 50.0, "dur": 10.0,
           "pid": 1, "tid": 5, "cat": "device"}]
    d = reader.device_track({"traceEvents": ev})
    assert d["kernels"] == {"poa_consensus": {"launches": 2,
                                              "busy_us": 20.0}}
    assert d["busy_share"] == pytest.approx(0.2)
    assert d["gaps_by_span"]["poa.batch"] == {"gaps": 1, "sum_us": 20.0,
                                              "max_us": 20.0}
    assert d["gaps_by_span"]["phase.poa"]["gaps"] == 2
    assert d["top_gaps"][0]["gap_us"] == 40.0


def test_tracer_bounds_its_buffer(tmp_path):
    t = Tracer(max_events=3)
    for i in range(5):
        t.add_complete("s", 0, 1000 * i)
    assert len(t.events()) == 3 and t.dropped == 2
    t.add_track_complete("k", t.t0_ns, t.t0_ns + 1500, 7, "device: k",
                         "device")
    path = str(tmp_path / "t.json")
    t.write(path)
    doc, errors = jax_reader.load_trace(path)
    assert errors == [] and doc["otherData"]["dropped_events"] == 3


def test_disarmed_hooks_are_no_ops():
    obs.reset()
    assert obs.span("x") is obs.span("y")
    obs.count("c")
    obs.event("e")
    assert obs.snapshot() is None and obs.write_trace() is None
    assert obs.served_sum_check({}) == {}
