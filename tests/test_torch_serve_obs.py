"""The serve daemon's observability and queueing modules against the JAX
package's, on the CPU.

Each JAX-free module the port copied (racon_tpu_torch/obs/{slo, ledger,
export, flight, context}.py, fleet/queues.py, serve/protocol.py, the
obs shipment and telemetry) must give racon_tpu's outputs on the same
inputs; each setting the port takes as an argument must default to its
JAX knob's default (racon_tpu/config.py).
"""

import importlib
import inspect
import io
import json

import pytest

from racon_tpu import config as jax_config
from racon_tpu.fleet import queues as jax_queues
from racon_tpu.obs import context as jax_context
from racon_tpu.obs import export as jax_export
from racon_tpu.obs import flight as jax_flight
from racon_tpu.obs import ledger as jax_ledger
from racon_tpu.obs import slo as jax_slo
from racon_tpu.serve import protocol as jax_protocol
from racon_tpu_torch import obs
from racon_tpu_torch.fleet import DEFAULT_TENANT_QUOTA, queues
from racon_tpu_torch.obs import context, export, flight, ledger, slo
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.serve import protocol, server, session
from racon_tpu_torch.serve.__main__ import build_arg_parser

# (racon_tpu.obs has a function named tracer, which `from ... import`
# would give)
jax_tracer = importlib.import_module("racon_tpu.obs.tracer")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in list(jax_config.KNOBS):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.configure(None)
    yield
    faults.configure(None)
    slo.reset()
    jax_slo.reset()


# -- defaults ---------------------------------------------------------------

def _jax_default(name):
    kind = jax_config.KNOBS[name].kind
    return {"int": jax_config.get_int, "float": jax_config.get_float,
            "bool": jax_config.get_bool,
            "str": jax_config.get_str}[kind](name)


def _arg_default(fn, arg):
    return inspect.signature(fn).parameters[arg].default


def _cli_default(flag):
    return build_arg_parser().get_default(flag)


PORT_DEFAULTS = {
    "RACON_TPU_SERVE_PORT": lambda: session.DEFAULT_PORT,
    "RACON_TPU_SERVE_QUEUE_DEPTH": lambda: session.DEFAULT_QUEUE_DEPTH,
    "RACON_TPU_SERVE_MAX_JOBS": lambda: session.DEFAULT_MAX_JOBS,
    "RACON_TPU_SERVE_WARMUP": lambda: session.DEFAULT_WARMUP,
    "RACON_TPU_SERVE_WINDOW_BUDGET": lambda: session.DEFAULT_WINDOW_BUDGET,
    "RACON_TPU_METRICS_PORT": lambda: session.DEFAULT_METRICS_PORT,
    "RACON_TPU_MEM_BUDGET_MB": lambda: session.DEFAULT_MEMORY_BUDGET_MB,
    "RACON_TPU_FLEET_TENANT_QUOTA": lambda: DEFAULT_TENANT_QUOTA,
    "RACON_TPU_SLO_LATENCY_S": lambda: _arg_default(slo.SLOEngine,
                                                    "latency_s"),
    "RACON_TPU_SLO_AVAILABILITY": lambda: _arg_default(slo.SLOEngine,
                                                       "availability"),
    "RACON_TPU_SLO_FAST_WINDOW_S": lambda: _arg_default(slo.SLOEngine,
                                                        "fast_window_s"),
    "RACON_TPU_SLO_SLOW_WINDOW_S": lambda: _arg_default(slo.SLOEngine,
                                                        "slow_window_s"),
    "RACON_TPU_SLO_BURN_ALERT": lambda: _arg_default(slo.SLOEngine,
                                                     "burn_alert"),
    "RACON_TPU_SLO_SHED_BURN": lambda: _arg_default(slo.SLOEngine,
                                                    "shed_burn"),
    "RACON_TPU_FLIGHT": lambda: flight.DEFAULT_ENABLED,
    "RACON_TPU_FLIGHT_EVENTS": lambda: flight.DEFAULT_MAX_EVENTS,
    "RACON_TPU_OBS_SHIP_EVENTS": lambda: obs.SHIP_EVENTS,
    "RACON_TPU_TELEMETRY_RING": lambda: obs.TELEMETRY_RING,
}


@pytest.mark.parametrize("name", sorted(PORT_DEFAULTS))
def test_port_default_equals_the_jax_knob_default(name):
    assert PORT_DEFAULTS[name]() == _jax_default(name)


@pytest.mark.parametrize("dest,name", [
    ("port", "RACON_TPU_SERVE_PORT"),
    ("queue_depth", "RACON_TPU_SERVE_QUEUE_DEPTH"),
    ("max_jobs", "RACON_TPU_SERVE_MAX_JOBS"),
    ("window_budget", "RACON_TPU_SERVE_WINDOW_BUDGET"),
    ("metrics_port", "RACON_TPU_METRICS_PORT"),
    ("tenant_quota", "RACON_TPU_FLEET_TENANT_QUOTA"),
    ("memory_budget_mb", "RACON_TPU_MEM_BUDGET_MB"),
    ("slo_latency_s", "RACON_TPU_SLO_LATENCY_S"),
    ("slo_availability", "RACON_TPU_SLO_AVAILABILITY"),
    ("slo_shed_burn", "RACON_TPU_SLO_SHED_BURN")])
def test_daemon_flag_and_argument_defaults_equal_the_jax_knobs(dest, name):
    assert _cli_default(dest) == _jax_default(name)
    arg = {"slo_latency_s": None, "slo_availability": None,
           "slo_shed_burn": None}.get(dest, dest)
    if arg is not None:
        assert _arg_default(server.ServeDaemon, arg) == _jax_default(name)
    assert _cli_default("no_warm") is (not _jax_default(
        "RACON_TPU_SERVE_WARMUP"))


# -- fleet/queues.py --------------------------------------------------------

QUEUE_CASES = {
    "one_tenant_fifo": [("push", "a", 1, 0), ("push", "a", 2, 0),
                        ("push", "a", 3, 0), "pop", "pop", "pop", "pop"],
    "round_robin": [("push", "a", 1, 0), ("push", "a", 2, 0),
                    ("push", "a", 3, 0), ("push", "b", 4, 0),
                    ("push", "c", 5, 0), "pop", "pop", "pop", "pop", "pop"],
    "priority_outranks": [("push", "a", 1, 0), ("push", "b", 2, 5),
                          ("push", "a", 3, 5), ("push", "c", 4, 1),
                          "pop", "pop", "pop", "pop"],
    "remove_and_rotate": [("push", "a", 1, 0), ("push", "b", 2, 0),
                          ("push", "a", 3, 0), ("remove", "a", 1),
                          ("remove", "b", 9), "pop", ("push", "b", 5, 0),
                          "pop", "pop", "pop"],
    "interleaved": [("push", "x", 1, 2), "pop", ("push", "y", 2, 0),
                    ("push", "x", 3, 0), ("push", "y", 4, 2), "pop",
                    ("push", "z", 5, 0), "pop", "pop", "pop", "pop"],
}


def _drive_queue(q, ops):
    out = []
    for op in ops:
        if op == "pop":
            out.append(q.pop())
        elif op[0] == "push":
            q.push(op[1], op[2], op[3])
        else:
            out.append(q.remove(op[1], op[2]))
        out.append((len(q), q.per_tenant()))
    return out


@pytest.mark.parametrize("case", sorted(QUEUE_CASES))
def test_tenant_queues_pop_order_equals_jax(case):
    ops = QUEUE_CASES[case]
    assert _drive_queue(queues.TenantQueues(), ops) == \
        _drive_queue(jax_queues.TenantQueues(), ops)


# -- obs/slo.py -------------------------------------------------------------

SLO_CASES = {
    "defaults": ({}, [("a", 1.0, True, 0.0), ("a", 2.0, False, 1.0),
                      ("b", 9.0, True, 5.0)]),
    "targets": ({"latency_s": "default=2.5,a=1.0"},
                [("a", 1.5, True, 0.0), ("a", 0.5, True, 1.0),
                 ("b", 3.0, True, 2.0), ("b", 2.0, True, 70.0),
                 ("a", 1.2, True, 80.0)]),
    "bare_target_and_shed": ({"latency_s": "0.5", "shed_burn": 1.0,
                              "availability": 0.9},
                             [("a", 1.0, True, 0.0), ("a", 1.0, True, 1.0),
                              ("b", 0.1, True, 2.0)]),
    "windows": ({"fast_window_s": 5, "slow_window_s": 20,
                 "burn_alert": 1.5, "latency_s": "1"},
                [("a", 2.0, True, 0.0), ("a", 0.1, True, 4.0),
                 ("a", 3.0, False, 10.0), ("a", 0.2, True, 30.0)]),
    "malformed_targets": ({"latency_s": "x=,=3,foo=bar,2,-1,c=0.25"},
                          [("c", 0.5, True, 0.0), ("d", 3.0, True, 1.0)]),
}
_SLO_ENV = {"latency_s": "RACON_TPU_SLO_LATENCY_S",
            "availability": "RACON_TPU_SLO_AVAILABILITY",
            "fast_window_s": "RACON_TPU_SLO_FAST_WINDOW_S",
            "slow_window_s": "RACON_TPU_SLO_SLOW_WINDOW_S",
            "burn_alert": "RACON_TPU_SLO_BURN_ALERT",
            "shed_burn": "RACON_TPU_SLO_SHED_BURN"}


def _drive_slo(engine, records):
    out = []
    for tenant, latency, ok, now in records:
        engine.record(tenant, latency, ok=ok, now=now)
        out.append((engine.burn_rates(tenant, now=now),
                    engine.alerting(tenant, now=now),
                    engine.should_shed(tenant, now=now)))
    last = records[-1][3]
    for dt in (0.0, 30.0, 700.0):
        out.append(engine.snapshot(now=last + dt))
    return out


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_engine_snapshots_equal_jax(case, monkeypatch):
    settings, records = SLO_CASES[case]
    for key, value in settings.items():
        monkeypatch.setenv(_SLO_ENV[key], str(value))
    assert _drive_slo(slo.SLOEngine(**settings), records) == \
        _drive_slo(jax_slo.SLOEngine(), records)


def test_slo_burn_fault_forces_the_alert_as_in_jax(monkeypatch):
    """The slo.burn point: an injected raise is absorbed as a forced
    burn at the alert threshold for one fast window."""
    faults.configure("slo.burn:count=1")
    monkeypatch.setenv("RACON_TPU_FAULT", "slo.burn:count=1")
    records = [("a", 0.1, True, 0.0), ("a", 0.1, True, 10.0),
               ("a", 0.1, True, 100.0)]
    got = _drive_slo(slo.SLOEngine(), records)
    want = _drive_slo(jax_slo.SLOEngine(), records)
    assert got == want
    assert got[0][1] is True and got[-3]["counters"]["burn_faults"] == 1


def test_slo_process_engine_takes_its_settings():
    slo.reset(latency_s="3", shed_burn=2.0)
    eng = slo.engine()
    assert eng.targets == {"default": 3.0} and eng.shed_burn == 2.0
    assert slo.engine() is eng
    slo.reset()
    assert slo.engine().targets == {}
    with pytest.raises(TypeError):
        slo.reset(bogus=1)


# -- obs/ledger.py ----------------------------------------------------------

SUMMARIES = {
    "torch_report": {"alignment": {"wall_s": {"hirschberg": 1.25,
                                              "host": 0.5}},
                     "consensus": {"wall_s": {"ls": 2.0, "host": 0.25,
                                              "journal": 0.0}},
                     "memory": {"wall_s": {}}},
    "host_report": {"consensus": {"wall_s": {"host": 3.5}}},
    "scalar_and_garbage": {"parse": {"wall_s": 0.75},
                           "stitch": {"wall_s": "bad"},
                           "alignment": {"wall_s": {"a": "x", "b": 1}},
                           "window_assign": 7, "unknown": {"wall_s": 1}},
    "not_a_dict": ["x"],
}


@pytest.mark.parametrize("case", sorted(SUMMARIES))
def test_stage_seconds_equals_jax(case):
    s = SUMMARIES[case]
    assert ledger.stage_seconds(s) == jax_ledger.stage_seconds(s)


SNAPSHOTS = {
    "both": {"histograms": {"span_us.kernel.build": {"sum": 1.5e6},
                            "span_us.journal.replay": {"sum": 2500.0},
                            "span_us.phase.poa": {"sum": 9e6}}},
    "zero_and_bad": {"histograms": {"span_us.kernel.build": {"sum": 0},
                                    "span_us.journal.replay": {"sum": "x"}}},
    "disarmed": None,
    "no_histograms": {"counters": {}},
}


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_overlay_seconds_equals_jax(case):
    s = SNAPSHOTS[case]
    assert ledger.overlay_seconds(s) == jax_ledger.overlay_seconds(s)


def _ledger_doc(mod, marks, stages):
    led = mod.JobLedger("job0001", tenant="t")
    base = 10**12
    for name, t in marks:
        led.mark(name, t_ns=base + int(t * 1e9))
    led.mark("submit", t_ns=base + 5)   # idempotent: the first stamp stays
    led.merge_stage_s(stages)
    led.add_stage("poa", -1.0)
    led.add_stage("poa", "x")
    doc = led.as_dict()
    return doc


LEDGER_CASES = {
    "full": ([("admit", 0.001), ("dispatch", 0.5), ("finish", 3.0),
              ("result_ship", 3.01)],
             {"parse": 0.2, "align": 1.0, "poa": 1.1, "kernel_build": 0.3}),
    "unfinished": ([("admit", 0.0), ("dispatch", 0.25)], {"poa": 0.5}),
    "no_ship": ([("admit", 0.0), ("dispatch", 0.1), ("finish", 2.0)],
                {"align": 1.0, 7: 2.0}),
}


@pytest.mark.parametrize("case", sorted(LEDGER_CASES))
def test_job_ledger_and_summarize_equal_jax(case):
    marks, stages = LEDGER_CASES[case]
    # JobLedger stamps "submit" at construction from the clock: the
    # derived intervals are compared, not the submit-relative marks
    a = _ledger_doc(ledger, [("submit", 0.0)] + marks, stages)
    b = _ledger_doc(jax_ledger, [("submit", 0.0)] + marks, stages)
    assert a["stage_s"] == b["stage_s"]
    assert sorted(a["marks"]) == sorted(b["marks"])
    docs = [a, b, None, {"stage_s": "x"}, {"stage_s": {"poa": "x"},
                                           "wall_s": "y"}]
    assert ledger.summarize(docs) == jax_ledger.summarize(docs)
    assert ledger.summarize([]) is None and jax_ledger.summarize([]) is None


# -- obs/export.py ----------------------------------------------------------

EXPORT_CASES = {
    "empty": (None, None, None),
    "metrics": ({"counters": {"served.consensus.ls": 12,
                              "kernel.builds.poa": 1, "odd name!": 2.5},
                 "histograms": {"span_us.phase.poa": {
                     "count": 3, "sum": 12.5,
                     "buckets": {"4": 1, "16": 1, "1": 1}},
                     "bad": "x", "nobuckets": {"count": 2}}},
                None, {"serve_queued_jobs": 2, "serve_running_jobs": 1,
                       "none": None}),
    "slo": (None, "snapshot", {"g": 0.5}),
}


@pytest.mark.parametrize("case", sorted(EXPORT_CASES))
def test_prometheus_text_equals_jax(case):
    metrics, snap, gauges = EXPORT_CASES[case]
    if snap == "snapshot":
        eng = slo.SLOEngine(latency_s="1,t=2")
        for i, (ten, lat) in enumerate((("t", 3.0), ("u", 0.5),
                                        ('q"x', 2.0))):
            eng.record(ten, lat, now=float(i))
        snap = eng.snapshot(now=5.0)
    assert export.prometheus_text(metrics, snap, gauges) == \
        jax_export.prometheus_text(metrics, snap, gauges)


# -- serve/protocol.py ------------------------------------------------------

MESSAGES = [{"op": "ping"},
            {"op": "submit", "sequences": "/r.fq", "args": {"w": 500},
             "trace": None, "unicode": "é☃"},
            {"ok": True, "result": {"records": 2, "polished_bp": 1.5e6,
                                    "list": [1, "a", None, False]}}]


@pytest.mark.parametrize("i", range(len(MESSAGES)))
def test_protocol_bytes_equal_jax(i):
    a, b = io.BytesIO(), io.BytesIO()
    protocol.write_message(a, MESSAGES[i])
    jax_protocol.write_message(b, MESSAGES[i])
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    assert protocol.read_message(a) == MESSAGES[i]
    assert protocol.read_message(a) is None     # clean EOF


@pytest.mark.parametrize("raw", [b"not json\n", b"[1, 2]\n", b'"s"\n',
                                 b"x" * (protocol.MAX_LINE + 10)])
def test_protocol_errors_equal_jax(raw):
    assert protocol.MAX_LINE == jax_protocol.MAX_LINE
    errors = []
    for mod in (protocol, jax_protocol):
        with pytest.raises(ValueError) as e:
            mod.read_message(io.BytesIO(raw))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


# -- obs/flight.py, obs/context.py ------------------------------------------

def _flight_run(mod, tmp_path, name):
    rec = mod.FlightRecorder(max_events=20)
    for i in range(30):
        rec.record("ev", job=i, n=i * 2)
        rec.span(f"span{i % 3}", i * 10.7)
    rec.record("bare")
    rec.set_role("serve")
    rec.set_dir(str(tmp_path / name))
    path = rec.dump("job_error", error="RuntimeError: x")
    with open(path) as f:
        doc = json.load(f)
    for ev in doc["events"]:
        ev.pop("t_mono_ns")
    return ({k: v for k, v in doc.items()
             if k not in ("t_dump_mono_ns", "tool", "pid")},
            len(mod.scan(str(tmp_path))))


def test_flight_ring_records_equal_jax(tmp_path):
    port, n_port = _flight_run(flight, tmp_path, "port")
    jax, n_jax = _flight_run(jax_flight, tmp_path, "jax")
    assert port == jax
    assert len(port["events"]) == 20
    assert (n_port, n_jax) == (1, 2)    # each scan sees the dumps so far


def test_flight_recorder_off_and_its_least_ring(tmp_path):
    rec = flight.FlightRecorder(max_events=4, enabled=False)
    rec.record("x")
    assert rec.events() == [] and rec.dump("r", str(tmp_path)) is None
    rec = flight.FlightRecorder(max_events=4)
    for i in range(40):
        rec.record("y", i=i)
    # a ring of at least 16, as the JAX package's
    assert [e["args"]["i"] for e in rec.events()] == list(range(24, 40))


def test_trace_context_equals_jax():
    for mod in (context, jax_context):
        ctx = jax_context.fresh()
        mod.activate({"trace_id": "ab", "parent": "cd", "x": 1})
        assert mod.current() == {"trace_id": "ab", "parent": "cd"}
        mod.activate({"trace_id": 5})
        assert mod.current() is None
        mod.activate(ctx)
        assert mod.current() == ctx
        mod.clear()
        assert mod.current() is None


# -- obs shipment, role and telemetry ---------------------------------------

def test_shipment_roundtrips_through_both_tracers():
    """A job's shipment (the port's tracer, role and trace context
    stamped) is absorbed by the JAX tracer, its events re-based as the
    JAX package's own shipment's are."""
    context.activate({"trace_id": "feedbeef", "parent": "01"})
    obs.set_role("serve")
    try:
        obs.reset()
        obs.configure(metrics=True)
        with obs.span("phase.poa", windows=3):
            obs.event("serve.job", job="j1")
        ship = obs.shipment(max_events=1)
        assert obs.role() == "serve"
        assert ship["role"] == "serve" and ship["trace_id"] == "feedbeef"
        assert ship["dropped"] == 1 and len(ship["events"]) == 1
        full = obs.shipment()
        assert [e["name"] for e in full["events"]] == ["serve.job",
                                                       "phase.poa"]
        assert full["metrics"]["histograms"]["span_us.phase.poa"]["count"] \
            == 1
        names = [e["name"] for e in flight.recorder().events()[-2:]]
        assert names == ["serve.job", "phase.poa"]
    finally:
        obs.set_role(None)
        context.clear()
        obs.reset()
    jt = jax_tracer.Tracer()
    assert jt.ingest(full) == 2
    got = [e for e in jt.to_dict()["traceEvents"] if e.get("ph") != "M"]
    assert [e["name"] for e in got] == ["serve.job", "phase.poa"]
    assert all(e["pid"] == full["pid"] for e in got)
    # the port's export has the JAX export's keys
    jt2 = jax_tracer.Tracer()
    jt2.add_instant("x", a=1)
    assert set(jt2.export(metrics={})) == set(full)


def test_telemetry_ring_is_bounded_and_survives_reset():
    for i in range(obs.TELEMETRY_RING + 5):
        obs.telemetry_tick(jobs_run=i)
    obs.reset()
    ring = obs.telemetry()
    assert len(ring) == obs.TELEMETRY_RING
    assert ring[-1]["jobs_run"] == obs.TELEMETRY_RING + 4
    assert "mem.rss_mb" in ring[-1] and "served_total" not in ring[-1]
    assert obs.telemetry(last=2) == ring[-2:]
