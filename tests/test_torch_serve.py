"""The port's serve daemon (racon_tpu_torch/serve) against the JAX
package's (racon_tpu/serve), on the CPU.

The pure functions (estimate_windows, percentile, render_markdown,
serve_job_paths, JobSpec.validate) must give racon_tpu's outputs on the
same inputs. A "host" job's bytes must equal racon_tpu's cpu session's
on the same spec; a "cuda" job with device="cpu" (the kernels' plain
versions) those of TorchPolisher(device="cpu"), which
tests/test_torch_polish.py holds to racon_tpu's TpuPolisher. Then the
scheduler (round robin, admission, cancel, a device failure, recovery) and the
daemon (in a thread on port 0). Two tests start subprocesses: the
window-budget demotion (one `cli --host` child) and a daemon killed
mid-job and restarted (two daemons, one after the other). Data: the
simulator at 0.002 Mbp with SAM overlaps; every wait has a timeout.
"""

import json
import os
import socket
import threading
import time

import pytest

from racon_tpu.fingerprint import serve_job_paths as jax_job_paths
from racon_tpu.serve import JobSpec as JaxJobSpec
from racon_tpu.serve import PolishSession as JaxSession
from racon_tpu.serve import loadtest as jax_loadtest
from racon_tpu.serve.scheduler import estimate_windows as jax_estimate
from racon_tpu_torch import TorchPolisher, cli, create_polisher
from racon_tpu_torch.fingerprint import serve_job_paths
from racon_tpu_torch.obs import slo
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.serve import (AdmissionError, JobCancelled, JobSpec,
                                   PolishSession, Scheduler, ServeClient,
                                   ServeDaemon, ServeError, loadtest)
from racon_tpu_torch.serve.scheduler import estimate_windows
from racon_tpu_torch.tools import simulate

ARGS = dict(window_length=100, quality_threshold=10.0, error_threshold=0.3,
            match=5, mismatch=-4, gap=-8, num_threads=1)
WAIT = 120   # seconds: every wait's deadline


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = simulate.generate(str(tmp_path_factory.mktemp("serve_data")),
                          mbp=0.002, coverage=6, mean_read=600, seed=5)
    return (d["reads"], d["overlaps_sam"], d["draft"])


@pytest.fixture(scope="module")
def host_fasta(data):
    """The host backend's bytes, in the FASTA a job writes."""
    p = create_polisher(*data, backend="host", **ARGS)
    p.initialize()
    return "".join(f">{n}\n{s}\n" for n, s in p.polish(True))


@pytest.fixture(scope="module")
def cuda_fasta(data):
    """TorchPolisher(device="cpu")'s bytes."""
    p = TorchPolisher(*data, device="cpu", **ARGS)
    p.initialize()
    return "".join(f">{n}\n{s}\n" for n, s in p.polish(True))


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No fault armed; a fresh process SLO engine (each test's jobs
    alone)."""
    monkeypatch.delenv(faults.ENV, raising=False)
    monkeypatch.delenv("RACON_TPU_FAULT", raising=False)
    faults.configure(None)
    slo.reset()
    yield
    faults.configure(None)
    slo.reset()


def _spec(paths, job_id="", **over):
    return JobSpec(*paths, args=dict(ARGS), job_id=job_id, **over)


def _read(path):
    with open(path) as f:
        return f.read()


# -- the pure functions against the JAX package's ----------------------------

TARGETS = {
    "one_contig": ">a\n" + "ACGT" * 60 + "\n",
    "multi_line_contigs": ">a x\nACGT\nACGTAC\n>b\n" + "A" * 250 +
                          "\n>empty\n>c\nGG\n",
    "fastq": "@r\nACGT\n+\n!!!!\n",
    "empty": "",
    "garbage_first": "ACGT\n>a\nAC\n",
}


@pytest.mark.parametrize("w", [1, 7, 100, 500])
@pytest.mark.parametrize("case", sorted(TARGETS))
def test_estimate_windows_equals_jax(case, w, tmp_path):
    path = tmp_path / "t.fasta"
    path.write_text(TARGETS[case])
    assert estimate_windows(str(path), w) == jax_estimate(str(path), w)
    assert estimate_windows(str(tmp_path / "missing.fa"), w) is None


@pytest.mark.parametrize("values", [[3.0], [1.0, 2.0], [5, 1, 4, 2, 3],
                                    [0.1 * i for i in range(37)]])
@pytest.mark.parametrize("p", [0, 50, 95, 99, 100])
def test_percentile_equals_jax(values, p):
    assert loadtest.percentile(values, p) == \
        jax_loadtest.percentile(values, p)


SUMMARIES = {
    "warm": {"jobs": 4, "clients": 2, "tenants": 1, "priority_levels": 1,
             "throughput_mbps": 0.0123456, "warm_mbps": 0.5,
             "latency_s": {"p50": 1.0, "p95": 2.25, "p99": 2.5},
             "service_s": {"cold_first_job": 3.0, "warm_mean": 1.5,
                           "cold_warm_delta": 1.5},
             "warm_kernel_builds": 0},
    "cold_only_mixed": {"jobs": 1, "clients": 1, "tenants": 3,
                        "priority_levels": 2, "throughput_mbps": 1.0,
                        "warm_mbps": None,
                        "latency_s": {"p50": 1.0, "p95": 1.0, "p99": 1.0},
                        "service_s": {"cold_first_job": None,
                                      "warm_mean": None,
                                      "cold_warm_delta": None},
                        "warm_kernel_builds": 2},
}


@pytest.mark.parametrize("case", sorted(SUMMARIES))
def test_render_markdown_equals_jax(case):
    """The JAX package's table, less its docs-block markers and fleet
    series, naming the port's harness."""
    s = SUMMARIES[case]
    want = jax_loadtest.render_markdown(dict(s, pool=None, curve=[]), "w")
    want = want.replace("racon_tpu.serve", "racon_tpu_torch.serve")
    assert loadtest.render_markdown(s, "w") == \
        "\n".join(want.splitlines()[1:-1])


@pytest.mark.parametrize("backend,jax_backend",
                         [(None, None), ("cuda", "tpu"), ("host", "cpu")])
def test_serve_job_paths_equal_jax(backend, jax_backend):
    got = serve_job_paths("/w", "job0001", backend)
    want = jax_job_paths("/w", "job0001", jax_backend)
    if backend is not None:
        assert got["journal"] == f"/w/jobs/job0001/journal.{backend}.jsonl"
        want["journal"] = want["journal"].replace(jax_backend, backend)
    assert got == want


SPEC_CASES = {
    "unknown_arg": dict(args={"bogus": 1, "window_length": 5}),
    "missing_target": dict(target="/nonexistent.fasta"),
    "empty_sequences": dict(sequences=""),
    "bad_job_id": dict(job_id="a/b"),
    "dot_job_id": dict(job_id=".hidden"),
    "valid": {},
}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_jobspec_validate_errors_equal_jax(case, data):
    kw = dict(sequences=data[0], overlaps=data[1], target=data[2],
              args=dict(ARGS))
    kw.update(SPEC_CASES[case])
    errors = []
    for cls in (JobSpec, JaxJobSpec):
        try:
            cls(**kw).validate()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    assert errors[0] == errors[1]
    docs = []       # the wire round trip: as_dict, then from_dict
    for cls in (JobSpec, JaxJobSpec):
        try:
            docs.append(cls.from_dict(cls(**kw).as_dict()).as_dict())
        except ValueError as e:
            docs.append(str(e))
    assert docs[0] == docs[1]


def test_jobspec_backends_are_the_ports(data):
    JobSpec(*data, backend="cuda").validate()
    JobSpec(*data, backend="host").validate()
    with pytest.raises(ValueError, match="allowed: cuda, host"):
        JobSpec(*data, backend="tpu").validate()
    with pytest.raises(ValueError, match="unknown job field"):
        JobSpec.from_dict({"sequences": "a", "overlaps": "b",
                           "target": "c", "fleet": 1})


# -- the session ------------------------------------------------------------

def test_host_job_equals_the_jax_cpu_session(data, host_fasta, tmp_path):
    jax_res = JaxSession(str(tmp_path / "jax"), backend="cpu").run_job(
        JaxJobSpec(*data, args=dict(ARGS), job_id="h"))
    res = PolishSession(str(tmp_path / "port"), backend="host").run_job(
        _spec(data, job_id="h"))
    assert _read(res["output"]) == _read(jax_res["output"]) == host_fasta
    assert set(jax_res) <= set(res)
    assert res["backend"] == "host" and res["kernel_builds"] == 0
    assert res["output"] == os.path.join(str(tmp_path / "port"), "jobs",
                                         "h", "polished.fasta")
    assert os.path.isfile(os.path.join(str(tmp_path / "port"), "jobs", "h",
                                       "journal.host.jsonl"))


def test_cuda_job_on_the_cpu_equals_torch_polisher_and_resumes(
        data, cuda_fasta, tmp_path):
    """A cuda job (device="cpu") gives TorchPolisher's bytes with the JAX
    session's result keys; the same job id again replays its journal."""
    s = PolishSession(str(tmp_path / "state"), backend="cuda", device="cpu")
    # nothing to build or load for the plain versions
    assert s.warm() == 0.0 and s.warmed is False
    first = s.run_job(_spec(data, job_id="r"))
    assert _read(first["output"]) == cuda_fasta
    jax_keys = {"job_id", "backend", "cold", "wall_s", "records",
                "polished_bp", "kernel_builds", "journal_replayed", "output",
                "report", "trace", "obs", "summary", "ledger"}
    assert jax_keys <= set(first)
    assert first["cold"] and first["journal_replayed"] == 0
    assert first["kernel_builds"] == 0 and first["launches"] == {}
    assert first["batches"] >= 1
    assert set(first["ledger"]["stage_s"]) >= {"align", "poa"}
    with open(first["report"]) as f:
        rep = json.load(f)
    assert rep["job_id"] == "r" and rep["ledger"]["job"] == "r"
    names = {e["name"] for e in first["obs"]["events"]}
    assert {"serve.job", "phase.poa"} <= names
    again = s.run_job(_spec(data, job_id="r"))
    assert not again["cold"] and again["journal_replayed"] >= 1
    assert _read(again["output"]) == cuda_fasta
    assert s.stats()["jobs_run"] == 2


def test_session_cancel_before_start(data, tmp_path):
    s = PolishSession(str(tmp_path / "state"), backend="host")
    ev = threading.Event()
    ev.set()
    with pytest.raises(JobCancelled):
        s.run_job(_spec(data, job_id="c"), cancel_event=ev)
    with pytest.raises(ValueError):
        PolishSession(str(tmp_path / "x"), backend="tpu")


# -- the scheduler ----------------------------------------------------------

class _FakeSession:
    """Duck-typed session: records execution order, optionally blocks the
    device lane on an event."""

    backend = "cuda"

    def __init__(self, workdir, gate=None):
        self.workdir = str(workdir)
        self.gate = gate
        self.order = []
        os.makedirs(os.path.join(self.workdir, "jobs"), exist_ok=True)

    def job_dir(self, job_id):
        return os.path.join(self.workdir, "jobs", job_id)

    def stats(self):
        return {"jobs_run": len(self.order)}

    def run_job(self, spec, cancel_event=None):
        if self.gate is not None:
            self.gate.wait(timeout=WAIT)
        if cancel_event is not None and cancel_event.is_set():
            raise JobCancelled(spec.job_id)
        self.order.append(spec.job_id)
        return {"job_id": spec.job_id, "backend": "cuda", "cold": False,
                "wall_s": 0.0, "records": 0, "polished_bp": 0,
                "kernel_builds": 0, "journal_replayed": 0,
                "output": "", "report": "", "trace": "", "summary": None}


def _wait_running(job, timeout=30):
    deadline = time.monotonic() + timeout
    while job.state == "queued":
        assert time.monotonic() < deadline, job.as_status()
        time.sleep(0.01)


def test_scheduler_round_robin_and_admission(data, tmp_path):
    gate = threading.Event()
    ses = _FakeSession(tmp_path / "state", gate=gate)
    sched = Scheduler(ses, queue_depth=4, max_jobs=10, host_lane=False)
    sched.start()
    try:
        blocker = sched.submit(_spec(data, job_id="blk", submitter="z"))
        _wait_running(blocker)
        jobs = [sched.submit(_spec(data, job_id=j, submitter=s))
                for j, s in (("a1", "a"), ("a2", "a"), ("a3", "a"),
                             ("b1", "b"))]
        with pytest.raises(AdmissionError, match="queue full"):
            sched.submit(_spec(data, job_id="a4", submitter="a"))
        gate.set()
        for j in jobs:
            assert j.done.wait(WAIT), j.as_status()
        # round robin: submitter a cannot run its whole burst before b
        assert ses.order == ["blk", "a1", "b1", "a2", "a3"]
        for j in jobs:
            with open(os.path.join(ses.job_dir(j.id), "result.json")) as f:
                assert json.load(f)["state"] == "done"
        st = sched.stats()
        assert st["jobs"] == {"done": 5}
        assert st["admission"]["rejected_queue_full"] == 1
        assert st["ledger"]["jobs"] == 5 and "slo" in st
    finally:
        gate.set()
        sched.shutdown(wait=True, timeout=WAIT)


def test_scheduler_max_jobs_quota_and_cancel_queued(data, tmp_path):
    gate = threading.Event()
    ses = _FakeSession(tmp_path / "state", gate=gate)
    sched = Scheduler(ses, queue_depth=10, max_jobs=3, host_lane=False,
                      tenant_quota=2)
    sched.start()
    try:
        running = sched.submit(_spec(data, job_id="run", submitter="a"))
        _wait_running(running)
        queued = sched.submit(_spec(data, job_id="wait", submitter="a"))
        with pytest.raises(AdmissionError, match="tenant quota"):
            sched.submit(_spec(data, job_id="q", submitter="a"))
        with pytest.raises(AdmissionError, match="already queued"):
            sched.submit(_spec(data, job_id="wait", submitter="b"))
        sched.submit(_spec(data, job_id="b1", submitter="b"))
        with pytest.raises(AdmissionError, match="at capacity"):
            sched.submit(_spec(data, job_id="over", submitter="c"))
        st = sched.cancel("wait")
        assert st["state"] == "cancelled"
        assert queued.done.is_set()
        with open(os.path.join(ses.job_dir("wait"), "result.json")) as f:
            assert json.load(f)["state"] == "cancelled"
        gate.set()
        assert running.done.wait(WAIT)
        assert sched.get("b1").done.wait(WAIT)
        assert ses.order == ["run", "b1"]        # the cancelled job never ran
        with pytest.raises(KeyError):
            sched.get("nope")
        assert sched.admission == {"rejected_quota": 1,
                                   "rejected_capacity": 1}
    finally:
        gate.set()
        sched.shutdown(wait=True, timeout=WAIT)


def test_scheduler_memory_pressure_sheds_then_rejects(data, tmp_path):
    ses = _FakeSession(tmp_path / "state", gate=threading.Event())
    sched = Scheduler(ses, queue_depth=4, max_jobs=8, memory_budget_mb=100)
    assert sched.memory.enabled
    levels = iter(["soft", "hard"])
    sched.memory_source = lambda: next(levels)
    job = sched.submit(_spec(data, job_id="soft"))
    assert job.lane == "host" and "memory" in job.demotions[0]["cause"]
    with pytest.raises(AdmissionError, match="memory pressure"):
        sched.submit(_spec(data, job_id="hard"))
    assert sched.admission == {"shed_memory": 1, "rejected_memory": 1}


def test_device_failure_fails_the_job_and_never_runs_it_on_the_host(
        data, cuda_fasta, tmp_path):
    """An injected raise at the ls POA batch fails the device-lane job
    with that error: the job is not re-run on the host lane, nothing is
    counted as a demotion, and the daemon goes on serving the next job
    on the device lane. (The host lane's runner is replaced by a probe:
    this test starts no child.)"""
    ses = PolishSession(str(tmp_path / "state"), backend="cuda",
                        device="cpu")
    sched = Scheduler(ses, queue_depth=4, max_jobs=8)
    ran_on_host = []
    sched._run_host = lambda job: ran_on_host.append(job.id)
    faults.configure("poa.run.ls:raise=RuntimeError")
    sched.start()
    try:
        job = sched.submit(_spec(data, job_id="dj"))
        assert job.done.wait(WAIT), job.as_status()
        assert job.state == "failed" and job.result is None
        assert "RuntimeError: injected fault at poa.run.ls" in job.error
        assert job.lane == "device" and job.demotions == []
        assert ran_on_host == []
        with open(os.path.join(ses.job_dir("dj"), "result.json")) as f:
            assert json.load(f)["state"] == "failed"
        faults.configure(None)
        ok = sched.submit(_spec(data, job_id="ok"))
        assert ok.done.wait(WAIT), ok.as_status()
        assert ok.state == "done" and ok.lane == "device", ok.error
        assert _read(ok.result["output"]) == cuda_fasta
        st = sched.stats()
        assert st["jobs"] == {"failed": 1, "done": 1}
        assert st["admission"] == {"reserved_windows": 0,
                                   "by_tenant": {"device": {"local": 0},
                                                 "host": {}}}
        assert ran_on_host == []
    finally:
        faults.configure(None)
        sched.shutdown(wait=True, timeout=WAIT)


def test_recover_tolerates_torn_spec_and_result(data, tmp_path):
    ses = _FakeSession(tmp_path / "state")
    jobs_root = os.path.join(ses.workdir, "jobs")

    def job_dir(job_id):
        d = os.path.join(jobs_root, job_id)
        os.makedirs(d, exist_ok=True)
        return d

    a = job_dir("jobA")            # good spec, torn result: re-queued
    with open(os.path.join(a, "spec.json"), "w") as f:
        json.dump(_spec(data, job_id="jobA").as_dict(), f)
    with open(os.path.join(a, "result.json"), "w") as f:
        f.write('{"job_id": "jobA", "state": "do')
    with open(os.path.join(job_dir("jobB"), "spec.json"), "w") as f:
        f.write("null\n")          # parses, not an object: failed
    with open(os.path.join(job_dir("jobC"), "spec.json"), "w") as f:
        f.write('{"seq')           # torn: failed
    d = job_dir("jobD")            # finished: left alone
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(_spec(data, job_id="jobD").as_dict(), f)
    with open(os.path.join(d, "result.json"), "w") as f:
        json.dump({"job_id": "jobD", "state": "done"}, f)

    sched = Scheduler(ses, queue_depth=8, max_jobs=8, host_lane=False)
    assert sched.recover() == ["jobA"]
    assert not os.path.exists(os.path.join(a, "result.json"))
    assert sched.get("jobA").state == "queued"
    for jid in ("jobB", "jobC"):
        j = sched.get(jid)
        assert j.state == "failed" and "recovery failed" in j.error
        with open(os.path.join(jobs_root, jid, "result.json")) as f:
            assert json.load(f)["state"] == "failed"
    with pytest.raises(KeyError):
        sched.get("jobD")


def test_scheduler_takes_no_fleet_plane(data, tmp_path):
    """The scheduler now takes a fleet plane (the name is older than the
    plane branch). Without one the device lane runs the job through
    ``session.run_job``; with one it hands the job to the plane, which
    finishes it through ``on_done``, and the session runs nothing."""
    ses = _FakeSession(tmp_path / "alone")
    sched = Scheduler(ses, host_lane=False)
    assert sched.plane is None
    sched.start()
    try:
        job = sched.submit(_spec(data))
        assert job.done.wait(WAIT) and job.state == "done"
        assert ses.order == [job.id]
    finally:
        sched.shutdown(timeout=WAIT)

    class StubPlane:
        def __init__(self):
            self.submitted = []

        def submit_job(self, job_id, *a, on_done=None, **kw):
            self.submitted.append(job_id)
            # finish off the submitter's thread, as the plane does
            threading.Thread(target=on_done, args=("done", {
                "job_id": job_id, "backend": "cuda", "records": 1,
                "polished_bp": 4, "kernel_builds": 0,
                "journal_replayed": 0, "output": "", "report": None,
                "trace": None, "summary": None}, None)).start()

        def cancel_job(self, job_id):
            return False

        def snapshot(self):
            return {}

        def fleet_telemetry(self):
            return {"workers": {}}

    ses = _FakeSession(tmp_path / "plane")
    plane = StubPlane()
    sched = Scheduler(ses, plane=plane, host_lane=False)
    assert sched.plane is plane
    sched.start()
    try:
        job = sched.submit(_spec(data))
        assert job.done.wait(WAIT) and job.state == "done", job.error
        assert job.lane == "device" and job.result["polished_bp"] == 4
        assert plane.submitted == [job.id]
        assert ses.order == []
    finally:
        sched.shutdown(timeout=WAIT)


# -- the daemon, in a thread ------------------------------------------------

@pytest.fixture
def daemon(tmp_path):
    made = []

    def start(**kw):
        kw.setdefault("warm", False)
        d = ServeDaemon(str(tmp_path / "state"), port=0, **kw)
        d.start()
        made.append(d)
        return d

    yield start
    for d in made:
        d.stop(wait=True)


def test_two_concurrent_clients_get_equal_bytes(data, cuda_fasta, daemon):
    d = daemon(backend="cuda", device="cpu", warm=True)
    assert d.session.stats()["warmed"] is False
    results = {}

    def client(name):
        with ServeClient(d.port, timeout=WAIT) as c:
            jid = c.submit(*data, args=dict(ARGS), submitter=name)
            results[name] = c.wait(jid, timeout=WAIT)

    threads = [threading.Thread(target=client, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert sorted(results) == ["a", "b"]
    colds = sorted(r["result"]["cold"] for r in results.values())
    assert colds == [False, True]
    for r in results.values():
        assert r["state"] == "done" and r["lane"] == "device"
        assert r["demotions"] == [] and r["result"]["kernel_builds"] == 0
        assert _read(r["result"]["output"]) == cuda_fasta
    with ServeClient(d.port, timeout=WAIT) as c:
        st = c.stats()
        assert st["jobs"] == {"done": 2} and st["session"]["jobs_run"] == 2
        assert st["session"]["device"] == "cpu"
        assert len(st["telemetry"]) >= 2 and st["ledger"]["jobs"] == 2
        assert st["slo"]["counters"]["observed"] == 2
        m = c.metrics()
        assert "# TYPE racon_tpu_serve_queued_jobs gauge" in m["text"]
        assert 'racon_tpu_slo_burn_rate{tenant="a",window="fast"} 0' in \
            m["text"]
        assert m["slo"]["counters"]["bad"] == 0


def test_protocol_errors_keep_the_connection_open(data, tmp_path, daemon):
    d = daemon(backend="host")
    sock = socket.create_connection(("127.0.0.1", d.port), timeout=WAIT)
    f = sock.makefile("rwb")

    def rpc(raw):
        f.write(raw + b"\n")
        f.flush()
        return json.loads(f.readline())

    try:
        assert rpc(b"this is not json")["ok"] is False
        assert "unknown op" in rpc(b'{"op": "frobnicate"}')["error"]
        bad = rpc(json.dumps({"op": "submit", "sequences": data[0],
                              "overlaps": data[1],
                              "target": str(tmp_path / "gone.fa")}).encode())
        assert bad["ok"] is False and "not found" in bad["error"]
        assert "unknown job id" in rpc(
            b'{"op": "status", "job_id": "nope"}')["error"]
        assert "unknown backend" in rpc(json.dumps(
            {"op": "submit", "sequences": data[0], "overlaps": data[1],
             "target": data[2], "backend": "tpu"}).encode())["error"]
        # the same connection still serves good requests after each error
        ping = rpc(b'{"op": "ping"}')
        assert ping["ok"] is True and ping["backend"] == "host"
    finally:
        sock.close()
    with ServeClient(d.port, timeout=WAIT) as c:
        with pytest.raises(ServeError, match="unknown polish arg"):
            c.submit(*data, args={"bogus": 1})
        assert c.stats()["jobs"] == {}


def test_shutdown_op_then_submissions_are_refused(data, daemon):
    d = daemon(backend="host")
    with ServeClient(d.port, timeout=WAIT) as c:
        assert c.shutdown()["bye"] is True
    d.scheduler.shutdown(wait=True, timeout=WAIT)
    with pytest.raises(AdmissionError, match="shutting down"):
        d.scheduler.submit(_spec(data, job_id="late"))
    deadline = time.monotonic() + WAIT
    while True:     # the listening socket closes with the stop
        try:
            socket.create_connection(("127.0.0.1", d.port), timeout=1).close()
        except OSError:
            break
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_metrics_http_endpoint_serves_prometheus_text(daemon):
    from urllib.request import urlopen

    d = daemon(backend="host")
    assert d.metrics_port == 0 and d._httpd is None    # 0: off
    s = socket.socket()     # a free port for the endpoint
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    d.metrics_port = port
    d._start_metrics_http()
    with urlopen(f"http://127.0.0.1:{port}/metrics", timeout=WAIT) as r:
        body = r.read().decode()
        assert r.status == 200
    assert "racon_tpu_serve_running_jobs 0" in body


def test_cli_serve_subcommand_dispatches(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "daemon" in out and "--poa-kernel" in out and "--fleet-max" in out


# -- subprocesses: the host lane's child; a daemon killed and restarted ------

def test_window_budget_demotes_to_the_host_lane_child(data, host_fasta,
                                                      tmp_path):
    """A job over the window budget runs on the host lane, a `cli --host`
    child, with the host backend's bytes; the demotion is recorded."""
    ses = PolishSession(str(tmp_path / "state"), backend="cuda",
                        device="cpu")
    sched = Scheduler(ses, queue_depth=4, max_jobs=8, window_budget=5)
    sched.start()
    try:
        job = sched.submit(_spec(data, job_id="big"))
        assert job.lane == "host"
        assert "window budget" in job.demotions[0]["cause"]
        assert job.done.wait(WAIT), job.as_status()
        assert job.state == "done", job.error
        assert job.result["backend"] == "host"
        assert _read(job.result["output"]) == host_fasta
        with open(job.result["report"]) as f:
            assert json.load(f)["phases"]["consensus"]["served"]["host"] > 0
        assert ses.jobs_run == 0                  # the device lane idle
        assert sched.stats()["admission"]["demoted_budget"] == 1
    finally:
        sched.shutdown(wait=True, timeout=WAIT)


def test_daemon_killed_midjob_resumes_on_restart(data, host_fasta,
                                                 tmp_path):
    """A daemon SIGKILLed at its job's third journal record is restarted
    on the same state directory: the job is recovered, its journal
    replayed, and its bytes are the uninterrupted run's."""
    state = str(tmp_path / "state")
    extra = ["--no-warm", "--no-host-lane", "--backend", "host"]

    def spawn(env):
        proc = loadtest.spawn_daemon(state, "host",
                                     extra_args=extra, env=env, timeout=WAIT)
        with open(os.path.join(state, "serve.json")) as f:
            return proc, json.load(f)["port"]

    env = dict(os.environ)
    proc1, port1 = spawn(dict(env, RACON_TORCH_FAULT=(
        "journal.append:batch=3:kill=1")))
    try:
        with ServeClient(port1, timeout=WAIT) as c:
            jid = c.submit(*data, args=dict(ARGS), job_id="prem")
        assert proc1.wait(timeout=WAIT) == -9      # SIGKILL mid-job
    finally:
        if proc1.poll() is None:
            proc1.kill()
            proc1.wait()
    jd = os.path.join(state, "jobs", "prem")
    assert os.path.isfile(os.path.join(jd, "spec.json"))
    assert not os.path.isfile(os.path.join(jd, "result.json"))
    assert os.path.getsize(os.path.join(jd, "journal.host.jsonl")) > 0

    proc2, port2 = spawn(env)
    try:
        with ServeClient(port2, timeout=WAIT) as c:
            res = c.wait(jid, timeout=WAIT)
            assert res["state"] == "done" and res["lane"] == "device"
            assert res["result"]["journal_replayed"] >= 1
            assert _read(res["result"]["output"]) == host_fasta
            c.shutdown()
        assert proc2.wait(timeout=WAIT) == 0
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait()
