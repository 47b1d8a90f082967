"""The port's fleet plane (racon_tpu_torch/fleet/plane.py, pool.py) and
the daemon's plane branch against the JAX package's, on the CPU.

An unstarted FleetPlane binds no socket and spawns nothing, so scripted
scenarios drive the port's and the JAX package's planes through the same
``submit_job``, ``_fetch``, ``_heartbeat``, ``_result``, ``_worker_dead``
and ``cancel_job`` calls; both must give the same answers, chunk states,
attempts, lease holders, counters and pick order (affinity, steals,
tenant rotation, priority), with the JAX knobs set to the values the
port takes as arguments. Then the pool's scale faults and its ``spawn``
seam, the autoscaler's replacement of a worker below the floor, the
scheduler's plane branch (a failed plane job fails and is not re-run on
the host lane; a cancel reaches the plane; the workers' RSS in the
memory ladder), the load test's fleet series, the obs reader's ``merge``
and ``fleet``, and a daemon in a thread whose plane runs one worker in a
thread (the pool's ``spawn`` seam): its job's FASTA is the direct
polish's. No test here starts a process.
"""

import json
import os
import random
import time

import pytest
import torch

from racon_tpu.fleet.plane import FleetPlane as JaxPlane
from racon_tpu.fleet.pool import ElasticPool as JaxPool
from racon_tpu.obs import __main__ as jax_reader
from racon_tpu.resilience import faults as jax_faults
from racon_tpu.serve import loadtest as jax_loadtest
from racon_tpu_torch import create_polisher
from racon_tpu_torch.distrib import worker
from racon_tpu_torch.fleet import (DEFAULT_MAX_WORKERS, DEFAULT_MIN_WORKERS,
                                   DEFAULT_SCALE_P95_MS, DEFAULT_STEAL,
                                   DEFAULT_TENANT_QUOTA)
from racon_tpu_torch.fleet.plane import FleetPlane
from racon_tpu_torch.fleet.pool import ElasticPool
from racon_tpu_torch.obs import __main__ as reader
from racon_tpu_torch.obs import slo
from racon_tpu_torch.ops import cuda_lib
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.serve import (JobSpec, Scheduler, ServeClient,
                                   ServeDaemon, loadtest)
from racon_tpu_torch.serve import __main__ as serve_main
from racon_tpu_torch.tools import simulate
from tests.test_torch_distrib import ThreadProc

ARGS = dict(window_length=100, quality_threshold=10.0, error_threshold=0.3,
            match=5, mismatch=-4, gap=-8, num_threads=1)
KW = dict(window_length=100, match=5, mismatch=-4, gap=-8)
WAIT = 120   # seconds: every wait's deadline


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No fault armed in either package; a fresh SLO engine; one torch
    thread."""
    torch.set_num_threads(1)
    for k in (faults.ENV, "RACON_TPU_FAULT", "RACON_TPU_FLEET_STEAL"):
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    jax_faults.reset()
    slo.reset()
    yield
    faults.configure(None)
    jax_faults.reset()
    slo.reset()


def _identical_reads(root, n_targets=2, n_reads=4, seed=11):
    """200 bp targets, each covered by identical reads (SAM)."""
    rng = random.Random(seed)
    os.makedirs(root, exist_ok=True)
    paths = [os.path.join(root, n) for n in ("reads.fasta", "ovl.sam",
                                             "targets.fasta")]
    with open(paths[2], "w") as tf, open(paths[0], "w") as rf, \
            open(paths[1], "w") as of:
        of.write("@HD\tVN:1.6\n")
        for t in range(n_targets):
            seq = "".join(rng.choice("ACGT") for _ in range(200))
            tf.write(f">t{t}\n{seq}\n")
            for i in range(n_reads):
                rf.write(f">t{t}r{i}\n{seq}\n")
                of.write(f"t{t}r{i}\t0\tt{t}\t1\t60\t200M\t*\t0\t0\t"
                         f"{seq}\t*\n")
    return paths


# -- the plane's dispatch core against the JAX package's ---------------------

class Driver:
    """One package's unstarted plane and the knob and fault settings of a
    scenario, set the way that package takes them."""

    def __init__(self, pkg, tmp_path, monkeypatch):
        self.pkg, self.tmp, self.mp = pkg, tmp_path, monkeypatch
        self.done = []
        wd = str(tmp_path / pkg / "plane")
        if pkg == "jax":
            self.plane = JaxPlane(workdir=wd, min_workers=0, max_workers=2,
                                  backend="cpu")
        else:
            self.plane = FleetPlane(workdir=wd, min_workers=0,
                                    max_workers=2, backend="host")

    def submit(self, job_id, tenant="acme", priority=0, n_targets=2):
        paths = _identical_reads(str(self.tmp / f"data-{job_id}"),
                                 n_targets=n_targets)
        wd = str(self.tmp / self.pkg / f"wd-{job_id}")
        return self.plane.submit_job(
            job_id, *paths, dict(ARGS), False,
            "cpu" if self.pkg == "jax" else "host", wd, tenant=tenant,
            priority=priority,
            on_done=lambda *a: self.done.append((job_id, a[0], a[2])))

    def steal(self, on):
        if self.pkg == "jax":
            if on:
                self.mp.delenv("RACON_TPU_FLEET_STEAL", raising=False)
            else:
                self.mp.setenv("RACON_TPU_FLEET_STEAL", "0")
        else:
            self.plane.steal = on

    def fault(self, spec):
        if self.pkg == "jax":
            if spec:
                self.mp.setenv("RACON_TPU_FAULT", spec)
            else:
                self.mp.delenv("RACON_TPU_FAULT", raising=False)
            jax_faults.reset()
        else:
            faults.configure(spec)


def _resp(r):
    if "chunk" in r:
        ch = r["chunk"]
        return ("chunk", ch["index"], ch["attempt"],
                os.path.basename(ch["journal"]))
    return tuple(sorted(k for k, v in r.items() if k != "ok" and v is True))


def _snap(p):
    now = time.monotonic()
    return {"chunks": [(c.index, c.pos, c.job.id, c.state, c.attempts,
                        c.failures, sorted(c.tried), c.journal_held,
                        sorted((a, ls.worker, ls.canonical)
                               for a, ls in c.leases.items()),
                        c.next_eligible > now, c.served_by)
                       for c in p.chunks],
            "jobs": {j: job.state for j, job in p.jobs.items()},
            "counters": dict(p.counters), "served": dict(p.phase.served),
            "affinity": dict(p._affinity), "rotation": list(p._tenant_rr)}


def _deliver(p, resp, worker=0, body=">x\nACGT\n"):
    ch = resp["chunk"]
    with open(ch["output"], "w") as f:
        f.write(body)
    return p._result({"worker": worker, "chunk": ch["index"],
                      "attempt": ch["attempt"], "output": ch["output"],
                      "stats": {}})


def sc_affinity_then_steal(d, log):
    d.submit("A", tenant="acme")
    d.submit("B", tenant="bcorp")
    log += [_resp(d.plane._fetch(0)) for _ in range(3)]


def sc_steal_gate_and_fault(d, log):
    d.submit("A", tenant="acme")
    d.submit("B", tenant="bcorp")
    log += [_resp(d.plane._fetch(0)) for _ in range(2)]
    d.steal(False)
    log.append(_resp(d.plane._fetch(0)))      # pinned: wait
    d.steal(True)
    d.fault("pool.steal")
    log.append(_resp(d.plane._fetch(0)))      # faulted steal: wait
    d.fault(None)
    log.append(_resp(d.plane._fetch(0)))      # the steal lands


def sc_priority_across_tenants(d, log):
    d.submit("lo", tenant="acme", priority=0)
    d.submit("hi", tenant="acme", priority=5)
    d.submit("other", tenant="bcorp", priority=1)
    log += [_resp(d.plane._fetch(w)) for w in (0, 1, 2, 3)]


def sc_ordered_gather_and_duplicates(d, log):
    job = d.submit("G")
    r1, r2 = d.plane._fetch(0), d.plane._fetch(0)
    by = {r["chunk"]["index"]: r for r in (r1, r2)}
    log.append(_deliver(d.plane, by[1], body=">c1\nTTTT\n"))
    log.append(_deliver(d.plane, by[0], body=">c0\nAAAA\n"))
    assert job.done.wait(10)
    with open(job.result["output"]) as f:
        log.append(f.read())
    log.append((job.result["fleet"], job.result["records"],
                job.result["polished_bp"]))
    log.append(_deliver(d.plane, by[0]))      # a late duplicate
    log.append(list(d.done))


def sc_drain_and_stopping(d, log):
    d.submit("D")
    d.plane.pool._draining.add(7)
    log.append(_resp(d.plane._fetch(7)))
    log.append(_resp(d.plane._fetch(0)))
    with d.plane._cv:
        d.plane._stopping = True
    log.append(_resp(d.plane._fetch(0)))


def sc_lease_reclaim_fault(d, log):
    d.submit("R")
    log.append(_resp(d.plane._fetch(0)))
    d.fault("lease.reclaim")
    d.plane._worker_dead(0, "unit test")
    d.fault(None)


def sc_speculation_and_heartbeats(d, log):
    d.submit("S", n_targets=3)
    rs = [d.plane._fetch(0) for _ in range(3)]
    for r in rs[:2]:
        _deliver(d.plane, r)
    lag = d.plane.chunks[rs[2]["chunk"]["index"]]
    for lease in lag.leases.values():
        lease.t_start -= 60.0
    spec = d.plane._fetch(1)
    log.append(_resp(spec))
    ch = spec["chunk"]
    log.append(d.plane._heartbeat(1, ch["index"], ch["attempt"]))
    log.append(d.plane._heartbeat(1, ch["index"], ch["attempt"] + 5))


def sc_cancel_job(d, log):
    d.submit("C")
    r = d.plane._fetch(0)
    log.append(d.plane.cancel_job("C"))
    log.append(d.plane.cancel_job("C"))
    ch = r["chunk"]
    log.append(d.plane._heartbeat(0, ch["index"], ch["attempt"]))
    log.append(_resp(d.plane._fetch(1)))
    log.append(_deliver(d.plane, r))
    log.append(list(d.done))


PLANE_SCENARIOS = {
    "affinity_then_steal": sc_affinity_then_steal,
    "steal_gate_and_fault": sc_steal_gate_and_fault,
    "priority_across_tenants": sc_priority_across_tenants,
    "ordered_gather_and_duplicates": sc_ordered_gather_and_duplicates,
    "drain_and_stopping": sc_drain_and_stopping,
    "lease_reclaim_fault": sc_lease_reclaim_fault,
    "speculation_and_heartbeats": sc_speculation_and_heartbeats,
    "cancel_job": sc_cancel_job,
}


@pytest.mark.parametrize("name", sorted(PLANE_SCENARIOS))
def test_plane_scenario_equals_jax(name, tmp_path, monkeypatch):
    logs = {}
    for pkg in ("jax", "torch"):
        d = Driver(pkg, tmp_path, monkeypatch)
        log = []
        PLANE_SCENARIOS[name](d, log)
        log.append(_snap(d.plane))
        logs[pkg] = log
    assert logs["torch"] == logs["jax"]


@pytest.mark.parametrize("direction", ["up", "down"])
def test_pool_scale_fault_equals_jax(direction, tmp_path, monkeypatch):
    """pool.scale_up / pool.scale_down: an armed raise is absorbed, the
    resize skipped and counted, in both packages."""

    class Live:
        returncode = None
        pid = 1

        def poll(self):
            return None

    got = {}
    for pkg, cls in (("jax", JaxPool), ("torch", ElasticPool)):
        pool = cls(logs_dir=str(tmp_path / pkg), min_workers=0,
                   max_workers=2)
        if direction == "down":
            pool._procs[0] = Live()
        spec = f"pool.scale_{direction}"
        if pkg == "jax":
            monkeypatch.setenv("RACON_TPU_FAULT", spec)
            jax_faults.reset()
        else:
            faults.configure(spec)
        first = (pool.scale_up(1, cause="drill") if direction == "up"
                 else pool.scale_down(1, cause="drill"))
        monkeypatch.delenv("RACON_TPU_FAULT", raising=False)
        jax_faults.reset()
        faults.configure(None)
        second = (pool.scale_down(1, cause="idle") if direction == "down"
                  else None)
        got[pkg] = (first, second, pool.live(), dict(pool.counters),
                    sorted(pool._draining))
    assert got["torch"] == got["jax"]


def test_pool_spawn_seam_command_and_fault_scoping(tmp_path, monkeypatch):
    """The pool starts `python -m racon_tpu_torch.distrib.worker` with
    the worker's settings; RACON_TORCH_FAULT reaches worker 0 alone."""
    monkeypatch.setenv(faults.ENV, "worker.result:kill=1")
    calls = []

    class Fake:
        pid = 99
        returncode = None

        def __init__(self, cmd, env=None, stdout=None, stderr=None):
            calls.append((cmd, env))

        def poll(self):
            return None

    plane = FleetPlane(str(tmp_path / "plane"), min_workers=2,
                       max_workers=4, device="cpu", spawn=Fake)
    plane.pool.port = 5
    assert plane.pool.start() == 2
    assert plane.memory_share == 0.25
    (cmd0, env0), (cmd1, env1) = calls
    assert cmd0[1:] == ["-m", "racon_tpu_torch.distrib.worker", "--port",
                        "5", "--worker", "0", "--device", "cpu",
                        "--backend", "cuda", "--poa-kernel", "ls",
                        "--memory-share", "0.25"]
    assert cmd1[cmd1.index("--worker") + 1] == "1"
    assert env0[faults.ENV] == "worker.result:kill=1"
    assert faults.ENV not in env1
    assert os.path.dirname(os.path.dirname(worker.__file__)).startswith(
        env0["PYTHONPATH"].split(os.pathsep)[0])
    assert plane.pool.counters == {"workers_spawned": 2}


def test_autoscale_grows_on_backlog_and_replaces_below_floor(tmp_path):
    """A backlog of four chunks on one active worker grows the pool; a
    worker that exits (a sticky CUDA error) is replaced up to the floor
    with no backlog."""
    procs = []

    class Fake:
        pid = 1

        def __init__(self, cmd, env=None, stdout=None, stderr=None):
            self.returncode = None
            procs.append(self)

        def poll(self):
            return self.returncode

    plane = FleetPlane(str(tmp_path / "plane"), min_workers=1,
                       max_workers=2, spawn=Fake)
    plane.pool.start()
    paths = _identical_reads(str(tmp_path / "data"), n_targets=4)
    plane.submit_job("J", *paths, dict(ARGS), False, "host",
                     str(tmp_path / "wd"))
    plane._autoscale(time.monotonic())
    assert plane.pool.live() == 2 and plane.counters == {
        "jobs_admitted": 1}
    assert plane.pool.counters["scale_ups"] == 1
    with plane._cv:
        for c in plane.chunks:
            c.state = "done"
    procs[0].returncode = worker.STICKY_EXIT
    procs[1].returncode = worker.STICKY_EXIT
    assert [r[1] for r in plane._reap()] == [worker.STICKY_EXIT] * 2
    plane._autoscale(time.monotonic())
    assert plane.pool.live() == 1 and len(procs) == 3


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_plane_floor_serves_no_card_job(device, tmp_path, monkeypatch):
    """A chunk whose every attempt fails exhausts its retries. Off the
    card it goes to the local floor; on the card the job fails with the
    chunk's last error and nothing runs on the floor."""
    paths = _identical_reads(str(tmp_path / "data"))
    monkeypatch.setattr(cuda_lib, "build_all", lambda: 0.0)
    monkeypatch.setattr(worker, "load_kernels", lambda device, backend: None)

    def stub(a, **kw):
        raise RuntimeError("POA consensus kernel: boom")

    floor = []

    def run_local(self, c):
        # the floor without its ``cli --host`` child
        floor.append(c.index)
        with open(os.path.join(c.dir, "out.local.fasta"), "w") as f:
            f.write(f">c{c.pos}\nACGT\n")
        with self._cv:
            c.state, c.served_by = "done", "local"
            c.output = os.path.join(c.dir, "out.local.fasta")
            finished = c.job.unfinished() == 0
        if finished:
            self._finish_job(c.job, "done")

    monkeypatch.setattr(worker, "_polish_chunk", stub)
    monkeypatch.setattr(FleetPlane, "_run_local", run_local)
    plane = FleetPlane(str(tmp_path / "plane"), min_workers=1,
                       max_workers=1, retry_base=0.01, max_retries=1,
                       device=device, spawn=ThreadProc)
    calls = []
    plane.start()
    try:
        job = plane.submit_job("J", *paths, dict(ARGS), False, "cuda",
                               str(tmp_path / "wd"),
                               on_done=lambda *a: calls.append(a))
        assert job.done.wait(WAIT)
    finally:
        plane.stop(timeout=WAIT)
    if device == "cpu":
        assert job.state == "done" and len(calls) == 1
        assert sorted(floor) == [c.index for c in job.chunks]
        assert [(d["from"], d["to"]) for d in plane.phase.degradations] \
            == [("fleet", "local")]
        return
    assert job.state == "failed" and floor == []
    assert "exhausted its retry budget" in job.error
    assert job.error.endswith("last error: RuntimeError: POA consensus "
                              "kernel: boom")
    assert calls == [("failed", None, job.error)]
    assert plane.phase.degradations == []
    assert plane.counters["jobs_failed"] == 1


def test_fleet_defaults_equal_jax_knob_defaults(monkeypatch):
    from racon_tpu import fleet as jax_fleet

    for k in ("MIN_WORKERS", "MAX_WORKERS", "SCALE_P95_MS", "STEAL",
              "TENANT_QUOTA"):
        monkeypatch.delenv(f"RACON_TPU_FLEET_{k}", raising=False)
    assert (DEFAULT_MIN_WORKERS, DEFAULT_MAX_WORKERS, DEFAULT_SCALE_P95_MS,
            DEFAULT_STEAL, DEFAULT_TENANT_QUOTA) == (
        jax_fleet.fleet_min_workers(), jax_fleet.fleet_max_workers(),
        jax_fleet.fleet_scale_p95_ms(), jax_fleet.fleet_steal_enabled(),
        jax_fleet.fleet_tenant_quota())
    a = serve_main.build_arg_parser().parse_args([])
    assert (a.fleet_min, a.fleet_max) == (DEFAULT_MIN_WORKERS,
                                         DEFAULT_MAX_WORKERS)


# -- the scheduler's plane branch ---------------------------------------------

class _FakeSession:
    backend = "cuda"

    def __init__(self, root):
        self.workdir = str(root)
        self.ran = []
        os.makedirs(os.path.join(self.workdir, "jobs"), exist_ok=True)

    def job_dir(self, job_id):
        return os.path.join(self.workdir, "jobs", job_id)

    def run_job(self, spec, cancel_event=None):
        self.ran.append(spec.job_id)
        raise AssertionError("a plane job ran in-process")

    def stats(self):
        return {}


class _FakePlane:
    """Answers each submit through `answer(on_done)`."""

    def __init__(self, answer=None, rss=0.0):
        self.answer = answer
        self.submitted, self.cancelled = [], []
        self.rss = rss

    def submit_job(self, job_id, *a, on_done=None, **kw):
        self.submitted.append(job_id)
        if self.answer is not None:
            self.answer(on_done)

    def cancel_job(self, job_id):
        self.cancelled.append(job_id)
        return True

    def snapshot(self):
        return {"workers": {"live": 1}}

    def fleet_telemetry(self):
        return {"workers": {"0": {"rss_mb": self.rss}}}


def _sched(tmp_path, plane, **kw):
    sched = Scheduler(_FakeSession(tmp_path / "state"), plane=plane, **kw)
    sched.start()
    return sched


def test_plane_failure_fails_the_job_and_never_runs_it_on_the_host(
        tmp_path):
    paths = _identical_reads(str(tmp_path / "data"))
    plane = _FakePlane(lambda on_done: on_done("failed", None, "boom"))
    sched = _sched(tmp_path, plane)
    try:
        job = sched.submit(JobSpec(*paths, args=dict(KW)))
        assert job.done.wait(WAIT)
        assert job.state == "failed" and job.error == "boom"
        assert job.lane == "device" and job.demotions == []
        assert plane.submitted == [job.id]
        assert sched.session.ran == []
        st = sched.stats()
        assert st["fleet"] == {"workers": {"live": 1}}
        assert st["queued"]["host"] == 0
    finally:
        sched.shutdown(timeout=WAIT)


def test_cancel_reaches_the_plane(tmp_path):
    paths = _identical_reads(str(tmp_path / "data"))
    plane = _FakePlane()
    sched = _sched(tmp_path, plane)
    try:
        job = sched.submit(JobSpec(*paths, args=dict(KW)))
        deadline = time.monotonic() + WAIT
        while job.state != "running" and time.monotonic() < deadline:
            time.sleep(0.01)
        sched.cancel(job.id)
        assert plane.cancelled == [job.id] and job.cancel.is_set()
    finally:
        sched.shutdown(timeout=WAIT)


@pytest.mark.parametrize("rss,level", [(10.0, "ok"), (85.0, "soft"),
                                       (99.0, "hard")])
def test_memory_ladder_reads_the_workers_rss(rss, level, tmp_path):
    """With a plane, the worst worker's RSS joins the daemon's own
    against the watermarks (80% and 95% of the budget)."""
    sched = Scheduler(_FakeSession(tmp_path / "state"),
                      plane=_FakePlane(rss=rss), memory_budget_mb=100)
    sched.memory._rss = lambda: 1.0
    assert sched.memory_source() == level


# -- the load test's fleet series, the obs reader's merge and fleet -----------

def test_loadtest_pool_series_and_saturation_curve_equal_jax():
    samples = [
        {"t": 0.5, "queued": {"device": 3},
         "fleet": {"workers": {"live": 1, "active": 1}, "min_workers": 1,
                   "max_workers": 4, "chunks_pending": 3,
                   "timeline": [[0.0, 1]]}},
        {"t": 1.5, "queued": {"device": 1},
         "fleet": {"workers": {"live": 3, "active": 3}, "min_workers": 1,
                   "max_workers": 4, "chunks_pending": 1,
                   "timeline": [[0.0, 1], [1.2, 3]]}},
    ]
    completed = [{"t_done": 0.4, "latency_s": 0.4},
                 {"t_done": 1.9, "latency_s": 1.0}]
    assert loadtest.pool_series(samples) == jax_loadtest.pool_series(samples)
    assert loadtest.pool_series([{"t": 0.1}]) is None
    for b in (1, 2, 5):
        assert loadtest.saturation_curve(completed, samples, 2.0, b) == \
            jax_loadtest.saturation_curve(completed, samples, 2.0, b)
    summary = {"jobs": 2, "clients": 1, "tenants": 1, "priority_levels": 1,
               "throughput_mbps": 0.5, "warm_mbps": None,
               "latency_s": {"p50": 1.0, "p95": 1.0, "p99": 1.0},
               "service_s": {"cold_first_job": None, "warm_mean": None,
                             "cold_warm_delta": None},
               "warm_kernel_builds": 0,
               "pool": loadtest.pool_series(samples),
               "curve": loadtest.saturation_curve(completed, samples, 2.0,
                                                  2)}
    want = jax_loadtest.render_markdown(summary, "w").replace(
        "racon_tpu.serve", "racon_tpu_torch.serve")
    assert loadtest.render_markdown(summary, "w") == \
        "\n".join(want.splitlines()[1:-1])


def _trace_doc(pid, role, t0, events, trace_id="ab"):
    return {"traceEvents": [{"name": "process_name", "ph": "M",
                             "pid": pid, "tid": 0, "args": {"name": role}},
                            *[dict(e, pid=pid, tid=1) for e in events]],
            "displayTimeUnit": "ms",
            "otherData": {"pid": pid, "role": role, "trace_id": trace_id,
                          "t0_monotonic_ns": t0, "dropped_events": 0},
            "racon_tpu": {"metrics": {"counters": {"served.poa.ls": 2}}}}


def test_obs_merge_and_fleet_equal_jax(tmp_path):
    coord = _trace_doc(1, "coordinator", 5_000_000, [
        {"name": "distrib.dispatch", "ph": "i", "s": "t", "ts": 10,
         "args": {"span_id": "s1", "trace_id": "ab"}},
        {"name": "fleet.steal", "ph": "i", "s": "t", "ts": 12,
         "args": {}}])
    wrk = _trace_doc(2, "worker0", 7_000_000, [
        {"name": "distrib.chunk", "ph": "X", "ts": 3, "dur": 900,
         "args": {"parent": "s1", "trace_id": "ab", "chunk": 0}},
        {"name": "phase.poa", "ph": "X", "ts": 5, "dur": 400, "args": {}},
        {"name": "mem.rss", "ph": "i", "s": "t", "ts": 950,
         "args": {"rss_mb": 12.5}}])
    bad = _trace_doc(3, "worker1", 6_000_000, [
        {"name": "distrib.chunk", "ph": "X", "ts": 3, "dur": 9,
         "args": {"parent": "zz", "trace_id": "cd", "chunk": 1}}], "cd")
    paths = []
    for i, doc in enumerate((coord, wrk, bad)):
        paths.append(str(tmp_path / f"t{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(doc, f)
    for docs in ((coord, wrk), (coord, wrk, bad)):
        names = paths[:len(docs)]
        got = reader.merge_traces(list(docs), names)
        want = jax_reader.merge_traces(list(docs), names)
        assert got["traceEvents"] == want["traceEvents"]
        assert got["racon_tpu"] == want["racon_tpu"]
        assert reader.fleet_breakdown(got) == \
            jax_reader.fleet_breakdown(want)
    out = str(tmp_path / "m.json")
    assert reader.main(["merge", *paths[:2], "--out", out]) == 0
    assert reader.main(["fleet", out]) == 0
    assert reader.main(["merge", *paths, "--out", out]) == 0
    assert reader.main(["fleet", out]) == 1          # dangling parent
    assert reader.main(["fleet", str(tmp_path / "none.json")]) == 2
    assert reader.main(["merge", "--out", out]) == 2


# -- the daemon, in a thread, with a plane of one thread worker ---------------

@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    torch.set_num_threads(1)
    d = simulate.generate(str(tmp_path_factory.mktemp("fleet")), mbp=0.003,
                          contigs=3)
    paths = (d["reads"], d["overlaps"], d["draft"])
    p = create_polisher(*paths, device="cpu", **KW)
    p.initialize()
    return paths, "".join(f">{n}\n{s}\n" for n, s in p.polish(True))


def _daemon_job(tmp_path, sim, **fleet):
    paths, _ = sim
    d = ServeDaemon(str(tmp_path / "state"), device="cpu", warm=False,
                    host_lane=False, **fleet)
    d.start()
    try:
        with ServeClient(d.port, timeout=WAIT) as c:
            jid = c.submit(*paths, args=dict(KW))
            resp = c.wait(jid, timeout=WAIT)
            stats = c.stats()
    finally:
        d.stop(wait=True)
    return d, resp, stats


def test_daemon_plane_with_a_thread_worker_gives_the_direct_bytes(sim,
                                                                  tmp_path):
    d, resp, stats = _daemon_job(tmp_path, sim, fleet_min=1, fleet_max=1,
                                 fleet_spawn=ThreadProc)
    assert d.plane is not None and d.session.warmed is False
    assert resp["state"] == "done" and resp["lane"] == "device"
    res = resp["result"]
    with open(res["output"]) as f:
        assert f.read() == sim[1]
    assert res["fleet"] == {"chunks": 2, "served": {"fleet": 2}}
    assert res["kernel_builds"] == 0 and res["journal_replayed"] == 0
    fleet = stats["fleet"]
    assert fleet["min_workers"] == 1 and fleet["max_workers"] == 1
    assert fleet["memory_share"] == 1.0
    assert fleet["counters"]["chunks_fleet"] == 2
    assert fleet["per_worker"]["0"]["chunks"] == 2
    with open(os.path.join(str(tmp_path / "state"), "fleet",
                           "report.json")) as f:
        rep = json.load(f)
    assert rep["phases"]["fleet"]["served"]["fleet"] == 2


def test_daemon_without_a_plane_runs_the_job_in_process(sim, tmp_path):
    d, resp, stats = _daemon_job(tmp_path, sim)
    assert d.plane is None and "fleet" not in stats
    res = resp["result"]
    assert resp["state"] == "done" and "fleet" not in res
    with open(res["output"]) as f:
        assert f.read() == sim[1]
    assert stats["session"]["jobs_run"] == 1
