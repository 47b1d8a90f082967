"""The port's distrib fleet (racon_tpu_torch/distrib, fleet/leases.py,
fleet/pool.py) against the JAX package's (racon_tpu/distrib), on the CPU.

The coordinator spawns nothing until ``run()``, so scripted scenarios
drive the port's and the JAX package's Coordinator through the same
calls (``_fetch``, ``_heartbeat``, ``_result``, ``_expire_leases``,
``_worker_dead``, ``_fail_chunk``) and must leave the same chunk states,
attempts, lease holders, journal ownership and counters, with the JAX
knobs set to the values the port takes as arguments. Then: the eight
distributed fault points, the settings' defaults, the memory share's
arithmetic, a worker's exit after a sticky CUDA error (seen by torch or
by a port launch function), a card run whose chunk cannot finish (it
fails; no host child serves it), the CLI without a card, and three
end-to-end runs — one worker in a thread (the pool's
``spawn`` seam) against the sequential polish and racon_tpu's
TpuPolisher; two worker processes, one SIGKILLed at its first result,
then ``obs merge`` and ``obs fleet`` on the traces; and a fleet whose
every spawn fails, polished by the local rung's ``cli --host`` children.
Those two are the file's only tests that start processes.
"""

import json
import os
import random
import signal
import threading
import time

import pytest
import torch

import racon_tpu
from racon_tpu import config as jax_config
from racon_tpu.distrib import Coordinator as JaxCoordinator
from racon_tpu.distrib import common as jax_common
from racon_tpu.obs import context as jax_context
from racon_tpu.obs.tracer import Tracer as JaxTracer
from racon_tpu.resilience import faults as jax_faults
from racon_tpu_torch import cli, create_polisher
from racon_tpu_torch.distrib import Coordinator, common, worker
from racon_tpu_torch.distrib import __main__ as distrib_main
from racon_tpu_torch.obs import __main__ as reader
from racon_tpu_torch.obs import context, tracer
from racon_tpu_torch.ops import cuda_lib, poa_driver
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.tools import simulate

ARGS = dict(window_length=100, quality_threshold=10.0, error_threshold=0.3,
            match=5, mismatch=-4, gap=-8, num_threads=1)
KW = dict(window_length=100, match=5, mismatch=-4, gap=-8)
WAIT = 120   # seconds: every run's and wait's deadline
NEW_POINTS = ("worker.spawn", "worker.heartbeat", "worker.result",
              "pool.scale_up", "pool.scale_down", "pool.steal",
              "lease.reclaim", "mem.oom")
# the port's settings and the JAX knobs that hold them in the scenarios
SETTINGS = dict(retry_base=0.25, max_retries=3, speculate=2.5)
JAX_KNOBS = {"RACON_TPU_DISTRIB_RETRY_BASE": "0.25",
             "RACON_TPU_DISTRIB_MAX_RETRIES": "3",
             "RACON_TPU_DISTRIB_SPECULATE": "2.5"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No fault armed in either package; one torch thread."""
    torch.set_num_threads(1)
    for k in (faults.ENV, "RACON_TPU_FAULT"):
        monkeypatch.delenv(k, raising=False)
    faults.configure(None)
    jax_faults.reset()
    yield
    faults.configure(None)
    jax_faults.reset()


def _identical_reads(root, n_targets=3, n_reads=4):
    """Three 200 bp targets, each covered by identical reads (SAM)."""
    rng = random.Random(11)
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


def _fasta(records):
    return "".join(f">{n}\n{s}\n" for n, s in records)


# -- the coordinator's lease core against the JAX package's -----------------

def _resp(r):
    """A fetch answer without its paths' directories."""
    if "chunk" in r:
        ch = r["chunk"]
        return ("chunk", ch["index"], ch["attempt"],
                os.path.basename(ch["journal"]),
                os.path.basename(ch["output"]))
    return tuple(sorted(k for k, v in r.items() if k != "ok" and v is True))


def _snap(o):
    now = time.monotonic()
    return {"chunks": [(c.index, c.state, c.attempts, c.failures,
                        sorted(c.tried), c.journal_held, c.local,
                        sorted((a, ls.worker, ls.canonical)
                               for a, ls in c.leases.items()),
                        c.next_eligible > now, c.served_by,
                        os.path.basename(c.output or ""))
                       for c in o.chunks],
            "counters": dict(o.counters), "served": dict(o.phase.served),
            "retries": o.phase.retries}


def _deliver(o, resp, worker, replayed=0):
    ch = resp["chunk"]
    return o._result({"worker": worker, "chunk": ch["index"],
                      "attempt": ch["attempt"],
                      "output": os.path.basename(ch["output"]),
                      "stats": {"journal_replayed": replayed}})


def sc_expiry_backoff_journal(o, log):
    a = o._fetch(0)
    log.append(_resp(a))
    c = o.chunks[a["chunk"]["index"]]
    time.sleep(0.05)                     # outlive the 10 ms TTL
    o._expire_leases()
    log.append(_snap(o))
    first = c.next_eligible
    with o._cv:
        o._fail_chunk(c, RuntimeError("again"))
    log.append(c.next_eligible >= first)
    c.next_eligible = 0.0
    log.append(_resp(o._fetch(1)))       # a side journal
    o._worker_dead(1, "test")


def sc_dead_worker_releases_journal(o, log):
    a = o._fetch(0)
    log.append(_resp(a))
    o._worker_dead(0, "sigkill")
    log.append(_snap(o))
    o.chunks[a["chunk"]["index"]].next_eligible = 0.0
    log.append(_resp(o._fetch(1)))       # resumes the canonical journal


def sc_redispatch_prefers_untried(o, log):
    a = o._fetch(0)
    chunk = o.chunks[a["chunk"]["index"]]
    with o._cv:
        chunk.leases.clear()
        o._fail_chunk(chunk, RuntimeError("boom"))
        chunk.next_eligible = 0.0
    log.append(_resp(o._fetch(0)))


def sc_first_result_wins(o, log):
    a1 = o._fetch(0)
    c = o.chunks[a1["chunk"]["index"]]
    with o._cv:
        c.leases.clear()
        c.state = "pending"
    c.next_eligible = 0.0
    a2 = o._fetch(1)
    log.append(_resp(a2))
    log.append(_deliver(o, a2, 1, replayed=2))
    log.append(_deliver(o, a1, 0))


def sc_speculation_on_straggler(o, log):
    assigned = [o._fetch(0) for _ in range(3)]
    log.append([_resp(a) for a in assigned])
    log.append(_resp(o._fetch(1)))       # nothing completed yet: wait
    for a in assigned[:2]:
        _deliver(o, a, 0)
    lag = o.chunks[assigned[2]["chunk"]["index"]]
    for lease in lag.leases.values():
        lease.t_start -= 60.0            # far past factor x median
    log.append(_resp(o._fetch(1)))
    log.append(_resp(o._fetch(1)))       # no second duplicate for 1


def sc_heartbeat_renew_and_cancel(o, log):
    a = o._fetch(0)["chunk"]
    c = o.chunks[a["index"]]
    old = c.leases[a["attempt"]].deadline
    time.sleep(0.01)
    log.append(o._heartbeat(0, a["index"], a["attempt"]))
    log.append(c.leases[a["attempt"]].deadline > old)
    log.append(o._heartbeat(0, a["index"], a["attempt"] + 7))


def sc_lease_reclaim_fault(o, log):
    a = o._fetch(0)
    log.append(_resp(a))
    o._worker_dead(0, "unit test")       # the reclaim fault is armed


def sc_drain_when_done(o, log):
    for c in o.chunks:
        c.state = "done"
    log.append(_resp(o._fetch(0)))
    o._worker_dead(0, "exited 0")        # a clean drain, not a death


SCENARIOS = {
    "expiry_backoff_journal": (sc_expiry_backoff_journal, 0.01, None),
    "dead_worker_releases_journal": (sc_dead_worker_releases_journal, 10.0,
                                     None),
    "redispatch_prefers_untried": (sc_redispatch_prefers_untried, 10.0,
                                   None),
    "first_result_wins": (sc_first_result_wins, 10.0, None),
    "speculation_on_straggler": (sc_speculation_on_straggler, 10.0, None),
    "heartbeat_renew_and_cancel": (sc_heartbeat_renew_and_cancel, 5.0,
                                   None),
    "lease_reclaim_fault": (sc_lease_reclaim_fault, 10.0, "lease.reclaim"),
    "drain_when_done": (sc_drain_when_done, 10.0, None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_coordinator_scenario_equals_jax(name, tmp_path, monkeypatch):
    fn, ttl, fault = SCENARIOS[name]
    paths = _identical_reads(str(tmp_path / "data"))
    for k, v in JAX_KNOBS.items():
        monkeypatch.setenv(k, v)
    logs = {}
    for pkg in ("jax", "torch"):
        wd = str(tmp_path / pkg)
        if pkg == "jax":
            o = JaxCoordinator(*paths, wd, args=dict(ARGS), backend="cpu",
                               workers=2, lease_ttl=ttl)
        else:
            o = Coordinator(*paths, wd, args=dict(ARGS), backend="host",
                            workers=2, lease_ttl=ttl, **SETTINGS)
        os.makedirs(wd, exist_ok=True)
        o._layout()
        if fault:
            if pkg == "jax":
                monkeypatch.setenv("RACON_TPU_FAULT", fault)
                jax_faults.reset()
            else:
                faults.configure(fault)
        log = []
        fn(o, log)
        log.append(_snap(o))
        logs[pkg] = log
        monkeypatch.delenv("RACON_TPU_FAULT", raising=False)
        faults.configure(None)
    assert logs["torch"] == logs["jax"]
    if fault:
        assert logs["torch"][-1]["counters"]["reclaim_faults"] == 1


# -- settings, fault points, trace context -----------------------------------

@pytest.mark.parametrize("point", NEW_POINTS)
def test_fault_point_parses_as_in_jax(point):
    spec = f"{point}:kill=1:count=1,{point}:raise=RuntimeError:batch=2"
    got = faults.parse_spec(spec)
    want = jax_faults.parse_spec(spec)
    assert point in faults.KNOWN_POINTS and point in jax_faults.KNOWN_POINTS
    assert [(s.point, s.kill, s.count, s.batch, s.raise_name)
            for s in got] == [(s.point, s.kill, s.count, s.batch,
                               s.raise_name) for s in want]


def test_defaults_equal_jax_knob_defaults(monkeypatch):
    for name in ("WORKERS", "LEASE_TTL", "HEARTBEAT", "RETRY_BASE",
                 "MAX_RETRIES", "SPECULATE", "FAULT_WORKER"):
        monkeypatch.delenv(f"RACON_TPU_DISTRIB_{name}", raising=False)
    assert common.DEFAULT_WORKERS == jax_common.distrib_workers()
    assert common.DEFAULT_LEASE_TTL == jax_common.distrib_lease_ttl()
    assert common.DEFAULT_RETRY_BASE == jax_common.distrib_retry_base()
    assert common.DEFAULT_MAX_RETRIES == jax_common.distrib_max_retries()
    assert common.DEFAULT_SPECULATE == jax_common.distrib_speculate()
    assert common.DEFAULT_FAULT_WORKER == jax_common.distrib_fault_worker()
    assert common.HEARTBEAT_FLOOR == jax_common.HEARTBEAT_FLOOR
    assert jax_config.get_raw("RACON_TPU_DISTRIB_HEARTBEAT") in (None, "")
    p = distrib_main.build_arg_parser().parse_args(["r", "o", "t"])
    assert (p.workers, p.lease_ttl, p.retry_base, p.max_retries,
            p.speculate, p.fault_worker, p.heartbeat) == (
        2, 10.0, 0.25, 3, 2.5, 0, None)


@pytest.mark.parametrize("ttl,hb", [(9.0, None), (10.0, None),
                                    (0.01, None), (9.0, 0.5), (9.0, 0.001)])
def test_heartbeat_interval_equals_jax(ttl, hb, monkeypatch):
    if hb is None:
        monkeypatch.delenv("RACON_TPU_DISTRIB_HEARTBEAT", raising=False)
    else:
        monkeypatch.setenv("RACON_TPU_DISTRIB_HEARTBEAT", str(hb))
    assert common.heartbeat_interval(ttl, hb) == \
        pytest.approx(jax_common.distrib_heartbeat(ttl))


def test_rpc_raises_on_eof_and_not_ok():
    import io

    class _Pipe(io.BytesIO):
        def write(self, data):       # the request bytes are discarded
            return len(data)

        def flush(self):
            pass

    with pytest.raises(common.WireError, match="closed"):
        common.rpc(_Pipe(), {"op": "fetch"})
    with pytest.raises(common.WireError, match="nope"):
        common.rpc(_Pipe(b'{"ok": false, "error": "nope"}\n'),
                   {"op": "fetch"})


def test_fleet_stats_scrapes_a_listening_coordinator(tmp_path):
    paths = _identical_reads(str(tmp_path / "data"))
    coord = Coordinator(*paths, str(tmp_path / "coord"), args=dict(ARGS),
                        backend="host")
    os.makedirs(coord.workdir, exist_ok=True)
    coord._layout()
    coord._listen()
    try:
        st = common.fleet_stats(coord.port, timeout=WAIT)
    finally:
        coord._sock.close()
    assert st["ok"] and st["chunks"] == {"pending": 3, "running": 0,
                                         "done": 0}
    assert st["workers"] == {"live": 0, "dead": 0} and st["leases"] == 0


def test_heartbeat_fault_stops_renewal():
    faults.configure("worker.heartbeat:raise=RuntimeError")
    t0 = time.monotonic()
    # no wire: the injected raise fires before the socket is touched
    worker._heartbeat_loop(None, 0, 0, 1, 0.01, threading.Event())
    assert time.monotonic() - t0 < 5.0


def test_trace_context_minting_as_in_jax():
    root, jroot = context.fresh(), jax_context.fresh()
    assert set(root) == set(jroot) == {"trace_id", "parent"}
    assert root["parent"] is None and len(root["trace_id"]) == \
        len(jroot["trace_id"]) == 16
    kid, jkid = context.child(root), jax_context.child(jroot)
    assert kid["trace_id"] == root["trace_id"]
    assert len(kid["parent"]) == len(jkid["parent"]) == 8
    assert context.child(None) is None and jax_context.child(None) is None
    assert context.child({"trace_id": ""}) is None


def test_tracer_ingest_equals_jax():
    src = tracer.Tracer()
    src.role = "worker0"
    src.add_instant("mem.rss", rss_mb=1.0)
    src.add_complete("distrib.chunk", src.t0_ns + 1000, src.t0_ns + 9000,
                     chunk=0)
    src.add_track_complete("poa_consensus", src.t0_ns + 2000.0,
                           src.t0_ns + 2500.0, 1 << 20, "device: poa",
                           "device")
    ship = src.export(max_events=10)
    ship["pid"] = 4242
    got, want = tracer.Tracer(), JaxTracer()
    assert got.ingest(ship) == want.ingest(ship) == 3
    assert got.ingest({"events": "bad"}) == want.ingest({"events": "x"}) == 0

    def foreign(t):
        doc = t.to_dict()
        return [(e["name"], e["ph"], e.get("tid"), int(e.get("ts", 0)))
                for e in doc["traceEvents"] if e.get("pid") == 4242]

    assert foreign(got) == foreign(want)


# -- the memory share ---------------------------------------------------------

@pytest.mark.parametrize("share", [1.0, 0.5, 0.25])
def test_memory_share_sizes_batches_and_the_check(share):
    gib = 1 << 30
    total, held, free = 80 * gib, 3 * gib, 70 * gib
    sized = poa_driver.shared_free_bytes(free, total, held, share)
    assert sized == (free if share == 1.0 else
                     min(free, int(share * total) - held))
    assert poa_driver.shared_free_bytes(free, total, 60 * gib, 0.5) == 0
    cfg = poa_driver.make_config(512, 200, 5, -4, -8)
    per = poa_driver.window_bytes(cfg)
    cap = poa_driver.batch_cap(cfg, sized, 2)
    assert cap == max(1, poa_driver.memory_room(sized) // (2 * per))
    if share < 1.0:
        assert cap < poa_driver.batch_cap(cfg, free, 2)
    # a window that fits the card but not the share fails the check,
    # naming the largest -w the share takes
    big = poa_driver.make_config(16384, 200, 5, -4, -8)
    room = poa_driver.memory_room(sized)
    if poa_driver.window_bytes(big) > room:
        with pytest.raises(ValueError, match=r"-w \d+$"):
            poa_driver.check_memory([big], sized, "ls")
    else:
        poa_driver.check_memory([big], sized, "ls")


def test_polisher_checks_the_memory_share(tmp_path):
    paths = _identical_reads(str(tmp_path))
    with pytest.raises(ValueError, match="device_memory_share"):
        create_polisher(*paths, device="cpu", device_memory_share=0.0, **KW)
    p = create_polisher(*paths, device="cpu", device_memory_share=0.5, **KW)
    assert p.device_memory_share == 0.5


# -- workers in threads (the pool's spawn seam) -------------------------------

class ThreadProc:
    """A worker run by ``distrib.worker.main`` in a thread, with Popen's
    interface: what the pool's ``spawn`` returns."""

    def __init__(self, cmd, env=None, stdout=None, stderr=None):
        self.argv = cmd[cmd.index("--port"):]
        self.pid = os.getpid()
        self.returncode = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            self.returncode = worker.main(self.argv)
        except BaseException:  # noqa: BLE001 - recorded as an exit code
            self.returncode = 1

    def poll(self):
        return self.returncode

    def wait(self, timeout=WAIT):
        self._t.join(timeout)
        return self.returncode

    def terminate(self):
        pass

    kill = terminate


def _poisoned_launch():
    """The port's launch path after an illegal address: the launch
    function returns the sticky code, cuda_lib.check raises, and the
    polisher wraps it."""
    try:
        cuda_lib.check(700, "POA consensus kernel")
    except cuda_lib.DeviceError as e:
        raise RuntimeError("consensus batch failed") from e


@pytest.mark.parametrize("seen_by", ["torch", "launch"])
def test_sticky_cuda_error_exits_and_redispatches(seen_by, tmp_path,
                                                  monkeypatch):
    """A chunk that raises a sticky CUDA error, where torch sees it first
    (torch.AcceleratorError) or where one of the port's launch functions
    does (cuda_lib.DeviceError 700): its worker reports the error and
    exits with STICKY_EXIT; the coordinator counts it dead and the other
    worker polishes the chunk."""
    paths = _identical_reads(str(tmp_path / "data"))
    calls = []

    def stub(a, **kw):
        calls.append(a["index"])
        if len(calls) == 1:
            if seen_by == "launch":
                _poisoned_launch()
            raise torch.AcceleratorError("CUDA error: an illegal memory "
                                         "access was encountered")
        with open(a["output"], "w") as f:
            f.write(f">c{a['index']}\nACGT\n")
        return {"wall_s": 0.0, "journal_replayed": 0}

    monkeypatch.setattr(worker, "_polish_chunk", stub)
    coord = Coordinator(*paths, str(tmp_path / "coord"), args=dict(ARGS),
                        backend="host", device="cpu", workers=2,
                        retry_base=0.01, spawn=ThreadProc)
    res = coord.run(str(tmp_path / "out.fasta"), timeout=WAIT)
    with open(tmp_path / "out.fasta") as f:
        assert f.read() == "".join(f">c{i}\nACGT\n" for i in range(3))
    assert worker.is_sticky(torch.AcceleratorError("x"))
    assert not worker.is_sticky(RuntimeError("x"))
    for code in (700, 719):
        assert worker.is_sticky(cuda_lib.DeviceError("k", code))
    # invalid configuration, out of memory: the context lives on
    for code in (1, 2, 9):
        assert not worker.is_sticky(cuda_lib.DeviceError("k", code))
    codes = sorted(p.returncode for p in coord.pool._procs.values())
    assert codes == [0, worker.STICKY_EXIT]
    assert res["counters"]["workers_dead"] == 1
    failed = calls[0]
    assert calls.count(failed) == 2
    assert res["chunk_stats"][failed]["attempts"] == 2
    assert res["served"] == {"fleet": 3, "local": 0}


@pytest.mark.parametrize("how", ["retries", "collapse"])
def test_card_chunk_that_cannot_finish_fails_the_run(how, tmp_path,
                                                     monkeypatch):
    """On the card a chunk that exhausts its retries, or a fleet that
    collapses (every spawn fails), fails the run with the chunk's last
    error: no ``cli --host`` child polishes it with the host's bytes."""
    paths = _identical_reads(str(tmp_path / "data"))
    monkeypatch.setattr(cuda_lib, "build_all", lambda: 0.0)
    monkeypatch.setattr(worker, "load_kernels", lambda device, backend: None)

    def stub(a, **kw):
        raise RuntimeError("POA consensus kernel: boom")

    monkeypatch.setattr(worker, "_polish_chunk", stub)
    if how == "collapse":
        monkeypatch.setenv(faults.ENV, "worker.spawn:raise=RuntimeError")
    wd = tmp_path / "coord"
    coord = Coordinator(*paths, str(wd), args=dict(ARGS), backend="cuda",
                        device="cuda", workers=2, retry_base=0.01,
                        max_retries=1, spawn=ThreadProc)
    want = ("exhausted its retry budget .* last error: RuntimeError: POA "
            "consensus kernel: boom" if how == "retries" else
            "fleet collapse: no live workers")
    with pytest.raises(RuntimeError, match=want):
        coord.run(str(tmp_path / "out.fasta"), timeout=WAIT)
    assert not (tmp_path / "out.fasta").exists()
    assert coord.phase.served.get("local", 0) == 0
    assert not any(c.local for c in coord.chunks)
    assert list(wd.glob("chunks/*/local.stderr.log")) == []
    assert coord.phase.degradations == []


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    """A three-contig set, the port's sequential polish of it on the CPU,
    and racon_tpu's TpuPolisher (JAX CPU backend, Hirschberg aligner)."""
    torch.set_num_threads(1)
    d = simulate.generate(str(tmp_path_factory.mktemp("distrib")),
                          mbp=0.003, contigs=3)
    paths = (d["reads"], d["overlaps"], d["draft"])
    p = create_polisher(*paths, device="cpu", **KW)
    p.initialize()
    seq = _fasta(p.polish(True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
        mp.delenv("RACON_TPU_FAULT", raising=False)
        jp = racon_tpu.TpuPolisher(*paths, **KW)
        jp.initialize()
        jax_fasta = _fasta(jp.polish(True))
    return paths, seq, jax_fasta


def test_thread_worker_fleet_equals_sequential_and_jax(sim, tmp_path):
    paths, seq, jax_fasta = sim
    assert seq == jax_fasta
    out = str(tmp_path / "out.fasta")
    coord = Coordinator(*paths, str(tmp_path / "coord"), args=dict(KW),
                        backend="cuda", device="cpu", workers=1,
                        chunks_hint=3, spawn=ThreadProc)
    res = coord.run(out, timeout=WAIT)
    with open(out) as f:
        assert f.read() == seq
    assert res["served"] == {"fleet": 3, "local": 0}
    assert res["memory_share"] == 1.0 and res["build_s"] == 0.0
    assert res["cuda_context"] is False
    assert [r["kernel_builds"] for r in res["chunk_stats"]] == [0] * 3
    assert all(r["worker"] == 0 and r["memory_share"] == 1.0
               for r in res["chunk_stats"])
    assert sum(r["records"] for r in res["chunk_stats"]) == 3
    for c in coord.chunks:
        assert os.path.isfile(c.journal)
    with open(tmp_path / "coord" / "result.json") as f:
        assert json.load(f)["served"] == res["served"]


# -- the two tests that start processes ---------------------------------------

def test_killed_worker_process_redispatch_resumes(sim, tmp_path,
                                                  monkeypatch, capsys):
    """Two worker processes; RACON_TORCH_FAULT reaches worker 0 alone,
    which dies by SIGKILL at its first result. The chunk is re-dispatched
    and resumed from its journal, with the sequential bytes; ``obs
    merge`` and ``obs fleet`` read the coordinator's and the chunks'
    traces."""
    paths, seq, _ = sim
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv(faults.ENV, "worker.result:kill=1")
    wd = tmp_path / "coord"
    trace = str(tmp_path / "coord.trace.json")
    out = str(tmp_path / "out.fasta")
    coord = Coordinator(*paths, str(wd), args=dict(KW), backend="cuda",
                        device="cpu", workers=2, retry_base=0.01,
                        trace_path=trace,
                        report_path=str(tmp_path / "report.json"))
    res = coord.run(out, timeout=WAIT)
    with open(out) as f:
        assert f.read() == seq
    assert res["counters"]["workers_dead"] == 1
    assert res["journal_replayed"] > 0
    redone = [r for r in res["chunk_stats"] if r["attempts"] > 1]
    assert redone and all(r["worker"] == 1 and r["journal_replayed"] > 0
                          for r in redone)
    assert res["served"] == {"fleet": 3, "local": 0}
    chunk_traces = sorted(str(p) for p in wd.glob("chunks/*/trace.a*.json"))
    assert len(chunk_traces) >= 4       # the killed attempt's is kept
    merged = str(tmp_path / "merged.json")
    assert reader.main(["merge", trace, *chunk_traces, "--out",
                        merged]) == 0
    assert reader.main(["fleet", merged]) == 0
    assert "parenting holds" in capsys.readouterr().out
    assert reader.main(["fleet", "--json", merged]) == 0
    b = json.loads(capsys.readouterr().out)
    roles = {p["role"] for p in b["processes"].values()}
    assert {"coordinator", "worker0", "worker1"} <= roles
    assert len(b["trace_ids"]) == 1 and b["violations"] == []
    with open(tmp_path / "report.json") as f:
        rep = json.load(f)
    assert rep["phases"]["distrib"]["served"]["fleet"] == 3


def test_fleet_collapse_polishes_locally_on_the_host(sim, tmp_path,
                                                     monkeypatch):
    """Every spawn fails (worker.spawn:raise=RuntimeError): the fleet
    collapses and the coordinator polishes each chunk through a
    ``cli --host`` child, with the host backend's bytes; the report
    records fleet -> local."""
    paths, _, _ = sim
    host = create_polisher(*paths, backend="host", **KW)
    host.initialize()
    want = _fasta(host.polish(True))
    monkeypatch.setenv(faults.ENV, "worker.spawn:raise=RuntimeError")
    out, report = str(tmp_path / "out.fasta"), str(tmp_path / "rep.json")
    old = signal.getsignal(signal.SIGTERM)
    try:
        rc = distrib_main.main(
            ["--host", "--workers", "2", "--chunks", "2", "--state-dir",
             str(tmp_path / "state"), "-o", out, "--report", report,
             "-w", "100", "-m", "5", "-x", "-4", "-g", "-8", *paths])
    finally:
        signal.signal(signal.SIGTERM, old)
    assert rc == 0
    with open(out) as f:
        assert f.read() == want
    with open(report) as f:
        ph = json.load(f)["phases"]["distrib"]
    assert ph["served"] == {"fleet": 0, "local": 2}
    assert [(d["from"], d["to"]) for d in ph["degradations"]] == \
        [("fleet", "local")]
    assert ph["extra"]["spawn_failures"] == 2


# -- the CLI without a card ---------------------------------------------------

@pytest.mark.parametrize("entry", ["cli", "module"])
def test_distrib_without_cuda_fails_before_spawning(entry, tmp_path,
                                                    capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    paths = _identical_reads(str(tmp_path / "data"))
    state = tmp_path / "state"
    argv = ["--state-dir", str(state), *paths]
    rc = (cli.main(["distrib", *argv]) if entry == "cli"
          else distrib_main.main(argv))
    assert rc == 1
    assert "--device cpu or --host" in capsys.readouterr().err
    assert not state.exists()


# -- package rules ------------------------------------------------------------

FLEET_MODULES = ("distrib/__init__.py", "distrib/__main__.py",
                 "distrib/common.py", "distrib/coordinator.py",
                 "distrib/worker.py", "fleet/__init__.py",
                 "fleet/leases.py", "fleet/plane.py", "fleet/pool.py")


@pytest.mark.parametrize("rel", FLEET_MODULES)
def test_fleet_module_imports_no_jax_and_reads_no_jax_knob(rel):
    """The import scan of tests/test_torch_polish.py and the knob scan of
    tests/test_torch_faults.py walk every file of the port; this holds
    the new modules by name."""
    import ast
    import re

    import racon_tpu_torch

    path = os.path.join(os.path.dirname(racon_tpu_torch.__file__),
                        *rel.split("/"))
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            names = []
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "racon_tpu")
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            assert not re.search(r"RACON_TPU_\w+", node.value), rel
