"""FleetPlane: the autoscaling, multi-job chunk-level control plane.

A copy of the JAX package's plane (racon_tpu/fleet/plane.py) with its
knobs as arguments. Where the serve scheduler runs whole jobs in its own
process and the distrib coordinator farms chunks of *one* job to a
*fixed* fleet, the plane does both: every admitted job is split into
contig chunks (``polisher._split_fasta``, so the chunks concatenate to
the sequential polish's bytes), all chunks share one dispatch queue,
and an ``ElasticPool`` of ``racon_tpu_torch.distrib.worker`` processes
grows and shrinks from live signals. The plane speaks the distrib wire
protocol, so the same worker serves a coordinator or a plane.

* **Affinity and work-stealing.** A worker prefers chunks of the job it
  last served. When its job has no eligible chunk but others do, it
  steals — tenant-fair rotation, highest job priority first — behind
  the ``pool.steal`` fault point, counted and traced (``fleet.steal``).
  ``steal=False`` pins workers to their job.
* **Autoscaling.** The monitor grows the pool by one worker a tick when
  a backlog is pending and the recent chunk queueing p95 exceeds
  ``scale_p95_ms`` (or the backlog is four times the active workers, or
  no worker is active, or the SLO engine's burn-rate alert fires below
  the ceiling: obs/slo.py), and drains one worker after four idle ticks
  above the floor. Both transitions carry fault points; scale-down is
  drain-based, so a resize never cuts a lease. A worker that exits (a
  sticky CUDA error: distrib/worker.py) is replaced up to the floor.
* **Leases, speculation, reclaim.** The distrib discipline: TTL leases
  renewed by heartbeats, EOF as the fast death signal, speculative
  duplicates of stragglers, backoff on re-dispatch, and a
  ``lease.reclaim``-guarded reclaim that releases a dead holder's
  canonical journals so the re-run resumes.
* **Local floor.** For a job whose workers run off the card (the host
  backend, or ``device="cpu"``), a chunk that exhausts its retry budget,
  or every chunk when the fleet collapses and cannot respawn, runs in
  the plane through ``python -m racon_tpu_torch.cli --host``, recorded
  as a ``fleet → local`` degradation. A job on the card fails there
  instead, with the chunk's last error: the floor's host bytes are never
  served in the card's place.

On the card the plane builds the CUDA sources before its first worker
starts, creates no CUDA context of its own, and gives each worker 1 /
``max_workers`` of the card's memory. Tracing: dispatches emit
``distrib.dispatch`` events with fresh child span ids, and the workers'
shipped chunks are absorbed into the plane's trace.
"""

from __future__ import annotations

import os
import socket
import statistics
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import obs
from ..distrib.common import (DEFAULT_FAULT_WORKER, DEFAULT_LEASE_TTL,
                              DEFAULT_MAX_RETRIES, DEFAULT_RETRY_BASE,
                              DEFAULT_SPECULATE, heartbeat_interval,
                              local_command, on_card, worker_args,
                              worker_env)
from ..distrib.coordinator import _fold_worker_stats, _p95
from ..obs import context, flight, slo
from ..ops import cuda_lib
from ..ops.poa_driver import DEFAULT_POA_KERNEL
from ..polisher import _split_fasta
from ..resilience import faults
from ..resilience.report import PhaseReport, RunReport
from ..serve.protocol import read_message, write_message
from . import (DEFAULT_MAX_WORKERS, DEFAULT_MIN_WORKERS,
               DEFAULT_SCALE_P95_MS, DEFAULT_STEAL)
from .leases import (Chunk, Lease, fire_reclaim_fault,
                     release_worker_leases)
from .pool import ElasticPool

#: Lattice tiers of the plane's phase: the fleet, then the plane's own
#: local floor.
TIERS = ("fleet", "local")

JOB_TERMINAL = ("done", "failed", "cancelled")


class FleetJob:
    """One admitted job: its inputs, its chunks, and its lifecycle
    (running -> done | failed | cancelled)."""

    def __init__(self, job_id: str, tenant: str, priority: int,
                 sequences: str, overlaps: str, target: str, args: dict,
                 include_unpolished: bool, backend: str, workdir: str,
                 on_done: Optional[Callable] = None):
        self.id = job_id
        self.tenant = tenant
        self.priority = priority
        self.sequences = sequences
        self.overlaps = overlaps
        self.target = target
        self.args = args
        self.include_unpolished = include_unpolished
        self.backend = backend
        self.workdir = workdir
        self.on_done = on_done     # (state, result, error) once terminal
        self.state = "running"
        self.error: Optional[str] = None
        self.result: Optional[dict] = None
        self.chunks: List[Chunk] = []
        self.done = threading.Event()
        self.t_submit = time.monotonic()
        self.t_end: Optional[float] = None
        # the ledger's stage_s fragment (obs/ledger.py): per-stage
        # seconds summed over this job's chunks — plane queue waits and
        # the workers' compute stages. Chunks run in parallel, so these
        # are resource-seconds, not wall slices.
        self.stage_s: Dict[str, float] = {}

    def add_stage(self, stage: str, seconds) -> None:
        # call with the plane's _cv held
        try:
            s = float(seconds)
        except (TypeError, ValueError):
            return
        if s >= 0:
            self.stage_s[stage] = self.stage_s.get(stage, 0.0) + s

    def unfinished(self) -> int:
        return sum(1 for c in self.chunks if c.state != "done")


class FleetPlane:
    """Many jobs over one elastic pool of `min_workers` … `max_workers`
    worker processes. ``backend``, ``device`` and ``poa_kernel`` are the
    workers'; ``scale_p95_ms`` and ``steal`` the JAX package's
    ``RACON_TPU_FLEET_*`` knobs, the rest its ``RACON_TPU_DISTRIB_*``
    ones (distrib/common.py); ``spawn`` starts a worker
    (fleet/pool.py)."""

    def __init__(self, workdir: str,
                 min_workers: int = DEFAULT_MIN_WORKERS,
                 max_workers: int = DEFAULT_MAX_WORKERS,
                 lease_ttl: float = DEFAULT_LEASE_TTL,
                 heartbeat: Optional[float] = None,
                 retry_base: float = DEFAULT_RETRY_BASE,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 speculate: float = DEFAULT_SPECULATE,
                 scale_p95_ms: float = DEFAULT_SCALE_P95_MS,
                 steal: bool = DEFAULT_STEAL,
                 fault_worker: int = DEFAULT_FAULT_WORKER,
                 backend: str = "cuda", device: str = "cuda",
                 poa_kernel: str = DEFAULT_POA_KERNEL,
                 trace_path: Optional[str] = None,
                 report_path: Optional[str] = None,
                 spawn: Callable = subprocess.Popen):
        self.workdir = workdir
        self.min_workers = min_workers
        self.max_workers = max(min_workers, max_workers, 1)
        self.lease_ttl = lease_ttl
        self.heartbeat = heartbeat_interval(lease_ttl, heartbeat)
        self.retry_base = retry_base
        self.max_retries = max_retries
        self.speculate = speculate
        self.scale_p95_ms = scale_p95_ms
        self.steal = steal
        self.fault_worker = fault_worker
        self.backend = backend
        self.device = str(device)
        self.trace_path = trace_path
        self.report_path = report_path
        # each worker's share of the card: 1 / the pool's ceiling
        self.memory_share = 1.0 / self.max_workers

        self.jobs: Dict[str, FleetJob] = {}
        self.chunks: List[Chunk] = []          # the global chunk table
        self.counters: Dict[str, int] = {}
        self.completed_walls: List[float] = []
        self.queue_waits: List[float] = []     # eligible->dispatch, s
        self.worker_stats: Dict[int, dict] = {}
        self.worker_start: Dict[int, dict] = {}
        self.build_s = 0.0
        self._staleness_max = 0.0
        self._affinity: Dict[int, str] = {}    # worker -> last job id
        self._tenant_rr: List[str] = []        # steal-order rotation
        self._ctx: Optional[dict] = None
        self._last_tick = 0.0
        self._last_scale = 0.0
        self._idle_ticks = 0
        self._respawn_failures = 0
        self._degraded = False
        self._failing: List[FleetJob] = []     # card jobs the floor refused
        self.report = RunReport()
        self.phase = PhaseReport("fleet", TIERS)
        self.report.attach(self.phase)
        self._cv = threading.Condition()
        self._stopping = False
        self._dead_workers = set()
        self._sock: Optional[socket.socket] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self.port = 0
        self.pool = ElasticPool(
            logs_dir=os.path.join(workdir, "workers"),
            min_workers=self.min_workers, max_workers=self.max_workers,
            env_fn=lambda i: worker_env(i, self.fault_worker),
            on_spawn=lambda i, pid: obs.event("fleet.spawn", worker=i,
                                              pid=pid),
            on_spawn_failure=self._on_spawn_failure,
            worker_args=worker_args(self.device, backend, poa_kernel,
                                    self.memory_share),
            spawn=spawn)

    # -- counters -----------------------------------------------------------

    def _count(self, name: str, n: int = 1) -> None:
        # Condition wraps an RLock, so this is safe (and cheap) from
        # call sites that already hold self._cv.
        with self._cv:
            self.counters[name] = self.counters.get(name, 0) + n
        obs.count(f"fleet.{name}", n)

    def _on_spawn_failure(self, index: int, exc: BaseException) -> None:
        self.phase.record_failure("fleet", exc)  # concurrency: PhaseReport counters are guarded by the pool caller's _cv (monitor/start paths)
        obs.event("fleet.spawn_failed", worker=index,
                  error=f"{type(exc).__name__}: {exc}")

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Arm tracing and the flight directory, build the CUDA sources
        where the workers run on the card, bind the dispatch socket,
        fill the pool to its floor, start the monitor. The plane owns the
        process's tracer for its lifetime (with the plane on, device jobs
        run in workers, so nothing else arms it)."""
        obs.reset()
        obs.set_role("fleet")
        context.activate(context.fresh())
        obs.configure(trace_path=self.trace_path)
        self._ctx = context.current() if obs.enabled() else None
        os.makedirs(self.workdir, exist_ok=True)
        flight.set_dir(self.workdir)
        if on_card(self.backend, self.device):
            self.build_s = cuda_lib.build_all()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        t = threading.Thread(target=self._accept_loop,
                             name="fleet-accept", daemon=True)
        t.start()
        with self._cv:
            self.pool.port = self.port
            self.pool.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="fleet-monitor", daemon=True)
        self._monitor_thread.start()

    def stop(self, timeout: float = 10.0) -> None:
        """Graceful shutdown: stop dispatching (every fetch drains), wait
        the workers out, kill leftovers, write the report and trace."""
        with self._cv:
            if self._stopping:
                return
            self._stopping = True
            self._cv.notify_all()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout)
        self.pool.shutdown(timeout=max(1.0, timeout / 2))
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self.report.finalize()
        dumps = flight.scan(self.workdir)
        if dumps:
            self._count("flight_dumps", len(dumps))
        with self._cv:
            self.phase.extra.update(self.counters)
            self.phase.extra.update(self.pool.counters)
        if self.report_path:
            self.report.write(self.report_path)
        obs.release(write=True)
        context.clear()

    # -- submission ---------------------------------------------------------

    def submit_job(self, job_id: str, sequences: str, overlaps: str,
                   target: str, args: dict, include_unpolished: bool,
                   backend: str, workdir: str, tenant: str = "local",
                   priority: int = 0,
                   on_done: Optional[Callable] = None) -> FleetJob:
        """Admit one job: split it into chunks and make them eligible.
        Returns at once; ``on_done(state, result, error)`` fires (off the
        submitter's thread) when the job is terminal."""
        chunks_dir = os.path.join(workdir, "chunks")
        os.makedirs(chunks_dir, exist_ok=True)
        # the split is deterministic in (target, hint): a restarted
        # daemon re-splits identically and the chunk journals line up
        paths = _split_fasta(target, max(2, 2 * self.max_workers),
                             chunks_dir)
        if paths is None:
            paths = [target]
        job = FleetJob(job_id, tenant, priority, sequences, overlaps,
                       target, args, include_unpolished,
                       backend or self.backend, workdir, on_done)
        with self._cv:
            if self._stopping:
                raise RuntimeError("fleet plane is stopping")
            if job_id in self.jobs and \
                    self.jobs[job_id].state not in JOB_TERMINAL:
                raise RuntimeError(f"job {job_id!r} is already "
                                   f"{self.jobs[job_id].state}")
            base = len(self.chunks)
            for i, p in enumerate(paths):
                cd = os.path.join(chunks_dir, f"chunk{i:03d}")
                os.makedirs(cd, exist_ok=True)
                c = Chunk(base + i, p, cd)
                c.job = job           # backrefs for multi-job dispatch
                c.pos = i             # position inside the job's gather
                job.chunks.append(c)
                self.chunks.append(c)
            self.jobs[job_id] = job
            self.phase.total += len(job.chunks)
            if tenant not in self._tenant_rr:
                self._tenant_rr.append(tenant)
            self._count("jobs_admitted")
            self._cv.notify_all()
        return job

    def cancel_job(self, job_id: str) -> bool:
        """Cancel a job: pending chunks never dispatch again, running
        attempts are told to stop renewing on their next heartbeat and
        their late results are discarded. True if the job was live."""
        with self._cv:
            job = self.jobs.get(job_id)
            if job is None or job.state in JOB_TERMINAL:
                return False
            job.state = "cancelled"
            job.error = "cancelled"
            job.t_end = time.monotonic()
            self._count("jobs_cancelled")
            self._cv.notify_all()
        self._finish_job(job, "cancelled", error="cancelled mid-run")
        return True

    # -- connection handling ------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return   # socket closed during shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="fleet-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        worker = -1
        try:
            f = conn.makefile("rwb")
            while True:
                try:
                    req = read_message(f)
                    if req is None:
                        break
                    if "worker" in req:
                        worker = int(req["worker"])
                    resp = self._dispatch(req)
                except (ValueError, KeyError, TypeError) as e:
                    resp = {"ok": False, "error": f"{e}"}
                except Exception as e:  # noqa: BLE001 — one bad request
                    # must not take down the plane
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                write_message(f, resp)
        except (OSError, BrokenPipeError, ConnectionResetError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            # EOF on a worker's connection: a clean drain is a completed
            # scale-down; anything else is the fast death signal
            if worker >= 0:
                if self.pool.is_draining(worker):
                    self._count("workers_drained")
                else:
                    self._worker_dead(worker, "connection lost")

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "hello":
            self._hello(int(req["worker"]), req.get("start"))
            return {"ok": True, "lease_ttl": self.lease_ttl,
                    "heartbeat": self.heartbeat}
        if op == "fetch":
            return self._fetch(int(req["worker"]))
        if op == "heartbeat":
            return self._heartbeat(int(req["worker"]), int(req["chunk"]),
                                   int(req["attempt"]))
        if op == "result":
            return self._result(req)
        if op == "error":
            return self._chunk_error(req)
        if op == "stats":
            return self._stats()
        raise ValueError(f"unknown op {op!r}")

    def _hello(self, worker: int, start) -> None:
        """A worker's start-up, from its spawn to its ``hello`` (with the
        seconds it reports for its imports and its kernels' load)."""
        with self._cv:
            t = self.pool.spawned_at.get(worker)
            self.worker_start[worker] = {
                **(start if isinstance(start, dict) else {}),
                "hello_s": (None if t is None else
                            round(time.monotonic() - t, 3))}

    # -- assignment ---------------------------------------------------------

    def _eligible(self, now: float) -> List[Chunk]:
        """Dispatchable chunks (call with the lock held)."""
        return [c for c in self.chunks
                if c.state == "pending" and not c.local
                and c.next_eligible <= now
                and c.job.state == "running"]

    def _fetch(self, worker: int) -> dict:
        with self._cv:
            if self._stopping or self.pool.is_draining(worker):
                # a worker fetches only between chunks, so a drain answer
                # here is graceful by construction: it holds no lease
                return {"ok": True, "drain": True}
            now = time.monotonic()
            eligible = self._eligible(now)
            aff = self.jobs.get(self._affinity.get(worker, ""))
            if aff is not None and aff.state == "running":
                own = [c for c in eligible if c.job is aff]
                if own:
                    chunk = min(own, key=lambda c: (worker in c.tried,
                                                    c.index))
                    return self._assign(chunk, worker, speculative=False)
                if eligible:
                    # the worker's job is live but starved: take a chunk
                    # of another job (tenant-fair, priority first)
                    if not self.steal:
                        return {"ok": True, "wait": True, "poll_s": 0.2}
                    try:
                        faults.check("pool.steal")
                    except Exception:  # noqa: BLE001 — absorbed: a
                        # faulted steal skips this fetch; the chunk stays
                        # eligible for the next one
                        self._count("steal_faults")
                        return {"ok": True, "wait": True, "poll_s": 0.2}
                    chunk = self._pick_fair(eligible, worker)
                    self._count("steals")
                    obs.event("fleet.steal", chunk=chunk.index,
                              worker=worker, job=chunk.job.id,
                              victim_tenant=chunk.job.tenant,
                              from_job=aff.id)
                    return self._assign(chunk, worker, speculative=False)
            elif eligible:
                chunk = self._pick_fair(eligible, worker)
                return self._assign(chunk, worker, speculative=False)
            chunk = self._straggler(worker, now)
            if chunk is not None:
                self._count("speculative")
                return self._assign(chunk, worker, speculative=True)
            return {"ok": True, "wait": True, "poll_s": 0.2}

    def _pick_fair(self, eligible: List[Chunk], worker: int) -> Chunk:
        """Tenant-fair pick: the first tenant in the rotation with an
        eligible chunk is served and rotates to the back; within a
        tenant, the highest job priority first, then a chunk this worker
        has not tried, then global order (call with the lock held)."""
        by_tenant: Dict[str, List[Chunk]] = {}
        for c in eligible:
            by_tenant.setdefault(c.job.tenant, []).append(c)
        for t in by_tenant:
            if t not in self._tenant_rr:
                self._tenant_rr.append(t)
        for i, t in enumerate(self._tenant_rr):
            cs = by_tenant.get(t)
            if cs:
                self._tenant_rr.append(self._tenant_rr.pop(i))
                return min(cs, key=lambda c: (-c.job.priority,
                                              worker in c.tried, c.index))
        return min(eligible, key=lambda c: c.index)

    def _straggler(self, worker: int, now: float) -> Optional[Chunk]:
        """The longest-running chunk past the speculation threshold that
        `worker` could duplicate (call with the lock held)."""
        if self.speculate <= 0 or not self.completed_walls:
            return None
        median = statistics.median(self.completed_walls)
        best, best_elapsed = None, 0.0
        for c in self.chunks:
            if (c.state != "running" or c.local or worker in c.tried
                    or len(c.leases) >= 2 or not c.leases
                    or c.job.state != "running"):
                continue
            elapsed = now - min(ls.t_start for ls in c.leases.values())
            if elapsed > self.speculate * median and elapsed > best_elapsed:
                best, best_elapsed = c, elapsed
        return best

    def _assign(self, c: Chunk, worker: int, speculative: bool) -> dict:  # concurrency: caller holds this plane's _cv; a Chunk is owned by exactly one plane
        c.attempts += 1
        attempt = c.attempts
        c.state = "running"
        c.tried.add(worker)
        canonical = not c.journal_held
        if canonical:
            c.journal_held = True
            journal = c.journal
        else:
            journal = os.path.join(c.dir, f"journal.a{attempt}.jsonl")
        c.leases[attempt] = Lease(worker, attempt, self.lease_ttl,
                                  canonical)
        self._affinity[worker] = c.job.id
        wait = max(0.0, time.monotonic() - max(c.t_pending,
                                               c.next_eligible))
        self.queue_waits.append(wait)
        # the plane's queueing rides the job ledger's dispatch stage:
        # with a plane the scheduler's own dispatch is instant
        c.job.add_stage("dispatch", wait)
        self._count("dispatches")
        if attempt > 1 and not speculative:
            self._count("redispatches")
        # the coordinator's dispatch and span contract, with the job id
        ctx = context.child(self._ctx)
        obs.event("distrib.dispatch", chunk=c.index, worker=worker,
                  attempt=attempt, speculative=speculative,
                  canonical_journal=canonical, job=c.job.id,
                  tenant=c.job.tenant,
                  trace_id=(ctx or {}).get("trace_id"),
                  span_id=(ctx or {}).get("parent"))
        return {"ok": True, "chunk": {
            "index": c.index, "attempt": attempt,
            "sequences": c.job.sequences, "overlaps": c.job.overlaps,
            "target": c.target, "args": c.job.args,
            "include_unpolished": c.job.include_unpolished,
            "backend": c.job.backend, "journal": journal,
            "output": os.path.join(c.dir, f"out.a{attempt}.fasta"),
            "trace": ctx,
        }}

    # -- worker messages ----------------------------------------------------

    def _heartbeat(self, worker: int, index: int, attempt: int) -> dict:
        with self._cv:
            c = self.chunks[index]
            lease = c.leases.get(attempt)
            if (lease is None or c.state == "done"
                    or c.job.state != "running"):
                return {"ok": True, "cancel": True}
            now = time.monotonic()
            self._staleness_max = max(self._staleness_max,
                                      now - lease.last_beat)
            lease.last_beat = now
            lease.deadline = now + self.lease_ttl
            self._count("heartbeats")
            return {"ok": True, "cancel": False}

    def _result(self, req: dict) -> dict:
        index = int(req["chunk"])
        attempt = int(req["attempt"])
        worker = int(req["worker"])
        stats = req.get("stats") or {}
        finished: Optional[FleetJob] = None
        with self._cv:
            c = self.chunks[index]
            lease = c.leases.pop(attempt, None)
            if c.state == "done" or c.job.state != "running":
                self._count("duplicates")
                obs.event("fleet.duplicate", chunk=index, worker=worker,
                          attempt=attempt)
                return {"ok": True, "accepted": False}
            c.state = "done"
            c.served_by = "fleet"
            c.output = str(req["output"])
            c.stats = stats
            self.phase.record_served("fleet")
            if lease is not None:
                wall = time.monotonic() - lease.t_start
                self.completed_walls.append(wall)
                self.phase.add_wall("fleet", wall)
            replayed = int(stats.get("journal_replayed") or 0)
            if replayed:
                self._count("journal_replayed", replayed)
            self._count("chunks_fleet")
            # the worker's stage durations join the job's ledger fragment
            frag = stats.get("stage_s")
            if isinstance(frag, dict):
                for stage, s in frag.items():
                    if isinstance(stage, str):
                        c.job.add_stage(stage, s)
            _fold_worker_stats(self.worker_stats, worker, stats)
            obs.event("fleet.chunk_done", chunk=index, job=c.job.id,
                      worker=worker, attempt=attempt, replayed=replayed)
            absorbed = obs.absorb(req.get("obs"))
            if absorbed:
                self._count("obs_events_absorbed", absorbed)
            if c.job.unfinished() == 0:
                finished = c.job
            self._cv.notify_all()
        if finished is not None:
            self._finish_job(finished, "done")
        return {"ok": True, "accepted": True}

    def _chunk_error(self, req: dict) -> dict:
        index = int(req["chunk"])
        attempt = int(req["attempt"])
        err = str(req.get("error", "worker error"))
        with self._cv:
            c = self.chunks[index]
            lease = c.leases.pop(attempt, None)
            if lease is not None and lease.canonical:
                # the worker survived to report, so its journal writer is
                # closed: the canonical journal is safe to hand on
                c.journal_held = False
            if c.state != "done" and c.job.state == "running":
                self._fail_chunk(c, RuntimeError(err))
                c.error = err   # the worker's own "Type: message"
            obs.event("fleet.chunk_error", chunk=index,
                      worker=int(req["worker"]), attempt=attempt,
                      error=err)
            return {"ok": True}

    def _stats(self) -> dict:
        with self._cv:
            now = time.monotonic()
            states = {"pending": 0, "running": 0, "done": 0}
            for c in self.chunks:
                states[c.state] = states.get(c.state, 0) + 1
            leases = sum(len(c.leases) for c in self.chunks)
            staleness = max((now - ls.last_beat for c in self.chunks
                             for ls in c.leases.values()), default=0.0)
            self._staleness_max = max(self._staleness_max, staleness)
            return {"ok": True,
                    "chunks": states,
                    "leases": leases,
                    "workers": {"live": self.pool.live(),
                                "dead": len(self._dead_workers)},
                    "served": dict(self.phase.served),
                    "staleness_s": round(staleness, 3),
                    "counters": dict(self.counters),
                    "telemetry": obs.telemetry(last=8)}

    # -- failure paths (call with the lock held) ----------------------------

    def _fail_chunk(self, c: Chunk, exc: BaseException) -> None:  # concurrency: caller holds this plane's _cv; a Chunk is owned by exactly one plane
        c.failures += 1
        c.error = f"{type(exc).__name__}: {exc}"
        self.phase.record_failure("fleet", exc)
        self.phase.retries += 1
        if not c.leases and c.state != "done":
            c.state = "pending"
            backoff = self.retry_base * (2 ** (c.failures - 1))
            c.next_eligible = time.monotonic() + backoff
            self._cv.notify_all()

    def _worker_dead(self, worker: int, why: str) -> None:
        with self._cv:
            if worker in self._dead_workers or self._stopping:
                return
            self._dead_workers.add(worker)
            self._count("workers_dead")
            obs.event("fleet.worker_dead", worker=worker, cause=why)
            # the reclaim is a named fault point: kill=1 crashes the
            # plane mid-reclaim, a raise is absorbed and counted
            if fire_reclaim_fault():
                self._count("reclaim_faults")
            for c in self.chunks:
                popped = release_worker_leases(c, worker)
                if popped:
                    self._count("lease_reclaimed", len(popped))
                    if c.state != "done" and c.job.state == "running":
                        self._fail_chunk(
                            c, RuntimeError(f"worker {worker} died "
                                            f"({why}) holding chunk "
                                            f"{c.index}"))

    def _expire_leases(self) -> None:
        now = time.monotonic()
        with self._cv:
            for c in self.chunks:
                expired = [a for a, ls in c.leases.items()
                           if ls.deadline < now]
                for a in expired:
                    lease = c.leases.pop(a)
                    # the canonical journal stays held: an unresponsive
                    # but live holder may still be writing
                    self._count("lease_expired")
                    obs.event("fleet.lease_expired", chunk=c.index,
                              worker=lease.worker, attempt=a)
                    if c.state != "done" and c.job.state == "running":
                        self._fail_chunk(
                            c, TimeoutError(
                                f"lease on chunk {c.index} expired "
                                f"(worker {lease.worker}, attempt {a})"))

    # -- autoscaling monitor ------------------------------------------------

    def _monitor(self) -> None:
        while True:
            with self._cv:
                if self._stopping:
                    return
            for index, rc, was_draining in self._reap():
                if not was_draining:
                    self._worker_dead(index, f"exited {rc}")
            self._expire_leases()
            now = time.monotonic()
            if now - self._last_scale >= 0.25:
                self._last_scale = now
                self._autoscale(now)
            if now - self._last_tick >= 1.0:
                self._last_tick = now
                self._telemetry_tick(now)
            with self._cv:
                for c in self.chunks:
                    if (c.failures > self.max_retries and not c.leases
                            and c.state == "pending" and not c.local
                            and c.job.state == "running"):
                        self._to_local(c, f"chunk {c.index} exhausted its "
                                       f"retry budget ({c.failures} "
                                       f"failures > {self.max_retries})")
                local_work = [c for c in self.chunks
                              if c.local and c.state == "pending"
                              and c.job.state == "running"]
                failing, self._failing = self._failing, []
            for job in failing:
                self._finish_job(job, "failed", error=job.error)
            for c in local_work:
                self._run_local(c)
            with self._cv:
                self._cv.wait(0.05)

    def _reap(self):
        with self._cv:
            return self.pool.reap()

    def _autoscale(self, now: float) -> None:
        """One scaling decision a call: grow when a backlog queues past
        the p95 trigger (or capacity is gone), drain when idle above the
        floor; at most one worker a direction a tick."""
        with self._cv:
            backlog = len(self._eligible(now))
            active = self.pool.active()
            live = self.pool.live()
            leases = sum(len(c.leases) for c in self.chunks)
            p95 = _p95(self.queue_waits[-50:])
            p95_ms = 0.0 if p95 is None else 1000.0 * p95
            if backlog > 0:
                self._idle_ticks = 0
                # an SLO burn-rate alert grows the pool before the
                # queueing p95 trips (obs/slo.py)
                slo_burn = slo.engine().alerting("")
                if slo_burn:
                    self._count("slo_alert_ticks")
                if active == 0 or p95_ms > self.scale_p95_ms \
                        or backlog >= 4 * active \
                        or (slo_burn and live < self.pool.max_workers):
                    cause = (f"backlog {backlog}, active {active}, "
                             f"queueing p95 {p95_ms:.0f}ms")
                    if slo_burn:
                        cause = f"slo_burn: {cause}"
                    spawned = self.pool.scale_up(1, cause=cause)
                    if slo_burn and spawned:
                        self._count("scale_up_slo")
                    if active == 0 and spawned == 0 and live == 0:
                        self._respawn_failures += 1
                        if self._respawn_failures >= 3:
                            # fleet collapse and the pool cannot come
                            # back: every eligible chunk falls to the
                            # local floor
                            for c in self._eligible(now):
                                self._to_local(c, "fleet collapse: no "
                                               "live workers and respawn "
                                               "failing")
                    else:
                        self._respawn_failures = 0
            elif leases == 0 and active > self.pool.min_workers:
                self._idle_ticks += 1
                if self._idle_ticks >= 4:
                    self._idle_ticks = 0
                    self.pool.scale_down(1, cause="idle above floor")
            else:
                self._idle_ticks = 0
                if active < self.pool.min_workers and \
                        live < self.pool.max_workers:
                    # a worker exited (a sticky CUDA error, a crash):
                    # back up to the floor
                    self.pool.scale_up(1, cause="below floor")

    def _telemetry_tick(self, now: float) -> None:
        with self._cv:
            staleness = max(
                (now - ls.last_beat for c in self.chunks
                 for ls in c.leases.values()), default=0.0)
            self._staleness_max = max(self._staleness_max, staleness)
            obs.telemetry_tick(
                queue_depth=sum(1 for c in self.chunks
                                if c.state == "pending"
                                and c.job.state == "running"),
                leases=sum(len(c.leases) for c in self.chunks),
                workers_live=self.pool.live(),
                workers_active=self.pool.active(),
                jobs_running=sum(1 for j in self.jobs.values()
                                 if j.state == "running"),
                staleness_s=round(staleness, 3))

    def _degrade(self, cause: str) -> None:
        """Record the fleet → local step (once a plane's life)."""
        if not self._degraded:
            self._degraded = True
            self.phase.record_degrade("fleet", "local",
                                      RuntimeError(cause))

    # -- the local floor ----------------------------------------------------

    def _to_local(self, c: Chunk, cause: str) -> None:  # concurrency: caller holds this plane's _cv
        """Send a chunk the fleet cannot finish to the local floor. A job
        on the card fails instead, with the chunk's last error (the
        monitor finishes it outside the lock): the floor's host bytes
        are not the card's."""
        job = c.job
        if not on_card(job.backend, self.device):
            c.local = True
            self._degrade(cause)
            return
        if job.state == "running":
            job.state = "failed"
            job.error = (f"{cause}; chunk {c.index}'s last error: "
                         f"{c.error or 'none reported'}")
            job.t_end = time.monotonic()
            self._failing.append(job)
            self._cv.notify_all()

    def _run_local(self, c: Chunk) -> None:  # concurrency: chunk-state writes happen under this plane's _cv; a Chunk is owned by exactly one plane
        """Polish one chunk in the plane through ``cli --host``. A free
        canonical journal is resumed only where the job's backend is the
        host's (the journal's fingerprint names its backend); otherwise a
        fresh local journal."""
        from ..serve.scheduler import child_env

        job = c.job
        with self._cv:
            if c.state == "done" or job.state != "running":
                return
            c.state = "running"
            resume = (not c.journal_held) and job.backend == "host"
        journal = c.journal if resume else os.path.join(
            c.dir, "journal.local.jsonl")
        out_path = os.path.join(c.dir, "out.local.fasta")
        part = out_path + ".part"
        cmd = local_command(job.args, job.include_unpolished,
                            job.sequences, job.overlaps, c.target, journal)
        t0 = time.monotonic()
        with open(part, "w") as out_f, \
                open(os.path.join(c.dir, "local.stderr.log"), "w") as err_f:
            rc = subprocess.call(cmd, stdout=out_f, stderr=err_f,
                                 env=child_env())
        finished: Optional[FleetJob] = None
        failed = False
        with self._cv:
            if c.state == "done" or job.state != "running":
                self._count("duplicates")   # a late fleet result won
                return
            if rc != 0:
                # the local rung is the floor: its failure fails the job,
                # not the plane
                self.phase.record_failure(
                    "local", RuntimeError(f"local chunk {c.index} "
                                          f"exited {rc}"))
                failed = True
            else:
                os.replace(part, out_path)
                c.state = "done"
                c.served_by = "local"
                c.output = out_path
                self.phase.record_served("local")
                self.phase.add_wall("local", time.monotonic() - t0)
                self._count("chunks_local")
                obs.event("fleet.chunk_local", chunk=c.index, job=job.id)
                if job.unfinished() == 0:
                    finished = job
                self._cv.notify_all()
        if failed:
            with self._cv:
                if job.state == "running":
                    job.state = "failed"
                    job.error = (f"chunk {c.index} failed on the local "
                                 f"rung (exit {rc}; see "
                                 f"{c.dir}/local.stderr.log)")
                    job.t_end = time.monotonic()
                    self._count("jobs_failed")
            self._finish_job(job, "failed", error=job.error)
        elif finished is not None:
            self._finish_job(finished, "done")

    # -- job completion -----------------------------------------------------

    def _finish_job(self, job: FleetJob, state: str,
                    error: Optional[str] = None) -> None:
        """Gather (on done), mark terminal, fire the callback. Runs
        outside the lock: the gather is file I/O and the callback
        re-enters the scheduler's own lock — holding ours across either
        would order fleet._cv before scheduler._cv."""
        result = None
        if state == "done":
            try:
                result = self._gather(job)
            except Exception as e:  # noqa: BLE001 — a torn gather fails
                # the job, not the plane
                state, error = "failed", f"gather: {type(e).__name__}: {e}"
        with self._cv:
            if job.state == "running" or job.state == "cancelled":
                job.state = state if job.state != "cancelled" \
                    else "cancelled"
            job.result = result
            if error and not job.error:
                job.error = error
            if job.t_end is None:
                job.t_end = time.monotonic()
            if state == "done":
                self._count("jobs_done")
            elif state == "failed":
                self._count("jobs_failed")
            obs.event("fleet.job_done", job=job.id, state=job.state,
                      chunks=len(job.chunks))
            job.done.set()
            self._cv.notify_all()
        if job.on_done is not None:
            job.on_done(job.state, result, job.error)

    def _gather(self, job: FleetJob) -> dict:
        """Ordered gather: chunk outputs concatenate in position order,
        so the polished FASTA is the single-process polish's bytes. The
        result has a serve job's keys; ``kernel_builds`` and ``launches``
        sum the chunks'."""
        out_path = os.path.join(job.workdir, "polished.fasta")
        part = out_path + ".part"
        with open(part, "wb") as out:
            for c in sorted(job.chunks, key=lambda c: c.pos):
                assert c.state == "done" and c.output, c.index
                with open(c.output, "rb") as f:
                    out.write(f.read())
        os.replace(part, out_path)
        records = polished_bp = 0
        with open(out_path) as f:
            for line in f:
                if line.startswith(">"):
                    records += 1
                else:
                    polished_bp += len(line.strip())
        served: Dict[str, int] = {}
        launches: Dict[str, int] = {}
        for c in job.chunks:
            served[c.served_by or "?"] = served.get(c.served_by or "?",
                                                    0) + 1
            for k, v in (c.stats.get("launches") or {}).items():
                launches[k] = launches.get(k, 0) + int(v)
        return {
            "job_id": job.id,
            "backend": job.backend,
            "cold": False,
            "wall_s": round(time.monotonic() - job.t_submit, 4),
            "records": records,
            "polished_bp": polished_bp,
            "kernel_builds": sum(int(c.stats.get("kernel_builds") or 0)
                                 for c in job.chunks),
            "journal_replayed": sum(int(c.stats.get("journal_replayed")
                                        or 0) for c in job.chunks),
            "launches": launches,
            "output": out_path,
            "report": None,
            "trace": None,
            "summary": None,
            "fleet": {"chunks": len(job.chunks), "served": served},
            "ledger": {"stage_s": {k: round(v, 6) for k, v in
                                   sorted(job.stage_s.items())}},
        }

    # -- telemetry ----------------------------------------------------------

    def fleet_telemetry(self) -> dict:
        """The fleet telemetry summary stamped into serve stats."""
        with self._cv:
            return {
                "workers": {str(w): dict(s)
                            for w, s in sorted(self.worker_stats.items())},
                "queueing_p95_s": _p95(self.queue_waits),
                "staleness_max_s": round(self._staleness_max, 3),
            }

    def snapshot(self) -> dict:
        """Live control-plane snapshot for the serve ``stats`` op and the
        load test's poller: pool size and limits, counters, timeline,
        per-worker telemetry."""
        with self._cv:
            jobs: Dict[str, int] = {}
            for j in self.jobs.values():
                jobs[j.state] = jobs.get(j.state, 0) + 1
            counters = dict(self.counters)
            counters.update(self.pool.counters)
            return {
                "workers": {"live": self.pool.live(),
                            "active": self.pool.active(),
                            "dead": len(self._dead_workers)},
                "min_workers": self.pool.min_workers,
                "max_workers": self.pool.max_workers,
                "memory_share": self.memory_share,
                # whether this process made a CUDA context of its own
                # (it should not: each worker has its own)
                "cuda_context": torch.cuda.is_initialized(),
                "jobs": jobs,
                "chunks_pending": sum(1 for c in self.chunks
                                      if c.state == "pending"),
                "counters": counters,
                "queueing_p95_s": _p95(self.queue_waits),
                "staleness_max_s": round(self._staleness_max, 3),
                "timeline": [list(s) for s in
                             self.pool.size_timeline[-64:]],
                "per_worker": {str(w): dict(s) for w, s in
                               sorted(self.worker_stats.items())},
                "worker_start": {str(w): dict(s) for w, s in
                                 sorted(self.worker_start.items())},
            }
