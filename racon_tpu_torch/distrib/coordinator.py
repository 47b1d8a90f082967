"""The ``racon_tpu_torch distrib`` coordinator: a chunk fleet with leases.

A copy of the JAX package's coordinator (racon_tpu/distrib/coordinator.py)
with its knobs as arguments (distrib/common.py). The coordinator splits
the target FASTA into contiguous contig chunks (``polisher._split_fasta``,
the chunked polish's base-balanced split, so the chunks' output
concatenates to the sequential polish's bytes) and farms them out to a
fleet of worker processes over the serve wire format (newline JSON over
localhost TCP, serve/protocol.py). Workers are clients: they connect,
say ``hello``, then loop ``fetch`` → polish → ``result``; a thread per
in-flight chunk sends ``heartbeat`` renewals on a second connection.

* **Leases.** Every assignment carries a TTL lease; a heartbeat renews
  it; a lease that outlives its TTL expires and the chunk re-queues with
  exponential backoff (``retry_base * 2^n``). A worker's connection EOF
  (crash, SIGKILL) or its exit expires all of its leases at once.
* **Re-dispatch.** An expired or failed chunk prefers a worker that has
  not tried it. When the previous holder is *known dead* the re-run
  resumes the chunk's journal; a holder that is merely unresponsive
  keeps it and the re-run writes a side journal.
* **Speculation.** An idle worker with no pending work duplicates the
  longest-running chunk once it exceeds ``speculate`` x the median
  chunk wall; the first result wins, later ones are discarded and
  counted.
* **Fleet → local.** Where the workers run off the card (``--host`` or
  ``--device cpu``), a chunk that exhausts its retry budget, or every
  chunk when the fleet shrinks to zero, is polished by the coordinator
  through ``python -m racon_tpu_torch.cli --host``, recorded as a
  ``fleet → local`` degradation in the report. On the card the rung's
  host bytes would not be the card's, so the run fails there instead,
  with the chunk's last error (the JAX fleet's local rung serves its
  host oracle's bytes under ``--tpu`` too). Nothing else falls back.

On the card: the coordinator builds the CUDA sources once
(``cuda_lib.build_all``, under its file lock) before it spawns a worker,
so the workers only load them; it never creates a CUDA context of its
own; and each worker may hold 1 / ``workers`` of the card's memory
(``--memory-share``; ``poa_driver.sizing_bytes``). Workers start with
``subprocess.Popen`` (the pool's ``spawn``), never a fork.

Ordered gather: results install per chunk index and concatenate in
order, so the polished FASTA is the single-process polish's. ``run``
returns the run's accounting (served counts, counters, each chunk's
stats, per-worker telemetry, the pool's timeline) and writes it to
``<workdir>/result.json``.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import obs
from ..fleet.leases import (Chunk, Lease, fire_reclaim_fault,
                            release_worker_leases)
from ..fleet.pool import ElasticPool
from ..obs import context, flight
from ..ops import cuda_lib
from ..ops.poa_driver import DEFAULT_POA_KERNEL
from ..polisher import _split_fasta
from ..resilience import faults
from ..resilience.report import PhaseReport, RunReport
from ..serve.protocol import read_message, write_message
from ..serve.session import POLISH_ARG_DEFAULTS
from .common import (DEFAULT_FAULT_WORKER, DEFAULT_LEASE_TTL,
                     DEFAULT_MAX_RETRIES, DEFAULT_RETRY_BASE,
                     DEFAULT_SPECULATE, DEFAULT_WORKERS, heartbeat_interval,
                     local_command, on_card, process_age_s,
                     worker_args, worker_env)

#: Fleet tiers, lattice order (fleet is the device-analogue; local is
#: the coordinator-run floor).
TIERS = ("fleet", "local")


class Coordinator:
    """One polish over a fleet of `workers` worker processes.

    ``args`` are racon's parameters (``serve.session.POLISH_ARG_DEFAULTS``
    keys); ``backend`` ("cuda" or "host"), ``device`` ("cuda", or "cpu"
    for the kernels' plain versions) and ``poa_kernel`` the workers'.
    ``lease_ttl``, ``heartbeat``, ``retry_base``, ``max_retries``,
    ``speculate`` and ``fault_worker`` are the JAX package's
    ``RACON_TPU_DISTRIB_*`` knobs (distrib/common.py). ``spawn`` starts a
    worker (fleet/pool.py)."""

    def __init__(self, sequences: str, overlaps: str, target: str,
                 workdir: str, args: Optional[dict] = None,
                 include_unpolished: bool = False, backend: str = "cuda",
                 device: str = "cuda",
                 poa_kernel: str = DEFAULT_POA_KERNEL,
                 workers: int = DEFAULT_WORKERS,
                 chunks_hint: Optional[int] = None,
                 lease_ttl: float = DEFAULT_LEASE_TTL,
                 heartbeat: Optional[float] = None,
                 retry_base: float = DEFAULT_RETRY_BASE,
                 max_retries: int = DEFAULT_MAX_RETRIES,
                 speculate: float = DEFAULT_SPECULATE,
                 fault_worker: int = DEFAULT_FAULT_WORKER,
                 trace_path: Optional[str] = None,
                 report_path: Optional[str] = None,
                 spawn: Callable = subprocess.Popen):
        self.sequences = sequences
        self.overlaps = overlaps
        self.target = target
        self.workdir = workdir
        self.args = dict(POLISH_ARG_DEFAULTS)
        self.args.update(args or {})
        self.include_unpolished = include_unpolished
        self.backend = backend
        self.device = str(device)
        self.n_workers = workers
        self.chunks_hint = chunks_hint
        self.lease_ttl = lease_ttl
        self.heartbeat = heartbeat_interval(lease_ttl, heartbeat)
        self.retry_base = retry_base
        self.max_retries = max_retries
        self.speculate = speculate
        self.fault_worker = fault_worker
        self.trace_path = trace_path
        self.report_path = report_path
        # each worker's share of the card: 1 / the fleet's size
        self.memory_share = 1.0 / max(1, workers)

        self.chunks: List[Chunk] = []
        self.counters: Dict[str, int] = {}
        self.completed_walls: List[float] = []
        self.queue_waits: List[float] = []      # eligible→dispatch, s
        self.worker_stats: Dict[int, dict] = {} # per-worker aggregates
        self.worker_start: Dict[int, dict] = {} # per-worker start-up
        self._accepted: Dict[int, tuple] = {}   # chunk -> (worker, attempt)
        self._staleness_max = 0.0               # worst heartbeat gap, s
        self._ctx: Optional[dict] = None        # fleet trace context
        self._last_tick = 0.0
        self.build_s = 0.0
        self.report = RunReport()
        self.phase = PhaseReport("distrib", TIERS)
        self.report.attach(self.phase)
        self._cv = threading.Condition()
        self._stopping = False
        self._degraded = False
        self._dead_workers = set()
        self._sock: Optional[socket.socket] = None
        self.port = 0
        # fixed-size use of the shared elastic pool: min == max, filled
        # once by start(); spawn failures shrink it, nothing regrows it
        self.pool = ElasticPool(
            logs_dir=os.path.join(workdir, "workers"),
            min_workers=self.n_workers, max_workers=self.n_workers,
            env_fn=lambda i: worker_env(i, self.fault_worker),
            on_spawn=lambda i, pid: obs.event("distrib.spawn",
                                              worker=i, pid=pid),
            on_spawn_failure=self._on_spawn_failure,
            worker_args=worker_args(self.device, backend, poa_kernel,
                                    self.memory_share),
            spawn=spawn)

    # -- counters (mirrored into obs so the coordinator trace carries
    # -- distrib.* series; the dict is the source of truth) ----------------

    def _count(self, name: str, n: int = 1) -> None:
        # Condition wraps an RLock, so this is safe (and cheap) from
        # call sites that already hold self._cv.
        with self._cv:
            self.counters[name] = self.counters.get(name, 0) + n
        obs.count(f"distrib.{name}", n)

    # -- setup -------------------------------------------------------------

    def _layout(self) -> None:
        chunks_dir = os.path.join(self.workdir, "chunks")
        os.makedirs(chunks_dir, exist_ok=True)
        paths = _split_fasta(self.target, self.chunks_hint or
                             max(2, 2 * self.n_workers), chunks_dir)
        if paths is None:
            # one contig, or not FASTA: one chunk, the whole target
            paths = [self.target]
        for i, p in enumerate(paths):
            cd = os.path.join(chunks_dir, f"chunk{i:03d}")
            os.makedirs(cd, exist_ok=True)
            self.chunks.append(Chunk(i, p, cd))
        self.phase.total = len(self.chunks)

    def _listen(self) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", 0))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        t = threading.Thread(target=self._accept_loop,
                             name="distrib-accept", daemon=True)
        t.start()

    def _on_spawn_failure(self, index: int, exc: BaseException) -> None:
        # a spawn failure (injected or real) shrinks the fleet; it must
        # not kill the run, which can still finish on fewer workers or
        # degrade to local. The pool counts spawn_failures.
        self.phase.record_failure("fleet", exc)  # concurrency: invoked from pool.start() before any worker thread exists
        obs.event("distrib.spawn_failed", worker=index,
                  error=f"{type(exc).__name__}: {exc}")

    def _spawn_fleet(self) -> None:
        with self._cv:
            self.pool.port = self.port
            spawned = self.pool.start()
        if spawned:
            self._count("workers_spawned", spawned)

    # -- connection handling ------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return   # socket closed during shutdown
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="distrib-conn", daemon=True)
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
                    # must not take down the coordinator
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
            # EOF on any of a worker's connections is the fast death
            # signal: a SIGKILLed worker's leases expire now, not a TTL
            # from now
            if worker >= 0:
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

    def _fetch(self, worker: int) -> dict:
        with self._cv:
            if self._stopping or all(c.state == "done"
                                     for c in self.chunks):
                return {"ok": True, "drain": True}
            now = time.monotonic()
            eligible = [c for c in self.chunks
                        if c.state == "pending" and not c.local
                        and c.next_eligible <= now]
            if eligible:
                # prefer a chunk this worker has not attempted (the
                # "retry on a different worker" rule), then chunk order
                chunk = min(eligible,
                            key=lambda c: (worker in c.tried, c.index))
                return self._assign(chunk, worker, speculative=False)
            chunk = self._straggler(worker, now)
            if chunk is not None:
                return self._assign(chunk, worker, speculative=True)
            return {"ok": True, "wait": True, "poll_s": 0.2}

    def _straggler(self, worker: int, now: float) -> Optional[Chunk]:
        """The longest-running chunk past the speculation threshold that
        `worker` could duplicate (call with the lock held)."""
        if self.speculate <= 0 or not self.completed_walls:
            return None
        median = statistics.median(self.completed_walls)
        best, best_elapsed = None, 0.0
        for c in self.chunks:
            if (c.state != "running" or c.local or worker in c.tried
                    or len(c.leases) >= 2 or not c.leases):
                continue
            elapsed = now - min(ls.t_start for ls in c.leases.values())
            if elapsed > self.speculate * median and elapsed > best_elapsed:
                best, best_elapsed = c, elapsed
        return best

    def _assign(self, c: Chunk, worker: int, speculative: bool) -> dict:
        c.attempts += 1
        attempt = c.attempts
        c.state = "running"
        c.tried.add(worker)
        # journal ownership: the canonical journal resumes a re-dispatch,
        # but only one live writer may ever hold it — a merely
        # unresponsive holder keeps it and the new attempt gets a side
        # journal
        canonical = not c.journal_held
        if canonical:
            c.journal_held = True
            journal = c.journal
        else:
            journal = os.path.join(c.dir, f"journal.a{attempt}.jsonl")
        c.leases[attempt] = Lease(worker, attempt, self.lease_ttl,
                                  canonical)
        self.queue_waits.append(max(
            0.0, time.monotonic() - max(c.t_pending, c.next_eligible)))
        self._count("dispatches")
        if speculative:
            self._count("speculative")
        if attempt > 1 and not speculative:
            self._count("redispatches")
        # each dispatch gets a fresh span id; the worker stamps it as the
        # `parent` of its distrib.chunk span, so the merged timeline
        # parents worker spans under this event
        ctx = context.child(self._ctx)
        obs.event("distrib.dispatch", chunk=c.index, worker=worker,
                  attempt=attempt, speculative=speculative,
                  canonical_journal=canonical,
                  trace_id=(ctx or {}).get("trace_id"),
                  span_id=(ctx or {}).get("parent"))
        return {"ok": True, "chunk": {
            "index": c.index, "attempt": attempt,
            "sequences": self.sequences, "overlaps": self.overlaps,
            "target": c.target, "args": self.args,
            "include_unpolished": self.include_unpolished,
            "backend": self.backend, "journal": journal,
            "output": os.path.join(c.dir, f"out.a{attempt}.fasta"),
            "trace": ctx,
        }}

    # -- worker messages ----------------------------------------------------

    def _heartbeat(self, worker: int, index: int, attempt: int) -> dict:
        with self._cv:
            c = self.chunks[index]
            lease = c.leases.get(attempt)
            if lease is None or c.state == "done":
                # the attempt was superseded (its lease expired and the
                # chunk was re-dispatched, or another attempt won)
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
        with self._cv:
            c = self.chunks[index]
            lease = c.leases.pop(attempt, None)
            if c.state == "done":
                # the first result won already; this duplicate is
                # discarded (its per-attempt output is never installed)
                self._count("duplicates")
                obs.event("distrib.duplicate", chunk=index, worker=worker,
                          attempt=attempt)
                return {"ok": True, "accepted": False}
            c.state = "done"
            c.served_by = "fleet"
            c.output = str(req["output"])
            c.stats = stats
            self._accepted[index] = (worker, attempt)
            self.phase.record_served("fleet")
            if lease is not None:
                wall = time.monotonic() - lease.t_start
                self.completed_walls.append(wall)
                self.phase.add_wall("fleet", wall)
            replayed = int(stats.get("journal_replayed") or 0)
            if replayed:
                self._count("journal_replayed", replayed)
            self._count("chunks_fleet")
            _fold_worker_stats(self.worker_stats, worker, stats)
            obs.event("distrib.chunk_done", chunk=index, worker=worker,
                      attempt=attempt, replayed=replayed)
            # fold the worker's shipped spans and metrics into this
            # tracer: the written trace is the merged fleet timeline
            absorbed = obs.absorb(req.get("obs"))
            if absorbed:
                self._count("obs_events_absorbed", absorbed)
            self._cv.notify_all()
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
            if c.state != "done":
                self._fail_chunk(c, RuntimeError(err))
                c.error = err   # the worker's own "Type: message"
            obs.event("distrib.chunk_error", chunk=index,
                      worker=int(req["worker"]), attempt=attempt,
                      error=err)
            return {"ok": True}

    def _stats(self) -> dict:
        """The ``stats`` op: live fleet telemetry (queue depth, leases in
        flight, served by tier, heartbeat staleness) and the recent
        telemetry ring."""
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
                    "workers": {"live": self._live_workers(),
                                "dead": len(self._dead_workers)},
                    "served": dict(self.phase.served),
                    "staleness_s": round(staleness, 3),
                    "counters": dict(self.counters),
                    "telemetry": obs.telemetry(last=8)}

    def fleet_telemetry(self) -> dict:
        """The run's fleet telemetry: per-worker aggregates, the queueing
        p95 and the worst heartbeat staleness."""
        return {
            "workers": {str(w): dict(s)
                        for w, s in sorted(self.worker_stats.items())},
            "queueing_p95_s": _p95(self.queue_waits),
            "staleness_max_s": round(self._staleness_max, 3),
        }

    # -- failure paths (call with the lock held) ----------------------------

    def _fail_chunk(self, c: Chunk, exc: BaseException) -> None:
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
            if worker in self._dead_workers:
                return
            if self._stopping or all(c.state == "done"
                                     for c in self.chunks):
                return   # a clean drain-and-exit, not a death
            self._dead_workers.add(worker)
            self._count("workers_dead")
            obs.event("distrib.worker_dead", worker=worker, cause=why)
            # the reclaim is a named fault point: kill=1 crashes the
            # coordinator mid-reclaim, a raise is absorbed and counted —
            # the reclaim itself always proceeds
            if fire_reclaim_fault():
                self._count("reclaim_faults")
            for c in self.chunks:
                # a known-dead writer releases the canonical journal, so
                # the re-dispatch resumes it
                popped = release_worker_leases(c, worker)
                if popped:
                    self._count("lease_expired", len(popped))
                    if c.state != "done":
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
                    obs.event("distrib.lease_expired", chunk=c.index,
                              worker=lease.worker, attempt=a)
                    if c.state != "done":
                        self._fail_chunk(
                            c, TimeoutError(
                                f"lease on chunk {c.index} expired "
                                f"(worker {lease.worker}, attempt {a})"))

    # -- fleet -> local degradation -----------------------------------------

    def _live_workers(self) -> int:
        return sum(1 for i in self.pool.alive_indices()
                   if i not in self._dead_workers)

    def _degrade(self, cause: str) -> None:
        """Record the fleet → local step (once a run)."""
        if not self._degraded:
            self._degraded = True
            self.phase.record_degrade("fleet", "local",
                                      RuntimeError(cause))

    def _to_local(self, c: Chunk, cause: str) -> None:
        """Send a chunk the fleet cannot finish to the local rung (call
        with the lock held). Where the workers run on the card, the rung's
        host bytes are not the card's: the run fails instead, with the
        chunk's last error."""
        if on_card(self.backend, self.device):
            raise RuntimeError(f"{cause}; chunk {c.index}'s last error: "
                               f"{c.error or 'none reported'}")
        c.local = True
        self._degrade(cause)

    def _run_local(self, c: Chunk) -> None:
        """Polish one chunk in the coordinator through ``cli --host``. A
        free canonical journal is resumed only where the workers' backend
        is the host's (the journal's fingerprint names its backend);
        otherwise a fresh local journal."""
        from ..serve.scheduler import child_env

        with self._cv:
            if c.state == "done":
                return
            c.state = "running"
            resume = (not c.journal_held) and self.backend == "host"
        journal = c.journal if resume else os.path.join(
            c.dir, "journal.local.jsonl")
        out_path = os.path.join(c.dir, "out.local.fasta")
        part = out_path + ".part"
        cmd = local_command(self.args, self.include_unpolished,
                            self.sequences, self.overlaps, c.target,
                            journal)
        t0 = time.monotonic()
        with open(part, "w") as out_f, \
                open(os.path.join(c.dir, "local.stderr.log"), "w") as err_f:
            rc = subprocess.call(cmd, stdout=out_f, stderr=err_f,
                                 env=child_env())
        with self._cv:
            if c.state == "done":
                self._count("duplicates")   # a late fleet result won
                return
            if rc != 0:
                # the local rung is the floor: its failure fails the run
                c.state = "pending"
                c.local = True
                self.phase.record_failure(
                    "local", RuntimeError(f"local chunk {c.index} "
                                          f"exited {rc}"))
                raise RuntimeError(
                    f"chunk {c.index} failed on the local rung "
                    f"(exit {rc}; see {c.dir}/local.stderr.log)")
            os.replace(part, out_path)
            c.state = "done"
            c.served_by = "local"
            c.output = out_path
            self.phase.record_served("local")
            self.phase.add_wall("local", time.monotonic() - t0)
            self._count("chunks_local")
            obs.event("distrib.chunk_local", chunk=c.index)
            self._cv.notify_all()

    # -- main loop ----------------------------------------------------------

    def run(self, output_path: str,
            timeout: Optional[float] = None) -> dict:
        t_run = time.monotonic()
        startup_s = process_age_s()
        obs.reset()
        obs.set_role("coordinator")
        # the fleet's trace context: minted fresh a run, activated before
        # configure so that the tracer stamps it into the file's
        # provenance; _assign derives one child context a dispatch
        context.activate(context.fresh())
        obs.configure(trace_path=self.trace_path)
        self._ctx = context.current() if obs.enabled() else None
        faults.reset()
        os.makedirs(self.workdir, exist_ok=True)
        flight.set_dir(self.workdir)
        deadline = None if not timeout else time.monotonic() + timeout
        try:
            with obs.span("distrib.run", workers=self.n_workers,
                          backend=self.backend, device=self.device):
                self._layout()
                if on_card(self.backend, self.device):
                    self.build_s = cuda_lib.build_all()
                self._listen()
                self._spawn_fleet()
                try:
                    self._monitor(deadline)
                finally:
                    self._shutdown_fleet()
                self._gather(output_path)
            self.report.finalize()
            # post-mortem sweep: a flight.<pid>.json that a killed worker
            # left in a chunk directory
            dumps = [d.get("path") for d in flight.scan(self.workdir)]
            if dumps:
                self._count("flight_dumps", len(dumps))
            # pool counters (spawn_failures, scale faults) merge under the
            # coordinator's own, which win on overlap
            counters = dict(self.pool.counters)
            counters.update(self.counters)
            self.phase.extra.update(counters)
            if self.report_path:
                self.report.write(self.report_path)
            result = {
                "output": output_path,
                "chunks": len(self.chunks),
                "workers": self.n_workers,
                "backend": self.backend,
                "device": self.device,
                "memory_share": self.memory_share,
                "build_s": round(self.build_s, 4),
                # where the wall goes outside the chunks: this process's
                # start (interpreter, imports) before run(), run()'s own
                # wall, and each worker's spawn-to-hello
                "startup_s": startup_s,
                "run_s": round(time.monotonic() - t_run, 3),
                "worker_start": {str(w): dict(s) for w, s in
                                 sorted(self.worker_start.items())},
                # whether this process made a CUDA context of its own
                # (it should not: each worker has its own)
                "cuda_context": torch.cuda.is_initialized(),
                "served": dict(self.phase.served),
                "degradations": list(self.phase.degradations),
                "counters": counters,
                "journal_replayed": self.counters.get("journal_replayed",
                                                      0),
                "report": self.report_path,
                "trace": self.trace_path,
                "telemetry": self.fleet_telemetry(),
                "chunk_stats": [
                    {"index": c.index, "served_by": c.served_by,
                     "attempts": c.attempts,
                     "worker": self._accepted.get(c.index, (None,))[0],
                     "attempt": self._accepted.get(c.index,
                                                   (None, None))[1],
                     **c.stats} for c in self.chunks],
                "pool": {"min": self.pool.min_workers,
                         "max": self.pool.max_workers,
                         "timeline": [list(s) for s in
                                      self.pool.size_timeline]},
                "flight": dumps,
                "summary": self.report.summary(),
            }
            with open(os.path.join(self.workdir, "result.json"), "w") as f:
                json.dump(result, f, indent=1)
                f.write("\n")
            return result
        finally:
            # scoped teardown: write the merged trace, then disarm the
            # process-global tracer and trace context
            obs.release(write=True)
            context.clear()

    def _monitor(self, deadline: Optional[float]) -> None:
        while True:
            with self._cv:
                if all(c.state == "done" for c in self.chunks):
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"distrib run exceeded its deadline with "
                    f"{sum(1 for c in self.chunks if c.state != 'done')} "
                    f"chunk(s) unfinished")
            # reap exited workers (the second death signal, for a worker
            # that died before connecting or exited after a sticky error)
            with self._cv:
                reaped = self.pool.reap()
            for i, rc, _was_draining in reaped:
                self._worker_dead(i, f"exited {rc}")
            self._expire_leases()
            now = time.monotonic()
            if now - self._last_tick >= 1.0:
                self._last_tick = now
                with self._cv:
                    staleness = max(
                        (now - ls.last_beat for c in self.chunks
                         for ls in c.leases.values()), default=0.0)
                    self._staleness_max = max(self._staleness_max,
                                              staleness)
                    obs.telemetry_tick(
                        queue_depth=sum(1 for c in self.chunks
                                        if c.state == "pending"),
                        leases=sum(len(c.leases) for c in self.chunks),
                        workers_live=self._live_workers(),
                        staleness_s=round(staleness, 3))
            with self._cv:
                live = self._live_workers()
                undone = [c for c in self.chunks if c.state != "done"]
                for c in undone:
                    if (c.failures > self.max_retries and not c.leases
                            and c.state == "pending" and not c.local):
                        self._to_local(c, f"chunk {c.index} exhausted "
                                       f"its retry budget ({c.failures} "
                                       f"failures > {self.max_retries})")
                if live == 0 and undone:
                    # fleet collapse: every remaining chunk falls to the
                    # local rung (dead workers' leases already expired)
                    for c in undone:
                        if c.state == "pending" and not c.local:
                            self._to_local(c, "fleet collapse: no live "
                                           "workers")
                local_work = [c for c in self.chunks
                              if c.local and c.state == "pending"]
            for c in local_work:
                self._run_local(c)
            with self._cv:
                self._cv.wait(0.05)

    def _shutdown_fleet(self) -> None:
        with self._cv:
            self._stopping = True
        self.pool.shutdown(timeout=5.0)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def _gather(self, output_path: str) -> None:
        """Ordered gather: chunk outputs concatenate in chunk order, so
        the result is the unchunked polish's bytes."""
        part = output_path + ".part"
        with open(part, "wb") as out:
            for c in self.chunks:
                assert c.state == "done" and c.output, c.index
                with open(c.output, "rb") as f:
                    out.write(f.read())
        os.replace(part, output_path)


def _p95(waits: List[float]) -> Optional[float]:
    """p95 of the eligible→dispatch queue waits (None before the first
    dispatch)."""
    waits = sorted(waits)
    if not waits:
        return None
    return round(waits[min(len(waits) - 1, int(0.95 * len(waits)))], 4)


def _fold_worker_stats(per_worker: Dict[int, dict], worker: int,
                       stats: dict) -> None:
    """Fold one chunk's result stats into its worker's aggregate: chunks,
    summed and per-chunk walls, summed kernel wall, and the peak RSS and
    peak reserved device memory (call with the owner's lock held)."""
    ws = per_worker.setdefault(worker, {"chunks": 0, "wall_s": 0.0,
                                        "kernel_wall_s": 0.0,
                                        "rss_mb": 0.0, "chunk_walls": []})
    ws["chunks"] += 1
    wall = float(stats.get("wall_s") or 0.0)
    ws["wall_s"] = round(ws["wall_s"] + wall, 4)
    ws["chunk_walls"].append(wall)
    ws["kernel_wall_s"] = round(
        ws["kernel_wall_s"] + float(stats.get("kernel_wall_s") or 0.0), 4)
    ws["rss_mb"] = max(ws["rss_mb"], float(stats.get("rss_mb") or 0.0))
    if stats.get("device_peak_mb") is not None:
        ws["device_peak_mb"] = max(ws.get("device_peak_mb", 0.0),
                                   float(stats["device_peak_mb"]))
