"""ElasticPool: worker-process lifecycle for chunk fleets.

A copy of the JAX package's pool (racon_tpu/fleet/pool.py). The distrib
coordinator runs it at a fixed size (min == max, filled once by
``start()``), the fleet plane grows and shrinks it from live signals.
The pool owns process mechanics only — spawn, reap, drain, kill, and the
pool-size timeline; *when* to scale is the owner's policy.

A worker is ``python -m racon_tpu_torch.distrib.worker --port P --worker
I`` plus ``worker_args`` (its device, backend, POA kernel and share of
the card's memory: distrib/worker.py), started by ``spawn``:
``subprocess.Popen`` by default, never a fork of a process that may hold
a CUDA context. ``spawn`` is any callable taking Popen's ``(cmd, env=,
stdout=, stderr=)`` and returning an object with Popen's ``pid``,
``poll``, ``terminate``, ``kill``, ``wait`` and ``returncode`` (the
tests run ``distrib.worker.main`` in a thread through it).

Scale transitions are named control-plane seams with fault points
(resilience/faults.py):

* ``pool.scale_up``   — checked once per growth decision, before any
  process is spawned; an injected raise is absorbed, counted in
  ``counters['scale_up_faults']``, and the growth step is skipped;
* ``pool.scale_down`` — checked once per drain decision, the same way;
* ``worker.spawn``    — checked per process launched; a spawn failure
  shrinks the fleet, never kills the run.

Scale-down is graceful by construction: a victim is only marked draining
here; the owner answers its next ``fetch`` with ``drain``, and a worker
fetches only between chunks, so a draining worker never holds a lease
and a canonical journal can never be orphaned by a resize.

Threading: every mutating entry point runs under the owner's condition
variable (the coordinator's or the plane's ``_cv``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

from .. import obs
from ..resilience import faults

#: The worker's module, run with ``python -m``.
WORKER_MODULE = "racon_tpu_torch.distrib.worker"


class ElasticPool:  # concurrency: every mutating entry point is called under the owner's _cv (documented contract)
    def __init__(self, logs_dir: str, min_workers: int, max_workers: int,
                 env_fn: Optional[Callable[[int], dict]] = None,
                 port: int = 0,
                 on_spawn: Optional[Callable[[int, int], None]] = None,
                 on_spawn_failure: Optional[
                     Callable[[int, BaseException], None]] = None,
                 worker_args: Sequence[str] = (),
                 spawn: Callable = subprocess.Popen):
        self.logs_dir = logs_dir
        self.min_workers = max(0, int(min_workers))
        self.max_workers = max(self.min_workers, int(max_workers))
        self.port = port            # set by the owner before start()
        self.worker_args = list(worker_args)
        self._env_fn = env_fn
        self._spawn = spawn
        self._on_spawn = on_spawn
        self._on_spawn_failure = on_spawn_failure
        self._procs: Dict[int, object] = {}
        self.spawned_at: Dict[int, float] = {}   # index -> monotonic s
        self._draining: set = set()
        self._reaped: set = set()
        self._next_index = 0
        self.counters: Dict[str, int] = {}
        self.size_timeline: List[list] = []   # [t_rel_s, live] samples
        self._t0 = time.monotonic()

    # -- introspection ------------------------------------------------------

    def live(self) -> int:
        """Processes still running (draining ones included — they hold
        no lease but still count against the ceiling until they exit)."""
        return sum(1 for p in self._procs.values() if p.poll() is None)

    def active(self) -> int:
        """Live workers that are not draining — the dispatch capacity."""
        return sum(1 for i, p in self._procs.items()
                   if p.poll() is None and i not in self._draining)

    def is_draining(self, worker: int) -> bool:
        return worker in self._draining

    def indices(self) -> List[int]:
        return sorted(self._procs)

    def alive_indices(self) -> List[int]:
        return sorted(i for i, p in self._procs.items()
                      if p.poll() is None)

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _sample(self) -> None:
        self.size_timeline.append(
            [round(time.monotonic() - self._t0, 3), self.live()])

    # -- spawning -----------------------------------------------------------

    def command(self, index: int) -> List[str]:
        """The command line of worker `index`."""
        return [sys.executable, "-m", WORKER_MODULE, "--port",
                str(self.port), "--worker", str(index), *self.worker_args]

    def _spawn_one(self) -> Optional[int]:
        """Launch one worker; None on an (injected or real) spawn
        failure — a failed spawn shrinks the fleet, it must not kill the
        run."""
        index = self._next_index
        self._next_index += 1
        try:
            faults.check("worker.spawn")
            os.makedirs(self.logs_dir, exist_ok=True)
            env = self._env_fn(index) if self._env_fn else None
            with open(os.path.join(self.logs_dir,
                                   f"worker{index}.log"), "w") as log:
                proc = self._spawn(self.command(index), env=env,
                                   stdout=log, stderr=log)
        except Exception as e:  # noqa: BLE001 — injected or real; the
            # owner records it and the run continues on fewer workers
            self._count("spawn_failures")
            if self._on_spawn_failure:
                self._on_spawn_failure(index, e)
            return None
        self._procs[index] = proc
        self.spawned_at[index] = time.monotonic()
        self._count("workers_spawned")
        if self._on_spawn:
            self._on_spawn(index, proc.pid)
        self._sample()
        return index

    def start(self) -> int:
        """Fill the pool to its floor (no scale event — the floor is the
        configured baseline, not a growth decision)."""
        spawned = 0
        for _ in range(self.min_workers):
            if self._spawn_one() is not None:
                spawned += 1
        return spawned

    def scale_up(self, n: int = 1, cause: str = "") -> int:
        """Grow by up to n workers (bounded by the ceiling); returns how
        many spawned. One ``pool.scale_up`` check guards the whole
        decision."""
        n = min(n, self.max_workers - self.live())
        if n <= 0:
            return 0
        try:
            faults.check("pool.scale_up")
        except Exception:  # noqa: BLE001 — absorbed: a faulted resize
            # skips the growth step; staying small is the safe outcome
            self._count("scale_up_faults")
            return 0
        spawned = sum(1 for _ in range(n)
                      if self._spawn_one() is not None)
        if spawned:
            self._count("scale_ups")
            obs.count("fleet.scale_ups", spawned)
            obs.event("fleet.scale_up", added=spawned, live=self.live(),
                      cause=cause)
        return spawned

    # -- draining / reaping -------------------------------------------------

    def scale_down(self, n: int = 1, cause: str = "") -> List[int]:
        """Mark up to n workers draining (never below the floor); returns
        the victims. The owner answers each victim's next fetch with
        ``drain``: a worker fetches only between chunks, so no lease (and
        no canonical journal) is ever cut."""
        victims: List[int] = []
        n = min(n, self.active() - self.min_workers)
        if n <= 0:
            return victims
        try:
            faults.check("pool.scale_down")
        except Exception:  # noqa: BLE001 — absorbed: a faulted drain
            # keeps the worker alive, which is the safe outcome
            self._count("scale_down_faults")
            return victims
        # newest first: the oldest workers have loaded and run the most
        for index in sorted(self._procs, reverse=True):
            if len(victims) >= n:
                break
            if (self._procs[index].poll() is None
                    and index not in self._draining):
                self._draining.add(index)
                victims.append(index)
        if victims:
            self._count("scale_downs", len(victims))
            obs.count("fleet.scale_downs", len(victims))
            obs.event("fleet.scale_down", drained=victims,
                      live=self.live(), cause=cause)
            self._sample()
        return victims

    def reap(self) -> List[tuple]:
        """Newly exited workers as (index, returncode, was_draining),
        each reported once. The owner decides whether an exit is a death
        (lease reclaim) or a completed drain."""
        out = []
        for index, proc in self._procs.items():
            if proc.poll() is not None and index not in self._reaped:
                self._reaped.add(index)
                out.append((index, proc.returncode,
                            index in self._draining))
        if out:
            self._sample()
        return out

    # -- shutdown -----------------------------------------------------------

    def shutdown(self, timeout: float = 5.0) -> None:
        """Wait for the workers to drain out, then kill any leftover:
        no process outlives the pool. Runs after the owner's serving loop
        has stopped, outside any lock, so that a slow worker exit cannot
        stall connection teardown."""
        t0 = time.monotonic()
        for p in self._procs.values():
            while p.poll() is None and time.monotonic() - t0 < timeout:
                time.sleep(0.05)
            if p.poll() is None:
                p.kill()
                p.wait()
        self._sample()
