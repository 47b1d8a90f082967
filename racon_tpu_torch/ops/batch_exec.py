"""The batch feeder of the consensus phase: depth-Q dispatch over a
driver's hooks.

A copy of the JAX package's shared executor (racon_tpu/ops/batch_exec.py)
reduced to what the port runs: no degradation lattice (no retry, no
bisection, no tier demotion: a launch that fails raises) and no sharding
(the driver's dispatch stripes a batch over devices itself,
parallel/partitioner.py). What it keeps:

* **single-copy packing**: the driver's ``pack`` hook copies each
  window's bytes once into the batch's buffers (pinned host memory on the
  card), and the band ladder's re-runs pack again only the windows that
  widen;
* **depth-Q dispatch**: up to ``depth`` batches in flight, so the host
  exports and packs batch N+1 while the card runs batch N. On the card a
  dispatch copies the pinned inputs to the device without blocking, on
  the calling thread's current stream, launches the kernel, copies the
  outputs into pinned host tensors without blocking and records an
  event; ``unpack`` waits on that event alone (the consensus driver's
  wait runs under the watchdog, resilience/watchdog.py, with the
  ``poa.run.<kernel>`` fault point inside it). Each batch in flight keeps
  its own pinned buffers, so none is rewritten while a copy from it may
  still run. On the CPU a dispatch computes inline;
* the **widen loop**: after a batch is installed, the driver's ``widen``
  hook returns the windows whose band hit (ops/band.py) and the executor
  re-runs them (``attempt``) until none is left: the band ladder's
  re-run seam, bounded by the ladder;
* the ``done`` hook, called once a batch is fully resolved;
* the **pack and kernel wall split**: ``pack_ns`` (host export and pack)
  and ``kernel_ns`` (host wall blocked waiting for the card, re-runs
  included), folded into a stats dict by ``stamp_walls``;
* a ``poa.batch`` span per batch, from its wait to its last re-run
  installed, with its windows, its pack seconds and its wait seconds;
* the **hard-watermark collapse**: once the run's memory budget
  (resilience/budget.py) latches its hard watermark, depth drops to 1
  and every batch resolves as soon as it is dispatched. The bytes never
  depend on the depth: it changes when results are waited on, not what
  computes.

The driver supplies an ops object (duck-typed):

    export(ctx, idxs)          -> batch items ([] = nothing to run)
    pack(ctx, items)           -> packed buffers
    dispatch(ctx, packed, items) -> a handle on the launched batch
    unpack(ctx, handle)        -> host results (waits for the card)
    install(ctx, items, results)
    widen(ctx)                 -> items to re-run ([] = ladder drained)
    attempt(ctx, packed, items) -> host results of a re-run (blocking)
    done(ctx, items)           (optional)
"""

from __future__ import annotations

import time
from collections import deque

from .. import obs

#: Batches in flight on the card (the JAX package's RACON_TPU_PIPELINE_DEPTH
#: default).
DEFAULT_DEPTH = 2


class BatchExecutor:
    """Depth-Q pipelined batch server over a driver's ops hooks."""

    def __init__(self, ops, *, depth: int = DEFAULT_DEPTH, budget=None):
        self.ops = ops
        self.depth = max(1, int(depth))
        self.budget = budget
        self.collapsed = False
        self._pending = deque()   # (ctx, items, packed, handle, pack ns)
        self.pack_ns = 0          # host wall: export and pack
        self.kernel_ns = 0        # host wall blocked on the card

    def _check_pressure(self) -> None:
        """Hard-watermark reaction at the pack seam: every batch in
        flight holds host buffers, so once the budget's hard watermark
        latches the executor stops queuing (depth 1) and drains."""
        if self.depth <= 1 or self.budget is None or \
                not self.budget.hard_latched():
            return
        self.depth = 1
        self.collapsed = True
        self.flush()

    def submit(self, ctx, idxs) -> None:
        """Export, pack and dispatch one batch; resolve the oldest once
        `depth` batches are in flight."""
        self._check_pressure()
        ops = self.ops
        t0 = time.monotonic_ns()
        items = ops.export(ctx, idxs)
        if not items:
            self.pack_ns += time.monotonic_ns() - t0
            return
        packed = ops.pack(ctx, items)
        pack_ns = time.monotonic_ns() - t0
        self.pack_ns += pack_ns
        handle = ops.dispatch(ctx, packed, items)
        self._pending.append((ctx, items, packed, handle, pack_ns))
        if len(self._pending) >= self.depth:
            self._resolve(*self._pending.popleft())

    def flush(self) -> None:
        """Resolve every batch in flight, oldest first."""
        while self._pending:
            self._resolve(*self._pending.popleft())

    def _resolve(self, ctx, items, packed, handle, pack_ns) -> None:
        ops = self.ops
        with obs.span("poa.batch", windows=len(items),
                      pack_s=pack_ns / 1e9) as sp:
            t0 = time.monotonic_ns()
            results = ops.unpack(ctx, handle)
            wait_ns = time.monotonic_ns() - t0
            self.kernel_ns += wait_ns
            sp.set(wait_s=wait_ns / 1e9)
            del packed, handle   # the batch's buffers may go now
            ops.install(ctx, items, results)
            self._widen(ctx)
        done = getattr(ops, "done", None)
        if done is not None:
            done(ctx, items)

    def _widen(self, ctx) -> None:
        """Drain the driver's verify-and-widen ladder: re-run the windows
        whose band hit until none is left (the ladder is bounded: its
        doublings, then the flat build)."""
        ops = self.ops
        while True:
            retry = ops.widen(ctx)
            if not retry:
                return
            t0 = time.monotonic_ns()
            packed = ops.pack(ctx, retry)
            t1 = time.monotonic_ns()
            results = ops.attempt(ctx, packed, retry)
            t2 = time.monotonic_ns()
            self.pack_ns += t1 - t0
            self.kernel_ns += t2 - t1
            ops.install(ctx, retry, results)

    def stamp_walls(self, stats: dict) -> None:
        """Add the pack and kernel wall split (seconds) to `stats`."""
        stats["pack_wall_s"] = stats.get("pack_wall_s", 0.0) + \
            self.pack_ns / 1e9
        stats["kernel_wall_s"] = stats.get("kernel_wall_s", 0.0) + \
            self.kernel_ns / 1e9
