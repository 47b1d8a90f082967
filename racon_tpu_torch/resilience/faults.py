"""Deterministic fault injection at the port's seams.

A copy of the JAX package's fault grammar (racon_tpu/resilience/faults.py)
over the seams the port has. The spec comes from the environment variable
``RACON_TORCH_FAULT`` (so that a child process receives it) or from
``configure(spec)``, which wins while it is set::

    RACON_TORCH_FAULT="poa.run.ls:raise=RuntimeError"
    RACON_TORCH_FAULT="journal.append:batch=40:kill=1"
    RACON_TORCH_FAULT="align.run:batch=1:count=1,poa.run.v2:hang=2"

Grammar (comma-separated specs, colon-separated fields)::

    <point>[:batch=N][:window=I][:count=N][:hang=SECONDS][:raise=NAME]
           [:kill=1]

* ``point``: one of KNOWN_POINTS, the first field;
* ``batch=N``: fire only on the Nth invocation of the point (0-based,
  counted per point per run);
* ``window=I``: fire only where window or job index I is in the checked
  batch (run points pass the batch's indices);
* ``count=N``: fire at most N times (default: every time);
* ``hang=S``: sleep S seconds instead of raising; the run points sleep
  where the host waits on the card, under the watchdog
  (resilience/watchdog.py), so ``hang=`` stands for a card that does not
  answer;
* ``raise=NAME``: the exception to raise (default ``MosaicError``; the
  names are the JAX package's, so that one spec means the same in both);
* ``kill=1``: SIGKILL the process instead (no handlers, no flushing: a
  preemption). With ``batch=N`` on ``journal.append`` the process dies
  after exactly N journaled records.

The port has no tier lattice: a ``raise`` at ``align.run`` or
``poa.run.*`` ends the polish with that error, as any other launch
failure does. ``band.hit`` makes every banded job or window of the
checked attempt a hit, which drives the ladder to flat; ``mem.pressure``
forces the hard watermark at a poll; ``mem.spill`` aborts a park. Those
three give the same bytes. ``slo.burn`` (the serve daemon's SLO engine,
obs/slo.py) absorbs a raise as a forced burn rate. ``sanitize.nan`` and
``sanitize.stats`` fire only where the runtime sanitizer is armed
(analysis/sanitize.py): each leaves one finding and the same bytes.

The distributed points mean what the JAX package's do
(racon_tpu/resilience/faults.py): ``kill=1`` on ``worker.heartbeat``,
``worker.result`` or ``mem.oom`` is a SIGKILL of that worker mid-chunk,
whose chunk the coordinator re-dispatches to resume from its journal; on
``pool.*`` or ``lease.reclaim`` it crashes the controller mid-transition.
The coordinator and the fleet plane hand ``RACON_TORCH_FAULT`` to one
worker only (``fault_worker``, 0 by default), so a spec kills a known
worker and not the fleet.

A malformed spec raises ValueError with a one-line message (the CLI exits
1 with it). ``reset()`` runs in each polisher constructor, so that
consecutive runs in one process fire on the same schedule.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

ENV = "RACON_TORCH_FAULT"

#: The seams the port checks.
KNOWN_POINTS = frozenset({
    "align.run",        # phase-1 kernels, per ladder round of a cohort
    "band.hit",         # a banded attempt's verify: every banded job or
                        # window of it becomes a hit (ladder to flat)
    "poa.run.ls",       # ls POA kernel, per batch, where the host waits
    "poa.run.v2",       # v2 POA kernel, the same
    "journal.append",   # each journal record write
    "journal.replay",   # journal replay on resume
    "watchdog.call",    # each wait under the watchdog
    "mem.pressure",     # each synchronous budget poll: forced hard
                        # watermark
    "mem.spill",        # before each park of a working set: aborted park
    "slo.burn",         # each SLO evaluation (obs/slo.py): a raise is
                        # absorbed as a forced burn
    "sanitize.nan",     # the armed sanitizer's consensus check: poisons
                        # the checker's copy of the chunk (the installed
                        # consensus is untouched)
    "sanitize.stats",   # each stats guard the armed sanitizer makes: one
                        # real cross-thread write through it
    # the distributed seams (distrib/, fleet/), as the JAX package's:
    "worker.spawn",     # before each worker process is launched: a raise
                        # is a spawn failure, which shrinks the fleet
    "worker.heartbeat", # a worker, before each lease renewal: a raise
                        # silently stops renewing (the lease expires)
    "worker.result",    # a worker, after a chunk is journaled and
                        # written, before its result is delivered
    "pool.scale_up",    # the pool, before growing: a raise is absorbed
                        # and the growth step skipped
    "pool.scale_down",  # the pool, before draining a worker: the same
    "pool.steal",       # the fleet plane, before a cross-job steal: a
                        # raise skips the steal for that fetch
    "lease.reclaim",    # before a dead worker's leases are reclaimed: a
                        # raise is absorbed and counted, the reclaim
                        # proceeds
    "mem.oom",          # a worker, before polishing a fetched chunk
})


class InjectedFault(Exception):
    """Base class of the synthetic injected failures."""


class MosaicError(InjectedFault):
    """The default injected failure; named as the JAX package's, so that
    a spec means the same in both packages."""


#: The exceptions a spec may name.
EXCEPTIONS = {
    "MosaicError": MosaicError,
    "InjectedFault": InjectedFault,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
}

_UNLIMITED = -1


@dataclass
class FaultSpec:
    point: str
    batch: Optional[int] = None
    window: Optional[int] = None
    count: int = _UNLIMITED
    hang: float = 0.0
    kill: bool = False
    raise_name: str = "MosaicError"
    fired: int = field(default=0, compare=False)

    def spent(self) -> bool:
        return self.count != _UNLIMITED and self.fired >= self.count

    def describe(self) -> str:
        sel = []
        if self.batch is not None:
            sel.append(f"batch={self.batch}")
        if self.window is not None:
            sel.append(f"window={self.window}")
        return ":".join([self.point, *sel])


def parse_spec(text: str) -> list:
    """Parse a spec; ValueError with a one-line message on any malformed
    field (unknown point or key, a selector that is not an integer, an
    unknown exception name)."""
    specs = []
    for part in filter(None, (p.strip() for p in text.split(","))):
        fields = part.split(":")
        point = fields[0]
        if point not in KNOWN_POINTS:
            raise ValueError(
                f"{ENV}: unknown injection point {point!r} "
                f"(valid: {', '.join(sorted(KNOWN_POINTS))})")
        spec = FaultSpec(point)
        for f in fields[1:]:
            key, sep, val = f.partition("=")
            if not sep:
                raise ValueError(f"{ENV}: expected key=value, got {f!r}")
            try:
                if key == "batch":
                    spec.batch = int(val)
                elif key == "window":
                    spec.window = int(val)
                elif key == "count":
                    spec.count = int(val)
                elif key == "hang":
                    spec.hang = float(val)
                elif key == "kill":
                    spec.kill = int(val) != 0
                elif key == "raise":
                    if val not in EXCEPTIONS:
                        raise ValueError(
                            f"{ENV}: unknown exception {val!r} "
                            f"(valid: {', '.join(sorted(EXCEPTIONS))})")
                    spec.raise_name = val
                else:
                    raise ValueError(f"{ENV}: unknown key {key!r} "
                                     f"(valid: batch, window, count, hang, "
                                     f"kill, raise)")
            except ValueError as e:
                if str(e).startswith(ENV):
                    raise
                raise ValueError(
                    f"{ENV}: bad value {val!r} for {key!r}") from None
        specs.append(spec)
    return specs


class FaultPlan:
    """Parsed specs and each point's invocation count for one run. The
    counting runs under ``_LOCK`` (a pipelined polish checks from two
    threads); the action (sleep, raise, SIGKILL) runs outside it."""

    def __init__(self, specs):
        self.specs = specs
        self.calls = {}

    def check(self, point: str,
              windows: Optional[Sequence[int]] = None) -> None:
        with _LOCK:
            n = self.calls.get(point, 0)
            self.calls[point] = n + 1
            fire = None
            for spec in self.specs:
                if spec.point != point or spec.spent():
                    continue
                if spec.batch is not None and spec.batch != n:
                    continue
                if spec.window is not None:
                    if windows is None or spec.window not in windows:
                        continue
                spec.fired += 1
                fire = spec
                break
        if fire is None:
            return
        from .. import obs

        obs.event("fault.fired", point=point, invocation=n,
                  spec=fire.describe())
        if fire.kill:
            os.kill(os.getpid(), signal.SIGKILL)
        if fire.hang:
            time.sleep(fire.hang)
            return
        raise EXCEPTIONS[fire.raise_name](
            f"injected fault at {fire.describe()} (invocation {n})")


_LOCK = threading.Lock()
_configured: Optional[str] = None   # configure()'s spec; None: the env's
_cached_text: Optional[str] = None
_cached_plan: Optional[FaultPlan] = None


def configure(spec: Optional[str]) -> None:
    """Set the spec for this process (None: back to RACON_TORCH_FAULT);
    raises ValueError where it is malformed. Counters start afresh."""
    global _configured, _cached_text, _cached_plan
    if spec:
        parse_spec(spec)
    with _LOCK:
        _configured = spec
        _cached_text = None
        _cached_plan = None


def active_spec() -> str:
    """The armed spec ('' when fault injection is off)."""
    if _configured is not None:
        return _configured
    return os.environ.get(ENV, "")


def _plan() -> Optional[FaultPlan]:
    global _cached_text, _cached_plan
    text = active_spec()
    with _LOCK:
        if text != _cached_text:
            _cached_text = text
            _cached_plan = FaultPlan(parse_spec(text)) if text else None
        return _cached_plan


def check(point: str, windows: Optional[Sequence[int]] = None) -> None:
    """Fire any armed fault for `point`; `windows` are the window or job
    indices of the checked batch (run points). A no-op when no spec is
    armed."""
    assert point in KNOWN_POINTS, point
    plan = _plan()
    if plan is not None:
        plan.check(point, windows)


def reset() -> None:
    """Fresh counters (each polisher constructor calls it)."""
    global _cached_text, _cached_plan
    with _LOCK:
        _cached_text = None
        _cached_plan = None


def validate() -> None:
    """Parse the armed spec now; ValueError where it is malformed (the
    CLI's up-front check)."""
    text = active_spec()
    if text:
        parse_spec(text)
