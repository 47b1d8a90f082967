"""Compile model counterexamples into replayable fault schedules.

The port's copy of racon_tpu/analysis/protocol/replay.py. A
counterexample trace is a sequence of model events. Most of them
(dispatch, TTL expiry, steal, gather) happen on their own in a real
fleet given enough timing pressure; only the fault-consuming events
(the ones that decrement the model's fault budget) need help. Each of
those maps onto a ``faults.KNOWN_POINTS`` injection, so a whole trace
compiles into one ``RACON_TORCH_FAULT`` spec string, plus, where the
faults target one worker, that worker's index: the ``fault_worker``
argument that ``distrib.Coordinator`` and ``fleet.FleetPlane`` take
(``distrib/common.worker_env`` hands the spec to that worker alone).
So a ``Schedule`` gives the environment and, apart from it, the keyword
arguments. The compiled spec is validated against the port's parser
(``faults.parse_spec``) before it is handed out: if the model invents a
fault the runtime grammar cannot express, compilation fails loudly.

``witness_trace`` runs the search in the other direction: it asks for a
shortest clean run of the real model that passes through a chosen set
of fault events (worker death + lease reclaim by default) and ends with
every job gathered: the schedule the replay test and the smoke's
``distrib_kill`` phase drive against a live two-worker fleet.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from .model import Config, Event, initial, successors

#: The fault spec's environment name (resilience/faults.py ENV),
#: repeated here so that compiling a schedule imports no runtime fault
#: machinery (validation does, lazily).
FAULT_ENV = "RACON_TORCH_FAULT"
#: The keyword that scopes a spec to one worker.
SCOPE_KW = "fault_worker"

#: Hang length for compiled worker_hang events: past the lease TTL the
#: replay tests run with, well short of any test timeout.
_HANG_S = 6

#: model event name -> (fault point, spec fields, scoped-to-worker).
#: Only fault-consuming events appear; everything else replays itself.
_COMPILE: Dict[str, Tuple[str, str, bool]] = {
    "worker_die": ("worker.result", "kill=1:count=1", True),
    "worker_hang": ("worker.result", f"hang={_HANG_S}:count=1", True),
    # heartbeat loss is permanent by design: renewals stop silently,
    # so the point stays broken (no count cap)
    "heartbeat_loss": ("worker.heartbeat", "raise=RuntimeError", True),
    "spawn_fail": ("worker.spawn", "raise=RuntimeError:count=1", False),
    "scale_down": ("pool.scale_down", "raise=RuntimeError:count=1",
                   False),
    "steal": ("pool.steal", "raise=RuntimeError:count=1", False),
    "lease_reclaim": ("lease.reclaim", "raise=RuntimeError:count=1",
                      False),
    "deliver_error": ("poa.run.ls", "raise=RuntimeError:count=1", True),
    "controller_kill": ("pool.scale_up", "kill=1:count=1", False),
}

#: events where the fault variant is marked by a trailing "fault" arg
#: (the unmarked form is the ordinary, injection-free transition).
_MARKED = {"scale_down", "steal", "lease_reclaim"}


class Unreplayable(ValueError):
    """The trace cannot be expressed as one RACON_TORCH_FAULT schedule."""


@dataclass(frozen=True)
class Schedule:
    """One replayable fault schedule compiled from a trace."""

    spec: str                      # RACON_TORCH_FAULT value
    worker: Optional[int]          # the fault_worker argument
    events: Tuple[str, ...]        # the injected events, in trace order

    def env(self) -> Dict[str, str]:
        """The environment the fleet's process runs under."""
        return {FAULT_ENV: self.spec} if self.spec else {}

    def kwargs(self) -> Dict[str, int]:
        """The keyword arguments of Coordinator / FleetPlane that scope
        the spec to its worker (none where no fault is scoped)."""
        return {SCOPE_KW: self.worker} if self.worker is not None else {}


def _injected(ev: Event) -> Optional[Tuple[str, Optional[int]]]:
    """(fault event name, scoped worker) when `ev` consumed a fault."""
    name, args = ev
    if name not in _COMPILE:
        return None
    if name in _MARKED and (not args or args[-1] != "fault"):
        return None                 # the ordinary, uninjected form
    _point, _fields, scoped = _COMPILE[name]
    w: Optional[int] = None
    if scoped:
        # the worker index is the last int argument (deliver_error and
        # worker_* events put it there)
        ints = [a for a in args if isinstance(a, int)]
        w = ints[-1] if ints else None
    return name, w


def compile_trace(trace: List[Event], validate: bool = True) -> Schedule:
    """Compile a counterexample trace into one fault schedule.

    Raises Unreplayable when the trace needs faults scoped to two
    different workers: a fleet hands its spec to a single worker.
    """
    parts: List[str] = []
    names: List[str] = []
    scopes: List[int] = []
    for ev in trace:
        hit = _injected(ev)
        if hit is None:
            continue
        name, w = hit
        point, fields, scoped = _COMPILE[name]
        parts.append(f"{point}:{fields}" if fields else point)
        names.append(name)
        if scoped and w is not None:
            scopes.append(w)
    distinct = sorted(set(scopes))
    if len(distinct) > 1:
        raise Unreplayable(
            f"trace injects faults into workers {distinct}, but "
            f"{SCOPE_KW} scopes a single worker")
    spec = ",".join(parts)
    sched = Schedule(spec=spec,
                     worker=distinct[0] if distinct else None,
                     events=tuple(names))
    if validate and spec:
        from ...resilience import faults
        faults.parse_spec(spec)     # ValueError on grammar drift
    return sched


def witness_trace(cfg: Optional[Config] = None,
                  require: Tuple[str, ...] = ("worker_die",
                                              "lease_reclaim"),
                  max_states: int = 2_000_000,
                  ) -> Tuple[List[Event], Schedule]:
    """Shortest clean run of the real model that passes through every
    event in `require` and ends quiescent with every job gathered (on
    the card a failed job is quiescent too, but not clean), plus its
    compiled schedule.

    BFS over (state, events seen) so the progress through `require` is
    part of the search: the result is the minimal interleaving that a
    replay can drive against a live fleet.
    """
    from . import invariants as inv

    cfg = cfg or Config(chunks=("A", "A", "A"), submit_ests=(2,))
    want = frozenset(require)
    init = initial(cfg)
    start = (init, frozenset())
    seen = {start: 0}
    nodes = [start]
    parent: List[Tuple[int, Optional[Event]]] = [(-1, None)]
    q = deque([0])
    while q:
        nid = q.popleft()
        s, got = nodes[nid]
        for ev, ns in successors(cfg, s, None):
            ngot: FrozenSet[str] = got | ({ev[0]} & want)
            key = (ns, ngot)
            if key in seen:
                continue
            if len(nodes) >= max_states:
                break
            seen[key] = len(nodes)
            nodes.append(key)
            parent.append((nid, ev))
            if (ngot == want and not ns.failed
                    and inv.quiescent(cfg, ns)):
                trace = _unwind(parent, len(nodes) - 1)
                return trace, compile_trace(trace)
            q.append(len(nodes) - 1)
    raise Unreplayable(
        f"no quiescent run through {sorted(want)} in "
        f"{cfg.describe()} (searched {len(nodes)} nodes)")


def _unwind(parent, nid: int) -> List[Event]:
    out: List[Event] = []
    while nid > 0:
        nid, ev = parent[nid]
        if ev is not None:
            out.append(ev)
    out.reverse()
    return out
