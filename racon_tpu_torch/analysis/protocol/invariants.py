"""The invariant library the checker evaluates over every reachable
state: the port's copy of racon_tpu/analysis/protocol/invariants.py.

Safety invariants are predicates on a single state (checked the moment
a state is discovered, so the BFS counterexample is minimal). The one
graph invariant, recovery-reaches-quiescence, is evaluated over the
fully explored space: from *every* reachable state a quiescent state
(every job gathered or, on the card, failed; every admission settled;
the controller up) must remain reachable. That formulation survives
the pool's benign resize cycles, which never deadlock but never stop
either. The port adds one safety invariant for the card's outcomes,
one-job-outcome: no job is both gathered and failed.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from .model import Config, S, reserved

ONE_CANONICAL = "one-canonical-owner"
BUDGET = "budget-capacity"
EXACTLY_ONCE = "exactly-once-gather"
NO_ORPHAN = "no-orphan-lease-after-drain"
QUIESCENCE = "recovery-quiescence"
ONE_OUTCOME = "one-job-outcome"


def check_one_canonical(cfg: Config, s: S) -> Optional[str]:
    """At most one live writer may hold a chunk's canonical journal:
    a merely-expired holder keeps it, only a *confirmed dead* one
    releases it (leases.release_worker_leases)."""
    for i, c in enumerate(s.chunks):
        if len(c.jowners) > 1:
            return (f"chunk {i}: {len(c.jowners)} live canonical "
                    f"journal writers (workers "
                    f"{sorted(c.jowners)}) — resumed bytes would "
                    f"interleave")
        if c.jowners and not c.jheld:
            return (f"chunk {i}: journal marked free while worker "
                    f"{min(c.jowners)} still writes it")
    return None


def check_budget(cfg: Config, s: S) -> Optional[str]:
    """The serve window-budget ledger never oversubscribes capacity
    (scheduler._admission_lane's atomic check-and-reserve)."""
    ledger = reserved(cfg, s)
    if ledger > cfg.budget:
        return (f"reserved windows {ledger} > budget {cfg.budget} "
                f"(submits: {list(s.submits)})")
    return None


def check_exactly_once(cfg: Config, s: S) -> Optional[str]:
    """Each chunk's result is accepted at most once (duplicates from
    speculation/stealing are discarded), and a gathered job gathered
    every chunk exactly once."""
    for i, c in enumerate(s.chunks):
        if c.acc >= 2:
            return (f"chunk {i}: {c.acc} results accepted — a "
                    f"duplicate reached the gather log")
        if cfg.chunks[i] in s.gathered and c.acc != 1:
            return (f"job {cfg.chunks[i]} gathered with chunk {i} "
                    f"accepted {c.acc} times")
    return None


def check_no_orphan(cfg: Config, s: S) -> Optional[str]:
    """A cleanly-drained worker exited between chunks: it holds no
    lease, no in-flight attempt, and no canonical journal."""
    for w, st in enumerate(s.workers):
        if st != "X":
            continue
        for i, c in enumerate(s.chunks):
            if any(a[0] == w for a in c.att):
                return (f"drained worker {w} exited still holding an "
                        f"attempt on chunk {i}")
            if w in c.jowners:
                return (f"drained worker {w} exited still owning "
                        f"chunk {i}'s canonical journal")
    return None


def check_one_outcome(cfg: Config, s: S) -> Optional[str]:
    """A job ends one way: gathered (its chunks' bytes written) or
    failed on the card (``_to_local``), never both."""
    both = sorted(s.gathered & s.failed)
    if both:
        return (f"job(s) {both} both gathered and failed: a failed job "
                f"wrote its output")
    return None


def quiescent(cfg: Config, s: S) -> bool:
    """The terminal contract: every job gathered or failed (on the
    card), every admission settled (released or shed), the controller
    up."""
    return (s.controller == "up"
            and all(j in s.gathered or j in s.failed for j in cfg.jobs)
            and all(st == "set" for st in s.submits))


#: invariant name -> state predicate (None = graph-level, handled by
#: the checker itself).
SAFETY: Dict[str, Callable[[Config, S], Optional[str]]] = {
    ONE_CANONICAL: check_one_canonical,
    BUDGET: check_budget,
    EXACTLY_ONCE: check_exactly_once,
    NO_ORPHAN: check_no_orphan,
    ONE_OUTCOME: check_one_outcome,
}

ALL = [ONE_CANONICAL, BUDGET, EXACTLY_ONCE, NO_ORPHAN, ONE_OUTCOME,
       QUIESCENCE]


def invariant_names() -> List[str]:
    return list(ALL)
