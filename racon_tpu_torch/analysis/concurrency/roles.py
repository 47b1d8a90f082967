"""Registered thread roles, sanctioned types, and the waiver syntax.

The port's copy of the JAX package's table
(racon_tpu/analysis/concurrency/roles.py), holding the port's roles: the
JAX roles less ``poa-warm`` (the port has no warm-up thread), the
watchdog's runner as ``racon-torch-watchdog-call``, and ``smoke-*`` for
the helper threads of ``chip_smoke.py``.

A *role* is the identity of a thread as far as the auditor is
concerned: every ``threading.Thread(name=...)`` must carry a name whose
pattern is registered here (enforced by the ``thread-discipline`` lint
rule), and the lock-discipline audit reasons about which roles reach
which mutation sites. The implicit ``main`` role covers everything
reachable from module level or from uncalled public entry points.

Waiver syntax: a mutation the auditor flags can be waived with a
trailing comment on the mutation line, the enclosing ``def`` line, or
the owning ``class`` line:

    self.calls[point] = n + 1  # concurrency: guarded by caller's _cv
"""

from __future__ import annotations

import re
from fnmatch import fnmatchcase

#: Registered thread-role name patterns (fnmatch globs) -> description.
#: The lint rule requires every Thread name to match one of these;
#: README.md's port section carries the same table (a test holds the
#: two equal).
THREAD_ROLE_PATTERNS = {
    "serve-accept": "serve daemon accept loop (serve/server.py)",
    "serve-conn": "serve per-connection request handler",
    "serve-*-lane": "scheduler lane worker (serve/scheduler.py)",
    "distrib-accept": "coordinator accept loop (distrib/coordinator.py)",
    "distrib-conn": "coordinator per-worker connection handler",
    "distrib-heartbeat": "worker lease-renewal loop (distrib/worker.py)",
    "fleet-accept": "fleet plane accept loop (fleet/plane.py)",
    "fleet-conn": "fleet plane per-worker connection handler",
    "fleet-monitor": "fleet plane autoscaler/lease monitor "
                     "(fleet/plane.py)",
    "mem-watchdog": "memory-budget RSS sampler (resilience/budget.py)",
    "align-worker": "pipelined-phases alignment feeder (polisher.py)",
    "racon-torch-watchdog-call": "device-call watchdog runner "
                                 "(resilience/watchdog.py)",
    "serve-metrics-http": "Prometheus exposition HTTP listener "
                          "(serve/server.py)",
    "loadtest-c*": "serve load-test client thread (serve/loadtest.py)",
    "loadtest-stats": "load-test daemon telemetry poller "
                      "(serve/loadtest.py)",
    "sanitize-stats-probe": "sanitizer cross-thread stats probe "
                            "(analysis/sanitize.py)",
    "smoke-*": "chip_smoke.py helper thread (the fleet daemon's starter, "
               "the daemon's clients)",
}

#: Constructor names whose instances are sanctioned lock-free shared
#: state: internally synchronised, or append-only behind a guard.
SANCTIONED_CONSTRUCTORS = frozenset({
    "queue.Queue", "queue.SimpleQueue", "queue.LifoQueue",
    "queue.PriorityQueue", "threading.Event", "GuardedStats",
    "guard_stats",
})

#: threading constructors that create a lock-like guard usable in a
#: ``with`` statement. Condition wraps an RLock, so re-acquiring the
#: same condition reentrantly is legal (self-edges are ignored in the
#: lock-order digraph).
LOCK_CONSTRUCTORS = frozenset({
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
})

_WAIVER_RE = re.compile(r"#\s*concurrency:\s*(\S.*)")


def waiver_reason(line: str):
    """The ``# concurrency: <reason>`` waiver on a source line, or None."""
    m = _WAIVER_RE.search(line)
    return m.group(1).strip() if m else None


def role_is_registered(name: str) -> bool:
    """True when a thread-name pattern matches a registered role.

    ``name`` is the *patternized* thread name: f-string interpolations
    are replaced with ``*``, so both directions of the glob match are
    tried (``loadtest-c3`` against the registered ``loadtest-c*``, and
    the patternized ``loadtest-c*`` against the same registration).
    """
    return role_of(name) is not None


def role_of(name: str):
    """The registered pattern a thread name matches, or None."""
    for pat in THREAD_ROLE_PATTERNS:
        if fnmatchcase(name, pat) or fnmatchcase(pat, name):
            return pat
    return None


def sanctioned_call(dotted: str) -> bool:
    """True when a constructor call creates sanctioned shared state
    (``GuardedStats`` and ``guard_stats`` are analysis/sanitize.py's)."""
    if dotted in SANCTIONED_CONSTRUCTORS:
        return True
    last = dotted.rsplit(".", 1)[-1]
    return last in {"GuardedStats", "guard_stats"} or (
        last in {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
        and (dotted == last or dotted.startswith("queue.")))


def lock_call(dotted: str) -> bool:
    """True when a constructor call creates a lock-like guard."""
    last = dotted.rsplit(".", 1)[-1]
    return last in LOCK_CONSTRUCTORS and (
        dotted == last or dotted.startswith("threading."))
