"""TTL leases and chunk lifecycle: the shared dispatch core.

A copy of the JAX package's module (racon_tpu/fleet/leases.py): the
distrib coordinator and the fleet plane run the same lease discipline.

* every assignment carries a TTL lease renewed by heartbeats;
* an expired lease re-queues the chunk with exponential backoff;
* a worker EOF reclaims all of its leases at once (death at socket
  speed, not TTL speed);
* the canonical per-chunk journal has at most one live writer — a
  *known dead* holder releases it (the re-dispatch resumes the journaled
  prefix), a merely unresponsive holder keeps it and the new attempt
  writes a side journal.

Reclaim is a named control-plane transition: ``fire_reclaim_fault``
checks the ``lease.reclaim`` injection point before a dead holder's
leases are released. kill=1 there crashes the controller mid-reclaim; an
injected raise is absorbed at the seam and counted, because reclaim runs
inside connection-teardown paths that must never throw.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

from ..resilience import faults


class Lease:
    __slots__ = ("worker", "attempt", "deadline", "t_start", "canonical",
                 "last_beat")

    def __init__(self, worker: int, attempt: int, ttl: float,
                 canonical: bool):
        self.worker = worker
        self.attempt = attempt
        self.t_start = time.monotonic()
        self.deadline = self.t_start + ttl
        self.canonical = canonical   # holds the chunk's primary journal
        self.last_beat = self.t_start   # heartbeat-staleness telemetry


class Chunk:
    """One contig chunk and its dispatch lifecycle."""

    def __init__(self, index: int, target: str, chunk_dir: str):
        self.index = index
        self.target = target
        self.dir = chunk_dir
        self.journal = os.path.join(chunk_dir, "journal.jsonl")
        self.state = "pending"        # pending | running | done
        self.local = False            # demoted to in-controller execution
        self.attempts = 0
        self.failures = 0
        self.next_eligible = 0.0
        self.leases: Dict[int, Lease] = {}
        self.tried = set()            # worker ids that have attempted
        self.journal_held = False     # a (possibly live) writer owns it
        self.output: Optional[str] = None
        self.stats: dict = {}
        self.served_by: Optional[str] = None
        self.error: Optional[str] = None    # the last attempt's failure
        self.t_pending = time.monotonic()   # queue-wait telemetry


def fire_reclaim_fault() -> bool:
    """Check the ``lease.reclaim`` injection point. kill=1 never returns
    (the controller's crash mid-reclaim); an injected raise is absorbed
    and reported as True so that the caller can count it — the reclaim
    itself still proceeds. False when nothing fired."""
    try:
        faults.check("lease.reclaim")
    except Exception:  # noqa: BLE001 — an injected reclaim fault is a
        # modeled hiccup, not a crash: reclaim runs in connection
        # teardown, which must never throw
        return True
    return False


def release_worker_leases(chunk: Chunk, worker: int) -> List[Lease]:  # concurrency: called with the owning control plane's _cv held (coordinator or fleet plane — one instance never spans both)
    """Pop every lease `worker` holds on `chunk`, releasing the
    canonical journal for any it held (the writer is known dead, so the
    re-dispatch may resume it). Call with the owning lock held."""
    held = [a for a, ls in chunk.leases.items() if ls.worker == worker]
    popped = []
    for a in held:
        lease = chunk.leases.pop(a)
        if lease.canonical:
            chunk.journal_held = False
        popped.append(lease)
    return popped
