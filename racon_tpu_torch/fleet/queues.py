"""Per-tenant FIFOs with priority lanes, served in round-robin rotation.

A copy of the JAX package's queues (racon_tpu/fleet/queues.py).

This is the serve scheduler's fairness structure (one FIFO per
submitter, submitters served in rotation so one flooding client cannot
starve the rest) extracted and generalized with priority lanes: within
a queue set, the highest priority present anywhere is served first, and
round-robin fairness applies among the tenants that have work at that
priority.  Priority orders service, fairness orders tenants — a
high-priority flood from one tenant still interleaves with other
tenants' high-priority work, and only outranks lower lanes.

Not internally locked: its caller (the serve scheduler) serializes
access under its own condition variable.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional


class TenantQueues:
    """Tenant -> priority -> FIFO, with a tenant rotation per pop."""

    def __init__(self) -> None:
        self._q: Dict[str, Dict[int, deque]] = {}
        self._rr: List[str] = []   # tenant rotation, front = next served

    def push(self, tenant: str, item, priority: int = 0) -> None:
        lanes = self._q.get(tenant)
        if lanes is None:
            lanes = self._q[tenant] = {}
            self._rr.append(tenant)
        q = lanes.get(priority)
        if q is None:
            q = lanes[priority] = deque()
        q.append(item)

    def pop(self):
        """Next item: the highest priority with queued work anywhere;
        among tenants holding that priority, the first in the rotation.
        The served tenant moves to the back of the rotation."""
        best: Optional[int] = None
        for lanes in self._q.values():
            for prio, q in lanes.items():
                if q and (best is None or prio > best):
                    best = prio
        if best is None:
            return None
        for i, tenant in enumerate(self._rr):
            q = self._q[tenant].get(best)
            if q:
                self._rr.append(self._rr.pop(i))
                return q.popleft()
        return None

    def remove(self, tenant: str, item) -> bool:
        """Remove a specific queued item (cancellation); True if found."""
        lanes = self._q.get(tenant)
        if not lanes:
            return False
        for q in lanes.values():
            if item in q:
                q.remove(item)
                return True
        return False

    def __len__(self) -> int:
        return sum(len(q) for lanes in self._q.values()
                   for q in lanes.values())

    def queued_for(self, tenant: str) -> int:
        return sum(len(q) for q in self._q.get(tenant, {}).values())

    def per_tenant(self) -> Dict[str, int]:
        """Queued-item counts by tenant (zero-count tenants included —
        they stay in the rotation once seen)."""
        return {t: self.queued_for(t) for t in self._rr}
