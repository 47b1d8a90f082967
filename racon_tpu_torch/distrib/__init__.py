"""Polishing with a fleet of worker processes: ``racon_tpu_torch distrib``.

A copy of the JAX package's distrib (racon_tpu/distrib): a coordinator
(coordinator.py) splits the target FASTA into contig chunks and farms
them out to worker processes (worker.py) over the serve wire format,
with TTL leases, heartbeat renewal, backoff re-dispatch, speculative
duplicates of stragglers, per-chunk journal resume, and a fleet → local
rung when the fleet shrinks to zero. The ordered gather keeps the output
the single-process polish's bytes. Each worker polishes on the card
with the port's kernels, holding 1 / (the fleet's size) of its memory.
"""

from ..fleet.leases import Chunk, Lease
from .common import WireError
from .coordinator import Coordinator

__all__ = ["Chunk", "Coordinator", "Lease", "WireError"]
