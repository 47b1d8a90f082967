"""The fleet's control-plane core, shared by the serve daemon and the
distrib coordinator.

A copy of the JAX package's fleet (racon_tpu/fleet):

* ``queues`` — per-tenant FIFOs with priority lanes served in
  round-robin rotation (the scheduler's fairness);
* ``leases`` — the TTL lease and chunk lifecycle of the distrib
  coordinator and the fleet plane;
* ``pool``   — ``ElasticPool``: worker-process lifecycle (spawn, reap,
  drain, kill) with the ``pool.scale_up`` / ``pool.scale_down`` fault
  points; the coordinator runs it at a fixed size, the plane scales it;
* ``plane``  — ``FleetPlane``: many jobs, one chunk queue, one elastic
  worker pool (imported from ``fleet.plane``: it needs the distrib
  modules).

The JAX package's ``RACON_TPU_FLEET_*`` knobs are arguments here; their
defaults are these constants: the pool's floor (``DEFAULT_MIN_WORKERS``)
and ceiling (``DEFAULT_MAX_WORKERS``; 0 in the daemon keeps the device
lane in-process), the autoscaler's queueing-p95 trigger
(``DEFAULT_SCALE_P95_MS``), work stealing (``DEFAULT_STEAL``) and the
per-tenant quota (``DEFAULT_TENANT_QUOTA``; 0: unlimited).
"""

from .leases import Chunk, Lease  # noqa: F401
from .pool import ElasticPool  # noqa: F401
from .queues import TenantQueues  # noqa: F401

DEFAULT_MIN_WORKERS = 1
DEFAULT_MAX_WORKERS = 0
DEFAULT_SCALE_P95_MS = 250.0
DEFAULT_STEAL = True
DEFAULT_TENANT_QUOTA = 0
