"""The fleet's shared pieces that the serve daemon needs.

The JAX package's fleet (racon_tpu/fleet) gives the serve scheduler and
its distributed coordinator one control-plane core. The port has the
part the resident daemon uses:

* ``queues`` — per-tenant FIFOs with priority lanes served in
  round-robin rotation (the scheduler's fairness);
* ``DEFAULT_TENANT_QUOTA`` — unfinished jobs one submitter may hold (0:
  unlimited), the JAX package's ``RACON_TPU_FLEET_TENANT_QUOTA``
  default; the scheduler takes it as an argument.

The plane, the worker pool and the leases wait for the port's
distributed modules.
"""

from .queues import TenantQueues  # noqa: F401

DEFAULT_TENANT_QUOTA = 0
