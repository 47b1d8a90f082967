"""Polishing as a service: the resident daemon of racon_tpu_torch.

The JAX package's serve layer (racon_tpu/serve) ported: every CLI run
pays the process start, the kernels' build and load, and the allocator's
first blocks; this package keeps that state resident and streams jobs
through it.

* ``session``   — PolishSession: one process, many polishes. The CUDA
  libraries stay loaded and the kernels stay loaded on the card across
  jobs; the daemon builds and loads them once at start
  (``PolishSession.warm``); per-request state (journal, report,
  trace, fault schedule, launch counts) is isolated per job directory.
* ``scheduler`` — queue-based scheduler multiplexing N concurrent jobs
  onto one card: admission control (queue depth, max jobs, window
  budget, memory), per-submitter round-robin fairness, and a host lane
  (``racon_tpu_torch.cli --host`` children) for jobs over the window
  budget or shed at submit — each such move recorded in the job's
  status and counted in ``stats``. A device-lane job that raises fails.
* ``server`` / ``client`` — localhost TCP daemon speaking a newline-JSON
  protocol (ping/submit/status/result/cancel/stats/metrics/shutdown) and
  the thin client. Each request carries its own crash-safe journal, so a
  job preempted with its daemon resumes on the daemon's restart.
* ``loadtest``  — concurrent synthetic-job harness reporting throughput
  and p50/p95/p99 latency plus the cold-first-job vs warm-job delta.

Entry points: ``python -m racon_tpu_torch.serve`` or ``python -m
racon_tpu_torch.cli serve`` (daemon), ``python -m
racon_tpu_torch.serve.loadtest`` (harness). Left out of the JAX
package's: the fleet plane (its ``--fleet-*`` flags), the load test's
``--docs``, the daemon's per-geometry warm-up (``--warm-window``) and its
warm-up scores (``-m -x -g``), which configure nothing on the card.
"""

from .client import ServeClient, ServeError
from .scheduler import AdmissionError, Scheduler
from .server import ServeDaemon
from .session import JobCancelled, JobSpec, PolishSession

__all__ = [
    "AdmissionError",
    "JobCancelled",
    "JobSpec",
    "PolishSession",
    "Scheduler",
    "ServeClient",
    "ServeDaemon",
    "ServeError",
]
