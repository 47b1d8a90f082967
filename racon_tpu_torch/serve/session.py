"""Resident polishing session: one process, many polish jobs.

A copy of the JAX package's session (racon_tpu/serve/session.py) for the
port's backends: "cuda" (``TorchPolisher`` with the session's ``device``
and ``poa_kernel``; ``device="cpu"`` runs the kernels' plain versions)
and "host" (``CpuPolisher``, the native pipeline).

A ``PolishSession`` keeps what is expensive to set up and safe to share
— the built and loaded CUDA libraries (``ops/cuda_lib``), the kernels
CUDA has loaded, the caching allocator's blocks and the feeder's pinned
buffers, all of which outlive the polisher that used them — and builds
what must be fresh per request through ``polisher.create_polisher``:
journal, run report, trace and fault schedule. ``warm()`` builds and
loads the libraries once at start, so even the first job builds and
loads nothing.

Each job starts from clean process-wide state: the polisher's
constructor resets the fault schedule, the obs state and the trace's
device track (``polisher._reset_run_state``), and the session sets the
launch counts to 0 and drops any ``cuda_lib.LAUNCH_EVENTS`` list first,
so a job's trace, report and ``launches`` hold only its own work. That
state is module-global, so in-process jobs must not overlap: ``run_job``
holds a lock and the scheduler (scheduler.py) provides the concurrency
by queueing. Each job runs inside its own directory
(``<workdir>/jobs/<job_id>/``) holding its journal, trace, report and
polished output.

Defaults of the daemon's settings, each its JAX knob's default:
``DEFAULT_PORT`` (``RACON_TPU_SERVE_PORT``), ``DEFAULT_QUEUE_DEPTH``,
``DEFAULT_MAX_JOBS``, ``DEFAULT_WARMUP``, ``DEFAULT_WINDOW_BUDGET``,
``DEFAULT_METRICS_PORT`` (``RACON_TPU_METRICS_PORT``) and
``DEFAULT_MEMORY_BUDGET_MB`` (``RACON_TPU_MEM_BUDGET_MB``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .. import fingerprint, obs
from ..obs import context, flight, ledger
from ..ops.poa_driver import DEFAULT_POA_KERNEL, kernel_for
from ..polisher import BACKENDS, create_polisher
from ..resilience import budget

DEFAULT_PORT = 0
DEFAULT_QUEUE_DEPTH = 16
DEFAULT_MAX_JOBS = 64
DEFAULT_WARMUP = True
DEFAULT_WINDOW_BUDGET = 0
DEFAULT_METRICS_PORT = 0
DEFAULT_MEMORY_BUDGET_MB = 0

#: Polish parameters a job may override, with the CLI defaults — the
#: same contract as `racon_tpu_torch.cli` flags, so a serve job and a
#: CLI run with equal parameters produce byte-identical output.
POLISH_ARG_DEFAULTS = {
    "window_length": 500,
    "quality_threshold": 10.0,
    "error_threshold": 0.3,
    "trim": True,
    "fragment_correction": False,
    "match": 3,
    "mismatch": -5,
    "gap": -4,
    "num_threads": 1,
}


class JobCancelled(RuntimeError):
    """Raised inside run_job when the job's cancel event is set."""


@dataclass
class JobSpec:
    """One polish request: input paths + polish parameters.

    ``args`` overrides ``POLISH_ARG_DEFAULTS`` (unknown keys are a
    submit-time error, not a mid-run crash).  ``job_id`` is assigned by
    the scheduler when empty.  ``window_budget`` overrides the daemon's
    window budget for this job (0 = daemon default).
    """

    sequences: str
    overlaps: str
    target: str
    args: dict = field(default_factory=dict)
    include_unpolished: bool = False
    backend: str = ""
    job_id: str = ""
    submitter: str = "local"
    window_budget: int = 0
    #: Priority lane (higher serves first; fairness still rotates
    #: tenants within a lane — fleet/queues.py).
    priority: int = 0
    #: Optional trace context ({"trace_id", "parent"}) from the
    #: submitter, so the job's spans parent under the caller's timeline
    #: when the traces are merged (obs/context.py).
    trace: Optional[dict] = None

    def validate(self) -> None:
        unknown = sorted(set(self.args) - set(POLISH_ARG_DEFAULTS))
        if unknown:
            raise ValueError(
                f"unknown polish arg(s) {', '.join(unknown)}; allowed: "
                f"{', '.join(sorted(POLISH_ARG_DEFAULTS))}")
        if self.backend and self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; allowed: "
                             f"{', '.join(BACKENDS)}")
        for label, path in (("sequences", self.sequences),
                            ("overlaps", self.overlaps),
                            ("target", self.target)):
            if not path or not os.path.isfile(path):
                raise ValueError(f"{label} file not found: {path!r}")
        if self.job_id and ("/" in self.job_id or self.job_id.startswith(".")):
            raise ValueError(f"invalid job id {self.job_id!r}")

    def polish_args(self) -> dict:
        """racon's keyword arguments for create_polisher: defaults +
        overrides."""
        merged = dict(POLISH_ARG_DEFAULTS)
        merged.update(self.args)
        return merged

    def as_dict(self) -> dict:
        return {
            "sequences": self.sequences,
            "overlaps": self.overlaps,
            "target": self.target,
            "args": dict(self.args),
            "include_unpolished": self.include_unpolished,
            "backend": self.backend,
            "job_id": self.job_id,
            "submitter": self.submitter,
            "window_budget": self.window_budget,
            "priority": self.priority,
            "trace": dict(self.trace) if self.trace else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "JobSpec":
        unknown = sorted(set(d) - {
            "sequences", "overlaps", "target", "args", "include_unpolished",
            "backend", "job_id", "submitter", "window_budget", "priority",
            "trace"})
        if unknown:
            raise ValueError(f"unknown job field(s): {', '.join(unknown)}")
        for key in ("sequences", "overlaps", "target"):
            if not isinstance(d.get(key), str) or not d.get(key):
                raise ValueError(f"job field {key!r} must be a non-empty "
                                 f"path string")
        args = d.get("args") or {}
        if not isinstance(args, dict):
            raise ValueError("job field 'args' must be an object")
        return cls(
            sequences=d["sequences"],
            overlaps=d["overlaps"],
            target=d["target"],
            args=dict(args),
            include_unpolished=bool(d.get("include_unpolished", False)),
            backend=str(d.get("backend") or ""),
            job_id=str(d.get("job_id") or ""),
            submitter=str(d.get("submitter") or "local"),
            window_budget=int(d.get("window_budget") or 0),
            priority=int(d.get("priority") or 0),
            trace=(dict(d.get("trace"))
                   if isinstance(d.get("trace"), dict) else None),
        )


def _journal_replayed(report) -> int:
    """Units the journal replayed across all phases of a resumed run."""
    return sum(rep.served.get("journal", 0)
               for rep in report.phases.values())


class PolishSession:
    """Resident session.  Thread-safe: ``run_job`` serializes in-process
    jobs (the per-run state the polisher constructors reset is
    module-global); the loaded kernels are shared across jobs — that
    sharing IS the hot path."""

    def __init__(self, workdir: str, backend: str = "cuda",
                 device="cuda", poa_kernel: str = DEFAULT_POA_KERNEL):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        kernel_for(poa_kernel)
        self.workdir = workdir
        self.backend = backend
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda or cpu, got {device!r}")
        self.poa_kernel = poa_kernel
        self.jobs_run = 0
        self.warmed = False
        self.warm_wall_s = 0.0
        self._lock = threading.Lock()
        os.makedirs(os.path.join(workdir, "jobs"), exist_ok=True)

    # -- layout ------------------------------------------------------------

    def job_dir(self, job_id: str) -> str:
        return fingerprint.serve_job_paths(self.workdir, job_id)["dir"]

    def _bind_device(self) -> None:
        """Make the session's card the calling thread's current device
        (the scheduler's device lane runs jobs on a thread of its own)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)

    # -- startup warm-up ---------------------------------------------------

    def warm(self) -> float:
        """Build the CUDA libraries where they are stale and load every
        one, so that no job's ``kernel_builds`` counts a build or a load.
        The cuda backend on the card only (on the CPU there is nothing to
        load); returns the wall seconds spent.

        Unlike the JAX daemon, which compiles one XLA program per window
        geometry and score set, nothing here depends on the jobs' window
        lengths or scores. Nor does the warm-up launch anything: a
        ``--no-warm`` daemon's first main-cell job was no slower than a
        warmed daemon's on an H100, so lazy kernel loading and the
        allocator's first blocks cost less than a job's spread."""
        if self.backend != "cuda" or self.device.type != "cuda":
            return 0.0
        from ..ops import cuda_lib

        with self._lock:
            self._bind_device()
            t0 = time.monotonic()
            cuda_lib.build_all()
            for name in cuda_lib.SOURCES:
                cuda_lib.load(name)
            self.warm_wall_s = round(time.monotonic() - t0, 4)
            self.warmed = True
        return self.warm_wall_s

    # -- job execution -----------------------------------------------------

    def run_job(self, spec: JobSpec,
                cancel_event: Optional[threading.Event] = None) -> dict:
        """Run one polish job to completion inside its job directory.

        Serialized: only one in-process job runs at a time (the
        scheduler queues the rest).  The job's journal is always armed
        with resume semantics — a re-submitted job whose previous run
        was preempted replays the journaled prefix instead of
        recomputing, and still produces byte-identical output."""
        with self._lock:
            return self._run_job_locked(spec, cancel_event)

    def _run_job_locked(self, spec: JobSpec, cancel) -> dict:
        from ..ops import cuda_lib

        job_id = spec.job_id or f"job{self.jobs_run:04d}"
        backend = spec.backend or self.backend
        paths = fingerprint.serve_job_paths(self.workdir, job_id, backend)
        jd = paths["dir"]
        os.makedirs(jd, exist_ok=True)
        kw = dict(spec.polish_args())
        if backend == "cuda":
            kw.update(device=self.device, poa_kernel=self.poa_kernel)
            self._bind_device()

        cold = self.jobs_run == 0
        t0 = time.monotonic()
        if cancel is not None and cancel.is_set():
            raise JobCancelled(job_id)
        # the job's launches alone: counts from 0, no caller's event list
        cuda_lib.reset_launches()
        cuda_lib.LAUNCH_EVENTS = None
        # trace-context propagation: a submitter's {trace_id, parent}
        # pair (JobSpec.trace) is activated before create_polisher so
        # the job's fresh tracer stamps it; a flight dump from this job
        # lands in the job directory
        context.activate(spec.trace)
        flight.set_dir(jd)
        try:
            polisher = create_polisher(
                spec.sequences, spec.overlaps, spec.target, backend=backend,
                journal_path=paths["journal"], resume_journal=True,
                trace_path=paths["trace"], **kw)
            # the constructor armed this request's tracer; the instant
            # event tags the per-request trace with its job id
            obs.event("serve.job", job=job_id, backend=backend, cold=cold,
                      submitter=spec.submitter)
            polisher.initialize()
            if cancel is not None and cancel.is_set():
                # phase boundary: alignment is done and journaled; the
                # consensus phase has not started. A re-run resumes here.
                raise JobCancelled(job_id)
            out = polisher.polish(not spec.include_unpolished)
            kernel_builds = obs.counter_total("kernel.builds.")
            launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}

            with open(paths["output"], "w") as f:
                for name, data in out:
                    f.write(f">{name}\n{data}\n")
            summary = polisher.report.summary()
            # the compute side's latency-ledger fragment: per-stage
            # seconds from this run's report plus the build and replay
            # overlays, persisted with the report and shipped in the
            # result for the scheduler's job ledger
            stage_s = ledger.stage_seconds(summary)
            stage_s.update(ledger.overlay_seconds(obs.snapshot()))
            polisher.report.ledger = {"job": job_id, "stage_s": stage_s}
            report_doc = dict(polisher.report.as_dict())
            report_doc["job_id"] = job_id
            with open(paths["report"], "w") as f:
                json.dump(report_doc, f, indent=1)
                f.write("\n")

            self.jobs_run += 1
            obs.telemetry_tick(jobs_run=self.jobs_run, job=job_id)
            return {
                "job_id": job_id,
                "backend": backend,
                "cold": cold,
                "wall_s": round(time.monotonic() - t0, 4),
                "records": len(out),
                "polished_bp": sum(len(data) for _, data in out),
                "kernel_builds": kernel_builds,
                "journal_replayed": _journal_replayed(polisher.report),
                "output": paths["output"],
                "report": paths["report"],
                "trace": paths["trace"],
                # bounded span shipment: a tracing submitter can absorb
                # this job's spans into its own timeline
                "obs": obs.shipment(),
                "summary": summary,
                "ledger": {"stage_s": dict(stage_s)},
                # the kernels this job launched, its consensus batches
                # and the daemon's RSS after it
                "launches": launches,
                "batches": polisher.stats.get("consensus", {}).get(
                    "batches"),
                "rss_mb": round(budget.rss_mb(), 1),
            }
        except JobCancelled:
            raise
        except Exception as e:  # noqa: BLE001 - post-mortem breadcrumb;
            # the scheduler owns the failure handling
            flight.dump("job_error", job=job_id,
                        error=f"{type(e).__name__}: {e}")
            raise
        finally:
            # scoped teardown: re-write the (now complete) per-job trace
            # and disarm, so the next job can never append into this
            # job's file
            try:
                obs.release(write=True)
            except Exception as e:  # noqa: BLE001 - a sticky CUDA error
                # fails the device track's flush too; the job's own error
                # is the one to report
                obs.reset()
                flight.record("serve.trace_lost", job=job_id,
                              error=f"{type(e).__name__}: {e}")
            context.clear()

    def stats(self) -> dict:
        """Plain counters (never touches the card: the daemon's
        connection threads call it)."""
        return {
            "backend": self.backend,
            "device": str(self.device),
            "poa_kernel": self.poa_kernel,
            "jobs_run": self.jobs_run,
            "warmed": self.warmed,
            "warm_wall_s": self.warm_wall_s,
            "workdir": self.workdir,
        }
