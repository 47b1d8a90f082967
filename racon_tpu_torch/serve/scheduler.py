"""Queue-based job scheduler: N concurrent submissions, one card.

A copy of the JAX package's scheduler (racon_tpu/serve/scheduler.py).

With a fleet plane (``plane``, fleet/plane.py; ``cli serve --fleet-max``)
the device lane hands each job to the plane and goes straight back to
its queue: the plane splits the job into chunks, which its worker
processes polish on the card, several jobs in flight at once. The
plane's ``on_done`` callback finishes the job; a job the plane reports
failed fails with its error (the plane's local floor serves no chunk of
a job on the card: fleet/plane.py). Without a plane the device lane runs
each job in this process.

Concurrency model: in-process polishes cannot overlap (the per-run
state the polisher constructors reset is module-global — see
``polisher._reset_run_state``), so the **device lane** is one worker
thread draining a queue through ``PolishSession.run_job``.  The **host
lane** is a second worker running demoted jobs as ``python -m
racon_tpu_torch.cli --host`` subprocesses — the native pipeline, the
host backend: a demotion changes *where* a job runs, and its output is
the host backend's bytes (which on real reads can differ from the
card's: the host POA is racon's, not the kernels').  A job moves to the
host lane only at submit, by an admission decision: it is over the
window budget (``demoted_budget``) or sheds (``shed``, ``shed_memory``,
``shed_slo``).  The job's status carries ``lane`` and its ``demotions``
with their causes, ``stats`` counts each kind, and ``host_lane=False``
turns the lane off.

A job that the device lane has started never moves: where its run
raises (a kernel that fails to build or launch, or anything else), the
job fails with that error.  Unlike the JAX daemon, which re-runs such a
job on its host lane, the port never hands work that was meant for the
card to the CPU after the fact; nor does it re-run a job the fleet plane
failed.

Admission control bounds what the daemon will hold: a queue-depth cap on
not-yet-running jobs, a max-jobs cap on everything unfinished, an
optional per-tenant quota (``tenant_quota``), and a window budget
enforced in two steps — a job whose estimated window count exceeds the
budget is demoted to the host lane at submit time, and a job that fits
alone but would push the device lane's *aggregate* reserved windows
over the budget is **shed** to the host lane; when the host lane itself
is saturated the submit is rejected.  The ladder is always shed → host
lane → reject, in that order.  The estimate is file I/O and runs outside
the scheduler lock; the check-and-reserve against the aggregate happens
atomically under it, so concurrent submits cannot both squeeze into the
same budget headroom.

The ladder also has a **memory dimension** (resilience/budget.py): with
``memory_budget_mb`` above 0, every submit samples the daemon's own RSS
against watermarks at 80% and 95% of it.  The soft watermark sheds the
job to the host lane (``shed_memory`` — a subprocess's allocations die
with it, unlike the resident device lane's), the hard one rejects
outright (``rejected_memory``).  Fairness is per-submitter round-robin
with priority lanes (fleet/queues.py): each submitter has its own FIFOs;
the scheduler serves the highest priority present and rotates
submitters within it.

A failure in either lane is final and marks only that job failed — the
daemon and the rest of the queue keep running.

Persistence: the scheduler writes ``spec.json`` into the job directory
at admission and ``result.json`` at any terminal state.  A daemon killed
mid-run leaves specs without results; ``recover()`` re-queues them on
restart, and the per-job journal (session.py) turns the re-run into a
resume.  Graceful ``shutdown()`` finishes the running job, leaves queued
jobs unpersisted-as-terminal, and lets the next daemon pick them up.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from .. import fingerprint, obs
from ..fleet import DEFAULT_TENANT_QUOTA
from ..fleet.queues import TenantQueues
from ..obs import ledger as joblog
from ..obs import slo
from ..resilience import budget as membudget
from .session import (DEFAULT_MAX_JOBS, DEFAULT_MEMORY_BUDGET_MB,
                      DEFAULT_QUEUE_DEPTH, DEFAULT_WINDOW_BUDGET,
                      JobCancelled, JobSpec, PolishSession)

LANES = ("device", "host")
# the directory that holds racon_tpu_torch, for a child's import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child_env(env: Optional[dict] = None) -> dict:
    """`env` (default: this process's) with this racon_tpu_torch first
    on the import path, so that a ``python -m racon_tpu_torch...`` child
    runs this code from any working directory."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env
TERMINAL = ("done", "failed", "cancelled")


class AdmissionError(RuntimeError):
    """Submission rejected by admission control (queue full / at
    capacity / invalid spec reuse).  The client sees the message; the
    daemon state is untouched."""


def estimate_windows(target_path: str, window_length: int) -> Optional[int]:
    """Estimated window count for a draft: per contig,
    ceil(len / window_length) — the same fixed-size chunking the window
    builder applies.  None when the target cannot be sized cheaply
    (non-FASTA, unreadable) — the budget check then lets it through."""
    import gzip

    opener = (gzip.open if target_path.lower().endswith(".gz") else open)
    lens: List[int] = []
    try:
        with opener(target_path, "rt") as f:
            for line in f:
                if line.startswith(">"):
                    lens.append(0)
                elif line.startswith("@") and not lens:
                    return None   # FASTQ (or garbage): not sized here
                elif lens:
                    lens[-1] += len(line.strip())
    except (OSError, UnicodeDecodeError):
        return None
    if not lens:
        return None
    w = max(1, int(window_length))
    return sum(math.ceil(n / w) for n in lens if n > 0)


class Job:
    """One scheduled job and its lifecycle:
    queued -> running -> done | failed | cancelled."""

    def __init__(self, spec: JobSpec, job_id: str):
        self.spec = spec
        self.id = job_id
        self.state = "queued"
        self.lane = "device"
        self.result: Optional[dict] = None
        self.error: Optional[str] = None
        self.demotions: List[dict] = []
        self.cancel = threading.Event()
        self.done = threading.Event()
        self.t_submit = time.monotonic()
        self.t_start: Optional[float] = None
        self.t_end: Optional[float] = None
        # per-job latency ledger (obs/ledger.py): stamps submit now;
        # the scheduler stamps admit/dispatch/finish/result_ship as the
        # job moves, the compute side ships stage_s fragments back
        self.ledger = joblog.JobLedger(job_id, tenant=spec.submitter)

    def as_status(self) -> dict:
        now = time.monotonic()
        return {
            "job_id": self.id,
            "state": self.state,
            "lane": self.lane,
            "submitter": self.spec.submitter,
            "demotions": list(self.demotions),
            "error": self.error,
            "queued_s": round((self.t_start or now) - self.t_submit, 4),
            "running_s": (None if self.t_start is None else
                          round((self.t_end or now) - self.t_start, 4)),
        }


class Scheduler:
    def __init__(self, session: PolishSession,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 max_jobs: int = DEFAULT_MAX_JOBS,
                 window_budget: int = DEFAULT_WINDOW_BUDGET,
                 host_lane: bool = True,
                 plane=None,
                 tenant_quota: int = DEFAULT_TENANT_QUOTA,
                 memory_budget_mb: int = DEFAULT_MEMORY_BUDGET_MB):
        self.session = session
        # a FleetPlane, or None: the device lane runs in this process
        self.plane = plane
        self.queue_depth = queue_depth
        self.max_jobs = max_jobs
        self.window_budget = window_budget
        self.host_lane = host_lane
        self.tenant_quota = tenant_quota
        # the memory dimension's watermarks (80% and 95%, MemoryBudget's
        # defaults), sampled per submit; no background thread
        self.memory = membudget.MemoryBudget(memory_budget_mb)
        self._jobs: Dict[str, Job] = {}
        # lane -> per-tenant priority queues (fleet/queues.py)
        self._queues: Dict[str, TenantQueues] = {ln: TenantQueues()
                                                 for ln in LANES}
        # device-lane window reservations by job id: the aggregate the
        # shed check holds against, reserved at admit under _cv and
        # released when the job leaves the device lane
        self._reserved: Dict[str, int] = {}
        self.admission: Dict[str, int] = {}   # demoted/shed/rejected/...
        self._cv = threading.Condition()
        self._stop = False
        self._counter = 0
        self._workers: List[threading.Thread] = []
        # injectable for tests: () -> "ok"|"soft"|"hard" — the memory
        # dimension of the admission ladder (sampled OUTSIDE _cv)
        self.memory_source = self._memory_pressure

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        for lane in LANES:
            if lane == "host" and not self.host_lane:
                continue
            t = threading.Thread(target=self._worker, args=(lane,),
                                 name=f"serve-{lane}-lane", daemon=True)
            t.start()
            self._workers.append(t)

    def shutdown(self, wait: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop accepting work, finish the running job(s), exit the
        workers.  Queued jobs keep their spec.json and get no
        result.json — a restarted daemon re-queues them (recover()) and
        their journals turn the re-run into a resume."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if wait:
            for t in self._workers:
                t.join(timeout)

    def recover(self) -> List[str]:
        """Re-queue every job directory holding a spec.json without a
        result.json — the unfinished work of a previous daemon life.  A
        spec that no longer admits (inputs deleted, invalid) is marked
        failed so it cannot retry forever on every restart.

        Torn files never crash the restart path: a result.json a killed
        daemon left unparseable (or parseable but not an object) is
        discarded so the job counts as unfinished and re-queues from its
        spec; a spec.json torn the same way fails that one job with the
        usual recovery warning.  Either way the daemon comes up — the
        broad per-job except is the lattice-of-last-resort for whatever
        shape mid-write truncation produced."""
        jobs_root = os.path.join(self.session.workdir, "jobs")
        recovered = []
        for job_id in sorted(os.listdir(jobs_root) if
                             os.path.isdir(jobs_root) else ()):
            jd = os.path.join(jobs_root, job_id)
            spec_path = os.path.join(jd, "spec.json")
            if not os.path.isfile(spec_path):
                continue
            result_path = os.path.join(jd, "result.json")
            if os.path.isfile(result_path):
                if self._result_intact(result_path):
                    continue
                try:
                    os.remove(result_path)   # truncate-and-requeue
                except OSError:
                    continue   # unreadable AND undeletable: leave it
                print(f"[racon_tpu_torch::serve] WARNING: discarding torn "
                      f"result.json for job {job_id}; re-queueing",
                      file=sys.stderr)
            try:
                with open(spec_path) as f:
                    doc = json.load(f)
                if not isinstance(doc, dict):
                    raise ValueError(f"spec.json holds "
                                     f"{type(doc).__name__}, not an object")
                spec = JobSpec.from_dict(doc)
                spec.job_id = job_id  # concurrency: single-owner until submit() publishes it
                self.submit(spec)
                recovered.append(job_id)
            except Exception as e:  # noqa: BLE001 — a torn spec.json can
                # decode to anything; one damaged job directory must not
                # take down the restart path
                job = Job(JobSpec("", "", "", job_id=job_id), job_id)
                job.state = "failed"  # concurrency: job is thread-local until published under _cv below
                job.error = f"recovery failed: {type(e).__name__}: {e}"  # concurrency: thread-local, see above
                job.done.set()
                with self._cv:
                    self._jobs[job_id] = job
                self._persist_result(job)
                print(f"[racon_tpu_torch::serve] WARNING: cannot recover job "
                      f"{job_id}: {e}", file=sys.stderr)
        return recovered

    @staticmethod
    def _result_intact(path: str) -> bool:
        """Whether a result.json parses to an object — anything else is
        the torn tail of a write the dying daemon never finished."""
        try:
            with open(path) as f:
                return isinstance(json.load(f), dict)
        except (OSError, ValueError, json.JSONDecodeError):
            return False

    # -- submission / queries ----------------------------------------------

    def submit(self, spec: JobSpec) -> Job:
        spec.validate()
        # the size estimate is file I/O: run it BEFORE taking the lock
        # (a slow disk must not stall every other submit/finish), then
        # check-and-reserve atomically under it — two concurrent submits
        # can never both fit into the same budget headroom
        est = self._estimate(spec)
        # so is the memory sample: it reads /proc
        mem = self.memory_source()
        with self._cv:
            if self._stop:
                raise AdmissionError("daemon is shutting down")
            unfinished = sum(1 for j in self._jobs.values()
                             if j.state not in TERMINAL)
            if unfinished >= self.max_jobs:
                self._admission_count("rejected_capacity")
                raise AdmissionError(
                    f"at capacity: {unfinished} unfinished jobs "
                    f"(max_jobs={self.max_jobs})")
            queued = sum(len(q) for q in self._queues.values())
            if queued >= self.queue_depth:
                self._admission_count("rejected_queue_full")
                raise AdmissionError(
                    f"queue full: {queued} queued jobs "
                    f"(queue_depth={self.queue_depth})")
            if self.tenant_quota > 0:
                held = sum(1 for j in self._jobs.values()
                           if j.spec.submitter == spec.submitter
                           and j.state not in TERMINAL)
                if held >= self.tenant_quota:
                    self._admission_count("rejected_quota")
                    raise AdmissionError(
                        f"tenant quota: submitter {spec.submitter!r} "
                        f"holds {held} unfinished jobs (tenant_quota="
                        f"{self.tenant_quota})")
            job_id = spec.job_id
            if job_id:
                prior = self._jobs.get(job_id)
                if prior is not None and prior.state not in TERMINAL:
                    raise AdmissionError(f"job id {job_id!r} is already "
                                         f"{prior.state}")
            else:
                while True:
                    job_id = f"job{self._counter:04d}"
                    self._counter += 1
                    if job_id not in self._jobs:
                        break
                spec.job_id = job_id
            job = Job(spec, job_id)
            lane = self._admission_lane(job, est, mem)
            job.ledger.mark("admit")
            # instant event: the job wall's anchor in a merged trace
            # (pairs with serve.job.done in _finish)
            obs.event("serve.job.submit", job=job_id,
                      tenant=spec.submitter, lane=lane)
            self._jobs[job_id] = job
            self._enqueue(lane, job)
            self._persist_spec(job)
            self._cv.notify_all()
            return job

    def _estimate(self, spec: JobSpec) -> Optional[int]:
        """Window estimate for budget admission; None when the budget
        machinery does not apply to this spec.  Lock-free (file I/O)."""
        if not self.host_lane:
            return None
        if (spec.backend or self.session.backend) == "host":
            return None
        if (spec.window_budget or self.window_budget) <= 0:
            return None
        w = spec.polish_args()["window_length"]
        return estimate_windows(spec.target, w)

    def _memory_pressure(self) -> str:
        """The memory level for admission: the worse of the daemon's own
        RSS against its watermarks and, with a plane, the worst worker's
        RSS its telemetry last reported ("ok" without a budget). Runs
        outside _cv: it reads /proc and takes the plane's lock."""
        level = self.memory.poll(fault_check=False)
        if not self.memory.enabled or self.plane is None or \
                membudget.at_least(level, "hard"):
            return level
        tel = self.plane.fleet_telemetry()
        worst = max((float(s.get("rss_mb") or 0.0)
                     for s in tel.get("workers", {}).values()), default=0.0)
        if worst >= self.memory.hard_mb:
            return "hard"
        if worst >= self.memory.soft_mb:
            return "soft"
        return level

    def _admission_count(self, name: str, n: int = 1) -> None:
        # call with self._cv held
        self.admission[name] = self.admission.get(name, 0) + n

    def _admission_lane(self, job: Job, est: Optional[int],
                        mem: str = "ok") -> str:
        """Lane decision + window reservation (call with _cv held).
        The ladder: per-job budget demote, then aggregate shed, then —
        if the host lane cannot absorb the fallout either — reject.
        ``mem`` is the pre-sampled memory-pressure level: soft sheds to
        the host lane, hard rejects outright."""
        spec = job.spec
        if membudget.at_least(mem, "hard"):
            # the memory dimension's bottom rung: under a hard
            # watermark admitting anything degrades every lane
            self._admission_count("rejected_memory")
            raise AdmissionError(
                f"memory pressure: RSS at the hard watermark "
                f"(memory_budget_mb={self.memory.budget_mb}) — "
                f"resubmit later")
        if not self.host_lane:
            return "device"
        if (spec.backend or self.session.backend) == "host":
            # the in-process device lane has nothing to offer a host job
            job.lane = "host"
            return "host"
        budget = spec.window_budget or self.window_budget
        to_host: Optional[str] = None
        if membudget.at_least(mem, "soft"):
            # memory shed: the host-lane subprocess's allocations die
            # with it; the resident device lane's do not
            to_host = (f"shed (memory): RSS over the soft watermark "
                       f"(memory_budget_mb={self.memory.budget_mb})")
            self._admission_count("shed_memory")
        elif slo.engine().should_shed(spec.submitter):
            # SLO shed: the tenant's burn rate exceeds the shedding
            # threshold on both windows — stop piling work onto the
            # lane that is missing its targets (opt-in, default off)
            to_host = (f"shed (slo): burn rate over shed_burn="
                       f"{slo.engine().shed_burn:g} on both windows")
            self._admission_count("shed_slo")
        elif budget > 0 and est is not None:
            if est > budget:
                to_host = (f"window budget: ~{est} windows > "
                           f"budget {budget}")
                self._admission_count("demoted_budget")
            else:
                reserved = sum(self._reserved.values())
                if reserved + est > budget:
                    # the job fits alone but not on top of what the
                    # device lane already holds: shed it
                    to_host = (f"shed: ~{est} windows would push the "
                               f"device lane to {reserved + est} "
                               f"reserved > budget {budget}")
                    self._admission_count("shed")
        if to_host is None:
            if est is not None:
                self._reserved[job.id] = est
            return "device"
        if len(self._queues["host"]) >= self.queue_depth:
            # the bottom of the ladder: host lane saturated too
            self._admission_count("rejected_host_saturated")
            raise AdmissionError(
                f"host lane saturated ({len(self._queues['host'])} "
                f"queued) and the device lane is over budget — "
                f"resubmit later ({to_host})")
        job.lane = "host"
        job.demotions.append({"from": "device", "to": "host",
                              "cause": to_host})
        obs.event("serve.shed" if to_host.startswith("shed") else
                  "serve.demote", job=job.id, cause=to_host)
        return "host"

    def get(self, job_id: str) -> Job:
        with self._cv:
            job = self._jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job id {job_id!r}")
        return job

    def cancel(self, job_id: str) -> dict:
        """Cancel a job.  Queued: removed immediately.  Running: the
        cancel event is honored at the next phase boundary (device lane)
        or kills the subprocess (host lane); a device job that reaches
        completion first stays done — cancellation is best-effort once
        work is on the device."""
        job = self.get(job_id)
        with self._cv:
            if job.state == "queued":
                for lane in LANES:
                    self._queues[lane].remove(job.spec.submitter, job)
                self._reserved.pop(job.id, None)
                job.state = "cancelled"
                job.error = "cancelled while queued"
                job.t_end = time.monotonic()
                job.done.set()
                self._persist_result(job)
                return job.as_status()
        job.cancel.set()
        # a plane job: propagate outside _cv (the plane fires on_done ->
        # _finish, which takes _cv itself)
        if self.plane is not None and job.lane == "device":
            self.plane.cancel_job(job_id)
        return job.as_status()

    def stats(self) -> dict:
        """Counters read under the scheduler's lock; nothing here
        touches the card (the daemon's connection threads call it). With
        a plane, its snapshot under ``fleet``."""
        # the plane's snapshot takes the plane's lock: outside ours, so
        # that the two condition variables never nest
        fleet = self.plane.snapshot() if self.plane is not None else None
        with self._cv:
            by_state: Dict[str, int] = {}
            for j in self._jobs.values():
                by_state[j.state] = by_state.get(j.state, 0) + 1
            queued = {lane: len(q) for lane, q in self._queues.items()}
            admission = dict(self.admission)
            admission["reserved_windows"] = sum(self._reserved.values())
            admission["by_tenant"] = {
                lane: q.per_tenant() for lane, q in self._queues.items()}
            done = [j for j in self._jobs.values()
                    if isinstance(j.result, dict)]
        out = {
            "jobs": by_state,
            "queued": queued,
            "queue_depth": self.queue_depth,
            "max_jobs": self.max_jobs,
            "window_budget": self.window_budget,
            "admission": admission,
            "session": self.session.stats(),
            # recent metrics-snapshot ring (obs.telemetry_tick entries,
            # stamped per finished job) — what `--stats-watch` polls
            "telemetry": obs.telemetry(last=8),
            # the SLO engine's state and the finished jobs' latency
            # ledgers, summed by stage
            "slo": slo.engine().snapshot(),
            "ledger": joblog.summarize(
                j.result.get("ledger") for j in done),
        }
        if fleet is not None:
            out["fleet"] = fleet
        return out

    # -- queue mechanics (call with self._cv held) -------------------------

    def _enqueue(self, lane: str, job: Job) -> None:
        self._queues[lane].push(job.spec.submitter, job,
                                job.spec.priority)

    def _pop(self, lane: str) -> Optional[Job]:
        """Next job for a lane: highest priority present, round-robin
        among the submitters holding it (fleet/queues.py) — bursts from
        one client interleave with everyone else's jobs."""
        return self._queues[lane].pop()

    # -- workers -----------------------------------------------------------

    def _worker(self, lane: str) -> None:
        while True:
            with self._cv:
                job = self._pop(lane)
                while job is None:
                    if self._stop:
                        return
                    self._cv.wait(0.2)
                    job = self._pop(lane)
                job.state = "running"
                job.lane = lane
                job.t_start = time.monotonic()
                job.ledger.mark("dispatch")
            if lane == "device" and self.plane is not None:
                # the fleet: hand the job to the plane and go straight
                # back to the queue — several jobs in flight at once is
                # what makes cross-job stealing possible
                self._dispatch_to_plane(job)
                continue
            try:
                if lane == "device":
                    result = self.session.run_job(job.spec,
                                                  cancel_event=job.cancel)
                else:
                    result = self._run_host(job)
            except JobCancelled:
                self._finish(job, "cancelled", error="cancelled mid-run")
            except Exception as e:  # noqa: BLE001 — the job fails with
                # its error; the daemon and the rest of the queue keep
                # serving.  A device-lane job is never re-run on the host.
                self._finish(job, "failed",
                             error=f"{type(e).__name__}: {e}")
            else:
                self._finish(job, "done", result=result)

    def _dispatch_to_plane(self, job: Job) -> None:
        """Submit one popped job to the fleet plane, without blocking.
        The plane's on_done callback (off its lock, on a fleet thread)
        finishes the job: done, cancelled, or failed with the plane's
        error — never re-run on the host lane."""
        spec = job.spec

        def on_done(state: str, result: Optional[dict],
                    error: Optional[str]) -> None:
            if state == "done":
                self._finish(job, "done", result=result)
            elif state == "cancelled":
                self._finish(job, "cancelled",
                             error=error or "cancelled mid-run")
            else:
                self._finish(job, "failed", error=error or "fleet failure")

        try:
            self.plane.submit_job(
                job.id, spec.sequences, spec.overlaps, spec.target,
                spec.polish_args(), spec.include_unpolished,
                spec.backend or self.session.backend,
                workdir=self.session.job_dir(job.id),
                tenant=spec.submitter, priority=spec.priority,
                on_done=on_done)
        except Exception as e:  # noqa: BLE001 — a plane that cannot
            # admit (stopping, a duplicate id) fails the job
            self._finish(job, "failed", error=f"{type(e).__name__}: {e}")

    def _finish(self, job: Job, state: str, result: Optional[dict] = None,
                error: Optional[str] = None) -> None:
        job.ledger.mark("finish")
        if result is not None:
            self._fold_ledger(job, result)
            # the persisted copy cannot time its own write: result.json
            # carries the ledger without the result_ship stage; the wire
            # copy below is re-finalized after the persist
            result["ledger"] = job.ledger.as_dict()
        with self._cv:
            self._reserved.pop(job.id, None)
            job.state = state
            job.result = result
            job.error = error
            job.t_end = time.monotonic()
        # persist before signalling done: a waiter released by done.wait()
        # must find result.json on disk (clients read it immediately)
        self._persist_result(job)
        job.ledger.mark("result_ship")
        if result is not None:
            result["ledger"] = job.ledger.as_dict()
        obs.event("serve.job.done", job=job.id, tenant=job.spec.submitter,
                  state=state)
        if state != "cancelled":
            # SLO ingest: a cancel is a client decision, not a miss
            slo.engine().record(
                job.spec.submitter,
                (job.t_end or time.monotonic()) - job.t_submit,
                ok=(state == "done"))
        with self._cv:
            job.done.set()
            self._cv.notify_all()

    @staticmethod
    def _fold_ledger(job: Job, result: dict) -> None:
        """Absorb the compute side's stage durations into the job
        ledger: the result's ``ledger.stage_s`` fragment, else its
        run-report summary."""
        frag = result.get("ledger")
        if isinstance(frag, dict) and isinstance(frag.get("stage_s"), dict):
            job.ledger.merge_stage_s(frag["stage_s"])
        elif isinstance(result.get("summary"), dict):
            job.ledger.merge_stage_s(
                joblog.stage_seconds(result["summary"]))

    # -- host lane ---------------------------------------------------------

    def _run_host(self, job: Job) -> dict:
        """Run one job as a ``racon_tpu_torch.cli --host`` subprocess.
        Same flags as a user-run CLI invocation (the host backend's
        bytes), its own journal (host-fingerprinted) and per-request
        trace, stdout written to a .part file and renamed only on
        success.  The child never touches the card."""
        spec = job.spec
        a = spec.polish_args()
        # the host-keyed journal: a host-lane re-run resumes it and
        # never replays device records
        paths = fingerprint.serve_job_paths(self.session.workdir, job.id,
                                            "host")
        jd = paths["dir"]
        os.makedirs(jd, exist_ok=True)
        out_path = paths["output"]
        part_path = out_path + ".part"
        report_path = paths["report"]
        stderr_path = os.path.join(jd, "host.stderr.log")
        cmd = [sys.executable, "-m", "racon_tpu_torch.cli", "--host",
               "-w", str(a["window_length"]),
               "-q", str(a["quality_threshold"]),
               "-e", str(a["error_threshold"]),
               "-m", str(a["match"]), "-x", str(a["mismatch"]),
               "-g", str(a["gap"]), "-t", str(a["num_threads"]),
               "--report", report_path,
               "--resume-journal", paths["journal"],
               "--trace", paths["trace"]]
        if not a["trim"]:
            cmd.append("--no-trimming")
        if a["fragment_correction"]:
            cmd.append("-f")
        if spec.include_unpolished:
            cmd.append("-u")
        cmd += [spec.sequences, spec.overlaps, spec.target]

        t0 = time.monotonic()
        with open(part_path, "w") as out_f, open(stderr_path, "w") as err_f:
            proc = subprocess.Popen(cmd, stdout=out_f, stderr=err_f,
                                    env=child_env())
            while True:
                try:
                    rc = proc.wait(timeout=0.2)
                    break
                except subprocess.TimeoutExpired:
                    if job.cancel.is_set():
                        proc.kill()
                        proc.wait()
                        raise JobCancelled(job.id) from None
        if rc != 0:
            tail = ""
            try:
                with open(stderr_path) as f:
                    tail = f.read()[-400:].strip()
            except OSError:
                pass
            raise RuntimeError(f"host lane exited {rc}: {tail}")
        os.replace(part_path, out_path)

        records = polished_bp = 0
        with open(out_path) as f:
            for line in f:
                if line.startswith(">"):
                    records += 1
                else:
                    polished_bp += len(line.strip())
        replayed = 0
        stage_s: Dict[str, float] = {}
        try:
            with open(report_path) as f:
                rep = json.load(f)
            replayed = sum(ph.get("served", {}).get("journal", 0)
                           for ph in rep.get("phases", {}).values())
            # report phases carry per-tier wall splits — the same shape
            # RunReport.summary() ships, so the ledger fragment comes
            # straight off the subprocess's own report
            stage_s = joblog.stage_seconds(rep.get("phases"))
        except (OSError, json.JSONDecodeError, AttributeError):
            pass
        return {
            "job_id": job.id,
            "backend": "host",
            "cold": False,
            "wall_s": round(time.monotonic() - t0, 4),
            "records": records,
            "polished_bp": polished_bp,
            "kernel_builds": 0,
            "journal_replayed": replayed,
            "output": out_path,
            "report": report_path,
            "trace": os.path.join(jd, "trace.json"),
            "summary": None,
            "ledger": {"stage_s": stage_s},
        }

    # -- persistence (job dir = crash-safe source of truth) ----------------

    def _persist_spec(self, job: Job) -> None:
        jd = self.session.job_dir(job.id)
        try:
            os.makedirs(jd, exist_ok=True)
            # tmp + rename, like _persist_result: a daemon killed
            # mid-write must never leave a torn spec.json for recover()
            tmp = os.path.join(jd, "spec.json.tmp")
            with open(tmp, "w") as f:
                json.dump(job.spec.as_dict(), f, indent=1)
                f.write("\n")
            os.replace(tmp, os.path.join(jd, "spec.json"))
        except OSError as e:
            print(f"[racon_tpu_torch::serve] WARNING: cannot persist spec for "
                  f"{job.id}: {e}", file=sys.stderr)

    def _persist_result(self, job: Job) -> None:
        jd = self.session.job_dir(job.id)
        doc = {
            "job_id": job.id,
            "state": job.state,
            "lane": job.lane,
            "result": job.result,
            "error": job.error,
            "demotions": list(job.demotions),
        }
        try:
            os.makedirs(jd, exist_ok=True)
            tmp = os.path.join(jd, "result.json.tmp")
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1)
                f.write("\n")
            os.replace(tmp, os.path.join(jd, "result.json"))
        except OSError as e:
            print(f"[racon_tpu_torch::serve] WARNING: cannot persist result "
                  f"for {job.id}: {e}", file=sys.stderr)
