"""Per-job latency ledger: stage-level accounting of where a serve job's
wall time went.

A copy of the JAX package's ledger (racon_tpu/obs/ledger.py). Every job
the scheduler admits gets one :class:`JobLedger`. The scheduler records
**monotonic stage stamps** (submit, admit, dispatch, finish,
result-ship) as the job moves through it; the compute side — the
in-process session or the host lane's CLI child — reports **per-stage
durations** (parse/align/window_assign/poa/stitch plus journal replay
and kernel builds) derived from its run report: the port's
``RunReport`` phases ``alignment`` and ``consensus`` map onto ``align``
and ``poa`` (``_REPORT_STAGES``).

Stamps are ``time.monotonic_ns()``; the compute durations are relative
(seconds), so they need no re-basing.

The finalized ledger is a plain JSON-ready dict persisted into the
job's ``result.json``, surfaced in the job's report (``ledger``), and
its wall fed to the per-tenant SLO engine (``obs/slo.py``). Like the
tracer, the ledger observes timing only — it never touches sequences or
consensus bytes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

#: Canonical stage order of the ledger's ``stage_s`` decomposition.
#: ``queue``/``dispatch``/``result_ship`` are derived from the
#: scheduler's stamps; the rest are compute durations reported by the
#: session or the host lane.  ``journal_replay``/``kernel_build`` overlap the
#: compute phases they occur inside (replay substitutes for align/poa
#: work; builds happen within align/poa batches), so sums over STAGES
#: must exclude them — ``attributed_s`` below does.
STAGES = ("queue", "dispatch", "journal_replay", "kernel_build",
          "parse", "align", "window_assign", "poa", "stitch",
          "result_ship")

#: Stages whose durations are additive pieces of the job wall.
_ADDITIVE = ("queue", "dispatch", "parse", "align", "window_assign",
             "poa", "stitch", "result_ship")

#: run-report phase name -> ledger stage name (the report uses racon's
#: phase vocabulary; the ledger uses obs.PHASES vocabulary).
_REPORT_STAGES = {"parse": "parse", "alignment": "align",
                  "window_assign": "window_assign", "consensus": "poa",
                  "stitch": "stitch"}


def stage_seconds(summary: dict) -> Dict[str, float]:
    """Ledger ``stage_s`` fragment from a ``RunReport.summary()`` dict:
    per-phase wall seconds mapped onto the canonical stage names.
    Unknown/malformed entries are skipped — a ledger is advisory."""
    out: Dict[str, float] = {}
    if not isinstance(summary, dict):
        return out
    for phase, rep in summary.items():
        stage = _REPORT_STAGES.get(phase)
        if stage is None or not isinstance(rep, dict):
            continue
        # per-phase wall is a tier -> seconds split (ls/host/journal/...):
        # the ledger wants the phase total, whichever tiers served it
        walls = rep.get("wall_s")
        if isinstance(walls, dict):
            total = 0.0
            for s in walls.values():
                try:
                    total += float(s)
                except (TypeError, ValueError):
                    continue
            out[stage] = round(total, 6)
        else:
            try:
                out[stage] = round(float(walls or 0.0), 6)
            except (TypeError, ValueError):
                continue
    return out


#: metrics-histogram name -> overlay stage: builds/replays happen
#: *inside* the compute phases, so these land in the non-additive
#: overlay stages of STAGES.
_OVERLAY_HISTS = {"span_us.kernel.build": "kernel_build",
                  "span_us.journal.replay": "journal_replay"}


def overlay_seconds(snapshot: Optional[dict]) -> Dict[str, float]:
    """Overlay-stage seconds (kernel builds, journal replay) from an
    ``obs.snapshot()`` metrics dict — the span_us histogram sums carry
    the totals.  Empty when disarmed or the spans never fired."""
    out: Dict[str, float] = {}
    hists = (snapshot or {}).get("histograms")
    if not isinstance(hists, dict):
        return out
    for hname, stage in _OVERLAY_HISTS.items():
        h = hists.get(hname)
        if not isinstance(h, dict):
            continue
        try:
            total = float(h.get("sum") or 0.0)
        except (TypeError, ValueError):
            continue
        if total > 0:
            out[stage] = round(total / 1e6, 6)
    return out


class JobLedger:
    """Stage stamps + per-stage durations for one job.  Thread-safe:
    the scheduler stamps from the submit connection thread and the lane
    workers."""

    def __init__(self, job_id: str, tenant: str = ""):
        self.job_id = job_id
        self.tenant = tenant
        self._lock = threading.Lock()
        self._marks: Dict[str, int] = {}       # stage -> monotonic_ns
        self._stage_s: Dict[str, float] = {}   # stage -> seconds
        self.mark("submit")

    def mark(self, stage: str, t_ns: Optional[int] = None) -> None:
        """Record the first time ``stage`` is reached (idempotent, so a
        retried dispatch keeps the original stamp)."""
        with self._lock:
            self._marks.setdefault(
                stage, time.monotonic_ns() if t_ns is None else int(t_ns))

    def add_stage(self, stage: str, seconds: float) -> None:
        """Accumulate a compute-stage duration."""
        try:
            s = float(seconds)
        except (TypeError, ValueError):
            return
        if s < 0:
            return
        with self._lock:
            self._stage_s[stage] = self._stage_s.get(stage, 0.0) + s

    def merge_stage_s(self, stage_s: dict) -> None:
        """Absorb a session or host-lane ``stage_s`` fragment (the shape
        :func:`stage_seconds` returns; rides the job's result)."""
        if not isinstance(stage_s, dict):
            return
        for stage, s in stage_s.items():
            if isinstance(stage, str):
                self.add_stage(stage, s)

    def as_dict(self) -> dict:
        """The finalized JSON-ready ledger.  ``marks`` are seconds
        relative to submit; interval stages (queue/dispatch/result_ship)
        are derived from the stamps; ``unattributed_s`` is the part of
        the wall the additive stages do not explain — reported, never
        hidden."""
        with self._lock:
            marks = dict(self._marks)
            stage_s = dict(self._stage_s)
        t0 = marks.get("submit", 0)

        def rel(stage: str) -> Optional[float]:
            t = marks.get(stage)
            return None if t is None else round((t - t0) / 1e9, 6)

        def between(a: str, b: str) -> Optional[float]:
            ta, tb = marks.get(a), marks.get(b)
            if ta is None or tb is None:
                return None
            return max(0.0, (tb - ta) / 1e9)

        queue = between("admit", "dispatch")
        if queue is not None:
            stage_s["queue"] = round(
                stage_s.get("queue", 0.0) + queue, 6)
        ship = between("finish", "result_ship")
        if ship is not None:
            stage_s["result_ship"] = round(
                stage_s.get("result_ship", 0.0) + ship, 6)
        wall = between("submit", "result_ship")
        if wall is None:
            wall = between("submit", "finish")
        attributed = sum(stage_s.get(k, 0.0) for k in _ADDITIVE)
        doc = {
            "job": self.job_id,
            "tenant": self.tenant,
            "marks": {k: rel(k) for k in sorted(marks)},
            "stage_s": {k: round(stage_s[k], 6)
                        for k in STAGES if k in stage_s},
            "wall_s": None if wall is None else round(wall, 6),
        }
        if wall is not None:
            doc["attributed_s"] = round(attributed, 6)
            doc["unattributed_s"] = round(max(0.0, wall - attributed), 6)
        return doc


def summarize(ledgers) -> Optional[dict]:
    """Aggregate finalized ledger dicts (one per job) into the compact
    per-stage summary the load test reports: total seconds per stage, job
    count, and the total/unattributed walls.  Returns None when there
    is nothing to aggregate."""
    totals: Dict[str, float] = {}
    wall = unattributed = 0.0
    n = 0
    for led in ledgers or ():
        if not isinstance(led, dict):
            continue
        stage_s = led.get("stage_s")
        if not isinstance(stage_s, dict):
            continue
        n += 1
        for stage, s in stage_s.items():
            try:
                totals[stage] = totals.get(stage, 0.0) + float(s)
            except (TypeError, ValueError):
                continue
        try:
            wall += float(led.get("wall_s") or 0.0)
            unattributed += float(led.get("unattributed_s") or 0.0)
        except (TypeError, ValueError):
            continue
    if not n:
        return None
    return {"jobs": n,
            "stage_s": {k: round(totals[k], 6) for k in sorted(totals)},
            "wall_s": round(wall, 6),
            "unattributed_s": round(unattributed, 6)}
