"""Critical-path attribution over a merged fleet trace.

A copy of the JAX package's racon_tpu/obs/critpath.py. ``obs merge``
folds the plane's or coordinator's trace and the per-chunk worker traces
onto one monotonic timeline; this module walks the
``distrib.dispatch`` -> ``distrib.chunk`` span parenting that
``obs fleet`` validates and answers the question the aggregate p99
cannot: *where did a slow job's wall time go?*

Per chunk, the decomposition is interval accounting inside the chunk
span (queue wait from the dispatch event to the span start, a
``setup`` prefix before the first ``phase.*`` span, the phase spans
themselves, a ``teardown`` suffix, and an explicit ``gap`` remainder —
never hidden).  ``journal.replay`` / ``kernel.build`` spans overlap
the phases they run inside, so they are reported as informational
sub-attribution, not added to the sum.

Per job, the **critical path** ends at the job's last-finishing chunk:
control-plane lead-in (submit -> that chunk's dispatch, from the
scheduler's ``serve.job.submit`` events when present), the chunk's own
decomposition, and the gather tail (chunk end -> ``serve.job.done``).
Stage contributions therefore sum to the job wall by construction,
with the residue reported as ``unattributed`` — the exit-3 gate.

The compute stages are cross-checked against the analytic cost model
(``costmodel.predict_from_counters`` over the counters ``obs merge``
aggregates from the input traces); the cross-check is informational
here — ``obs validate`` owns that gate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from . import PHASES
from . import costmodel

#: Stage order of the per-job decomposition (control -> compute -> tail).
JOB_STAGES = ("admit_queue", "queue", "setup", "parse", "align",
              "window_assign", "poa", "stitch", "teardown", "gap",
              "gather")

#: Informational overlapping sub-stages (not part of the additive sum).
OVERLAY_STAGES = ("journal_replay", "kernel_build")

_OVERLAY_SPANS = {"journal.replay": "journal_replay",
                  "kernel.build": "kernel_build"}


def percentile(values: List[float], q: float) -> Optional[float]:
    """Linearly interpolated percentile (same estimator family as the
    interpolated ``hist_quantile``), ``q`` in [0, 1]."""
    if not values:
        return None
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = q * (len(vs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(vs) - 1)
    return vs[lo] + (pos - lo) * (vs[hi] - vs[lo])


def _events(doc: dict):
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict):
            yield ev


def _args(ev: dict) -> dict:
    a = ev.get("args")
    return a if isinstance(a, dict) else {}


def _chunk_decomposition(chunk: dict, inner: List[dict],
                         dispatch_ts: Optional[float]) -> Dict[str, float]:
    """Interval accounting (µs) inside one ``distrib.chunk`` span."""
    ts = float(chunk.get("ts", 0))
    dur = float(chunk.get("dur", 0))
    end = ts + dur
    out: Dict[str, float] = {}
    if dispatch_ts is not None:
        out["queue"] = max(0.0, ts - dispatch_ts)
    phase_ivs = []
    for ev in inner:
        name = ev.get("name", "")
        ev_ts = float(ev.get("ts", 0))
        ev_dur = float(ev.get("dur", 0))
        if name.startswith("phase."):
            stage = name[len("phase."):]
            if stage in PHASES:
                out[stage] = out.get(stage, 0.0) + ev_dur
                phase_ivs.append((ev_ts, ev_ts + ev_dur))
        elif name in _OVERLAY_SPANS:
            stage = _OVERLAY_SPANS[name]
            out[stage] = out.get(stage, 0.0) + ev_dur
    if phase_ivs:
        union = costmodel.union_intervals(phase_ivs)
        first = min(s for s, _ in union)
        last = max(e for _, e in union)
        covered = sum(e - s for s, e in union)
        out["setup"] = max(0.0, first - ts)
        out["teardown"] = max(0.0, end - last)
        out["gap"] = max(0.0, (last - first) - covered)
    else:
        # a replayed/cached chunk may run no phases at all: its whole
        # span is setup+teardown-free compute we cannot split further
        out["gap"] = dur
    return out


def analyze(doc: dict, profile: str = "auto") -> dict:
    """The machine-readable critical-path report for a merged trace."""
    dispatches = {}           # span_id -> dispatch event
    job_marks: Dict[str, dict] = {}   # job -> {"submit": ts, "done": ts, ...}
    chunks = []
    spans_by_pid: Dict[int, List[dict]] = {}
    for ev in _events(doc):
        name = ev.get("name", "")
        ph = ev.get("ph")
        a = _args(ev)
        if ph in ("i", "I"):
            if name == "distrib.dispatch" and a.get("span_id"):
                dispatches[a["span_id"]] = ev
            elif name in ("serve.job.submit", "serve.job.done"):
                job = str(a.get("job"))
                m = job_marks.setdefault(job, {})
                key = name.rsplit(".", 1)[1]
                m[key] = float(ev.get("ts", 0))
                if a.get("tenant") is not None:
                    m["tenant"] = a.get("tenant")
        elif ph == "X":
            if name == "distrib.chunk":
                chunks.append(ev)
            elif isinstance(ev.get("pid"), int):
                spans_by_pid.setdefault(ev["pid"], []).append(ev)

    per_chunk = []
    for chunk in chunks:
        a = _args(chunk)
        parent = a.get("parent")
        disp = dispatches.get(parent)
        disp_args = _args(disp) if disp else {}
        ts = float(chunk.get("ts", 0))
        end = ts + float(chunk.get("dur", 0))
        inner = [ev for ev in spans_by_pid.get(chunk.get("pid"), [])
                 if ts <= float(ev.get("ts", 0))
                 and float(ev.get("ts", 0)) + float(ev.get("dur", 0))
                 <= end + 1]
        stages = _chunk_decomposition(
            chunk, inner,
            float(disp["ts"]) if disp is not None else None)
        per_chunk.append({
            "chunk": a.get("chunk"),
            "job": disp_args.get("job"),
            "worker": disp_args.get("worker"),
            "dispatch_ts": float(disp["ts"]) if disp is not None else None,
            "ts": ts, "end": end,
            "stages_us": stages,
        })

    # ---- per-job critical paths
    jobs = {}
    for c in per_chunk:
        key = str(c["job"]) if c["job"] is not None else "?"
        jobs.setdefault(key, []).append(c)
    per_job = []
    for job, job_chunks in sorted(jobs.items()):
        crit = max(job_chunks, key=lambda c: c["end"])
        marks = job_marks.get(job, {})
        start = marks.get("submit")
        done = marks.get("done")
        path: Dict[str, float] = {}
        t0 = crit["dispatch_ts"] if crit["dispatch_ts"] is not None \
            else crit["ts"]
        if start is not None:
            path["admit_queue"] = max(0.0, t0 - start)
        else:
            start = min(c["dispatch_ts"] if c["dispatch_ts"] is not None
                        else c["ts"] for c in job_chunks)
            path["admit_queue"] = max(0.0, t0 - start)
        for stage, us in crit["stages_us"].items():
            if stage in OVERLAY_STAGES:
                continue
            path[stage] = path.get(stage, 0.0) + us
        t_end = done if done is not None else max(c["end"]
                                                  for c in job_chunks)
        path["gather"] = max(0.0, t_end - crit["end"])
        wall = max(0.0, t_end - start)
        attributed = sum(path.values())
        unattributed = max(0.0, wall - attributed)
        overlay = {s: sum(c["stages_us"].get(s, 0.0) for c in job_chunks)
                   for s in OVERLAY_STAGES}
        per_job.append({
            "job": job,
            "tenant": marks.get("tenant"),
            "chunks": len(job_chunks),
            "critical_chunk": crit["chunk"],
            "wall_us": wall,
            "path_us": {k: round(v, 1) for k, v in path.items()},
            "overlay_us": {k: round(v, 1) for k, v in overlay.items()
                           if v},
            "attributed_us": round(attributed, 1),
            "unattributed_us": round(unattributed, 1),
            "unattributed_frac": round(unattributed / wall, 4)
            if wall > 0 else 0.0,
        })

    # ---- loadtest-level aggregation: per-stage p50/p99 contributions
    stage_pcts = {}
    walls = [j["wall_us"] for j in per_job if j["wall_us"] > 0]
    for stage in JOB_STAGES:
        vals = [j["path_us"].get(stage, 0.0) for j in per_job]
        if not any(vals):
            continue
        stage_pcts[stage] = {
            "p50_us": round(percentile(vals, 0.50) or 0.0, 1),
            "p99_us": round(percentile(vals, 0.99) or 0.0, 1),
            "total_us": round(sum(vals), 1),
        }
    # ---- cost-model cross-check over the merged counters
    crosscheck = None
    metrics = doc.get("racon_tpu")
    counters = None
    if isinstance(metrics, dict):
        m = metrics.get("metrics")
        if isinstance(m, dict) and isinstance(m.get("counters"), dict):
            counters = m["counters"]
    if counters:
        od = doc.get("otherData")
        platform = od.get("platform") if isinstance(od, dict) else None
        prof = costmodel.resolve_profile(profile, platform)
        pred = costmodel.predict_from_counters(counters, prof)
        crosscheck = {"profile": prof.name, "phases": {}}
        for stage, alias in (("align", "align"), ("poa", "poa")):
            measured_s = sum(c["stages_us"].get(stage, 0.0)
                             for c in per_chunk) / 1e6
            p = pred["phases"].get(alias, {})
            predicted_s = p.get("predicted_s", 0.0)
            crosscheck["phases"][stage] = {
                "predicted_s": round(predicted_s, 6),
                "measured_s": round(measured_s, 6),
                "ratio": round(costmodel._ratio(predicted_s, measured_s)
                               or 0.0, 2),
                "within_bound": (costmodel._ratio(predicted_s, measured_s)
                                 or 0.0) <= prof.error_bound_ratio
                if predicted_s and measured_s else None,
                "verdict": p.get("verdict"),
            }

    return {
        "jobs": per_job,
        "chunks": len(per_chunk),
        "stages": stage_pcts,
        "wall_p50_us": round(percentile(walls, 0.50) or 0.0, 1),
        "wall_p99_us": round(percentile(walls, 0.99) or 0.0, 1),
        "costmodel": crosscheck,
        "max_unattributed_frac": round(
            max((j["unattributed_frac"] for j in per_job), default=0.0), 4),
    }


def render(result: dict, path: str, threshold: float) -> str:
    lines = [f"critical path: {path}"]
    if not result["jobs"]:
        lines.append("  (no distrib.dispatch -> distrib.chunk pairs; "
                     "nothing to attribute)")
        return "\n".join(lines)
    lines.append(f"  jobs={len(result['jobs'])} chunks={result['chunks']} "
                 f"wall p50={result['wall_p50_us'] / 1e3:.2f} ms "
                 f"p99={result['wall_p99_us'] / 1e3:.2f} ms")
    lines.append("-- per-stage contribution to the job critical path " +
                 "-" * 5)
    for stage, s in result["stages"].items():
        lines.append(f"  {stage:<14s} p50={s['p50_us'] / 1e3:>9.2f} ms  "
                     f"p99={s['p99_us'] / 1e3:>9.2f} ms  "
                     f"total={s['total_us'] / 1e3:>9.2f} ms")
    lines.append("-- per-job attribution " + "-" * 22)
    for j in result["jobs"]:
        flag = " OVER" if j["unattributed_frac"] > threshold else ""
        lines.append(
            f"  job {j['job']:<10s} chunks={j['chunks']:<2d} "
            f"wall={j['wall_us'] / 1e3:>9.2f} ms  "
            f"unattributed={j['unattributed_us'] / 1e3:>8.2f} ms "
            f"({100 * j['unattributed_frac']:.1f}%){flag}")
    cc = result.get("costmodel")
    if cc:
        lines.append(f"-- cost-model cross-check ({cc['profile']}) " +
                     "-" * 10)
        for stage, p in cc["phases"].items():
            ok = ("n/a" if p["within_bound"] is None
                  else "ok" if p["within_bound"] else "OFF-MODEL")
            lines.append(f"  {stage:<8s} predicted={p['predicted_s']:.3f} s "
                         f"measured={p['measured_s']:.3f} s "
                         f"ratio={p['ratio']:.2f} [{ok}]")
    return "\n".join(lines)
