"""``python -m racon_tpu_torch.obs``: read a trace written with ``--trace``.

The JAX package's reader (racon_tpu/obs/__main__.py) in its flag form::

    python -m racon_tpu_torch.obs run.json              # breakdown
    python -m racon_tpu_torch.obs --validate run.json   # schema check
    python -m racon_tpu_torch.obs --diff old.json new.json
    python -m racon_tpu_torch.obs --device run.json     # the device track

``--device`` is the port's own: the card's busy share of the polish from
the device track (obs/__init__.py), launches and busy time per kernel,
and the longest host gaps between launches with the span that encloses
each. The subcommands of the JAX reader (model, validate, bench, merge,
fleet, critpath) wait: the cost model's machine profiles are the TPU's,
and merge and fleet need the distributed modules.

Exit codes: 0 valid; 1 schema violation(s) in a readable trace; 2 file
unreadable, not JSON, not a trace object, or bad arguments; 3 a
``--diff`` phase regression past ``--threshold``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Tuple

from . import PHASES
from .metrics import hist_quantile

_VALID_PH = {"X", "B", "E", "i", "I", "M", "C"}


def load_trace(path: str) -> Tuple[dict, List[str]]:
    """Read and validate one trace file: (document, schema violations;
    empty when valid). Raises OSError or ValueError for exit code 2."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome-trace object (no 'traceEvents' key)")
    errors: List[str] = []
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return doc, ["'traceEvents' is not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: bad or missing 'ph' {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: bad or missing 'name'")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errors.append(f"{where}: bad or missing 'pid'/'tid'")
        if ph == "M":
            continue  # metadata events carry no timestamp
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"{where}: bad or missing 'ts' {ts!r}")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"{where}: complete event with bad "
                              f"'dur' {dur!r}")
        if len(errors) >= 50:
            errors.append("... (further violations suppressed)")
            break
    return doc, errors


def phase_walls_us(doc: dict) -> Dict[str, int]:
    """Total duration per ``phase.*`` span, µs."""
    walls: Dict[str, int] = {}
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X" \
                and isinstance(ev.get("name"), str) \
                and ev["name"].startswith("phase."):
            name = ev["name"][len("phase."):]
            walls[name] = walls.get(name, 0) + int(ev.get("dur", 0))
    return walls


def _metrics_doc(doc: dict) -> dict:
    m = doc.get("racon_tpu")
    if isinstance(m, dict):
        m = m.get("metrics")
    return m if isinstance(m, dict) else {}


def _counters(doc: dict) -> Dict[str, int]:
    c = _metrics_doc(doc).get("counters")
    return c if isinstance(c, dict) else {}


def span_quantiles(doc: dict) -> Dict[str, dict]:
    """Per-span-name p50/p99 (µs) from the ``span_us.*`` log2
    histograms."""
    out: Dict[str, dict] = {}
    hists = _metrics_doc(doc).get("histograms")
    if not isinstance(hists, dict):
        return out
    for name, h in sorted(hists.items()):
        if not name.startswith("span_us.") or not isinstance(h, dict):
            continue
        p50 = hist_quantile(h, 0.50)
        p99 = hist_quantile(h, 0.99)
        if p50 is None:
            continue
        out[name[len("span_us."):]] = {
            "count": h.get("count", 0), "p50_us": p50, "p99_us": p99,
            "max_us": h.get("max"),
        }
    return out


def dropped_events(doc: dict) -> int:
    od = doc.get("otherData")
    if isinstance(od, dict):
        try:
            return int(od.get("dropped_events", 0))
        except (TypeError, ValueError):
            return 0
    return 0


def span_intervals(doc: dict, name: str) -> List[tuple]:
    """Sorted [(start_us, end_us)] of every complete event named
    `name`."""
    out = []
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X" \
                and ev.get("name") == name:
            ts = float(ev.get("ts", 0))
            out.append((ts, ts + float(ev.get("dur", 0))))
    return sorted(out)


def union_intervals(intervals) -> List[tuple]:
    """Merge possibly-overlapping intervals into disjoint ones."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(iv) for iv in merged]


def overlap_us(doc: dict, name_a: str, name_b: str) -> float:
    """Wall (µs) during which a span named `name_a` and one named
    `name_b` were open at once."""
    a = union_intervals(span_intervals(doc, name_a))
    b = union_intervals(span_intervals(doc, name_b))
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_overlaps_us(doc: dict) -> Dict[str, float]:
    """Nonzero pairwise overlaps between ``phase.*`` span families,
    keyed ``"a+b"`` ({} for a sequential polish)."""
    names = sorted({ev["name"] for ev in doc.get("traceEvents", [])
                    if isinstance(ev, dict) and ev.get("ph") == "X"
                    and isinstance(ev.get("name"), str)
                    and ev["name"].startswith("phase.")})
    out: Dict[str, float] = {}
    for i, na in enumerate(names):
        for nb in names[i + 1:]:
            ov = overlap_us(doc, na, nb)
            if ov > 0:
                out[f"{na[len('phase.'):]}+{nb[len('phase.'):]}"] = ov
    return out


def breakdown(doc: dict) -> dict:
    """Phase walls, per-tier served counters, span-duration quantiles
    and event counts: the machine-readable form of the rendered table
    (the JAX reader's, key for key)."""
    walls = phase_walls_us(doc)
    counters = _counters(doc)
    served: Dict[str, Dict[str, int]] = {}
    for name, v in counters.items():
        parts = name.split(".")
        if len(parts) == 3 and parts[0] == "served":
            served.setdefault(parts[1], {})[parts[2]] = v
    events: Dict[str, int] = {}
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "i":
            events[ev.get("name", "?")] = events.get(ev.get("name", "?"),
                                                     0) + 1
    return {"phase_us": walls, "served": served, "events": events,
            "counters": counters, "span_quantiles": span_quantiles(doc),
            "phase_overlap_us": phase_overlaps_us(doc),
            "dropped_events": dropped_events(doc)}


def device_track(doc: dict, top: int = 10) -> dict:
    """The device track against the host spans: launches and busy µs per
    kernel, the card's busy share of the polish (the union of the
    launches over the extent of the phase spans), and the host gaps
    between launches within that extent, each given to the shortest host
    span that holds its midpoint: per span name the gaps' count, sum and
    largest, and the `top` longest gaps."""
    dev, host = [], []
    for ev in doc.get("traceEvents", []):
        if not (isinstance(ev, dict) and ev.get("ph") == "X"):
            continue
        ts = float(ev.get("ts", 0))
        iv = (ts, ts + float(ev.get("dur", 0)), ev.get("name", "?"))
        (dev if ev.get("cat") == "device" else host).append(iv)
    kernels: Dict[str, dict] = {}
    for s, e, name in dev:
        k = kernels.setdefault(name, {"launches": 0, "busy_us": 0.0})
        k["launches"] += 1
        k["busy_us"] += e - s
    phases = [(s, e) for s, e, n in host if n.startswith("phase.")]
    if not phases:
        return {"kernels": kernels, "polish_us": 0.0, "busy_us": 0.0,
                "busy_share": None, "gaps_by_span": {}, "top_gaps": []}
    lo, hi = min(s for s, _ in phases), max(e for _, e in phases)
    busy = union_intervals((max(s, lo), min(e, hi)) for s, e, _ in dev
                           if e > lo and s < hi)
    busy_us = sum(e - s for s, e in busy)
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    by_span: Dict[str, dict] = {}
    ranked = []
    for s, e in gaps:
        mid = (s + e) / 2
        holders = [(he - hs, n) for hs, he, n in host if hs <= mid <= he]
        name = min(holders)[1] if holders else "(none)"
        g = by_span.setdefault(name, {"gaps": 0, "sum_us": 0.0,
                                      "max_us": 0.0})
        g["gaps"] += 1
        g["sum_us"] += e - s
        g["max_us"] = max(g["max_us"], e - s)
        ranked.append({"start_us": s, "gap_us": e - s, "span": name})
    ranked.sort(key=lambda r: -r["gap_us"])
    return {"kernels": kernels, "polish_us": hi - lo, "busy_us": busy_us,
            "busy_share": busy_us / (hi - lo) if hi > lo else None,
            "gaps_by_span": dict(sorted(by_span.items(),
                                        key=lambda kv: -kv[1]["sum_us"])),
            "top_gaps": ranked[:top]}


def render(doc: dict, path: str) -> str:
    b = breakdown(doc)
    lines = [f"trace: {path}"]
    if b["dropped_events"]:
        lines.append(f"  WARNING: {b['dropped_events']} event(s) dropped "
                     f"past the bounded buffer — totals are lower bounds")
    total = sum(b["phase_us"].values())
    lines.append("-- phases " + "-" * 34)
    order = [p for p in PHASES if p in b["phase_us"]]
    order += sorted(set(b["phase_us"]) - set(order))
    for p in order:
        us = b["phase_us"][p]
        pct = (100.0 * us / total) if total else 0.0
        lines.append(f"  {p:<16s} {us / 1e3:>10.2f} ms {pct:>5.1f}%")
    if not order:
        lines.append("  (no phase.* spans)")
    if b["phase_overlap_us"]:
        ivs = []
        for ev in doc.get("traceEvents", []):
            if isinstance(ev, dict) and ev.get("ph") == "X" \
                    and isinstance(ev.get("name"), str) \
                    and ev["name"].startswith("phase."):
                ts = float(ev.get("ts", 0))
                ivs.append((ts, ts + float(ev.get("dur", 0))))
        union = sum(e - s for s, e in union_intervals(ivs))
        lines.append("-- phase overlap (pipelined) " + "-" * 15)
        for pair, us in sorted(b["phase_overlap_us"].items()):
            lines.append(f"  {pair:<16s} {us / 1e3:>10.2f} ms concurrent")
        lines.append(f"  {'union wall':<16s} {union / 1e3:>10.2f} ms "
                     f"(vs {total / 1e3:.2f} ms summed)")
    if b["served"]:
        lines.append("-- served (windows/jobs per tier) " + "-" * 10)
        for phase, tiers in sorted(b["served"].items()):
            mix = "  ".join(f"{t}={n}" for t, n in sorted(tiers.items()))
            lines.append(f"  {phase:<16s} {mix}  (sum="
                         f"{sum(tiers.values())})")
    if b["span_quantiles"]:
        lines.append("-- span durations (p50/p99 from log2 histograms) --")
        for name, q in b["span_quantiles"].items():
            lines.append(f"  {name:<24s} n={q['count']:<6d} "
                         f"p50<={q['p50_us'] / 1e3:>9.2f} ms  "
                         f"p99<={q['p99_us'] / 1e3:>9.2f} ms")
    if b["events"]:
        lines.append("-- events " + "-" * 34)
        for name, n in sorted(b["events"].items()):
            lines.append(f"  {name:<28s} x{n}")
    return "\n".join(lines)


def render_device(doc: dict) -> str:
    d = device_track(doc)
    lines = ["-- device track " + "-" * 28]
    if not d["kernels"]:
        lines.append("  (no device events: not traced on the card)")
        return "\n".join(lines)
    for name, k in sorted(d["kernels"].items()):
        lines.append(f"  {name:<30s} x{k['launches']:<6d} "
                     f"{k['busy_us'] / 1e3:>10.2f} ms")
    if d["busy_share"] is not None:
        lines.append(f"  busy {d['busy_us'] / 1e3:.2f} ms of "
                     f"{d['polish_us'] / 1e3:.2f} ms polish "
                     f"({100 * d['busy_share']:.1f}%)")
    lines.append("-- host gaps between launches, by enclosing span --")
    for name, g in d["gaps_by_span"].items():
        lines.append(f"  {name:<24s} {g['gaps']:>6d} gaps "
                     f"{g['sum_us'] / 1e3:>10.2f} ms  max "
                     f"{g['max_us'] / 1e3:.2f} ms")
    return "\n".join(lines)


def diff(old: dict, new: dict, threshold: float,
         min_delta_us: int) -> Tuple[List[str], List[str]]:
    """Phase-wall regressions, and phases present on one side only
    (flagged, the missing side counted as 0: a resumed run may replay a
    whole phase). A regression: new > old*(1+threshold) and the growth
    past ``min_delta_us``."""
    ow, nw = phase_walls_us(old), phase_walls_us(new)
    regressions, flags = [], []
    for phase in sorted(set(ow) | set(nw)):
        o, n = ow.get(phase, 0), nw.get(phase, 0)
        if phase not in ow or phase not in nw:
            side = "new" if phase not in ow else "old"
            us = n if side == "new" else o
            flags.append(f"phase.{phase}: only-in-{side} "
                         f"({us / 1e3:.2f} ms; missing side counted as 0)")
        if n > o * (1.0 + threshold) and (n - o) > min_delta_us:
            pct = f"+{100.0 * (n - o) / o:.0f}%" if o else "only-in-new"
            regressions.append(
                f"phase.{phase}: {o / 1e3:.2f} ms -> {n / 1e3:.2f} ms "
                f"({pct}, threshold {threshold * 100:.0f}%)")
    return regressions, flags


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.obs",
        description="validate / summarize / diff racon_tpu_torch trace "
                    "files (Chrome-trace JSON from --trace)")
    p.add_argument("trace", nargs="+",
                   help="trace file (two files with --diff: OLD NEW)")
    p.add_argument("--validate", action="store_true",
                   help="schema validation only, no breakdown")
    p.add_argument("--diff", action="store_true",
                   help="compare two traces; exit 3 on phase regression")
    p.add_argument("--device", action="store_true",
                   help="the device track: busy share, launches per "
                        "kernel and host gaps by enclosing span")
    p.add_argument("--threshold", type=float, default=0.25,
                   help="--diff: relative slowdown tolerated per phase "
                        "(default 0.25 = 25%%)")
    p.add_argument("--min-delta-us", type=int, default=1000,
                   help="--diff: ignore regressions smaller than this "
                        "many µs (default 1000)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code not in (0, None) else 0

    if args.diff and len(args.trace) != 2:
        print("[obs] --diff needs exactly two trace files", file=sys.stderr)
        return 2
    if not args.diff and len(args.trace) != 1:
        print("[obs] expected one trace file (or two with --diff)",
              file=sys.stderr)
        return 2

    docs = []
    for path in args.trace:
        try:
            doc, errors = load_trace(path)
        except (OSError, ValueError) as e:
            print(f"[obs] cannot read trace {path}: {e}", file=sys.stderr)
            return 2
        if errors:
            for err in errors:
                print(f"[obs] {path}: {err}", file=sys.stderr)
            print(f"[obs] SCHEMA FAIL: {path}: {len(errors)} violation(s)",
                  file=sys.stderr)
            return 1
        docs.append(doc)

    if args.diff:
        regressions, flags = diff(docs[0], docs[1], args.threshold,
                                  args.min_delta_us)
        if args.as_json:
            print(json.dumps({"regressions": regressions,
                              "only_in": flags}, indent=2))
        else:
            for fl in flags:
                print(f"[obs] NOTE: {fl}")
            for r in regressions:
                print(f"[obs] REGRESSION: {r}")
            if not regressions:
                print(f"[obs] OK: no phase regression past "
                      f"{args.threshold * 100:.0f}%")
        return 3 if regressions else 0

    doc = docs[0]
    if args.validate:
        dropped = dropped_events(doc)
        if args.as_json:
            print(json.dumps({"valid": True,
                              "events": len(doc["traceEvents"]),
                              "dropped_events": dropped}))
        else:
            print(f"[obs] OK: {args.trace[0]} is valid Chrome-trace JSON "
                  f"({len(doc['traceEvents'])} events)")
            if dropped:
                print(f"[obs] WARNING: {dropped} event(s) were dropped "
                      f"past the tracer's bounded buffer")
        return 0
    if args.device:
        if args.as_json:
            print(json.dumps(device_track(doc), indent=2))
        else:
            print(render_device(doc))
        return 0
    if args.as_json:
        print(json.dumps(breakdown(doc), indent=2))
    else:
        print(render(doc, args.trace[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
