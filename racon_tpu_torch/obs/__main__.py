"""``python -m racon_tpu_torch.obs``: read a trace written with ``--trace``.

The JAX package's reader (racon_tpu/obs/__main__.py) in its flag form::

    python -m racon_tpu_torch.obs run.json              # breakdown
    python -m racon_tpu_torch.obs --validate run.json   # schema check
    python -m racon_tpu_torch.obs --diff old.json new.json
    python -m racon_tpu_torch.obs --device run.json     # the device track

``--device`` is the port's own: the card's busy share of the polish from
the device track (obs/__init__.py), launches and busy time per kernel,
and the longest host gaps between launches with the span that encloses
each. Two of the JAX reader's subcommands::

    python -m racon_tpu_torch.obs merge a.json b.json ... --out m.json
    python -m racon_tpu_torch.obs fleet m.json [--json]

``merge`` folds per-process traces (a distrib coordinator's or a fleet
plane's and its workers' chunk traces) into one timeline on the earliest
monotonic epoch; ``fleet`` gives each process's chunks, dispatches,
chunk and kernel wall and peak RSS, and checks that every chunk span's
parent is a dispatch event and that the run has one trace id (exit 1
where not). On a merged fleet trace ``--device`` gives the card's busy
share over all workers. The others (model, validate, bench, critpath)
wait: the cost model's machine profiles are the TPU's.

Exit codes: 0 valid; 1 schema violation(s) in a readable trace (or a
``fleet`` parenting violation); 2 file unreadable, not JSON, not a trace
object, or bad arguments; 3 a ``--diff`` phase regression past
``--threshold``.
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


def _doc_t0_ns(doc: dict):
    od = doc.get("otherData")
    if isinstance(od, dict):
        t0 = od.get("t0_monotonic_ns")
        if isinstance(t0, int):
            return t0
    return None


def merge_traces(docs: List[dict], paths: List[str]) -> dict:
    """Fold per-process trace documents into one multi-track timeline.

    Same-host traces share the monotonic clock, so each document's
    events shift by the µs offset of its ``t0_monotonic_ns`` epoch from
    the earliest one (documents without one keep their own timebase);
    the device track's float µs stay floats. pid and tid stamps are kept:
    one track group a process. Counters are summed; histograms, which do
    not merge losslessly, are left out."""
    t0s = [_doc_t0_ns(d) for d in docs]
    known = [t for t in t0s if t is not None]
    base = min(known) if known else None
    events: List[dict] = []
    processes: List[dict] = []
    counters: Dict[str, int] = {}
    platform = None
    dropped = 0
    for doc, path, t0 in zip(docs, paths, t0s):
        dt_ns = (t0 - base) if t0 is not None and base is not None else 0
        for ev in doc.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            ts = ev.get("ts")
            if ev.get("ph") != "M" and isinstance(ts, (int, float)):
                ev["ts"] = max(0, int(ts) + dt_ns // 1000
                               if isinstance(ts, int)
                               else ts + dt_ns / 1000.0)
            events.append(ev)
        dropped += dropped_events(doc)
        for name, v in _counters(doc).items():
            try:
                counters[name] = counters.get(name, 0) + int(v)
            except (TypeError, ValueError):
                continue
        od = doc.get("otherData") if isinstance(doc.get("otherData"),
                                                dict) else {}
        platform = platform or od.get("platform")
        processes.append({
            "path": path, "pid": od.get("pid"), "role": od.get("role"),
            "trace_id": od.get("trace_id"), "t0_monotonic_ns": t0,
            "offset_us": dt_ns // 1000,
            "events": len(doc.get("traceEvents", [])),
        })
    other = {"tool": "racon_tpu_torch.obs", "clock": "monotonic",
             "dropped_events": dropped, "merged_from": list(paths)}
    if platform:
        other["platform"] = platform
    merged = {"traceEvents": events, "displayTimeUnit": "ms",
              "otherData": other, "racon_tpu": {"processes": processes}}
    if counters:
        merged["racon_tpu"]["metrics"] = {
            "counters": dict(sorted(counters.items()))}
    return merged


_ELASTIC_NAMES = {"fleet.scale_up": "scale_ups",
                  "fleet.scale_down": "scale_downs",
                  "fleet.steal": "steals", "serve.shed": "sheds"}


def fleet_breakdown(doc: dict) -> dict:
    """Per-process accounting over a merged fleet trace, and the
    trace-context invariants the merge makes checkable: every
    ``distrib.chunk`` span that names a parent names the ``span_id`` of
    some ``distrib.dispatch`` event, and one fleet run has one trace
    id."""
    roles: Dict[int, str] = {}
    per: Dict[int, dict] = {}
    dispatch_ids = set()
    trace_ids = set()
    violations: List[str] = []
    elastic = {"scale_ups": 0, "scale_downs": 0, "steals": 0, "sheds": 0}
    chunk_spans = []
    for ev in doc.get("traceEvents", []):
        if not isinstance(ev, dict):
            continue
        pid = ev.get("pid")
        if not isinstance(pid, int):
            continue
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            name = (ev.get("args") or {}).get("name")
            if isinstance(name, str):
                roles[pid] = name
            continue
        p = per.setdefault(pid, {"spans": 0, "events": 0, "chunks": 0,
                                 "dispatches": 0, "chunk_wall_us": 0,
                                 "kernel_wall_us": 0, "peak_rss_mb": 0.0})
        args = ev.get("args") if isinstance(ev.get("args"), dict) else {}
        name = ev.get("name", "")
        if ev.get("ph") == "X":
            p["spans"] += 1
            dur = int(ev.get("dur", 0))
            if name == "distrib.chunk":
                p["chunks"] += 1
                p["chunk_wall_us"] += dur
                chunk_spans.append((pid, args))
                if args.get("trace_id"):
                    trace_ids.add(args["trace_id"])
            elif name in ("phase.align", "phase.poa"):
                p["kernel_wall_us"] += dur
        elif ev.get("ph") in ("i", "I"):
            p["events"] += 1
            if name == "distrib.dispatch":
                p["dispatches"] += 1
                if args.get("span_id"):
                    dispatch_ids.add(args["span_id"])
                if args.get("trace_id"):
                    trace_ids.add(args["trace_id"])
            elif name in _ELASTIC_NAMES:
                elastic[_ELASTIC_NAMES[name]] += 1
            elif name == "mem.rss":
                try:
                    p["peak_rss_mb"] = max(p["peak_rss_mb"],
                                           float(args.get("rss_mb") or 0.0))
                except (TypeError, ValueError):
                    pass
    for pid, args in chunk_spans:
        parent = args.get("parent")
        if parent and parent not in dispatch_ids:
            violations.append(
                f"distrib.chunk (pid {pid}, chunk {args.get('chunk')}) "
                f"names parent {parent!r} but no distrib.dispatch event "
                f"carries that span_id")
    if len(trace_ids) > 1:
        violations.append(f"multiple trace ids in one fleet trace: "
                          f"{sorted(trace_ids)}")
    return {
        "processes": {str(pid): {"role": roles.get(pid), **stats}
                      for pid, stats in sorted(per.items())},
        "dispatch_span_ids": len(dispatch_ids),
        "trace_ids": sorted(trace_ids),
        "elastic": elastic,
        "violations": violations,
    }


def _read_valid(path: str):
    """(document, None), or (None, exit code) with the message printed."""
    try:
        doc, errors = load_trace(path)
    except (OSError, ValueError) as e:
        print(f"[obs] cannot read trace {path}: {e}", file=sys.stderr)
        return None, 2
    if errors:
        for err in errors:
            print(f"[obs] {path}: {err}", file=sys.stderr)
        return None, 1
    return doc, None


def cmd_merge(args) -> int:
    docs = []
    for path in args.traces:
        doc, rc = _read_valid(path)
        if doc is None:
            return rc
        docs.append(doc)
    merged = merge_traces(docs, args.traces)
    try:
        with open(args.out, "w") as f:
            json.dump(merged, f)
            f.write("\n")
    except OSError as e:
        print(f"[obs] cannot write {args.out}: {e}", file=sys.stderr)
        return 2
    procs = merged["racon_tpu"]["processes"]
    print(f"[obs] merged {len(docs)} trace(s), "
          f"{len(merged['traceEvents'])} events, "
          f"{len(procs)} process entr{'y' if len(procs) == 1 else 'ies'} "
          f"-> {args.out}")
    return 0


def cmd_fleet(args) -> int:
    doc, rc = _read_valid(args.trace)
    if doc is None:
        return rc
    b = fleet_breakdown(doc)
    if args.as_json:
        print(json.dumps(b, indent=2))
    else:
        print(f"fleet trace: {args.trace}")
        print("-- processes " + "-" * 31)
        for pid, p in b["processes"].items():
            print(f"  pid {pid:<8s} {p['role'] or '?':<14s} "
                  f"chunks={p['chunks']:<3d} "
                  f"dispatches={p['dispatches']:<3d} "
                  f"chunk={p['chunk_wall_us'] / 1e3:>9.2f} ms  "
                  f"kernel={p['kernel_wall_us'] / 1e3:>9.2f} ms  "
                  f"peak_rss={p['peak_rss_mb']:>7.1f} MiB")
        if b["trace_ids"]:
            print(f"  trace id: {', '.join(b['trace_ids'])} "
                  f"({b['dispatch_span_ids']} dispatch span ids)")
        e = b["elastic"]
        if any(e.values()):
            print(f"  elastic: scale_ups={e['scale_ups']} "
                  f"scale_downs={e['scale_downs']} steals={e['steals']} "
                  f"sheds={e['sheds']}")
        for v in b["violations"]:
            print(f"[obs] VIOLATION: {v}", file=sys.stderr)
        if not b["violations"]:
            print("[obs] OK: trace-context parenting holds")
    return 1 if b["violations"] else 0


def _sub_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m racon_tpu_torch.obs")
    sub = p.add_subparsers(dest="cmd", required=True)
    mg = sub.add_parser("merge",
                        help="fold per-process traces (coordinator and "
                        "workers) into one multi-track timeline, re-based "
                        "onto the earliest monotonic epoch")
    mg.add_argument("traces", nargs="+",
                    help="trace files to merge (any order)")
    mg.add_argument("--out", required=True,
                    help="path for the merged Chrome-trace JSON")
    mg.set_defaults(fn=cmd_merge)
    fl = sub.add_parser("fleet",
                        help="per-process breakdown of a merged fleet "
                        "trace and the trace-context parenting check; "
                        "exit 1 on a dangling parent or mixed trace ids")
    fl.add_argument("trace")
    fl.add_argument("--json", action="store_true", dest="as_json")
    fl.set_defaults(fn=cmd_fleet)
    return p


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
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in ("merge", "fleet"):
        try:
            args = _sub_parser().parse_args(argv)
        except SystemExit as e:
            return 2 if e.code not in (0, None) else 0
        return args.fn(args)
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
