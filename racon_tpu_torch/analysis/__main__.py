"""`python -m racon_tpu_torch.analysis`: run the AST lint, the
CUDA-source audit, the concurrency auditor and its contracts over the port
(and, with ``--plans``, the launch-plan audit on the card); exit 1 on new
(non-baselined) violations.

The port's copy of the JAX package's CLI (racon_tpu/analysis/__main__.py)
with the flags whose engines the port has: ``--sanitize-report``,
``--list-rules``, ``--paths``, ``--baseline``, ``--write-baseline``,
``--json``, ``--no-lint``, ``--concurrency`` and ``--contracts``;
``--no-build-audit`` in place of ``--no-jaxpr``, and ``--plans [--device
cuda]`` for the card's part. As in the JAX CLI, a full-tree run with no
audit flag runs the lint, the source audit and both audits; an explicit
``--concurrency`` or ``--contracts`` runs only that audit, scoped to
``--paths`` where given; a ``--paths`` run with neither stays lint-only.
Exit codes: 0 clean, 1 violations (or sanitizer findings), 2 a report
that cannot be read, a plan audit without a card, or a ``--contracts``
scope with no contract anchor in it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from typing import List

from . import build_audit, lint

#: The audits' rule ids with their summaries (``--list-rules``; the JAX
#: CLI's wording).
CONCURRENCY_RULES = (
    ("unguarded-mutation",
     "shared state mutated by >=2 thread roles without one lock held at "
     "every site"),
    ("lock-order-cycle", "lock-acquisition-order digraph must be acyclic"),
)
CONTRACT_RULES = (
    ("lattice-drill", "every record_degrade edge needs a port test drill"),
    ("lattice-docs",
     "every record_degrade edge needs a table row in README.md's port "
     "section"),
    ("fault-drill", "every registered fault point needs a port test drill"),
    ("fault-docs",
     "every registered fault point needs a table row in README.md's port "
     "section"),
    ("protocol-mismatch",
     "wire-protocol producers/consumers must agree field-for-field with "
     "the declared spec"),
)


def _sanitize_report(path: str, as_json: bool) -> int:
    """Render the `sanitize` section of a run report; exit 1 on any
    recorded finding (the dynamic counterpart of the lint gate)."""
    try:
        with open(path) as f:
            report = json.load(f)
    except (OSError, ValueError) as e:
        print(f"[analysis] cannot read run report {path}: {e}",
              file=sys.stderr)
        return 2
    section = report.get("sanitize") if isinstance(report, dict) else None
    if not isinstance(section, dict):
        print(f"[analysis] {path}: no `sanitize` section (report predates "
              f"the runtime sanitizer?)", file=sys.stderr)
        return 2
    armed = bool(section.get("armed"))
    findings = section.get("findings") or []
    if as_json:
        print(json.dumps({"armed": armed, "findings": findings}, indent=2))
        return 1 if findings else 0
    for f in findings:
        times = f" x{f['count']}" if f.get("count", 1) > 1 else ""
        print(f"[sanitize] {f.get('kind', '?')} at {f.get('where', '?')}"
              f"{times}: {f.get('detail', '')}")
    if findings:
        print(f"[analysis] SANITIZE FAIL: {len(findings)} distinct "
              f"finding(s)")
        return 1
    state = "armed" if armed else "not armed (run without --sanitize)"
    print(f"[analysis] SANITIZE OK: no findings; sanitizer {state}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.analysis",
        description="racon_tpu_torch static analysis: the port's AST lint, "
                    "the CUDA-source audit and, on the card, the "
                    "launch-plan audit")
    p.add_argument("--repo-root", default=None,
                   help="repo root (default: auto-detected)")
    p.add_argument("--baseline", default=None, metavar="FILE",
                   help="suppression baseline JSON; violations whose "
                        "fingerprints it accepts are not reported "
                        "(default: <repo>/racon_tpu_torch/analysis/"
                        "baseline.json if present; the tree has none)")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept every current violation into the "
                        "baseline file and exit 0")
    p.add_argument("--paths", nargs="+", default=None, metavar="REL",
                   help="analyse only these repo-relative files instead "
                        "of the whole tree; the build audit is skipped. "
                        "Default is lint-only; an explicit --concurrency "
                        "or --contracts runs that audit scoped to the "
                        "paths")
    p.add_argument("--no-build-audit", action="store_true",
                   help="skip the CUDA-source audit (AST lint only)")
    p.add_argument("--no-lint", action="store_true",
                   help="skip the AST lint")
    p.add_argument("--concurrency", action="store_true",
                   help="run only the lock-discipline audit "
                        "(unguarded-mutation / lock-order-cycle); may be "
                        "combined with --contracts")
    p.add_argument("--contracts", action="store_true",
                   help="run only the contract cross-checks (degrade-edge "
                        "drills and docs, fault-point drills and docs, "
                        "wire-protocol field agreement); may be combined "
                        "with --concurrency")
    p.add_argument("--plans", action="store_true",
                   help="also run the launch-plan audit over the driver's "
                        "window classes and depth buckets (needs the card)")
    p.add_argument("--device", default="cuda",
                   help="the card for --plans (default cuda)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable output")
    p.add_argument("--list-rules", action="store_true",
                   help="print every rule id and summary and exit")
    p.add_argument("--sanitize-report", default=None, metavar="FILE",
                   help="render the runtime-sanitizer verdict from a run "
                        "report JSON (--report of a --sanitize run); exit "
                        "1 when the run recorded findings")
    args = p.parse_args(argv)

    if args.sanitize_report:
        return _sanitize_report(args.sanitize_report, args.as_json)

    if args.list_rules:
        from .rules import ALL_RULES
        for rule in ALL_RULES:
            print(f"{rule.id:18s} {rule.doc}")
        for rid, doc in (build_audit.SOURCE_RULES + build_audit.PLAN_RULES
                         + CONCURRENCY_RULES + CONTRACT_RULES):
            print(f"{rid:18s} {doc}")
        return 0

    root = args.repo_root or lint.repo_root_for()
    violations: List[lint.Violation] = []
    ran = set()           # the rule ids whose engines ran (--json counts)
    audits_selected = args.concurrency or args.contracts
    if not audits_selected:
        if not args.no_lint:
            violations.extend(lint.run_lint(root, paths=args.paths))
            from .rules import ALL_RULES
            ran.update(r.id for r in ALL_RULES)
        if not args.no_build_audit and args.paths is None:
            violations.extend(build_audit.run_source_audit(root))
            ran.update(rid for rid, _ in build_audit.SOURCE_RULES)
    # The concurrency and contract audits: an explicit flag always wins
    # (scoped to --paths where given); otherwise they ride along on a
    # full-tree default run, and a --paths run stays lint-only.
    full_default = (not audits_selected and not args.no_lint
                    and args.paths is None)
    from . import concurrency
    audits = {}
    try:
        if args.concurrency or full_default:
            t0 = time.perf_counter()
            model = concurrency.build_model(root, paths=args.paths)
            violations.extend(concurrency.run_concurrency(root,
                                                          model=model))
            ran.update(rid for rid, _ in CONCURRENCY_RULES)
            audits["concurrency"] = {
                "seconds": round(time.perf_counter() - t0, 3),
                "thread_entries": [
                    {"role": te.role, "path": te.relpath, "line": te.line}
                    for te in sorted(model.thread_entries,
                                     key=lambda te: (te.relpath, te.line))],
                "roles": sorted({te.role for te in model.thread_entries})}
        if args.contracts or full_default:
            t0 = time.perf_counter()
            violations.extend(concurrency.run_contracts(root,
                                                        paths=args.paths))
            ran.update(rid for rid, _ in CONTRACT_RULES)
            audits["contracts"] = {
                "seconds": round(time.perf_counter() - t0, 3)}
    except concurrency.UnsupportedScope as e:
        print(f"[analysis] {e}", file=sys.stderr)
        return 2
    plans = None
    if args.plans:
        try:
            plans = build_audit.run_plan_audit(args.device)
        except RuntimeError as e:
            print(f"[analysis] {e}", file=sys.stderr)
            return 2
        violations.extend(plans.violations)
        ran.update(rid for rid, _ in build_audit.PLAN_RULES)

    baseline_path = args.baseline or os.path.join(
        root, "racon_tpu_torch", "analysis", "baseline.json")
    if args.write_baseline:
        lint.write_baseline(baseline_path, violations)
        print(f"[analysis] baseline: accepted {len(violations)} "
              f"violation(s) into {baseline_path}")
        return 0

    baseline = lint.load_baseline(baseline_path)
    new = lint.filter_baselined(violations, baseline)

    from . import astcache
    n_base = len(violations) - len(new)
    if args.as_json:
        counts = Counter(v.rule for v in new)
        payload = {"total": len(violations), "baselined": n_base,
                   "new": [vars(v) for v in new],
                   "rules": {rid: counts.get(rid, 0)
                             for rid in sorted(ran | set(counts))},
                   "astcache": astcache.stats(), **audits}
        if plans is not None:
            payload["plans"] = {**plans.summary,
                                "occupancy": plans.occupancy}
        print(json.dumps(payload, indent=2, default=str))
    else:
        for v in new:
            print(v.render())
        if plans is not None:
            s = plans.summary
            print(f"[analysis] plans: {s['grid']} (class, depth) cells, "
                  f"{s['plans']} plans, {s['variants']} variants (cap "
                  f"{s['variant_cap']}), {s['builds']} builds, largest "
                  f"shared {s['max_shared_bytes']} of {s['shared_limit']} "
                  f"bytes, largest class {s['largest_class']}, "
                  f"{s['seconds']:.2f} s")
            for occ in plans.occupancy:
                print(f"[analysis] occupancy: {json.dumps(occ)}")
        tail = f" ({n_base} baselined)" if n_base else ""
        if new:
            print(f"[analysis] FAIL: {len(new)} violation(s){tail}")
        else:
            print(f"[analysis] OK: no new violations{tail}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
