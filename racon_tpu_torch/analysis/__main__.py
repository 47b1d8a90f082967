"""`python -m racon_tpu_torch.analysis`: run the AST lint, the
CUDA-source audit, the concurrency auditor and its contracts, the
determinism taint audit and the protocol model's conformance pass over
the port (and, with ``--plans``, the launch-plan audit on the card; with
``--model-check``, the protocol model's state exploration); exit 1 on
new (non-baselined) violations.

The port's copy of the JAX package's CLI (racon_tpu/analysis/__main__.py)
with the flags whose engines the port has: ``--sanitize-report``,
``--list-rules``, ``--paths``, ``--baseline``, ``--write-baseline``,
``--json``, ``--no-lint``, ``--concurrency``, ``--contracts``,
``--determinism``, ``--emit-manifest``, ``--det-mutate``,
``--list-det-mutations``, ``--model-check``, ``--mutate``,
``--list-mutations``, ``--emit-schedule`` and the ``--mc-*`` bounds, with
``--mc-off-card`` for the model's card axis (its jobs run on the card by
default, as the port's do); ``--no-build-audit`` in place of
``--no-jaxpr``, and ``--plans [--device cuda]`` for the card's part. As
in the JAX CLI, a full-tree run with no audit flag runs the lint, the
source audit, both concurrency audits, the determinism audit and the
model's conformance pass (not the state exploration); an explicit
``--concurrency``, ``--contracts`` or ``--determinism`` runs only that
audit, scoped to ``--paths`` where given; a ``--paths`` run with none of
them stays lint-only. Exit codes: 0 clean; 1 violations, sanitizer
findings or a caught mutant; 2 a report that cannot be read, a plan
audit without a card, a ``--contracts`` scope with no contract anchor in
it, or an unknown mutant; 3 a clean verdict from a model exploration
that did not exhaust its bounded space.
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
#: The protocol model's rules: ``fault-model`` runs with the contracts
#: and is counted with the model's conformance pass.
MODEL_RULES = (
    ("fault-model",
     "every fleet-scoped fault point must be claimed by a protocol-model "
     "transition"),
    ("model-site",
     "every protocol-model transition must point at a live code site"),
    ("model-fault",
     "every protocol-model fault point must exist in faults.KNOWN_POINTS"),
    ("model-coverage",
     "every fleet-scoped faults.check() site must be claimed by a "
     "protocol-model transition"),
    ("protocol-invariant",
     "no bounded interleaving of the fleet lifecycle may violate the "
     "invariant library (--model-check)"),
)
DETERMINISM_RULES = (
    ("determinism-leak",
     "no cost-only source (fingerprint.py SOURCES) may flow into the "
     "consensus/CIGAR install seams"),
    ("fingerprint-gap",
     "every complete fingerprint composition must cover the whole "
     "output-affecting domain"),
    ("fingerprint-overkey",
     "warning: fingerprint components keyed only on cost-only, "
     "taint-clean sources cause needless misses"),
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


_MODEL_REL = "racon_tpu_torch/analysis/protocol/model.py"


def _mc_config(args):
    """A model Config from the --mc-* bounds (defaults from Config)."""
    from .protocol import Config
    kw = {}
    if args.mc_workers is not None:
        kw["workers"] = args.mc_workers
    if args.mc_chunks is not None:
        kw["chunks"] = tuple(args.mc_chunks.split(","))
    if args.mc_retry is not None:
        kw["retry"] = args.mc_retry
    if args.mc_faults is not None:
        kw["faults"] = args.mc_faults
    if args.mc_budget is not None:
        kw["budget"] = args.mc_budget
    if args.mc_submits is not None:
        kw["submit_ests"] = tuple(int(x) for x
                                  in args.mc_submits.split(","))
    if args.mc_off_card:
        kw["card"] = False
    return Config(**kw)


def _model_check(args):
    """Run the state exploration; counterexamples come back as ordinary
    Violations (rule `protocol-invariant`), so the baseline, waiver and
    exit-code plumbing apply unchanged."""
    from .protocol import check

    res = check(cfg=_mc_config(args), mutation=args.mutate,
                strategy=args.mc_strategy, max_states=args.mc_max_states,
                depth=args.mc_depth)
    violations = [lint.Violation("protocol-invariant", _MODEL_REL, 1,
                                 v.render())
                  for v in res.violations]
    if args.emit_schedule:
        _emit_schedule(args.emit_schedule, res)
    return res, violations


def _emit_schedule(dest: str, res) -> None:
    """Compile the first counterexample (or, when clean, a shortest
    worker-death witness run) into a replayable RACON_TORCH_FAULT
    schedule JSON, with its fault_worker argument."""
    from .protocol import replay
    from .protocol.checker import _fmt_event

    payload = {}
    try:
        if res.violations:
            trace = res.violations[0].trace
            sched = replay.compile_trace(trace)
            payload["source"] = res.violations[0].invariant
        else:
            trace, sched = replay.witness_trace()
            payload["source"] = "witness"
        payload.update(spec=sched.spec, worker=sched.worker,
                       events=list(sched.events), env=sched.env(),
                       kwargs=sched.kwargs(),
                       trace=[_fmt_event(e) for e in trace])
    except replay.Unreplayable as e:
        payload = {"error": str(e)}
    text = json.dumps(payload, indent=2) + "\n"
    if dest == "-":
        sys.stdout.write(text)
    else:
        with open(dest, "w") as f:
            f.write(text)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.analysis",
        description="racon_tpu_torch static analysis: the port's AST lint, "
                    "the CUDA-source audit, the concurrency, determinism "
                    "and protocol audits and, on the card, the "
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
                        "Default is lint-only; an explicit --concurrency, "
                        "--contracts or --determinism runs that audit "
                        "scoped to the paths")
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
                        "wire-protocol field agreement, fleet fault points "
                        "claimed by the protocol model); may be combined "
                        "with --concurrency")
    p.add_argument("--determinism", action="store_true",
                   help="run only the determinism taint audit "
                        "(determinism-leak / fingerprint-gap / "
                        "fingerprint-overkey): prove no cost-only source "
                        "of fingerprint.py SOURCES can reach the "
                        "consensus/CIGAR install seams and that every "
                        "fingerprint composition covers the "
                        "output-affecting domain; may be combined with "
                        "--concurrency/--contracts")
    p.add_argument("--emit-manifest", default=None, metavar="FILE",
                   help="with the determinism audit: write the "
                        "source/fingerprint classification manifest "
                        "(determinism.json schema) to FILE ('-' = "
                        "stdout); implies --determinism")
    p.add_argument("--det-mutate", default=None, metavar="N|NAME",
                   help="determinism self-test: seed one contract bug "
                        "into a scratch copy of the tree (see "
                        "--list-det-mutations) and audit it; exit 1 "
                        "when the expected rule catches it")
    p.add_argument("--list-det-mutations", action="store_true",
                   help="print every seeded determinism mutant and the "
                        "rule expected to catch it, and exit")
    p.add_argument("--model-check", action="store_true",
                   help="run the protocol model checker: exhaust the "
                        "bounded fleet-lifecycle state space, evaluate "
                        "the invariant library, print minimal "
                        "counterexample traces (plus the conformance "
                        "pass keeping the model honest)")
    p.add_argument("--mutate", default=None, metavar="N|NAME",
                   help="model-check self-test: flip one transition "
                        "guard (index or name, see --list-mutations); "
                        "the checker must find a violation, so the exit "
                        "code is 1 when the seeded bug is caught "
                        "(implies --model-check)")
    p.add_argument("--list-mutations", action="store_true",
                   help="print every seeded model mutation and the "
                        "invariant expected to catch it, and exit")
    p.add_argument("--emit-schedule", default=None, metavar="FILE",
                   help="with --model-check: compile the first "
                        "counterexample (or, when clean, a shortest "
                        "worker-death witness run) into a replayable "
                        "RACON_TORCH_FAULT schedule JSON with its "
                        "fault_worker ('-' = stdout)")
    p.add_argument("--mc-workers", type=int, default=None,
                   help="model-check: pool slots (default 2)")
    p.add_argument("--mc-chunks", default=None, metavar="J,J,...",
                   help="model-check: job label per chunk, e.g. A,A,B "
                        "(default)")
    p.add_argument("--mc-retry", type=int, default=None,
                   help="model-check: per-chunk retry budget (default 1)")
    p.add_argument("--mc-faults", type=int, default=None,
                   help="model-check: injected-fault budget (default 1)")
    p.add_argument("--mc-budget", type=int, default=None,
                   help="model-check: window-budget capacity (default 3)")
    p.add_argument("--mc-submits", default=None, metavar="E,E,...",
                   help="model-check: window estimate per submitter, "
                        "e.g. 2,2 (default)")
    p.add_argument("--mc-off-card", action="store_true",
                   help="model-check: the jobs run off the card, where an "
                        "exhausted chunk takes the local floor (the JAX "
                        "model's space); by default they run on the "
                        "card, where it fails its job")
    p.add_argument("--mc-strategy", choices=("bfs", "dfs"), default="bfs",
                   help="model-check: bfs exhausts with minimal traces "
                        "(default); dfs is the depth-bounded fallback "
                        "for oversized configs")
    p.add_argument("--mc-depth", type=int, default=40,
                   help="model-check: dfs depth bound (default 40)")
    p.add_argument("--mc-max-states", type=int, default=2_000_000,
                   help="model-check: state-count cap (default 2e6)")
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
                         + CONCURRENCY_RULES + CONTRACT_RULES
                         + MODEL_RULES + DETERMINISM_RULES):
            print(f"{rid:18s} {doc}")
        return 0

    if args.list_mutations:
        from .protocol import MUTATIONS
        for i, (name, doc, expected, overrides) in enumerate(MUTATIONS):
            extra = f" [config: {overrides}]" if overrides else ""
            print(f"{i}: {name:28s} -> {expected}{extra}\n"
                  f"     {doc}")
        return 0

    if args.list_det_mutations:
        from .determinism import MUTANTS
        for i, (name, doc, expected, _patches) in enumerate(MUTANTS):
            print(f"{i}: {name:28s} -> {expected}\n"
                  f"     {doc}")
        return 0

    root = args.repo_root or lint.repo_root_for()

    if args.det_mutate is not None:
        from .determinism import run_mutant
        try:
            mutant, det, caught = run_mutant(root, args.det_mutate)
        except (ValueError, RuntimeError) as e:
            print(f"[analysis] {e}", file=sys.stderr)
            return 2
        for v in det.violations + det.warnings:
            print(v.render())
        verdict = "CAUGHT" if caught else "MISSED"
        print(f"[analysis] determinism mutant {mutant[0]}: {verdict} "
              f"(expected rule: {mutant[2]})")
        return 1 if caught else 0
    if args.mutate is not None:
        from .protocol.model import mutation_entry
        try:
            mutation_entry(args.mutate)
        except ValueError as e:
            print(f"[analysis] {e}", file=sys.stderr)
            return 2

    violations: List[lint.Violation] = []
    ran = set()           # the rule ids whose engines ran (--json counts)
    model_check = args.model_check or args.mutate is not None
    determinism = args.determinism or args.emit_manifest is not None
    audits_selected = (args.concurrency or args.contracts or model_check
                       or determinism)
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
    model = None
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
    det_audit = None
    if determinism or full_default:
        from .determinism import build_audit as build_det_audit
        t0 = time.perf_counter()
        det_audit = build_det_audit(root, paths=args.paths, model=model)
        violations.extend(det_audit.violations)
        ran.update(rid for rid, _ in DETERMINISM_RULES)
        verdicts = Counter(s["verdict"] for s in
                           det_audit.manifest["sources"].values())
        audits["determinism"] = {
            "seconds": round(time.perf_counter() - t0, 3),
            "sources": len(det_audit.manifest["sources"]),
            "verdicts": dict(verdicts),
            "sites": sorted(det_audit.manifest["sites"])}
        if args.emit_manifest:
            text = json.dumps(det_audit.manifest, indent=2) + "\n"
            if args.emit_manifest == "-":
                sys.stdout.write(text)
            else:
                with open(args.emit_manifest, "w") as f:
                    f.write(text)
    mc_result = None
    if model_check or full_default:
        from .protocol import run_conformance
        t0 = time.perf_counter()
        violations.extend(run_conformance(root))
        ran.update(rid for rid, _ in MODEL_RULES
                   if rid != "protocol-invariant")
        audits["conformance"] = {
            "seconds": round(time.perf_counter() - t0, 3)}
    if model_check:
        mc_result, mc_violations = _model_check(args)
        violations.extend(mc_violations)
        ran.add("protocol-invariant")
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
        if det_audit is not None:
            payload["determinism_warnings"] = [
                vars(v) for v in det_audit.warnings]
        if mc_result is not None:
            payload["model_check"] = {
                "config": mc_result.config.describe(),
                "card": mc_result.config.card,
                "mutation": mc_result.mutation,
                "strategy": mc_result.strategy,
                "states": mc_result.states,
                "transitions": mc_result.transitions,
                "elapsed_s": round(mc_result.elapsed_s, 3),
                "exhausted": mc_result.exhausted,
                "invariants": sorted({v.invariant
                                      for v in mc_result.violations})}
        print(json.dumps(payload, indent=2, default=str))
    else:
        for v in new:
            print(v.render())
        if det_audit is not None:
            for v in det_audit.warnings:
                print(f"[warn] {v.render()}")
        if mc_result is not None:
            state = ("exhausted" if mc_result.exhausted
                     else "PARTIAL (cap/depth hit)")
            mut = (f", mutation={mc_result.mutation}"
                   if mc_result.mutation else "")
            print(f"[analysis] model-check: {mc_result.config.describe()}"
                  f"{mut}: {mc_result.states} states / "
                  f"{mc_result.transitions} transitions in "
                  f"{mc_result.elapsed_s:.1f}s ({mc_result.strategy}, "
                  f"{state})")
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
    if new:
        return 1
    if mc_result is not None and not mc_result.exhausted:
        # a clean verdict from a partial exploration proves nothing
        print("[analysis] model-check did not exhaust the bounded "
              "space; clean verdict is unsound (raise --mc-max-states "
              "or --mc-depth, or shrink the config)", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
