"""The machine-readable ``determinism.json`` manifest (the port's copy of
racon_tpu/analysis/determinism/manifest.py).

One document per audit: every source with its declared and analysed
output-affecting verdict, its read sites and its flows into the install
seams, and every fingerprint site with its components and expanded
coverage.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import fingerprints, knobs, rules, taint

VERSION = 1


def build(state: taint.State,
          decls: Dict[str, knobs.SourceDecl],
          fp_reg: Optional[fingerprints.Registry],
          violations: List) -> dict:
    source_entries: Dict[str, dict] = {}
    for name in sorted(decls):
        decl = decls[name]
        reads = sorted((r for r in state.reads.values()
                        if r.source == name),
                       key=lambda r: (r.relpath, r.line))
        flows = sorted((h for h in state.hits.values()
                        if h.source == name),
                       key=lambda h: (h.relpath, h.line))
        leaks = [h for h in flows if h.waived is None]
        affects = decl.affects_output or bool(leaks)
        source_entries[name] = {
            "declared_at": {"path": decl.relpath, "func": decl.func,
                            "where": decl.where},
            "declared_affects_output": decl.affects_output,
            "affects_output": affects,
            "verdict": "output-affecting" if affects else "cost-only",
            "reads": [{"path": r.relpath, "line": r.line,
                       "func": r.func,
                       **({"waived": r.waived} if r.waived else {})}
                      for r in reads],
            "sink_flows": [{"path": h.relpath, "line": h.line,
                            "seam": h.seam, "func": h.func,
                            **({"waived": h.waived} if h.waived
                               else {})}
                           for h in flows],
        }

    site_entries: Dict[str, dict] = {}
    if fp_reg is not None:
        for name in sorted(fp_reg.sites):
            site = fp_reg.sites[name]
            site_entries[name] = {
                "helper": site.helper,
                "complete": site.complete,
                "line": site.line,
                "components": {c: list(site.components[c])
                               for c in sorted(site.components)},
                "expanded_coverage":
                    sorted(fp_reg.expanded_coverage(name)),
            }

    errors = [v for v in violations if v.rule not in rules.WARNING_RULES]
    warnings = [v for v in violations if v.rule in rules.WARNING_RULES]
    return {
        "version": VERSION,
        "engine": "racon_tpu_torch.analysis.determinism",
        "taint_iterations": state.iterations,
        "required_domain": sorted(rules.required_domain(fp_reg, decls)),
        "sources": source_entries,
        "sites": site_entries,
        "violations": {
            "errors": [vars(v) for v in errors],
            "warnings": [vars(v) for v in warnings],
        },
    }
