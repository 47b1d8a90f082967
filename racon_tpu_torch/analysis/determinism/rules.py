"""Engine 5 rule evaluation (the port's copy of
racon_tpu/analysis/determinism/rules.py).

Three rules over the taint state plus the two literal registries of
``racon_tpu_torch/fingerprint.py`` (``SOURCES``, and ``SITES`` with
``OUTPUT_SOURCES``):

* ``determinism-leak``: a source declared cost-only whose value reaches
  an install-seam payload. Anchored at the sink call.
* ``fingerprint-gap``: a fingerprint site declared ``complete`` whose
  expanded composition misses a token of the required domain (every
  ``OUTPUT_SOURCES`` entry plus ``source:<name>`` for every source
  declared ``affects_output``). Anchored at the site's line in
  fingerprint.py.
* ``fingerprint-overkey`` (warning): a site component whose tokens are
  all cost-only, taint-clean sources: equal-output runs would get
  needless fingerprint misses. Anchored at the component's line.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..lint import Violation
from . import fingerprints, knobs, taint

#: Rules that report but never fail the run.
WARNING_RULES = frozenset({"fingerprint-overkey"})

#: The token prefix of a declared source in a composition.
TOKEN = "source:"


def required_domain(fp_reg: Optional[fingerprints.Registry],
                    decls: Dict[str, knobs.SourceDecl]) -> Set[str]:
    """Every token a complete fingerprint composition must cover."""
    domain: Set[str] = set(fp_reg.output_sources) if fp_reg else set()
    for d in decls.values():
        if d.affects_output:
            domain.add(f"{TOKEN}{d.name}")
    return domain


def leak_violations(state: taint.State,
                    decls: Dict[str, knobs.SourceDecl]
                    ) -> List[Violation]:
    out = []
    for hit in state.hits.values():
        if hit.waived is not None:
            continue
        decl = decls.get(hit.source)
        if decl is not None and decl.affects_output:
            continue                    # declared output-affecting: fine
        out.append(Violation(
            "determinism-leak", hit.relpath, hit.line,
            f"source {hit.source} (declared cost-only) flows into the "
            f"{hit.seam} payload in {hit.func}: output bytes may depend "
            f"on it; declare it affects_output in fingerprint.py SOURCES "
            f"and cover {TOKEN}{hit.source} in the fingerprint, or cut "
            f"the flow (`# determinism: <reason>` if intentional)"))
    return out


def gap_violations(fp_reg: Optional[fingerprints.Registry],
                   decls: Dict[str, knobs.SourceDecl]) -> List[Violation]:
    if fp_reg is None:
        return []
    domain = required_domain(fp_reg, decls)
    out = []
    for name in sorted(fp_reg.sites):
        site = fp_reg.sites[name]
        if not site.complete:
            continue
        covered = fp_reg.expanded_coverage(name)
        for token in sorted(domain - covered):
            out.append(Violation(
                "fingerprint-gap", fp_reg.relpath, site.line,
                f"site `{name}` is declared complete but its "
                f"composition misses required token `{token}`: two "
                f"runs differing on it would collide to one "
                f"fingerprint"))
    return out


def overkey_violations(fp_reg: Optional[fingerprints.Registry],
                       decls: Dict[str, knobs.SourceDecl],
                       state: taint.State) -> List[Violation]:
    if fp_reg is None:
        return []
    flowed = {hit.source for hit in state.hits.values()}
    out = []
    for name in sorted(fp_reg.sites):
        site = fp_reg.sites[name]
        for comp in sorted(site.components):
            tokens = site.components[comp]
            names = [t[len(TOKEN):] for t in tokens
                     if t.startswith(TOKEN)]
            if not tokens or len(names) != len(tokens):
                continue                # any input token earns its keep
            if any(n in flowed or decls.get(n) is None
                   or decls[n].affects_output for n in names):
                continue
            out.append(Violation(
                "fingerprint-overkey", fp_reg.relpath,
                site.component_lines.get(comp, site.line),
                f"site `{name}` component `{comp}` keys only on "
                f"cost-only, taint-clean source(s) "
                f"{', '.join(sorted(names))}: equal-output runs get "
                f"needless fingerprint misses"))
    return out


def evaluate(state: taint.State,
             decls: Dict[str, knobs.SourceDecl],
             fp_reg: Optional[fingerprints.Registry]) -> List[Violation]:
    """Every Engine 5 violation (warnings included) of one audit."""
    return (leak_violations(state, decls)
            + gap_violations(fp_reg, decls)
            + overkey_violations(fp_reg, decls, state))
