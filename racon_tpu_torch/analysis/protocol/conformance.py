"""Model <-> implementation conformance (the drift guard): the port's
copy of racon_tpu/analysis/protocol/conformance.py, over the port's tree
(``racon_tpu_torch/`` and ``chip_smoke.py``).

The protocol model is only worth trusting while it matches the code it
claims to abstract, so every entry in ``model.TRANSITIONS`` is
cross-checked against the analyzed tree — in both directions:

* **model-site** — the transition's declared code site must exist: the
  file parses and defines the named callable.  A renamed or deleted
  handler breaks this before the model silently checks dead code.
* **model-fault** — the transition's declared fault point must be in
  ``faults.KNOWN_POINTS``; a point the runtime grammar does not know
  can never be injected, so its counterexamples would be unreplayable.
* **model-coverage** — the reverse direction: every literal
  ``faults.check("...")`` call site on a fleet-scoped point
  (``worker.*`` / ``pool.*`` / ``lease.*``) must be claimed by some
  model transition.  An injection point the model does not know about
  is an unchecked failure mode.

``TRANSITIONS`` is read from the analyzed tree's AST
(``ast.literal_eval``), never imported — fixture mini-trees can carry
deliberately-drifted models, and the pass always judges the tree it is
pointed at rather than the interpreter's copy.  A tree without a
protocol model (or without ``faults.py``) skips the respective checks,
contracts-style.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .. import astcache
from ..concurrency import contracts
from ..lint import PACKAGE, Violation, iter_source_files

MODEL_SITE = "model-site"
MODEL_FAULT = "model-fault"
MODEL_COVERAGE = "model-coverage"

MODEL_REL = f"{PACKAGE}/analysis/protocol/model.py"

#: KNOWN_POINTS prefixes the fleet control plane owns; everything else
#: (align.*, poa.*, journal.*, ...) belongs to the polishing engines.
FLEET_PREFIXES = ("worker.", "pool.", "lease.")

#: (name, site_file, site_callable, fault_point_or_None, decl_line)
Entry = Tuple[str, str, str, Optional[str], int]


def _transitions(repo_root: str
                 ) -> Tuple[Optional[List[Entry]], List[Violation]]:
    """TRANSITIONS entries from the tree's model.py AST, with per-entry
    declaration lines.  (None, []) when the tree has no model."""
    parsed = astcache.load(repo_root, MODEL_REL)
    if parsed.tree is None:
        return None, []
    for node in parsed.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "TRANSITIONS"):
            break
    else:
        return None, [Violation(
            MODEL_SITE, MODEL_REL, 1,
            "protocol model defines no TRANSITIONS literal")]
    if not isinstance(node.value, (ast.Tuple, ast.List)):
        return None, [Violation(
            MODEL_SITE, MODEL_REL, node.lineno,
            "TRANSITIONS must be a pure tuple literal")]
    entries: List[Entry] = []
    out: List[Violation] = []
    for elt in node.value.elts:
        try:
            name, rel, fn, point = ast.literal_eval(elt)
        except (ValueError, SyntaxError, TypeError):
            out.append(Violation(
                MODEL_SITE, MODEL_REL, elt.lineno,
                "TRANSITIONS entry is not a pure "
                "(name, file, callable, fault_point) literal"))
            continue
        entries.append((name, rel, fn, point, elt.lineno))
    return entries, out


def _defined_callables(tree: ast.Module) -> set:
    return {n.name for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _site_checks(repo_root: str,
                 entries: List[Entry]) -> List[Violation]:
    out: List[Violation] = []
    for name, rel, fn, _point, line in entries:
        parsed = astcache.load(repo_root, rel)
        if parsed.tree is None:
            out.append(Violation(
                MODEL_SITE, MODEL_REL, line,
                f"transition {name}: code site {rel} is missing from "
                f"the analyzed tree"))
        elif fn not in _defined_callables(parsed.tree):
            out.append(Violation(
                MODEL_SITE, MODEL_REL, line,
                f"transition {name}: {rel} defines no callable "
                f"{fn!r} — the model points at dead code"))
    return out


def _fault_checks(repo_root: str, entries: List[Entry],
                  known: Dict[str, int]) -> List[Violation]:
    out: List[Violation] = []
    for name, _rel, _fn, point, line in entries:
        if point is not None and point not in known:
            out.append(Violation(
                MODEL_FAULT, MODEL_REL, line,
                f"transition {name}: fault point {point!r} is not in "
                f"faults.KNOWN_POINTS — its counterexamples cannot "
                f"be injected"))
    return out


def _coverage_checks(repo_root: str,
                     entries: List[Entry]) -> List[Violation]:
    claimed = {e[3] for e in entries if e[3] is not None}
    out: List[Violation] = []
    for rel in iter_source_files(repo_root):
        if rel == MODEL_REL:
            continue
        parsed = astcache.load(repo_root, rel)
        if parsed.tree is None:
            continue
        for node in ast.walk(parsed.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "check"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue
            point = node.args[0].value
            if (point.startswith(FLEET_PREFIXES)
                    and point not in claimed):
                out.append(Violation(
                    MODEL_COVERAGE, rel, node.lineno,
                    f"fleet fault point {point!r} is injected here "
                    f"but no protocol-model transition claims it — "
                    f"an unchecked failure mode"))
    return out


def audit(repo_root: str) -> List[Violation]:
    entries, out = _transitions(repo_root)
    if entries is None:
        return out          # tree carries no protocol model: skip
    out.extend(_site_checks(repo_root, entries))
    known = dict(contracts.fault_points(repo_root))
    if known:               # no faults.py in tree: skip fault checks
        out.extend(_fault_checks(repo_root, entries, known))
        out.extend(_coverage_checks(repo_root, entries))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule, v.message))
