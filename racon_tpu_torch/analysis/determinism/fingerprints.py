"""Fingerprint-registry extraction for Engine 5 (the port's copy of
racon_tpu/analysis/determinism/fingerprints.py).

Parses the audited tree's ``racon_tpu_torch/fingerprint.py`` literally:
the ``SITES`` dict (composition per fingerprint site) and the
``OUTPUT_SOURCES`` tuple (the input tokens every complete composition
must cover). Literal parsing, not import, keeps fixture mini-trees
self-contained and anchors the audit on exactly what the file says.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .. import astcache
from .knobs import FINGERPRINT_REL


@dataclass
class Site:
    """One fingerprint composition, as declared in SITES."""

    name: str
    helper: str
    complete: bool
    components: Dict[str, Tuple[str, ...]]
    line: int = 0
    component_lines: Dict[str, int] = field(default_factory=dict)


@dataclass
class Registry:
    relpath: str
    output_sources: Tuple[str, ...]
    sites: Dict[str, Site]

    def expanded_coverage(self, site_name: str,
                          _seen: Optional[Set[str]] = None) -> Set[str]:
        """Every source token a site covers, with ``site:<name>``
        references expanded transitively (cycle-safe)."""
        seen = _seen if _seen is not None else set()
        if site_name in seen or site_name not in self.sites:
            return set()
        seen.add(site_name)
        out: Set[str] = set()
        for sources in self.sites[site_name].components.values():
            for token in sources:
                if token.startswith("site:"):
                    out |= self.expanded_coverage(token[5:], seen)
                else:
                    out.add(token)
        return out


def _literal(node) -> object:
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None


def extract_registry(repo_root: str) -> Optional[Registry]:
    """The SITES/OUTPUT_SOURCES literals of the tree's fingerprint.py,
    or None when the tree has no fingerprint registry (the fingerprint
    rules are then skipped: a taint-only audit is still sound)."""
    parsed = astcache.load(repo_root, FINGERPRINT_REL)
    if parsed.tree is None:
        return None
    sources: Tuple[str, ...] = ()
    sites: Dict[str, Site] = {}
    for node in parsed.tree.body:
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        names = {t.id for t in targets if isinstance(t, ast.Name)}
        if "OUTPUT_SOURCES" in names:
            lit = _literal(value)
            if isinstance(lit, (tuple, list)):
                sources = tuple(str(s) for s in lit)
        elif "SITES" in names and isinstance(value, ast.Dict):
            sites = _parse_sites(value)
    if not sites:
        return None
    return Registry(FINGERPRINT_REL, sources, sites)


def _parse_sites(node: ast.Dict) -> Dict[str, Site]:
    out: Dict[str, Site] = {}
    for key, val in zip(node.keys, node.values):
        if not (isinstance(key, ast.Constant) and isinstance(key.value, str)
                and isinstance(val, ast.Dict)):
            continue
        entry = _literal(val)
        if not isinstance(entry, dict):
            continue
        comps_node = next(
            (v for k, v in zip(val.keys, val.values)
             if isinstance(k, ast.Constant) and k.value == "components"
             and isinstance(v, ast.Dict)), None)
        comp_lines: Dict[str, int] = {}
        if comps_node is not None:
            for ck, cv in zip(comps_node.keys, comps_node.values):
                if isinstance(ck, ast.Constant):
                    comp_lines[str(ck.value)] = cv.lineno
        raw = entry.get("components") or {}
        comps = {str(c): tuple(str(s) for s in srcs)
                 for c, srcs in raw.items()
                 if isinstance(srcs, (tuple, list))}
        out[key.value] = Site(
            name=key.value,
            helper=str(entry.get("helper", "")),
            complete=bool(entry.get("complete", False)),
            components=comps,
            line=key.lineno,
            component_lines=comp_lines)
    return out
