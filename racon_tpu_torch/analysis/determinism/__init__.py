"""Engine 5: the determinism taint audit (``--determinism``).

The port's copy of racon_tpu/analysis/determinism. It proves the
byte-identity contract statically: every source that
``racon_tpu_torch/fingerprint.py`` SOURCES declares (the card's
arguments of ``TorchPolisher``, ``num_threads`` and the
``RACON_TORCH_FAULT`` read: what the journal's fingerprint leaves out)
is classified **output-affecting** or **cost-only** by propagating
explicit dataflow taint from its read sites through the
interprocedural call graph (the concurrency auditor's model,
``concurrency/model.py``) to the consensus and CIGAR install seams
(``pipeline.set_consensus`` / ``pipeline.set_job_cigar``:
``poa_driver._install`` and its host fallback, ``align_cuda.run_jobs``,
journal replay). The verdicts are then held against the fingerprint
compositions declared in the same file:

* ``determinism-leak``: a cost-only source's value reaches an install
  seam (the contract broken in code);
* ``fingerprint-gap``: an output-affecting input or source missing from
  a composition declared complete (a resume could replay stale bytes);
* ``fingerprint-overkey`` (warning): a component keyed only on
  cost-only, taint-clean sources (needless misses).

Violations are ordinary ``lint.Violation`` objects, so the baseline,
suppression and CLI plumbing apply unchanged; intentional flows carry a
``# determinism: <reason>`` waiver on (or directly above) the flagged
line. ``--emit-manifest`` writes the whole classification as
``determinism.json``. Nothing here imports torch.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..lint import _EXCLUDE_DIRS, _EXTRA_FILES, PACKAGE, Violation, \
    repo_root_for
from .rules import WARNING_RULES

__all__ = [
    "AuditResult", "MUTANTS", "WARNING_RULES", "build_audit",
    "run_determinism", "run_mutant",
]


@dataclass
class AuditResult:
    """One Engine 5 run: hard violations, warnings, and the manifest."""

    violations: List[Violation] = field(default_factory=list)
    warnings: List[Violation] = field(default_factory=list)
    manifest: Dict = field(default_factory=dict)


def build_audit(repo_root: Optional[str] = None,
                paths: Optional[Sequence[str]] = None,
                model=None) -> AuditResult:
    """Run the full audit over one repo tree.

    paths: a repo-relative file subset: the taint model is built from
    just these files (flows through unlisted code are invisible by
    design, as with ``--concurrency``); the source and fingerprint
    registries are always read from fingerprint.py, so the fingerprint
    rules judge the real contract either way. model: the concurrency
    model of the same scope where the caller built it.
    """
    from ..concurrency.model import Model
    from . import fingerprints, knobs, manifest, rules, taint
    root = repo_root or repo_root_for()
    if model is None:
        model = Model.build(root,
                            list(paths) if paths is not None else None)
    decls = knobs.extract_registry(root) or {}
    state = taint.analyze(model, decls)
    fp_reg = fingerprints.extract_registry(root)
    viols = rules.evaluate(state, decls, fp_reg)
    return AuditResult(
        violations=[v for v in viols if v.rule not in WARNING_RULES],
        warnings=[v for v in viols if v.rule in WARNING_RULES],
        manifest=manifest.build(state, decls, fp_reg, viols))


def run_determinism(repo_root: Optional[str] = None,
                    paths: Optional[Sequence[str]] = None
                    ) -> List[Violation]:
    """The hard (non-warning) violations of one audit: the shape every
    other engine's ``run_*`` entry point returns."""
    return build_audit(repo_root, paths).violations


# --------------------------------------------------------------------------
# seeded mutants: prove the audit catches what it claims to catch
# --------------------------------------------------------------------------

#: (name, doc, expected rule, patches): each patch is a (relpath,
#: old text, new text) exact-match substitution applied to a scratch
#: copy of the tree. ``--det-mutate NAME`` (or index) must then report
#: the expected rule, else the self-test failed.
MUTANTS = [
    ("drop-input-bytes",
     "remove the input_bytes component from the journal fingerprint "
     "composition: the declared-complete site no longer covers the "
     "problem's input bytes",
     "fingerprint-gap",
     [("racon_tpu_torch/fingerprint.py",
       '            "params": ("input:params",),\n'
       '            "input_bytes": ("input:sequences", "input:overlaps",\n'
       '                            "input:target"),\n',
       '            "params": ("input:params",),\n')]),
    ("leak-pipeline-depth",
     "route the pipeline_depth argument's value into the card's "
     "consensus payload installed by poa_driver._install",
     "determinism-leak",
     [("racon_tpu_torch/ops/poa_driver.py",
       "    fallback: List[int] = []\n",
       "    fallback: List[int] = []\n"
       "    stats[\"pipeline_depth\"] = pipeline_depth\n"),
      ("racon_tpu_torch/ops/poa_driver.py",
       "        payload = decode(codes)\n",
       "        payload = decode(codes) + str(\n"
       "            stats[\"pipeline_depth\"]).encode()\n")]),
    ("overkey-tier",
     "key the journal fingerprint on the POA kernel argument: a "
     "cost-only, taint-clean source would force fingerprint misses "
     "between byte-identical runs",
     "fingerprint-overkey",
     [("racon_tpu_torch/fingerprint.py",
       '            "backend": ("input:backend",),\n'
       '            "params": ("input:params",),\n',
       '            "backend": ("input:backend",),\n'
       '            "tier": ("source:poa_kernel",),\n'
       '            "params": ("input:params",),\n')]),
    ("drop-journal-waiver",
     "strip the documented waiver from the journal's window replay: the "
     "intentional journal-bytes flow must resurface as a "
     "determinism-leak",
     "determinism-leak",
     [("racon_tpu_torch/resilience/journal.py",
       "            # determinism: replayed bytes are journal records\n",
       "            # (waiver stripped by the seeded mutant)\n")]),
]


def _copy_sources(root: str, dest: str) -> None:
    """The linted sources of `root` (``racon_tpu_torch/`` without its
    build directories and bytecode caches, and ``chip_smoke.py``) into
    `dest`: on the card's machine the build directories hold built
    libraries."""
    def ignore(dirpath, names):
        return [n for n in names
                if n in _EXCLUDE_DIRS or n.startswith("build")
                and os.path.isdir(os.path.join(dirpath, n))]

    shutil.copytree(os.path.join(root, PACKAGE),
                    os.path.join(dest, PACKAGE), ignore=ignore)
    for extra in _EXTRA_FILES:
        src = os.path.join(root, extra)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(dest, extra))


def run_mutant(repo_root: Optional[str], which: str) -> tuple:
    """Apply one seeded mutant to a scratch copy of the tree and audit
    it. Returns ``(mutant, AuditResult, caught)``."""
    root = repo_root or repo_root_for()
    by_name = {m[0]: m for m in MUTANTS}
    if which in by_name:
        mutant = by_name[which]
    else:
        try:
            mutant = MUTANTS[int(which)]
        except (ValueError, IndexError):
            raise ValueError(
                f"unknown determinism mutant {which!r}; see "
                f"--list-det-mutations") from None
    tmp = tempfile.mkdtemp(prefix="racon-det-mutant-")
    try:
        _copy_sources(root, tmp)
        for rel, old, new in mutant[3]:
            path = os.path.join(tmp, rel)
            with open(path) as f:
                text = f.read()
            if old not in text:
                raise RuntimeError(
                    f"determinism mutant {mutant[0]}: patch anchor not "
                    f"found in {rel} (tree drifted; update MUTANTS)")
            with open(path, "w") as f:
                f.write(text.replace(old, new, 1))
        audit = build_audit(tmp)
        caught = any(v.rule == mutant[2]
                     for v in audit.violations + audit.warnings)
        return mutant, audit, caught
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
