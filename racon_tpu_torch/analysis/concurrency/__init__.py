"""Static concurrency and contract auditor.

The port's counterpart of the JAX package's auditor
(racon_tpu/analysis/concurrency/), pure AST work that imports no torch.

Part A (``--concurrency``): lock discipline. Discovers thread entry
points (``threading.Thread(target=...)``), assigns each a *role* from
the registered role patterns (roles.py), propagates roles through the
intra-repo call graph, infers which attributes and globals each role
mutates, and requires every location mutated by several roles to be
guarded by a consistently held lock, be a sanctioned lock-free type
(queue.Queue, threading.Event, GuardedStats), or carry an explicit
``# concurrency: <reason>`` waiver. Also builds the repo-wide
lock-acquisition-order digraph and fails on cycles.

Part B (``--contracts``): contract extraction. Statically extracts the
``record_degrade`` edges, the fault-point names and the serve/distrib
wire-protocol field sets, then cross-checks them against the declared
spec (serve/protocol.py), the port's tests (``tests/test_torch_*.py``)
and the table rows of README.md's port section.

Both emit ``lint.Violation`` objects, so the baseline, suppression and
CLI plumbing of the lint apply unchanged.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..lint import Violation, repo_root_for


class UnsupportedScope(ValueError):
    """A --paths scope that cannot carry the requested audit."""


def build_model(repo_root: Optional[str] = None,
                paths: Optional[Sequence[str]] = None):
    """The repo model (model.Model) over the linted tree, or over the
    repo-relative file subset `paths`: then cross-file edges to unlisted
    code are invisible by design."""
    from .model import Model
    return Model.build(repo_root or repo_root_for(),
                       list(paths) if paths is not None else None)


def run_concurrency(repo_root: Optional[str] = None,
                    paths: Optional[Sequence[str]] = None,
                    model=None) -> List[Violation]:
    """Run the lock-discipline and lock-order audit over one repo tree,
    on `model` where the caller built it (``build_model``), else on the
    model of `paths`."""
    from .locks import audit
    root = repo_root or repo_root_for()
    return audit(root, model=model or build_model(root, paths))


def contract_anchors() -> set:
    """The files whose violations a scoped ``--contracts`` run can show:
    the fault registry, the protocol declaration and the four wire
    surfaces."""
    from . import contracts
    anchors = {contracts._FAULTS_REL, contracts._PROTOCOL_REL}
    for _surface, consumer, producer in contracts._SURFACES:
        anchors.update((consumer, producer))
    return anchors


def run_contracts(repo_root: Optional[str] = None,
                  paths: Optional[Sequence[str]] = None
                  ) -> List[Violation]:
    """Run the degrade-edge, fault-point and wire-protocol cross-checks.

    paths: a repo-relative scope. The audit still reads the whole tree
    (the contracts cross-reference the tests and README.md), but only
    violations anchored at the scoped files are returned. At least one
    contract anchor (``contract_anchors``) must be in scope; otherwise
    UnsupportedScope is raised, because every contract check would be
    filtered away.
    """
    from . import contracts
    root = repo_root or repo_root_for()
    if paths is None:
        return contracts.audit(root)
    anchors = contract_anchors()
    scoped = set(paths)
    if not scoped & anchors:
        raise UnsupportedScope(
            "--contracts with --paths needs at least one contract "
            "anchor in scope (got none); anchors: "
            + ", ".join(sorted(anchors)))
    return [v for v in contracts.audit(root) if v.path in scoped]
