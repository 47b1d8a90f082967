"""Engine 4: the protocol model checker (``--model-check``).

The port's copy of racon_tpu/analysis/protocol: an explicit-state
checker over a formal, untimed model of the fleet chunk lifecycle
(model.py, with the ``card`` axis: on the card retry exhaustion fails
the job, off it the local floor polishes the chunk), an invariant
library evaluated over every reachable state (invariants.py), BFS/DFS
exploration with minimal counterexample traces (checker.py), a compiler
from counterexamples to replayable ``RACON_TORCH_FAULT`` schedules with
their ``fault_worker`` (replay.py), and a model <-> implementation
conformance pass (conformance.py) that keeps the model from drifting
away from the port's code.

The conformance pass emits ``lint.Violation`` objects, so the baseline,
suppression and CLI plumbing apply unchanged; the state exploration has
its own entry points below and is not part of a default full-tree run
(exhausting the bounded space costs seconds the lint path must not
pay). Nothing here imports torch.
"""

from __future__ import annotations

from typing import List, Optional

from ..lint import Violation, repo_root_for
from .checker import Result, check          # noqa: F401 (re-export)
from .model import (Config, MUTATIONS, TRANSITIONS,   # noqa: F401
                    mutation_names)


def run_conformance(repo_root: Optional[str] = None) -> List[Violation]:
    """Run the model <-> code conformance pass over one repo tree."""
    from .conformance import audit
    root = repo_root or repo_root_for()
    return audit(root)
