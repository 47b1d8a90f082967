"""The port's analysis layer: the runtime sanitizer, the AST lint, the
build audit, the concurrency auditor, the protocol model checker and the
determinism taint audit; one CLI, ``python -m racon_tpu_torch.analysis``.

The counterpart of the JAX package's ``racon_tpu/analysis``:

* **runtime sanitizer** (`sanitize.py`): checks at the partitioner's
  gather and the drivers' install seams, a sampled host recompute, and
  stats-dict guards; armed by arguments (``TorchPolisher(sanitize=True,
  sanitize_parity=N)``, ``--sanitize``), read back with
  ``--sanitize-report``;
* **AST lint** (`lint.py` and `rules/`): the port's six rules
  (``env-registry``, ``knob-docs``, ``fault-point``, ``device-except``,
  ``wall-clock``, ``thread-discipline``) over ``racon_tpu_torch/`` and
  ``chip_smoke.py``;
* **build audit** (`build_audit.py`), in place of the jaxpr audit: the
  CUDA-source audit on the CPU, and on the card (``--plans``) the
  launch-plan audit over the driver's whole window-class grid;
* **concurrency auditor** (`concurrency/`, ``--concurrency`` and
  ``--contracts``): lock discipline and lock order over the threads'
  roles, and the fault-point, degrade-edge, wire-protocol and
  fault-model contracts;
* **protocol model checker** (`protocol/`, ``--model-check``,
  ``--mutate``, ``--emit-schedule``): the fleet chunk lifecycle's
  bounded state space on the card and off it, its invariants, the
  model's conformance to the code, and counterexamples compiled into
  ``RACON_TORCH_FAULT`` schedules with their ``fault_worker``;
* **determinism taint audit** (`determinism/`, ``--determinism``,
  ``--emit-manifest``, ``--det-mutate``): no value the journal's
  fingerprint leaves out (``fingerprint.py`` SOURCES) reaches the
  consensus or CIGAR install seams, and every complete fingerprint
  covers the output-affecting domain.

Suppression: append ``# lint: disable=<rule-id>`` to the flagged line,
or record accepted debt in a baseline file (``--write-baseline``): the
CLI then fails only on new violations.

Importing this package, running the lint, the source audit, the
concurrency auditor, the model checker, the determinism audit or
``--sanitize-report`` imports no torch; only the plan audit and an armed
polish do.
"""

from .lint import Violation, iter_source_files, run_lint  # noqa: F401
from .build_audit import run_source_audit  # noqa: F401

__all__ = ["Violation", "iter_source_files", "run_lint", "run_source_audit"]
