"""Lint rule registry and the small AST helpers the rules share.

The port's counterparts of the JAX package's rules
(racon_tpu/analysis/rules/): ``env-registry`` and ``knob-docs``
(knobs.py), ``fault-point`` (faultpoints.py), ``device-except``
(excepts.py), ``wall-clock`` (clock.py) and ``thread-discipline``
(threads.py, over the roles of ``concurrency/roles.py``). Two JAX rules
have none here: ``tracer-leak`` (the port traces nothing: a kernel is a
CUDA source called through ctypes) and ``kernel-cache-key`` (the port
builds one library a source, not a kernel a shape and a device topology,
so there is no cache key to get wrong).

Every rule is an object with:

* ``id``: kebab-case identifier (used in suppressions and baselines);
* ``doc``: one-line rationale (``--list-rules``);
* ``check(ctx: FileContext) -> Iterable[Violation]``;
* optionally ``check_project(project: ProjectContext)`` for cross-file
  invariants (run once a lint, after the per-file pass).
"""

from __future__ import annotations

import ast
from typing import Optional


def dotted_name(node: ast.AST) -> str:
    """'os.environ.get' for the func of a Call; '' when not a plain
    name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def last_attr(node: ast.AST) -> str:
    """The final component of a call target ('get' for os.environ.get)."""
    name = dotted_name(node)
    return name.rsplit(".", 1)[-1] if name else ""


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


from .knobs import EnvRegistryRule, KnobDocsRule  # noqa: E402
from .faultpoints import FaultPointRule       # noqa: E402
from .excepts import DeviceExceptRule         # noqa: E402
from .clock import WallClockRule              # noqa: E402
from .threads import ThreadsRule              # noqa: E402

#: All rules, in documentation order.
ALL_RULES = (
    EnvRegistryRule(),
    KnobDocsRule(),
    FaultPointRule(),
    DeviceExceptRule(),
    WallClockRule(),
    ThreadsRule(),
)

RULES_BY_ID = {r.id: r for r in ALL_RULES}
