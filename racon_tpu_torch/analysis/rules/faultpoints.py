"""fault-point: every `faults.check(...)` name is a registered point.

The port's copy of the JAX rule (racon_tpu/analysis/rules/faultpoints.py)
against the port's registry, ``racon_tpu_torch.resilience.faults
.KNOWN_POINTS``. A ``faults.check("poa.run.sl")`` typo would assert at
run time only on the one path that reaches it; this rule resolves every
literal (and f-string pattern) passed to ``faults.check`` at lint time.

f-strings are matched structurally: ``f"poa.run.{kind}"`` passes iff at
least one known point matches ``poa.run.*``. A name held in a variable is
left to the run-time assert.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional

from ..lint import FileContext, Violation
from . import dotted_name, str_const


def _known_points():
    from ...resilience.faults import KNOWN_POINTS
    return KNOWN_POINTS


def _fstring_regex(node: ast.JoinedStr) -> Optional[str]:
    """'^poa\\.run\\..+$' for f"poa.run.{kind}"; None when the f-string
    has no literal part at all (matches anything: unverifiable)."""
    parts = []
    has_literal = False
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(re.escape(v.value))
            has_literal = True
        else:
            parts.append(".+")
    return "^" + "".join(parts) + "$" if has_literal else None


class FaultPointRule:
    id = "fault-point"
    doc = ("every faults.check(name) literal/pattern must resolve to a "
           "point of racon_tpu_torch.resilience.faults.KNOWN_POINTS")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        known = _known_points()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            func = dotted_name(node.func)
            if not (func == "faults.check" or func.endswith(".faults.check")):
                continue
            if not node.args:
                continue
            arg = node.args[0]
            lit = str_const(arg)
            if lit is not None:
                if lit not in known:
                    yield Violation(
                        self.id, ctx.relpath, node.lineno,
                        f"fault point {lit!r} is not registered in "
                        f"resilience.faults.KNOWN_POINTS")
                continue
            if isinstance(arg, ast.JoinedStr):
                pattern = _fstring_regex(arg)
                if pattern is None:
                    continue  # fully dynamic: the run-time assert covers it
                if not any(re.match(pattern, p) for p in known):
                    yield Violation(
                        self.id, ctx.relpath, node.lineno,
                        f"fault-point pattern {pattern!r} matches no "
                        f"registered injection point")
