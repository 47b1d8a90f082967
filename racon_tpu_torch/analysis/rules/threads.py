"""thread-discipline: every thread carries a registered role; no
sleeping under a lock.

The port's copy of the JAX rule (racon_tpu/analysis/rules/threads.py).
The concurrency auditor (``racon_tpu_torch/analysis/concurrency``)
reasons about *roles*, which named thread reaches which mutation site,
so an anonymous thread is invisible to it. Hence every
``threading.Thread(...)`` must pass ``daemon=`` explicitly (an
accidental non-daemon thread wedges interpreter shutdown) and a
``name=`` matching a role pattern registered in
``concurrency/roles.py``.

``time.sleep()`` lexically inside a ``with <lock>:`` block stalls every
other thread contending for that lock for the whole sleep; use
``Condition.wait(timeout)`` (which releases the lock) or sleep outside
the block.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..lint import FileContext, Violation
from . import dotted_name
from ..concurrency.roles import role_is_registered

#: with-item context expressions whose final name component matches one
#: of these fragments are treated as lock guards for the sleep check.
_LOCKISH = ("lock", "_cv", "cond", "mutex", "_sem", "_mu")


def _patternized_name(node) -> str:
    """Thread name with f-string interpolations collapsed to ``*``."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("*")
        return "".join(parts)
    return ""


def _lockish(expr) -> bool:
    name = dotted_name(expr)
    if not name:
        return False
    last = name.rsplit(".", 1)[-1].lower()
    return any(frag in last for frag in _LOCKISH)


class ThreadsRule:
    id = "thread-discipline"
    doc = ("threading.Thread needs daemon= and a name= matching a "
           "registered role (concurrency/roles.py); no time.sleep() "
           "under a lock")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        lock_depth = 0
        bare_thread = any(
            isinstance(n, ast.ImportFrom) and n.module == "threading"
            and any(a.name == "Thread" and a.asname is None
                    for a in n.names)
            for n in ast.walk(ctx.tree))

        def visit(node):
            nonlocal lock_depth
            if isinstance(node, ast.Call):
                yield from self._check_call(ctx, node, lock_depth,
                                            bare_thread)
            holds = 0
            if isinstance(node, (ast.With, ast.AsyncWith)):
                holds = sum(1 for item in node.items
                            if _lockish(item.context_expr))
            lock_depth += holds
            for child in ast.iter_child_nodes(node):
                yield from visit(child)
            lock_depth -= holds

        yield from visit(ctx.tree)

    def _check_call(self, ctx: FileContext, node: ast.Call,
                    lock_depth: int,
                    bare_thread: bool) -> Iterable[Violation]:
        name = dotted_name(node.func)
        if name == "time.sleep" and lock_depth > 0:
            yield Violation(
                self.id, ctx.relpath, node.lineno,
                "time.sleep() under a lock stalls every contending "
                "thread for the whole sleep; use Condition.wait(timeout) "
                "or sleep outside the with block")
            return
        if name not in ("threading.Thread", "Thread"):
            return
        if name == "Thread" and not bare_thread:
            return
        kwargs = {kw.arg: kw.value for kw in node.keywords
                  if kw.arg is not None}
        if "daemon" not in kwargs:
            yield Violation(
                self.id, ctx.relpath, node.lineno,
                "threading.Thread without an explicit daemon= — an "
                "accidental non-daemon thread wedges interpreter "
                "shutdown; decide and say so")
        if "name" not in kwargs:
            yield Violation(
                self.id, ctx.relpath, node.lineno,
                "threading.Thread without a name= carrying a registered "
                "thread role (see concurrency/roles.py); anonymous "
                "threads are invisible to the lock-discipline audit")
            return
        thread_name = _patternized_name(kwargs["name"])
        if not thread_name or not role_is_registered(thread_name):
            shown = thread_name or "<non-literal>"
            yield Violation(
                self.id, ctx.relpath, node.lineno,
                f"thread name {shown!r} does not match any registered "
                f"role pattern in concurrency/roles.py; register the "
                f"role or reuse an existing one")
