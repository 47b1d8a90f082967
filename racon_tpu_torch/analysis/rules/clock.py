"""wall-clock: no wall-clock reads in the port's resilience and obs layers.

The port's copy of the JAX rule (racon_tpu/analysis/rules/clock.py).
``time.time()`` jumps when NTP steps the clock: a deadline, a backoff or
an elapsed time built on it can go negative or grow by minutes mid-run.
The resilience layer (watchdog deadlines, the memory budget's polls, run
reports) must survive such steps, so it uses ``time.monotonic()`` (or
``time.perf_counter``); the obs layer too, since span durations from a
stepped wall clock render as negative bars. Wall-clock reads are fine
elsewhere (log stamps, unique names), hence the narrow scope. The JAX
rule also covers ``tools/hw_session.py``, which the port does not have.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..lint import FileContext, Violation
from . import dotted_name

_SCOPED = (("resilience",), ("obs",))


class WallClockRule:
    id = "wall-clock"
    doc = ("no time.time() in racon_tpu_torch/resilience/ or "
           "racon_tpu_torch/obs/; deadlines, elapsed time and trace spans "
           "use time.monotonic()")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        if not any(ctx.in_package(*p) for p in _SCOPED):
            return
        # `from time import time` makes every bare time() call a
        # wall-clock read; track the local name it lands on.
        bare_names = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name == "time":
                        bare_names.add(alias.asname or alias.name)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name == "time.time" or name in bare_names:
                yield Violation(
                    self.id, ctx.relpath, node.lineno,
                    "time.time() jumps with NTP steps; use "
                    "time.monotonic() for deadlines/elapsed time "
                    "(wall-clock timestamps belong outside the "
                    "resilience and obs layers)")
