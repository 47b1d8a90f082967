"""Trace-context propagation for the serve daemon.

A copy of the JAX package's module (racon_tpu/obs/context.py), less its
minting side (``mint_trace_id``, ``fresh``, ``child``), which only the
JAX package's fleet and distributed modules call; their port will bring
it.

A *trace context* is two hex tokens — a ``trace_id`` minted once per
submitter run, and a ``parent`` span id minted per dispatch — that ride
the serve newline-JSON wire (the ``trace`` payload field of
``serve.submit``) so a job's spans can be parented under the
submitter's timeline when the traces are merged.

The current context is process-global and deliberately lives *outside*
``obs`` arming state: ``obs.reset()`` (called by every polisher
constructor via ``_reset_run_state``) must not clear it, because the
serve session activates the context *before* building the job's
polisher.  ``obs.configure`` reads ``current()`` and stamps the ids
onto the tracer, which writes them into the trace file's provenance
block and into each shipment (``obs.shipment``).
"""

from __future__ import annotations

import threading
from typing import Optional

_lock = threading.Lock()
_current: Optional[dict] = None


def activate(ctx: Optional[dict]) -> None:
    """Install ``ctx`` as this process's current trace context (from
    the wire).  Passing a
    malformed dict deactivates instead of half-installing."""
    global _current
    ok = (isinstance(ctx, dict)
          and isinstance(ctx.get("trace_id"), str) and ctx["trace_id"])
    with _lock:
        _current = ({"trace_id": ctx["trace_id"],
                     "parent": ctx.get("parent")} if ok else None)


def clear() -> None:
    global _current
    with _lock:
        _current = None


def current() -> Optional[dict]:
    with _lock:
        return dict(_current) if _current else None
