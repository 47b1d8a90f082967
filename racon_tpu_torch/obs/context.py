"""Trace-context propagation for the serve daemon and the fleet.

A copy of the JAX package's module (racon_tpu/obs/context.py).

A *trace context* is two hex tokens — a ``trace_id`` minted once per
coordinator, fleet-plane or submitter run, and a ``parent`` span id
minted per dispatch — that ride the serve and distrib newline-JSON wire
(the ``trace`` payload field of ``distrib.fetch`` and ``serve.submit``)
so a worker's or job's spans can be parented under the dispatcher's
timeline when the traces are merged.

Ids are random (``os.urandom``), not time-derived, so two processes
started in the same tick cannot collide.

The current context is process-global and deliberately lives *outside*
``obs`` arming state: ``obs.reset()`` (called by every polisher
constructor via ``_reset_run_state``) must not clear it, because the
serve session and a distrib worker activate the context *before*
building the job's or chunk's polisher.  ``obs.configure`` reads
``current()`` and stamps the ids onto the tracer, which writes them into
the trace file's provenance block and into each shipment
(``obs.shipment``).
"""

from __future__ import annotations

import os
import threading
from typing import Optional

_lock = threading.Lock()
_current: Optional[dict] = None


def mint_trace_id() -> str:
    """64-bit random hex: one per fleet run."""
    return os.urandom(8).hex()


def mint_span_id() -> str:
    """32-bit random hex: one per dispatch or submit span."""
    return os.urandom(4).hex()


def fresh() -> dict:
    """A new root context (the coordinator's or the plane's)."""
    return {"trace_id": mint_trace_id(), "parent": None}


def child(ctx: Optional[dict]) -> Optional[dict]:
    """The context shipped with one dispatch: the same trace id, a fresh
    parent span id naming the dispatch event. None stays None, so a
    disarmed run ships no context at all."""
    if not ctx or not ctx.get("trace_id"):
        return None
    return {"trace_id": ctx["trace_id"], "parent": mint_span_id()}


def activate(ctx: Optional[dict]) -> None:
    """Install ``ctx`` as this process's current trace context (a worker
    or a job, from the wire; a coordinator, from ``fresh()``).  Passing a
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
