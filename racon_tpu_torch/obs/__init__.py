"""Span tracing and metrics for the port's polish.

A copy of the JAX package's obs core (racon_tpu/obs/__init__.py): one
module-level armed/disarmed switch feeds

* a **span tracer** (tracer.Tracer) writing Chrome-trace JSON: the phase
  spans ``phase.<name>`` (PHASES), the align cohorts, POA buckets and
  batches, journal replays, the kernel build, and instant events for
  injected faults and watchdog timeouts;
* a **metrics registry** (metrics.Metrics): counters and log2
  histograms. ``served.<phase>.<tier>`` counters are fed by
  ``PhaseReport.record_served`` itself, so ``served_sum_check`` checks the
  run report against them.

The names of spans and counters are the JAX package's, so that one reader
serves both packages' traces. Windows and alignment jobs are counted, not
spanned: the spans are per phase, cohort, bucket and batch.

Arming: ``configure(trace_path=..., metrics=...)``, which the polisher
constructors call after ``reset()`` (CLI ``--trace``). Disarmed, every
hook is a no-op and no file is written; the polish's bytes never depend
on it.

**The device track.** Armed on the card (``arm_device_track``), every
polish-path launch (the wrappers' ``cuda_lib.launch_events``) becomes one
complete event on a track of its own, named by its ``cuda_lib.LAUNCHES``
name (on a card other than cuda:0, by the card's index and that name;
the event's ``card`` arg is the index). Its start and end are the CUDA
events the wrapper records around the launch call, mapped to the host
clock through a reference event of the launch's card, recorded, after a
synchronize, with its ``monotonic_ns`` at arming: one for each distinct
card of a striped polish, since events of two cards cannot be timed
against each other. Launches of two streams on one card (a virtual
stripe) share its tracks; the reader counts their overlap once. The
events are read only in ``write_trace``, after a synchronize: an event
read before its stream has reached it raises. The track has its own sink
(``cuda_lib.TRACE_EVENTS``), so a caller's ``cuda_lib.LAUNCH_EVENTS`` list
sees every launch as before.

**Process identity and history** (for the serve daemon; they survive
``reset()``): the process role (``set_role``), the trace context
(``obs.context``, stamped on the tracer at arming), the flight recorder
(``obs.flight``: every instant event and finished span is breadcrumbed
there), and the telemetry ring (``telemetry_tick``, ``telemetry``; 64
entries, the JAX package's ``RACON_TPU_TELEMETRY_RING`` default). A job's
spans ship with its result (``shipment``, at most 1,500 events, the
JAX package's ``RACON_TPU_OBS_SHIP_EVENTS`` default), in the JAX
package's format, which either package's ``absorb`` folds into a
tracing coordinator's or fleet plane's timeline.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Optional

from . import context, flight
from .metrics import Metrics
from .tracer import NULL_SPAN, Span, Tracer

#: The five phases every polish decomposes into, in order; span names
#: are ``phase.<name>``.
PHASES = ("parse", "align", "window_assign", "poa", "stitch")

#: The device track's thread ids: this plus the kernel's index in
#: ``cuda_lib.LAUNCHES``.
DEVICE_TID = 1 << 20

#: Trace events a job's shipment carries at most, and the telemetry
#: ring's length: the JAX package's RACON_TPU_OBS_SHIP_EVENTS and
#: RACON_TPU_TELEMETRY_RING defaults.
SHIP_EVENTS = 1500
TELEMETRY_RING = 64

_lock = threading.Lock()
_tracer: Optional[Tracer] = None
_metrics: Optional[Metrics] = None
_trace_path: Optional[str] = None
_device = None   # {card index: (reference event, its monotonic_ns)}

# The process role ("serve", ...) for merged timelines; survives reset():
# a process keeps its identity across every run it hosts.
_role: Optional[str] = None

# The live-telemetry ring (the daemon's `stats` op scrapes it); survives
# reset(): it is the process's history, not a run's state.
_telemetry_lock = threading.Lock()
_telemetry = collections.deque(maxlen=TELEMETRY_RING)


# -- arming ----------------------------------------------------------------

def reset() -> None:
    """Disarm and drop the collected state, the device track's sink
    included (the polisher constructors call it before ``configure``).
    The role, the trace context, the flight recorder and the telemetry
    ring survive."""
    global _tracer, _metrics, _trace_path, _device
    with _lock:
        _tracer = None
        _metrics = None
        _trace_path = None
        _device = None
    cuda_lib = sys.modules.get(__package__.rsplit(".", 1)[0]
                               + ".ops.cuda_lib")
    if cuda_lib is not None:
        cuda_lib.TRACE_EVENTS = None


def configure(trace_path: Optional[str] = None,
              metrics: bool = False) -> None:
    """Arm for one run: spans and metrics, written to `trace_path` by
    ``write_trace``; ``metrics`` alone collects both in memory for the
    report's snapshot. Tracing implies metrics. Re-arming with the path
    already armed keeps what was collected."""
    global _tracer, _metrics, _trace_path
    if not trace_path and not metrics:
        return
    with _lock:
        if _tracer is not None and _trace_path == trace_path:
            return
        _trace_path = trace_path
        _tracer = Tracer()
        _metrics = m = Metrics()
        _tracer.role = _role
        ctx = context.current()
        if ctx is not None:
            _tracer.trace_id = ctx.get("trace_id")
            _tracer.parent_span = ctx.get("parent")
        fl = flight.recorder()

        # every finished span also lands in a span_us.<name> histogram,
        # so the reader has quantiles even where the buffer truncated,
        # and in the flight ring, so a crash dump carries the span tail
        def _on_complete(name, dur_us, _m=m, _fl=fl):
            _m.observe(f"span_us.{name}", dur_us)
            _fl.span(name, dur_us)

        _tracer.on_complete = _on_complete


def arm_device_track(devices) -> bool:
    """Arm the device track for a trace on the card, or on each distinct
    card of `devices` (a device or a sequence; see the module note);
    False where no trace file is armed."""
    global _device
    if _tracer is None or not _trace_path:
        return False
    import torch

    from ..ops import cuda_lib

    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    refs = {}
    for d in map(torch.device, devices):
        if d.type != "cuda":
            continue
        card = d.index if d.index is not None else \
            torch.cuda.current_device()
        if card in refs:
            continue
        with torch.cuda.device(card):
            torch.cuda.synchronize(card)
            ref = torch.cuda.Event(enable_timing=True)
            ref.record(torch.cuda.current_stream(card))
            ref.synchronize()
        refs[card] = (ref, time.monotonic_ns())
    cuda_lib.TRACE_EVENTS = []
    _device = refs
    return True


def release(write: bool = True) -> Optional[str]:
    """Write the trace (optionally), then disarm."""
    path = write_trace() if write else None
    reset()
    return path


def set_role(role: Optional[str]) -> None:
    """Name this process's track in merged timelines and flight dumps
    ("serve", ...). Sticky across ``reset()``."""
    global _role
    _role = role
    flight.set_role(role)
    t = _tracer
    if t is not None:
        t.role = role


def role() -> Optional[str]:
    return _role


def enabled() -> bool:
    return _tracer is not None


def trace_path() -> Optional[str]:
    return _trace_path


# -- recording hooks (each a cheap no-op when disarmed) --------------------

def span(name: str, **args):
    """Context manager timing a region; the shared null span when
    disarmed."""
    t = _tracer
    if t is None:
        return NULL_SPAN
    return Span(t, name, args)


def event(name: str, **args) -> None:
    """Instant event (watchdog timeout, injected fault, a job's
    demotion, ...). Always breadcrumbed into the flight recorder, and
    recorded on the timeline when armed."""
    flight.record(name, **args)
    t = _tracer
    if t is not None:
        t.add_instant(name, **args)


def add_complete(name: str, t0_ns: int, t1_ns: int, **args) -> None:
    """Span from raw monotonic_ns stamps, recorded after the fact."""
    t = _tracer
    if t is not None:
        t.add_complete(name, t0_ns, t1_ns, **args)


def count(name: str, n: int = 1) -> None:
    m = _metrics
    if m is not None:
        m.count(name, n)


def observe(name: str, value: float) -> None:
    m = _metrics
    if m is not None:
        m.observe(name, value)


# -- cross-process span shipping -------------------------------------------

def shipment(max_events: int = SHIP_EVENTS) -> Optional[dict]:
    """Bounded, JSON-ready export of the armed span buffer and metrics
    snapshot, shipped with a serve job's or a distrib chunk's result so
    that a tracing submitter or coordinator can fold it into its own
    timeline (``absorb``); None when disarmed."""
    t = _tracer
    if t is None:
        return None
    return t.export(max_events=max(1, max_events), metrics=snapshot())


def absorb(ship) -> int:
    """Fold a peer process's ``shipment()`` into this process's armed
    tracer (timestamps re-based, pid tracks kept): the coordinator and
    the fleet plane absorb their workers' chunks. A no-op when disarmed
    or the shipment is absent or malformed; returns the number of events
    absorbed."""
    t = _tracer
    if t is None or not isinstance(ship, dict):
        return 0
    return t.ingest(ship)


# -- live telemetry ----------------------------------------------------------

def telemetry_tick(**gauges) -> dict:
    """Append one gauge snapshot to the process's telemetry ring and
    return it: the gauges, the process RSS, and, with metrics armed, the
    served totals. Armed or not: it is the `stats` op's scrape state,
    not trace output."""
    from ..resilience import budget as _budget

    entry = {"t_mono_ns": time.monotonic_ns()}
    entry.update(gauges)
    entry["mem.rss_mb"] = round(_budget.rss_mb(), 1)
    m = _metrics
    if m is not None:
        entry["served_total"] = m.prefix_sum("served.")
    with _telemetry_lock:
        _telemetry.append(entry)
    return entry


def telemetry(last: Optional[int] = None) -> list:
    """The telemetry ring, oldest first (optionally just the last N)."""
    with _telemetry_lock:
        items = list(_telemetry)
    return items[-last:] if last else items


# -- snapshots & invariants ------------------------------------------------

def snapshot() -> Optional[dict]:
    """JSON-ready metrics snapshot, or None when disarmed."""
    m = _metrics
    return None if m is None else m.snapshot()


def counter_total(prefix: str) -> int:
    """Sum of every counter whose name starts with ``prefix`` (0 when
    disarmed)."""
    m = _metrics
    return 0 if m is None else m.prefix_sum(prefix)


def served_sum_check(phases) -> dict:
    """The ``served.<phase>.<tier>`` counters against each PhaseReport's
    served total: ``{phase: {"report": n, "metrics": n, "ok": bool}}``
    (``phases`` is ``RunReport.phases``); {} when disarmed."""
    m = _metrics
    if m is None:
        return {}
    out = {}
    for name, rep in phases.items():
        counted = m.prefix_sum(f"served.{name}.")
        total = rep.served_total()
        out[name] = {"report": total, "metrics": counted,
                     "ok": counted == total}
    return out


# -- export ----------------------------------------------------------------

def _flush_device_track() -> None:
    """Move the device track's launches into the tracer: after a
    synchronize of each card, each launch's start from its card's
    reference event and its duration from its own two events (the
    wrappers' events, as ``cuda_lib.LAUNCH_EVENTS`` readers time them).
    Track ids: DEVICE_TID, plus the card's index times the kernel count,
    plus the kernel's index."""
    refs, t = _device, _tracer
    if refs is None or t is None:
        return
    import torch

    from ..ops import cuda_lib

    for card in refs:
        torch.cuda.synchronize(card)
    names = list(cuda_lib.LAUNCHES)
    for name, start, end, device in cuda_lib.take_trace_events():
        card = device.index
        ref, ref_ns = refs[card]
        t0 = ref_ns + ref.elapsed_time(start) * 1e6
        t1 = t0 + start.elapsed_time(end) * 1e6
        t.add_track_complete(
            name, t0, t1, DEVICE_TID + card * len(names) + names.index(name),
            f"device: {name}" if card == 0 else f"device {card}: {name}",
            "device", card=card)


def write_trace() -> Optional[str]:
    """Write the Chrome-trace JSON (metrics snapshot embedded) to the
    armed path; None when tracing is disarmed or metrics-only. A write
    failure warns: it does not fail the polish that just finished."""
    t, path = _tracer, _trace_path
    if t is None or not path:
        return None
    _flush_device_track()
    try:
        t.write(path, metrics=snapshot(),
                platform="cuda" if _device is not None else None)
    except OSError as e:
        print(f"[racon_tpu_torch::obs] WARNING: cannot write trace {path}: "
              f"{e}", file=sys.stderr)
        return None
    return path
