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
name. Its start and end are the CUDA events the wrapper records around
the launch call, mapped to the host clock through one reference event
recorded, after a synchronize, with its ``monotonic_ns`` at arming. The
events are read only in ``write_trace``, after a synchronize: an event
read before its stream has reached it raises. The track has its own sink
(``cuda_lib.TRACE_EVENTS``), so a caller's ``cuda_lib.LAUNCH_EVENTS`` list
sees every launch as before. Left out, for the serve and distrib
modules: the fleet role, telemetry, the flight ring and trace context.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional

from .metrics import Metrics
from .tracer import NULL_SPAN, Span, Tracer

#: The five phases every polish decomposes into, in order; span names
#: are ``phase.<name>``.
PHASES = ("parse", "align", "window_assign", "poa", "stitch")

#: The device track's thread ids: this plus the kernel's index in
#: ``cuda_lib.LAUNCHES``.
DEVICE_TID = 1 << 20

_lock = threading.Lock()
_tracer: Optional[Tracer] = None
_metrics: Optional[Metrics] = None
_trace_path: Optional[str] = None
_device = None   # (device, reference event, its monotonic_ns) when armed


# -- arming ----------------------------------------------------------------

def reset() -> None:
    """Disarm and drop the collected state, the device track's sink
    included (the polisher constructors call it before ``configure``)."""
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

        # every finished span also lands in a span_us.<name> histogram,
        # so the reader has quantiles even where the buffer truncated
        def _on_complete(name, dur_us, _m=m):
            _m.observe(f"span_us.{name}", dur_us)

        _tracer.on_complete = _on_complete


def arm_device_track(device) -> bool:
    """Arm the device track for a trace on the card (see the module
    note); False where no trace file is armed."""
    global _device
    if _tracer is None or not _trace_path:
        return False
    import torch

    from ..ops import cuda_lib

    torch.cuda.synchronize(device)
    ref = torch.cuda.Event(enable_timing=True)
    ref.record(torch.cuda.current_stream(device))
    ref.synchronize()
    ref_ns = time.monotonic_ns()
    cuda_lib.TRACE_EVENTS = []
    _device = (device, ref, ref_ns)
    return True


def release(write: bool = True) -> Optional[str]:
    """Write the trace (optionally), then disarm."""
    path = write_trace() if write else None
    reset()
    return path


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
    """Instant event (watchdog timeout, injected fault, ...)."""
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
    synchronize, each launch's start from the reference event and its
    duration from its own two events (the wrappers' events, as
    ``cuda_lib.LAUNCH_EVENTS`` readers time them)."""
    dev, t = _device, _tracer
    if dev is None or t is None:
        return
    import torch

    from ..ops import cuda_lib

    device, ref, ref_ns = dev
    torch.cuda.synchronize(device)
    names = list(cuda_lib.LAUNCHES)
    for name, start, end in cuda_lib.take_trace_events():
        t0 = ref_ns + ref.elapsed_time(start) * 1e6
        t1 = t0 + start.elapsed_time(end) * 1e6
        t.add_track_complete(name, t0, t1, DEVICE_TID + names.index(name),
                             f"device: {name}", "device")


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
