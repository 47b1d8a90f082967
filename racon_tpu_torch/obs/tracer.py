"""Thread-safe span tracer emitting Chrome-trace ("Trace Event Format")
JSON, loadable in Perfetto / chrome://tracing.

A copy of the JAX package's tracer (racon_tpu/obs/tracer.py), with its
cross-process shipping (``export``: a serve job's spans ride its
result to a tracing submitter) and its provenance (``role``,
``trace_id``, ``parent_span``, from ``obs.set_role`` and
``obs.context``), and with one addition: ``add_track_complete``, a
complete event on a track of its own rather than on the calling
thread's (the card's launches, obs.__init__).

* **Monotonic clock only.**  Span math uses ``time.monotonic_ns()``.
* **Bounded memory.**  Past the cap events are counted as dropped
  (surfaced in the written trace) instead of growing without bound.
* **No data dependence.**  The tracer observes timing only: it never
  touches sequences, CIGARs or consensus bytes, so a traced polish gives
  the untraced bytes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class Span:
    """One timed region, used as a context manager.

    Records a complete ("ph":"X") event on exit; ``set()`` attaches
    key/value args. An exception escaping the body is recorded as an
    ``error`` arg."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0

    def set(self, **attrs) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer.add_complete(self.name, self._t0, time.monotonic_ns(),
                                  **self.args)
        return False


class _NullSpan:
    """The disarmed span: a shared no-op."""

    __slots__ = ()

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


#: Singleton handed out by ``obs.span()`` when tracing is disarmed.
NULL_SPAN = _NullSpan()


class Tracer:
    """In-memory trace-event buffer; all mutation under one lock, so
    spans from the alignment worker, the watchdog's threads and the
    calling thread interleave safely."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._thread_names: Dict[int, str] = {}
        self.dropped = 0
        self._max = max_events
        #: Optional ``(name, dur_us) -> None`` callback fired for every
        #: complete event, even past the buffer cap.
        self.on_complete = None
        # timestamps are offsets from tracer creation
        self._t0 = time.monotonic_ns()
        self.pid = os.getpid()
        #: Provenance, stamped by ``obs.configure`` from ``obs.context``
        #: and ``obs.set_role``: ``role`` names this process's track in a
        #: merged timeline ("serve", ...); trace_id/parent_span tie its
        #: spans to the submitter's trace context.
        self.role: Optional[str] = None
        self.trace_id: Optional[str] = None
        self.parent_span: Optional[str] = None

    @property
    def t0_ns(self) -> int:
        """Monotonic epoch of this tracer's ts=0."""
        return self._t0

    def _ts_us(self, t_ns: int) -> int:
        # a span on another thread may have started before the tracer
        # was armed: pinned to ts=0, so every event stays schema-valid
        return max(0, (t_ns - self._t0) // 1000)

    def _store(self, ev: dict, tid: int, tname: str) -> None:
        ev["pid"] = self.pid
        ev["tid"] = tid
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = tname
            if len(self._events) >= self._max:
                self.dropped += 1
                return
            self._events.append(ev)

    def _append(self, ev: dict) -> None:
        self._store(ev, threading.get_ident(),
                    threading.current_thread().name)

    def add_complete(self, name: str, t0_ns: int, t1_ns: int,
                     cat: str = "span", **args) -> None:
        """Record a finished region [t0_ns, t1_ns] (monotonic_ns stamps)
        on the calling thread's track."""
        dur = max(0, (t1_ns - t0_ns) // 1000)
        self._append({"name": name, "cat": cat, "ph": "X",
                      "ts": self._ts_us(t0_ns), "dur": dur,
                      "args": args})
        cb = self.on_complete
        if cb is not None:
            cb(name, dur)

    def add_track_complete(self, name: str, t0_ns: float, t1_ns: float,
                           tid: int, track: str, cat: str,
                           **args) -> None:
        """Record a finished region on track `tid` (named `track`), with
        µs as floats: the card's launches last tens of µs, which whole
        µs would round."""
        self._store({"name": name, "cat": cat, "ph": "X",
                     "ts": max(0.0, (t0_ns - self._t0) / 1000.0),
                     "dur": max(0.0, (t1_ns - t0_ns) / 1000.0),
                     "args": args}, tid, track)

    def add_instant(self, name: str, cat: str = "event", **args) -> None:
        """Record a point event (watchdog timeout, injected fault, ...)."""
        self._append({"name": name, "cat": cat, "ph": "i", "s": "t",
                      "ts": self._ts_us(time.monotonic_ns()),
                      "args": args})

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    # -- cross-process shipping -------------------------------------------
    def export(self, max_events: Optional[int] = None,
               metrics: Optional[dict] = None) -> dict:
        """A JSON-ready shipment of this process's span buffer: the last
        ``max_events`` events (the newest win), thread names, and the
        clock epoch a peer needs to re-base them. Bounded so a shipment
        fits the wire's one-line message limit."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
            dropped = self.dropped
        if max_events is not None and len(events) > max_events:
            dropped += len(events) - max_events
            events = events[-max_events:]
        ship = {
            "pid": self.pid,
            "t0_mono_ns": self._t0,
            "role": self.role,
            "trace_id": self.trace_id,
            "dropped": dropped,
            "thread_names": {str(t): n for t, n in names.items()},
            "events": events,
        }
        if metrics is not None:
            ship["metrics"] = metrics
        return ship

    def to_dict(self, metrics: Optional[dict] = None,
                platform: Optional[str] = None) -> dict:
        """The full Chrome-trace JSON object; the metrics snapshot and
        the provenance ride along as extra top-level keys."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
            dropped = self.dropped
        events.append({"name": "process_name", "ph": "M", "pid": self.pid,
                       "tid": 0,
                       "args": {"name": self.role or "racon-tpu-torch"}})
        for tid, tname in sorted(names.items()):
            events.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                           "tid": tid, "args": {"name": tname}})
        doc = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"tool": "racon_tpu_torch.obs",
                          "clock": "monotonic", "dropped_events": dropped,
                          "pid": self.pid, "t0_monotonic_ns": self._t0},
        }
        if self.role:
            doc["otherData"]["role"] = self.role
        if self.trace_id:
            doc["otherData"]["trace_id"] = self.trace_id
            if self.parent_span:
                doc["otherData"]["parent_span"] = self.parent_span
        if platform:
            doc["otherData"]["platform"] = platform
        if metrics is not None:
            doc["racon_tpu"] = {"metrics": metrics}
        return doc

    def write(self, path: str, metrics: Optional[dict] = None,
              platform: Optional[str] = None) -> None:
        tmp = f"{path}.tmp.{self.pid}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(metrics, platform=platform), f)
            f.write("\n")
        os.replace(tmp, path)
