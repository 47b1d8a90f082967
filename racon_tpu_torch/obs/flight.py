"""Crash flight recorder: an always-on ring of the last N spans/events.

A copy of the JAX package's recorder (racon_tpu/obs/flight.py) with its
two settings as arguments: ``enabled`` (the JAX package's
``RACON_TPU_FLIGHT``, default on) and ``max_events`` (its
``RACON_TPU_FLIGHT_EVENTS``, default 256); the process recorder has the
defaults.

Unlike the tracer (armed per run, written once at the end), the flight
recorder is *always* collecting — a fixed-size ``deque`` of the most
recent instant events, completed spans, and explicit breadcrumbs — and
is dumped on the paths where a process dies with its trace unwritten: a
serve job that raises, or SIGTERM in the daemon. The dump is a small
JSON file (``flight.<pid>.json``) in the current job directory (or the
daemon's state directory).

Overhead discipline: ``record`` is a dict build + deque append under a
lock — no I/O, no formatting. Disarmed tracing does not disable the
recorder (that is the point); ``enabled=False`` does.
Timestamps are ``monotonic_ns`` like the tracer's, so a dump's events
line up with a trace from the same process.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

#: The JAX package's RACON_TPU_FLIGHT and RACON_TPU_FLIGHT_EVENTS
#: defaults.
DEFAULT_ENABLED = True
DEFAULT_MAX_EVENTS = 256


class FlightRecorder:
    """Bounded ring of breadcrumbs + a one-shot JSON dumper."""

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS,
                 enabled: bool = DEFAULT_ENABLED):
        self._lock = threading.Lock()
        self._ring = collections.deque(maxlen=max(16, int(max_events)))
        self._enabled = bool(enabled)
        self._dir: Optional[str] = None
        self._role: Optional[str] = None

    # -- recording (hot-path safe) ----------------------------------------
    def enabled(self) -> bool:
        return self._enabled

    def record(self, name: str, kind: str = "event", **args) -> None:
        if not self._enabled:
            return
        ev = {"t_mono_ns": time.monotonic_ns(), "name": name, "kind": kind}
        if args:
            ev["args"] = args
        with self._lock:
            self._ring.append(ev)

    def span(self, name: str, dur_us: int) -> None:
        """Completed-span breadcrumb (chained off the tracer's
        ``on_complete``, so armed runs log their span tail here too)."""
        self.record(name, kind="span", dur_us=int(dur_us))

    def events(self) -> list:
        """The ring, oldest first."""
        with self._lock:
            return list(self._ring)

    # -- placement ---------------------------------------------------------
    def set_dir(self, path: Optional[str]) -> None:
        """Where a dump lands: the current job directory. None disables
        dumping until the next ``set_dir``."""
        with self._lock:
            self._dir = path

    def set_role(self, role: Optional[str]) -> None:
        with self._lock:
            self._role = role

    # -- dumping -----------------------------------------------------------
    def dump(self, reason: str, dir_path: Optional[str] = None,
             **detail) -> Optional[str]:
        """Write the ring to ``<dir>/flight.<pid>.json`` (tmp+replace so
        a dump interrupted by the impending SIGKILL never leaves a torn
        file). Returns the path, or None when disabled / no directory
        is set / the write fails — a post-mortem must never mask the
        crash it documents."""
        if not self._enabled:
            return None
        with self._lock:
            target = dir_path or self._dir
            events = list(self._ring)
            role = self._role
        if not target:
            return None
        from . import context
        doc = {
            "tool": "racon_tpu_torch.obs.flight",
            "clock": "monotonic",
            "pid": os.getpid(),
            "role": role,
            "reason": reason,
            "t_dump_mono_ns": time.monotonic_ns(),
            "trace_context": context.current(),
            "events": events,
        }
        if detail:
            doc["detail"] = detail
        path = os.path.join(target, f"flight.{os.getpid()}.json")
        tmp = f"{path}.tmp"
        try:
            os.makedirs(target, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            return None
        return path


#: Process-wide recorder. Deliberately NOT cleared by ``obs.reset()``:
#: the breadcrumbs from run setup are exactly what a crash early in the
#: next run needs.
_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def record(name: str, kind: str = "event", **args) -> None:
    _recorder.record(name, kind=kind, **args)


def set_dir(path: Optional[str]) -> None:
    _recorder.set_dir(path)


def set_role(role: Optional[str]) -> None:
    _recorder.set_role(role)


def dump(reason: str, dir_path: Optional[str] = None,
         **detail) -> Optional[str]:
    return _recorder.dump(reason, dir_path=dir_path, **detail)


def scan(dir_path: str) -> list:
    """Load every parseable ``flight.*.json`` under ``dir_path``
    (recursively — dumps land in nested job directories). Unreadable or
    torn files are skipped; the sweep is reporting, not recovery."""
    out = []
    for root, dirs, names in os.walk(dir_path):
        dirs.sort()
        for name in sorted(names):
            if not (name.startswith("flight.") and name.endswith(".json")):
                continue
            path = os.path.join(root, name)
            try:
                with open(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue
            if isinstance(doc, dict):
                doc["path"] = path
                out.append(doc)
    return out
