"""Memory budget: RSS watermarks, backpressure and working-set spill.

A copy of the JAX package's budget (racon_tpu/resilience/budget.py) as
one object a run owns (the polisher makes it and passes it down), with
its settings as arguments: ``budget_mb`` (0: no budget), the soft and
hard watermarks as fractions of it (0.8 and 0.95, the JAX package's
defaults), the spill directory and the watchdog's poll interval (200 ms).

``MemoryBudget`` samples the process RSS (``/proc/self/status`` VmRSS,
else ``resource.getrusage``) and classifies it::

    ok --> soft (soft_frac x budget) --> hard (hard_frac x budget)

* the **soft watermark** is backpressure: the chunked polisher stops
  reading ahead and parks each materialized working set in a spill file
  on disk (``park_bytes``, ``load_spill``) until pressure clears;
* the **hard watermark** latches, and the consumers take the pressure
  edges: the phase pipeline collapses to sequential (polisher.py) and the
  consensus feeder to depth 1 (ops/batch_exec.py). The bytes stay the
  same: the edges change scheduling, never results.

A watchdog thread samples in the background so pressure is seen between
the synchronous polls (one per chunk). The synchronous polls check the
``mem.pressure`` fault point (resilience/faults.py): an injected fault is
a forced hard breach, the deterministic pressure drill; the watchdog
thread does not check it, so the fault's invocation count stays on the
synchronous schedule. ``mem.spill`` fires before each park, and an
injected fault there aborts the park: the working set stays in memory.
Left out, for later modules: the flight recorder's dump.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, List, Optional, Tuple

from .. import obs
from . import faults

#: Pressure levels, in order; ``at_least`` compares by this order.
LEVELS = ("ok", "soft", "hard")


def _status_mb(key: bytes) -> Optional[float]:
    """A size field of /proc/self/status in MiB, or None."""
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(key):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return None


def rss_mb() -> float:
    """Current resident set size in MiB (VmRSS; else the peak)."""
    cur = _status_mb(b"VmRSS:")
    return peak_rss_mb() if cur is None else cur


def peak_rss_mb() -> float:
    """Peak resident set size of this process's image in MiB: VmHWM,
    which starts afresh at exec (ru_maxrss, the fallback, keeps the peak
    of the process that forked it)."""
    peak = _status_mb(b"VmHWM:")
    if peak is not None:
        return peak
    try:
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    except (ImportError, OSError):
        return 0.0


def at_least(level: str, floor: str) -> bool:
    """Whether `level` is at or above `floor` in the pressure order."""
    return LEVELS.index(level) >= LEVELS.index(floor)


class MemoryBudget:
    """RSS watermark tracker for one run.

    ``rss_source`` may replace the sampler (tests drive the watermarks
    with a list of readings)."""

    def __init__(self, budget_mb: int = 0, *, soft_frac: float = 0.8,
                 hard_frac: float = 0.95, spill_dir: Optional[str] = None,
                 poll_ms: int = 200,
                 rss_source: Optional[Callable[[], float]] = None):
        self.budget_mb = max(0, int(budget_mb))
        self.soft_mb = self.budget_mb * soft_frac
        self.hard_mb = self.budget_mb * hard_frac
        self.spill_dir = spill_dir
        self.poll_ms = poll_ms
        self._rss = rss_source or rss_mb
        self._lock = threading.Lock()
        self._level = "ok"
        self._hard_latched = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def enabled(self) -> bool:
        return self.budget_mb > 0

    def poll(self, fault_check: bool = True) -> str:
        """Sample RSS and classify it, latching the first crossing of the
        hard watermark; returns the level ("ok" without a budget). With
        `fault_check` (the synchronous polls), an injected ``mem.pressure``
        fault forces the hard watermark."""
        if not self.enabled:
            return "ok"
        forced = False
        if fault_check:
            try:
                faults.check("mem.pressure")
            except Exception:  # noqa: BLE001 - injected: a forced breach
                forced = True
        cur = float(self._rss())
        if forced or cur >= self.hard_mb:
            level = "hard"
        elif cur >= self.soft_mb:
            level = "soft"
        else:
            level = "ok"
        with self._lock:
            prev = self._level
            self._level = level
            self._hard_latched |= level == "hard"
        if level != prev and at_least(level, "soft"):
            obs.event("mem.pressure", level=level, rss_mb=round(cur, 1),
                      budget_mb=self.budget_mb, forced=forced)
            obs.count(f"mem.{level}_watermark")
        return level

    def level(self) -> str:
        """The last classified level (no sampling)."""
        with self._lock:
            return self._level

    def hard_latched(self) -> bool:
        """Whether the hard watermark has been crossed in this run."""
        with self._lock:
            return self._hard_latched

    def spill_dir_for(self, fallback: str) -> str:
        """Where parked working sets go: ``spill_dir``, else the run's
        own `fallback`."""
        return self.spill_dir or fallback

    def start(self) -> None:
        """Start the background sampler (nothing without a budget)."""
        if not self.enabled or self._thread is not None:
            return
        self._stop.clear()
        t = threading.Thread(target=self._watch,
                             args=(max(0.01, self.poll_ms / 1e3),),
                             name="mem-watchdog", daemon=True)
        self._thread = t
        t.start()

    def _watch(self, interval_s: float) -> None:
        while not self._stop.wait(interval_s):
            self.poll(fault_check=False)

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None


def park_bytes(payloads: List[Tuple[str, bytes]], dir_path: str,
               tag: str) -> Optional[str]:
    """Park named byte buffers in one spill file; returns its path, or None
    where an I/O error aborted the park (the caller then keeps its
    buffers), or where an injected ``mem.spill`` fault aborted it. The
    file is a JSON header line of [name, length] pairs and then the
    blobs."""
    try:
        faults.check("mem.spill")
    except Exception:  # noqa: BLE001 - injected: an aborted park
        obs.count("mem.spill_aborted")
        return None
    path = os.path.join(dir_path, f"spill.{tag}.{os.getpid()}.bin")
    try:
        os.makedirs(dir_path, exist_ok=True)
        header = json.dumps([[name, len(blob)] for name, blob in payloads])
        with open(path, "wb") as f:
            f.write(header.encode() + b"\n")
            for _name, blob in payloads:
                f.write(blob)
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass
        return None
    return path


def load_spill(path: str) -> List[Tuple[str, bytes]]:
    """Load parked buffers back and delete the spill file. Raises OSError
    or ValueError on a torn spill file; the caller treats that as any
    other torn chunk."""
    with open(path, "rb") as f:
        header = json.loads(f.readline().decode())
        out = []
        for name, length in header:
            blob = f.read(int(length))
            if len(blob) != int(length):
                raise ValueError(f"torn spill file {path!r}: {name} "
                                 f"expected {length} bytes, got {len(blob)}")
            out.append((str(name), blob))
    os.unlink(path)
    return out
