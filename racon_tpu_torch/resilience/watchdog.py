"""The device-call watchdog: a deadline on the host's wait for the card.

A copy of the JAX package's ``call_with_watchdog`` and
``WatchdogTimeout`` (racon_tpu/resilience/watchdog.py). Its
``WedgeTracker`` only feeds the degradation lattice, which the port does
not have.

The deadline is the polisher's ``device_timeout_s`` (0, the default,
turns it off, as ``RACON_TPU_DEVICE_TIMEOUT=0``). It bounds the host's
waits on the card: the wait on each launch's events before its outputs
are gathered (parallel/partitioner.py), for the consensus feeder's
batches (ops/batch_exec.py) and the aligner's launch rounds
(ops/align_cuda.py). It does not bound the host's own packing. On expiry
it raises WatchdogTimeout, naming the wait and the deadline, and the
polish ends with it: a wedged card cannot be recovered in-process (the
abandoned wait keeps its daemon thread).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from .. import obs
from . import faults


class WatchdogTimeout(Exception):
    """A wait on the card exceeded the device_timeout_s watchdog."""

    def __init__(self, message: str, what: str = ""):
        super().__init__(message)
        self.what = what


def call_with_watchdog(fn: Callable, timeout_s: float = 0.0,
                       what: str = "device call"):
    """fn() under a deadline of `timeout_s` seconds: a direct call when it
    is 0, else on a daemon thread joined for at most that long. Raises
    WatchdogTimeout on expiry; re-raises what fn raised."""
    faults.check("watchdog.call")
    if not timeout_s or timeout_s <= 0:
        return fn()
    box = {}

    def runner():
        try:
            box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed to the caller
            box["error"] = e

    th = threading.Thread(target=runner, daemon=True,
                          name="racon-torch-watchdog-call")
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        obs.event("watchdog.timeout", what=what, deadline_s=timeout_s)
        obs.count("watchdog_timeouts")
        raise WatchdogTimeout(
            f"{what} exceeded the {timeout_s:.3g}s device watchdog",
            what=what)
    if "error" in box:
        raise box["error"]
    return box["result"]


def wait_events(events, timeout_s: float, what: str,
                before: Optional[Callable] = None) -> None:
    """Wait for every CUDA event of `events` (a launch's, one a stripe;
    none on the CPU: nothing to wait for) under one deadline, with
    `before` (a run point's fault check) inside it. Only the wait runs on
    the watchdog's thread; the caller's launches and copies stay on its
    own thread and stream."""
    def wait():
        if before is not None:
            before()
        for event in events:
            event.synchronize()

    call_with_watchdog(wait, timeout_s, what)
