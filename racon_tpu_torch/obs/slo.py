"""Per-tenant SLO objects + multi-window burn-rate engine over the
job-latency ledger stream.

A copy of the JAX package's engine (racon_tpu/obs/slo.py) with its
settings as arguments, each defaulting to its JAX knob's default
(``RACON_TPU_SLO_LATENCY_S`` unset, ``_AVAILABILITY`` 0.99,
``_FAST_WINDOW_S`` 60, ``_SLOW_WINDOW_S`` 600, ``_BURN_ALERT`` 2.0,
``_SHED_BURN`` 0); ``reset(**settings)`` installs the process engine's.

An **objective** is a latency target (seconds, per tenant with a
``default`` fallback) plus an availability fraction.  Every finished
serve job is one observation: *bad* when it failed or overran its
tenant's latency target.  The classic error budget follows: with
availability ``a``, the budget is ``1 - a`` bad-fraction; the **burn
rate** over a window is ``bad_fraction / (1 - a)`` — burn 1.0 spends
the budget exactly at the sustainable rate, burn 10 spends it 10x too
fast.

Alerting is multi-window (the SRE-workbook shape): an alert requires
*both* the fast window (reactive, noisy) and the slow window
(confirming, stable) to burn past ``burn_alert``, so a single slow job
cannot page and a sustained regression cannot hide. The scheduler's
admission ladder sheds above ``shed_burn``.

Everything here is control-plane metadata — monotonic clocks only and
no dataflow into polished bytes. The engine is process-global (the
scheduler and the metrics exposition read the same one); with no
latency target it costs one deque append per finished job and alerts
only on failures.

Fault point ``slo.burn`` (resilience/faults.py): an armed raise is
absorbed as a *forced* burn — both windows report at least the alert
threshold for one fast window — the deterministic injected-slowdown
drill.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from ..resilience import faults

#: Observations kept per engine — bounds memory under sustained load
#: (the slow window trims by time; this caps a burst inside it).
_MAX_EVENTS = 8192


def parse_targets(text: str) -> Dict[str, float]:
    """Parse latency targets (the JAX package's
    ``RACON_TPU_SLO_LATENCY_S``): a bare float is the default
    target; ``key=value`` pairs (comma-separated) set per-tenant /
    per-profile targets, e.g. ``"default=2.5,tenant-a=1.0"``.
    Malformed fragments are skipped (a typo'd target must not take the
    daemon down)."""
    out: Dict[str, float] = {}
    for part in filter(None, (p.strip() for p in (text or "").split(","))):
        key, sep, val = part.partition("=")
        if not sep:
            key, val = "default", key
        try:
            t = float(val)
        except ValueError:
            continue
        if t > 0:
            out[key.strip()] = t
    return out


class SLOEngine:
    """Burn-rate accounting over (tenant, latency, ok) completions."""

    def __init__(self, latency_s: str = "", availability: float = 0.99,
                 fast_window_s: float = 60.0, slow_window_s: float = 600.0,
                 burn_alert: float = 2.0, shed_burn: float = 0.0):
        self._lock = threading.Lock()
        self.targets = parse_targets(latency_s)
        self.availability = min(0.999999, max(0.0, float(availability)))
        self.fast_window_s = max(1.0, float(fast_window_s))
        self.slow_window_s = max(self.fast_window_s, float(slow_window_s))
        self.burn_alert = max(0.0, float(burn_alert))
        self.shed_burn = max(0.0, float(shed_burn))
        # (t_mono_s, tenant, bad) observations, newest right
        self._events = deque(maxlen=_MAX_EVENTS)
        self._alerting: Dict[str, bool] = {}
        self._counters = {"observed": 0, "bad": 0, "alerts": 0,
                          "shed": 0, "burn_faults": 0}
        self._forced_until = 0.0

    # -- ingest ------------------------------------------------------------

    def target_for(self, tenant: str) -> Optional[float]:
        t = self.targets.get(tenant or "")
        return t if t is not None else self.targets.get("default")

    def record(self, tenant: str, latency_s: float, ok: bool = True,
               now: Optional[float] = None) -> None:
        """Ingest one finished job.  ``bad`` = failed, or overran the
        tenant's latency target (jobs with no target are bad only on
        failure — availability still applies)."""
        t = time.monotonic() if now is None else now
        target = self.target_for(tenant)
        bad = (not ok) or (target is not None and latency_s > target)
        with self._lock:
            self._events.append((t, tenant or "", bool(bad)))
            self._counters["observed"] += 1
            if bad:
                self._counters["bad"] += 1
        self._check_fault(t)
        self._evaluate(tenant or "", now=t)

    def _check_fault(self, now: float) -> None:
        """The ``slo.burn`` injection point: a raise is absorbed as a
        forced burn for one fast window (counted, never propagated)."""
        try:
            faults.check("slo.burn")
        except Exception:  # noqa: BLE001 — absorbed: an injected burn
            # forces the alert threshold, never propagates
            with self._lock:
                self._counters["burn_faults"] += 1
                self._forced_until = max(self._forced_until,
                                         now + self.fast_window_s)

    # -- burn math ---------------------------------------------------------

    def _window_burn(self, tenant: str, window_s: float,
                     now: float) -> float:
        lo = now - window_s
        total = bad = 0
        with self._lock:
            for t, ten, b in self._events:
                if t < lo or (tenant and ten != tenant):
                    continue
                total += 1
                bad += 1 if b else 0
            forced = now < self._forced_until
        budget = 1.0 - self.availability
        burn = (bad / total) / budget if total and budget > 0 else 0.0
        if forced:
            burn = max(burn, self.burn_alert if self.burn_alert > 0
                       else 1.0)
        return burn

    def burn_rates(self, tenant: str = "",
                   now: Optional[float] = None) -> Dict[str, float]:
        """Fast/slow-window burn rates for one tenant ('' = all
        traffic)."""
        t = time.monotonic() if now is None else now
        return {"fast": round(self._window_burn(tenant, self.fast_window_s,
                                                t), 4),
                "slow": round(self._window_burn(tenant, self.slow_window_s,
                                                t), 4)}

    def alerting(self, tenant: str = "",
                 now: Optional[float] = None) -> bool:
        """Multi-window alert: both windows burning past the threshold.
        It also drives the fault drill and the alert-transition event."""
        t = time.monotonic() if now is None else now
        self._check_fault(t)
        return self._evaluate(tenant, now=t)

    def _evaluate(self, tenant: str, now: float) -> bool:
        if self.burn_alert <= 0:
            return False
        rates = self.burn_rates(tenant, now=now)
        alert = (rates["fast"] >= self.burn_alert
                 and rates["slow"] >= self.burn_alert)
        with self._lock:
            was = self._alerting.get(tenant, False)
            self._alerting[tenant] = alert
            if alert and not was:
                self._counters["alerts"] += 1
        if alert and not was:
            # lazily: obs may be disarmed (the event still reaches the
            # flight ring) or armed into a job's trace
            from . import count, event
            event("slo.alert", tenant=tenant, fast=rates["fast"],
                  slow=rates["slow"])
            count("slo.alerts")
        return alert

    def should_shed(self, tenant: str = "",
                    now: Optional[float] = None) -> bool:
        """Admission-ladder signal: shed new non-urgent work while the
        burn exceeds ``shed_burn`` on both windows (0 = shedding
        disabled)."""
        if self.shed_burn <= 0:
            return False
        t = time.monotonic() if now is None else now
        rates = self.burn_rates(tenant, now=t)
        shed = (rates["fast"] >= self.shed_burn
                and rates["slow"] >= self.shed_burn)
        if shed:
            with self._lock:
                self._counters["shed"] += 1
        return shed

    # -- export ------------------------------------------------------------

    def tenants(self):
        with self._lock:
            return sorted({ten for _, ten, _ in self._events})

    def snapshot(self, now: Optional[float] = None) -> dict:
        """JSON-ready engine state for the ``metrics`` wire op, the
        Prometheus exposition and the load test."""
        t = time.monotonic() if now is None else now
        per = {}
        for ten in self.tenants():
            rates = self.burn_rates(ten, now=t)
            per[ten] = {"burn": rates,
                        "target_s": self.target_for(ten),
                        "alerting": self._alerting.get(ten, False)}
        with self._lock:
            counters = dict(self._counters)
            forced = t < self._forced_until
        return {
            "objectives": {"availability": self.availability,
                           "latency_s": dict(sorted(self.targets.items()))},
            "windows_s": {"fast": self.fast_window_s,
                          "slow": self.slow_window_s},
            "burn_alert": self.burn_alert,
            "shed_burn": self.shed_burn,
            "overall": {"burn": self.burn_rates("", now=t),
                        "alerting": self._alerting.get("", False)},
            "tenants": per,
            "counters": counters,
            "forced": forced,
        }


# -- process-global engine --------------------------------------------------
# One engine per process: the scheduler feeds it, the admission ladder
# reads it, the metrics op exports it.

_lock = threading.Lock()
_engine: Optional[SLOEngine] = None
_settings: dict = {}


def engine() -> SLOEngine:
    global _engine
    with _lock:
        if _engine is None:
            _engine = SLOEngine(**_settings)
        return _engine


def reset(**settings) -> None:
    """Drop the process engine; the next ``engine()`` is built with
    `settings` (SLOEngine's arguments; none: the defaults)."""
    global _engine, _settings
    SLOEngine(**settings)   # a bad setting raises here, not at first use
    with _lock:
        _engine = None
        _settings = dict(settings)
