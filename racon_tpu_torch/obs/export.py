"""Prometheus text-format exposition of the obs metrics registry and
the SLO engine.

A copy of the JAX package's exposition (racon_tpu/obs/export.py), with
its metric names, so that one scrape configuration reads both daemons.

Pure formatting over snapshots — no sockets, no clocks, stdlib only —
so it is trivially testable and shared by the two scrape surfaces: the
daemon's ``metrics`` wire op and the optional ``--metrics-port`` HTTP
endpoint (``GET /metrics``).

Mapping (exposition format 0.0.4):

* counter ``served.consensus.ls`` -> ``racon_tpu_served_consensus_ls_total``
* log2 histogram ``span_us.phase.poa`` ->
  ``racon_tpu_span_us_phase_poa_bucket{le="..."}`` (cumulative, with a
  closing ``+Inf``), ``_sum`` and ``_count``
* SLO engine -> ``racon_tpu_slo_burn_rate{tenant="...",window="fast"}``
  gauges, ``racon_tpu_slo_alerting{tenant="..."}`` 0/1, and the
  engine's own counters (``racon_tpu_slo_alerts_total`` etc.)
* extra gauges (queued and running jobs) ->
  ``racon_tpu_<name>`` gauges
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[\\\"\n]")


def _san(name: str) -> str:
    """A metric-name-safe identifier: dots (our namespace separator)
    and anything else illegal become underscores."""
    return _NAME_RE.sub("_", str(name))


def _label(value) -> str:
    return _LABEL_RE.sub("_", str(value))


def _fmt(v) -> str:
    if v is None:
        return "NaN"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _histogram_lines(name: str, hist: dict) -> List[str]:
    metric = f"racon_tpu_{_san(name)}"
    lines = [f"# TYPE {metric} histogram"]
    buckets = hist.get("buckets")
    cum = 0
    if isinstance(buckets, dict):
        for bound in sorted(buckets, key=float):
            try:
                cum += int(buckets[bound])
            except (TypeError, ValueError):
                continue
            lines.append(f'{metric}_bucket{{le="{_label(bound)}"}} {cum}')
    count = hist.get("count", cum)
    lines.append(f'{metric}_bucket{{le="+Inf"}} {_fmt(count)}')
    lines.append(f"{metric}_sum {_fmt(hist.get('sum', 0.0))}")
    lines.append(f"{metric}_count {_fmt(count)}")
    return lines


def prometheus_text(metrics: Optional[dict] = None,
                    slo: Optional[dict] = None,
                    gauges: Optional[Dict[str, float]] = None) -> str:
    """Render one scrape: ``metrics`` is an ``obs.snapshot()`` dict (or
    None when the registry is disarmed), ``slo`` an
    ``SLOEngine.snapshot()`` dict, ``gauges`` extra instantaneous
    values.  Always ends with a newline (the format requires it)."""
    lines: List[str] = []
    counters = (metrics or {}).get("counters")
    if isinstance(counters, dict):
        for name in sorted(counters):
            metric = f"racon_tpu_{_san(name)}"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric}_total {_fmt(counters[name])}")
    hists = (metrics or {}).get("histograms")
    if isinstance(hists, dict):
        for name in sorted(hists):
            h = hists[name]
            if isinstance(h, dict):
                lines.extend(_histogram_lines(name, h))
    if isinstance(gauges, dict):
        for name in sorted(gauges):
            v = gauges[name]
            if v is None:
                continue
            metric = f"racon_tpu_{_san(name)}"
            lines.append(f"# TYPE {metric} gauge")
            lines.append(f"{metric} {_fmt(v)}")
    if isinstance(slo, dict):
        lines.extend(_slo_lines(slo))
    return "\n".join(lines) + "\n"


def _slo_lines(slo: dict) -> List[str]:
    lines = ["# TYPE racon_tpu_slo_burn_rate gauge"]
    scopes = [("", slo.get("overall") or {})]
    tenants = slo.get("tenants")
    if isinstance(tenants, dict):
        scopes.extend(sorted(tenants.items()))
    for tenant, state in scopes:
        burn = state.get("burn") if isinstance(state, dict) else None
        if not isinstance(burn, dict):
            continue
        for window in ("fast", "slow"):
            lines.append(
                f'racon_tpu_slo_burn_rate{{tenant="{_label(tenant)}",'
                f'window="{window}"}} {_fmt(burn.get(window, 0.0))}')
    lines.append("# TYPE racon_tpu_slo_alerting gauge")
    for tenant, state in scopes:
        if isinstance(state, dict):
            lines.append(
                f'racon_tpu_slo_alerting{{tenant="{_label(tenant)}"}} '
                f'{1 if state.get("alerting") else 0}')
    objectives = slo.get("objectives")
    if isinstance(objectives, dict) \
            and objectives.get("availability") is not None:
        lines.append("# TYPE racon_tpu_slo_availability_objective gauge")
        lines.append(f"racon_tpu_slo_availability_objective "
                     f"{_fmt(objectives['availability'])}")
    counters = slo.get("counters")
    if isinstance(counters, dict):
        for name in sorted(counters):
            metric = f"racon_tpu_slo_{_san(name)}"
            lines.append(f"# TYPE {metric} counter")
            lines.append(f"{metric}_total {_fmt(counters[name])}")
    return lines
