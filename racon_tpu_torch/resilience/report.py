"""Machine-readable run report: who served what.

A copy of the JAX package's report (racon_tpu/resilience/report.py) with
the keys the port can fill: ``phases``, ``fault_spec``, ``obs`` and
``wall_s``. The sanitizer, flight-recorder, ledger and unknown-knob keys
wait for their modules and are left out (not written as null).

Each phase produces a ``PhaseReport``: served counts per tier, failure
causes, wall seconds per tier and the phase's extras. The tiers:

* alignment: ``("hirschberg", "host", "journal")``: the kernels, the
  host aligner (the jobs the kernels cannot take), replayed records;
* consensus: ``(poa_kernel, "host", "backbone", "journal")``: the POA
  kernel, the host re-polish of windows it flags failed, windows with
  fewer than three sequences, replayed records;
* memory: the chunked modes' budget and streaming verdicts.

Invariant (tested): a phase's served counts sum to its total.
``retries``, ``bisections`` and ``degradations`` keep the JAX schema and
stay 0 and empty: the port has no lattice.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional, Tuple

from .. import obs

_MAX_CAUSES = 20
_MAX_QUARANTINED = 1000

ALIGN_TIERS = ("hirschberg", "host", "journal")


def consensus_tiers(poa_kernel: str) -> Tuple[str, ...]:
    return (poa_kernel, "host", "backbone", "journal")


class PhaseReport:
    """Serving accounting for one phase (a single writer)."""

    def __init__(self, phase: str, tiers: Tuple[str, ...]):
        self.phase = phase
        self.tiers = tuple(tiers)
        self.total = 0
        self.served = {t: 0 for t in self.tiers}
        self.retries = 0
        self.bisections = 0
        self.quarantined: List[int] = []
        self.degradations: List[dict] = []
        self.causes = {}      # tier -> [error strings]
        self.wall_s = {}      # tier -> accumulated seconds
        self.extra = {}       # phase-specific counters

    # -- recording (each feeds the metrics from the same call, which is
    # what obs.served_sum_check holds the report against) --
    def record_served(self, tier: str, n: int = 1) -> None:
        self.served[tier] = self.served.get(tier, 0) + n
        obs.count(f"served.{self.phase}.{tier}", n)

    def record_failure(self, tier: str, exc: BaseException) -> None:
        lst = self.causes.setdefault(tier, [])
        if len(lst) < _MAX_CAUSES:
            lst.append(f"{type(exc).__name__}: {exc}")
        obs.count(f"failures.{self.phase}.{tier}")

    def record_degrade(self, frm: str, to: str,
                       exc: Optional[BaseException] = None) -> None:
        self.degradations.append({
            "from": frm, "to": to,
            "error": f"{type(exc).__name__}: {exc}" if exc else None})
        obs.event("pressure.degrade", phase=self.phase, frm=frm, to=to)

    def record_quarantine(self, index: int,
                          exc: Optional[BaseException] = None) -> None:
        if len(self.quarantined) < _MAX_QUARANTINED:
            self.quarantined.append(int(index))
        if exc is not None:
            self.record_failure("quarantine", exc)
        obs.count(f"quarantined.{self.phase}")

    def add_wall(self, tier: str, seconds: float) -> None:
        self.wall_s[tier] = self.wall_s.get(tier, 0.0) + seconds
        obs.observe(f"wall_s.{self.phase}.{tier}", seconds)

    def merge(self, other: "PhaseReport") -> None:
        """Fold another report of the same phase into this one (a chunked
        polish runs one a chunk). The metrics were fed when `other`
        recorded, so merging does not feed them again."""
        self.total += other.total
        for t, c in other.served.items():
            self.served[t] = self.served.get(t, 0) + c
        self.retries += other.retries
        self.bisections += other.bisections
        room = _MAX_QUARANTINED - len(self.quarantined)
        if room > 0:
            self.quarantined.extend(other.quarantined[:room])
        self.degradations.extend(other.degradations)
        for t, msgs in other.causes.items():
            lst = self.causes.setdefault(t, [])
            lst.extend(msgs[:max(0, _MAX_CAUSES - len(lst))])
        for t, s in other.wall_s.items():
            self.wall_s[t] = self.wall_s.get(t, 0.0) + s
        for k, v in other.extra.items():
            cur = self.extra.get(k)
            if isinstance(cur, bool) or isinstance(v, bool):
                self.extra[k] = bool(cur) or bool(v)
            elif isinstance(cur, (int, float)) and \
                    isinstance(v, (int, float)):
                self.extra[k] = round(cur + v, 6)
            elif isinstance(cur, dict) and isinstance(v, dict):
                self.extra[k] = {kk: cur.get(kk, 0) + v.get(kk, 0)
                                 for kk in {**cur, **v}}
            else:
                self.extra[k] = v

    # -- views ------------------------------------------------------------
    def served_total(self) -> int:
        return sum(self.served.values())

    def as_dict(self) -> dict:
        return {
            "phase": self.phase,
            "total": self.total,
            "served": dict(self.served),
            "retries": self.retries,
            "bisections": self.bisections,
            "quarantined": list(self.quarantined),
            "degradations": list(self.degradations),
            "causes": {k: list(v) for k, v in self.causes.items()},
            "wall_s": {k: round(v, 4) for k, v in self.wall_s.items()},
            **({"extra": dict(self.extra)} if self.extra else {}),
        }


class RunReport:
    """The run's phases, the armed fault spec, the obs snapshot and the
    wall seconds."""

    def __init__(self):
        self.phases = {}
        self._t0 = time.monotonic()
        self.wall_s = None

    def attach(self, phase_report: Optional[PhaseReport]) -> None:
        if phase_report is not None:
            self.phases[phase_report.phase] = phase_report

    def finalize(self) -> "RunReport":
        self.wall_s = time.monotonic() - self._t0
        return self

    def as_dict(self) -> dict:
        from .faults import active_spec

        return {
            "phases": {k: v.as_dict() for k, v in self.phases.items()},
            "fault_spec": active_spec(),
            "obs": {"armed": obs.enabled(),
                    **({"metrics": obs.snapshot(),
                        "served_sum": obs.served_sum_check(self.phases)}
                       if obs.enabled() else {})},
            "wall_s": round(self.wall_s if self.wall_s is not None
                            else time.monotonic() - self._t0, 3),
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
