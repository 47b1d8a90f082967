"""Analytic cost model of the port's kernels, and its check against a trace.

The JAX package's cost model (racon_tpu/obs/costmodel.py) on the port's
kernel grid and on an H100 profile. It predicts where the cycles go, per
POA bucket (DEPTH_BUCKETS x 128-lane window class, tier ls or v2) and for
the Hirschberg aligner, and joins the prediction against the DP cells a
traced polish counted (``obs validate``).

Three layers:

* **CostEstimate**: closed-form integer ops, bytes and serial DP steps
  per window (POA) or per job (aligner), from the bucket's shape. The ops
  are the per-cell counts the kernel table's bounds bill
  (chip_smoke.py): 6 a POA cell, 4 an edge-kernel cell (the Hirschberg
  cells are its forward and backward passes), 7 a base-case cell. The
  field keeps the JAX package's name, ``flops``.
* **MachineProfile**: peak op rate, memory bandwidth, the latency of a
  serial DP step, the host engines' cell rates, and the prediction error
  the profile declares it can hold. ``h100`` (one NVIDIA H100 80GB HBM3)
  and ``cpu-host`` (the plain PyTorch versions and the native host
  engines on a CPU) ship built in.
* **Roofline verdict**: predicted wall = max(compute, bandwidth,
  serial-step term); the winning term names the bound.

The model bills DP cells, not the host's orchestration around the
launches: a phase whose wall the host sets (the port's phase 1) reads
far above its prediction. That ratio is the model's error against the
phase's wall; how much of the phase is the card's work is the device
track's share of it (``obs --device``).

This module imports nothing but the standard library (the obs package's
rule: the daemon and the fleet's coordinator read it and must create no
CUDA context). The grid constants below are copies of the ops modules'
values, which tests/test_torch_costmodel.py pins.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

# -- kernel grid constants (copies of racon_tpu_torch.ops; pinned by tests)

#: ops/poa_driver.DEPTH_BUCKETS: the layer-count buckets windows batch into.
DEPTH_BUCKETS = (8, 32, 200)
#: ops/align_cuda.BANDS: the Hirschberg aligner's flat band buckets.
ALIGN_BANDS = (256, 512, 1024, 2048)
#: Windows a POA program runs at once. The port's ls kernel runs one block
#: a window (csrc/poa.cu), where the Pallas kernel runs 8 in lock step.
LS_GROUP = 1
#: The window lengths `obs model` tabulates by default.
AUDIT_WINDOW_LENGTHS = (500, 1000)

#: The consensus tiers a polish serves windows on (the run report's
#: names): the two POA kernels and the host POA.
POA_TIERS = ("ls", "v2", "host")
#: The tiers of POA_TIERS that run on the card.
DEVICE_POA_TIERS = ("ls", "v2")

#: Graph ranks per backbone position: POA graphs grow past the backbone
#: as divergent layer bases fork nodes (the JAX package's measure, about
#: 1,000 ranks over a 500-base backbone at 30x).
NODE_GROWTH = 2.0

#: ops/colstep.PACK: ranks the v2 kernel's column-compressed loop retires
#: a serial iteration. The port's ls kernel has no such loop.
POA_COLSTEP_PACK = 2.0

#: ops/band.BAND_BUCKETS: the verify-and-widen ladder's band rungs, whose
#: iterated cells `align.cells.banded` counts.
BAND_BUCKETS = (128, 256, 512, 1024, 2048)

#: Integer ops a DP cell of each kernel does, whatever the implementation:
#: POA: diag add, gap add, max, -j*g, running max, +j*g;
POA_OPS_PER_CELL = 6
#: the edit DP in a frame shifted by lane and row (csrc/align.cu):
#: mismatch flag, add, neighbour min, running min;
EDGE_OPS_PER_CELL = 4
#: the base case: the edge cell, a compare for each move bit, their pack.
BASE_OPS_PER_CELL = 7
#: Bytes a POA kernel reads per admitted layer base (a code and an int32
#: weight).
POA_LAYER_BYTES = 5.0

#: One H100 SXM (Hopper architecture white paper): 32-bit integer ops a
#: second (64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost) and HBM3
#: bytes a second.
H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
INT32_OPS_S = H100_SMS * 64 * H100_CLOCK_HZ
HBM_BYTES_S = 3.35e12


def window_class(bb_len: int) -> int:
    """128-lane geometry class (ops/poa_driver.window_class)."""
    return max(128, (bb_len + 127) // 128 * 128)


def band_need(n, m):
    """The band an (n, m) pair needs under the 10% rule: the drift plus a
    tenth of the longer side, plus 2. The one definition of the rule
    (ops/align_cuda.band_for and the ``align.cells.*`` counters call it);
    it takes ints or numpy integer arrays (elementwise), since
    (n + m + |m - n|) // 2 is max(n, m)."""
    drift = abs(m - n)
    return drift + (n + m + drift) // 2 // 10 + 2


class CostEstimate(NamedTuple):
    """Predicted work of one unit (window, align job or batch)."""

    flops: float          # integer ops
    hbm_bytes: float      # bytes that must cross device memory
    serial_steps: float   # latency-chained DP steps (rank loop, row scan)

    def scaled(self, k: float) -> "CostEstimate":
        return CostEstimate(self.flops * k, self.hbm_bytes * k,
                            self.serial_steps * k)

    def plus(self, other: "CostEstimate") -> "CostEstimate":
        return CostEstimate(self.flops + other.flops,
                            self.hbm_bytes + other.hbm_bytes,
                            self.serial_steps + other.serial_steps)


ZERO = CostEstimate(0.0, 0.0, 0.0)


@dataclass(frozen=True)
class MachineProfile:
    """What the machine can do: the denominator under every estimate.

    ``error_bound_ratio`` is the bound the profile declares: `obs
    validate` exits 3 when max(pred/meas, meas/pred) of a modeled phase
    exceeds it. The fields are the JAX package's, ``peak_flops`` being
    the integer op rate, and one of the port's own: ``align_step_cells``,
    which anchors the aligner's serial term to the machine's aligner (the
    JAX model divides its cells by its kernels' 256 lanes)."""

    name: str
    description: str
    clock_hz: float              # core clock (cycles columns only)
    peak_flops: float            # sustained integer ops a second
    hbm_bytes_per_s: float       # sustained device-memory bandwidth
    serial_step_s: float         # seconds a serial DP step, per window
    align_step_cells: float      # Hirschberg cells the aligner retires a
                                 # serial step, across the machine
    host_poa_cells_per_s: float  # host POA engine
    host_align_cells_per_s: float  # host aligner
    error_bound_ratio: float     # declared validate bound (>= 1)


PROFILES: Dict[str, MachineProfile] = {p.name: p for p in (
    MachineProfile(
        name="cpu-host",
        description="a CPU running the kernels' plain PyTorch versions "
                    "(one window, one DP row at a time) and the native "
                    "host engines; fitted to traced CPU polishes "
                    "(tools/fit_profile.py cpu-host)",
        clock_hz=3.0e9,
        # tools/fit_profile.py cpu-host (0.01 Mbp, 10x, -w 500, one torch
        # thread, the host backend on one thread; three runs) on an Intel
        # Xeon (8 cores, shared with other work), the median run's
        # rates, the three runs' range in brackets: phase.poa 12.88 s
        # [11.88-13.52] over 522.2 M POA ops and 170.0 k serial steps,
        # so serial_step_s 75.8 us [69.9-79.5] and peak_flops 40.5 M/s
        # [38.6-44.0]; phase.align 30.08 s [28.74-32.00] over 168.7 M
        # Hirschberg cells, so 425 cells a step [368-467]; the host
        # backend's consensus at 1.91 G model cells/s [1.73-2.22] and its
        # initialize at 1.26 G need-band cells/s [0.95-1.43] (a 0.05 s
        # call). The bytes term binds nowhere and is not fitted: a
        # nominal 10 GB/s.
        peak_flops=4.05e7,
        hbm_bytes_per_s=1.0e10,
        serial_step_s=7.58e-5,
        align_step_cells=425.0,
        host_poa_cells_per_s=1.91e9,
        host_align_cells_per_s=1.26e9,
        # CPU classes differ in Python dispatch cost far more than in op
        # rate: the JAX package's CPU bound.
        error_bound_ratio=8.0,
    ),
    MachineProfile(
        name="h100",
        description="one NVIDIA H100 80GB HBM3 (700 W): INT32 and HBM3 "
                    "peaks; serial_step_s is the DP-cost probe's row "
                    "latency over the card's SMs, align_step_cells the "
                    "aligner kernels' cells in that time",
        clock_hz=H100_CLOCK_HZ,
        peak_flops=INT32_OPS_S,
        hbm_bytes_per_s=HBM_BYTES_S,
        # The port's DP-cost probe (tools/dp_cost_probe.py mode 0, R=800,
        # B=16: one block an SM) timed a 1,024-column DP row behind one
        # barrier at about 410 ns on an NVIDIA H100 80GB HBM3 at 700.00 W
        # (PERF.md, section 7; a later smoke's probe read 501 ns, section
        # 5). With a block a window on each of the 132 SMs, the card
        # retires 132 window rows in that time.
        serial_step_s=410e-9 / H100_SMS,
        # tools/fit_profile.py h100 on an NVIDIA H100 80GB HBM3 at
        # 700.00 W and its host's 8 cores (the main cell: 1.0 Mbp, 30x,
        # -w 500; three runs, the median and the range in brackets):
        # 81.77 G Hirschberg cells in 219.1 ms [218.5-229.4] of edge and
        # base-case kernels on the device track, 1,159 cells a serial
        # step [1,107-1,163]; the host backend on 8 threads at 9.19 G
        # model POA cells/s [8.87-9.24] (3.61-3.76 s of consensus) and
        # 7.09 G need-band aligner cells/s [6.93-7.98] (3.82-4.41 s of
        # initialize, which also parses and builds the windows).
        align_step_cells=1159.0,
        host_poa_cells_per_s=9.19e9,
        host_align_cells_per_s=7.09e9,
        # The JAX package's device bound: what a DP-cell model may claim
        # of a phase whose wall the card's work sets. The port's phases
        # are not such (the card was busy 3.1% of a main polish), so a
        # ratio past it there is the model's error against a wall the
        # host sets; the card's part of a phase is the device track's
        # share of it.
        error_bound_ratio=2.5,
    ),
)}


def profile(name: str) -> MachineProfile:
    """Look up a machine profile; raises KeyError with the valid names."""
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown machine profile {name!r}; "
                       f"available: {sorted(PROFILES)}") from None


def resolve_profile(name: str, platform: Optional[str] = None
                    ) -> MachineProfile:
    """'auto' picks by the platform stamped in a trace (cuda -> h100,
    else cpu-host); anything else must be a registered profile name."""
    if name in ("", "auto", None):
        return PROFILES["h100" if platform == "cuda" else "cpu-host"]
    return profile(name)


# -- closed-form estimates -------------------------------------------------

def _poa_step_div(tier: str) -> float:
    """Ranks a tier's serial loop retires an iteration, times the windows
    a program shares it with."""
    return {"ls": float(LS_GROUP), "v2": POA_COLSTEP_PACK}.get(tier, 1.0)


def poa_window_cost(depth: int, wl_class: int, tier: str) -> CostEstimate:
    """Predicted work of ONE window of `depth` admitted layers in a
    `wl_class` geometry class served by `tier`: each layer aligns against
    the graph, ranks x layer length cells, with the rank loop
    latency-chained; the graph update and consensus ride inside the same
    rank steps."""
    ranks = NODE_GROWTH * wl_class
    cells = depth * ranks * wl_class
    # the layers' bases and weights in, the consensus out; the DP rows
    # stay in shared memory
    hbm = depth * wl_class * POA_LAYER_BYTES + 2 * wl_class * 5
    steps = depth * ranks / _poa_step_div(tier)
    return CostEstimate(cells * POA_OPS_PER_CELL, hbm, steps)


def align_job_cost(cap: int, band: int, step_cells: float) -> CostEstimate:
    """Predicted work of ONE Hirschberg job of `cap` rows at band `band`:
    forward and backward distance passes over the recursion tree, about
    twice the base DP, no stored matrix; its serial steps at `step_cells`
    cells a step (MachineProfile.align_step_cells)."""
    cells = 2.0 * float(cap) * band
    return CostEstimate(cells * EDGE_OPS_PER_CELL, cap * 2.0,
                        cells / step_cells)


def roofline(est: CostEstimate, prof: MachineProfile):
    """(seconds, verdict): the largest of the three roofline terms, and
    the bound it names."""
    terms = {
        "compute-bound": est.flops / prof.peak_flops,
        "bandwidth-bound": est.hbm_bytes / prof.hbm_bytes_per_s,
        "serial-step-bound": est.serial_steps * prof.serial_step_s,
    }
    verdict = max(terms, key=lambda k: terms[k])
    return terms[verdict], verdict


def host_poa_seconds(cells: float, prof: MachineProfile) -> float:
    return cells / prof.host_poa_cells_per_s


def host_align_seconds(cells: float, prof: MachineProfile) -> float:
    return cells / prof.host_align_cells_per_s


# -- the predicted grid (obs model) ----------------------------------------

def model_rows(prof: MachineProfile,
               window_lengths=AUDIT_WINDOW_LENGTHS,
               tiers=DEVICE_POA_TIERS, depth: Optional[int] = None
               ) -> List[dict]:
    """One row per (tier, depth bucket, window class) and one per aligner
    band (a job of 10 x band rows, the length at which the 10% rule needs
    that band): predicted ops, bytes, serial steps, wall and cycles per
    unit, and the roofline verdict."""
    rows = []
    classes = sorted({window_class(w) for w in window_lengths})
    for tier in tiers:
        for d in DEPTH_BUCKETS if depth is None else (depth,):
            for c in classes:
                est = poa_window_cost(d, c, tier)
                s, verdict = roofline(est, prof)
                rows.append({
                    "kind": "poa", "tier": tier, "depth": d, "class": c,
                    "flops": est.flops, "hbm_bytes": est.hbm_bytes,
                    "serial_steps": est.serial_steps,
                    "predicted_s": s,
                    "predicted_cycles": s * prof.clock_hz,
                    "verdict": verdict,
                })
    for band in ALIGN_BANDS:
        cap = 10 * band
        est = align_job_cost(cap, band, prof.align_step_cells)
        s, verdict = roofline(est, prof)
        rows.append({
            "kind": "align", "tier": "hirschberg", "cap": cap, "band": band,
            "flops": est.flops, "hbm_bytes": est.hbm_bytes,
            "serial_steps": est.serial_steps,
            "predicted_s": s, "predicted_cycles": s * prof.clock_hz,
            "verdict": verdict,
        })
    return rows


# -- validation against a measured trace ----------------------------------

_POA_CELLS = re.compile(r"^poa\.cells\.d(\d+)\.c(\d+)$")
_SHARD_ROWS = re.compile(r"^shard\.rows\.d(\d+)$")


def infer_n_devices(counters: Dict[str, int]) -> int:
    """Device count from the per-device stripe counters
    (`shard.rows.d<i>`); 1 when the run never striped."""
    n = 0
    for k in counters:
        m = _SHARD_ROWS.match(k)
        if m:
            n = max(n, int(m.group(1)) + 1)
    return max(1, n)


def _over_devices(est: CostEstimate, n: int) -> CostEstimate:
    """Spread a device-side estimate over n stripes: ops and bytes divide
    (each device launches its slice of the rows), the serial steps do not
    (every slice runs the same DP loop, at once)."""
    if n <= 1:
        return est
    return CostEstimate(est.flops / n, est.hbm_bytes / n,
                        est.serial_steps)


#: Trace phase span name -> run-report phase name.
PHASE_ALIASES = {"align": "alignment", "poa": "consensus"}


def _err_pct(pred: float, meas: float) -> Optional[float]:
    if meas <= 0.0:
        return None
    return 100.0 * (pred - meas) / meas


def _ratio(pred: float, meas: float) -> Optional[float]:
    if pred <= 0.0 or meas <= 0.0:
        return None
    return max(pred / meas, meas / pred)


def _dominant_tier(counters: Dict[str, int], phase: str,
                   candidates) -> Optional[str]:
    best, best_n = None, 0
    for t in candidates:
        n = counters.get(f"served.{phase}.{t}", 0)
        if n > best_n:
            best, best_n = t, n
    return best


def predict_from_counters(counters: Dict[str, int],
                          prof: MachineProfile,
                          n_devices: Optional[int] = None) -> dict:
    """Predicted per-phase walls and a per-bucket table from the DP-cell
    counters the drivers count while obs is armed.

    POA: `poa.cells.d<D>.c<C>` = the sum over the bucket's windows of
    (admitted depth x class C), the rank steps at graph growth 1.
    Aligner: `align.cells.hirschberg` = 2 x max(n, m) x the flat band
    bucket per Hirschberg job, its serial steps those cells over the
    profile's `align_step_cells`; `align.cells.total` the need-band cells
    over ALL phase-1 jobs (the host's share included).
    `poa.cells.banded` / `align.cells.banded` are the cells the banded
    path iterated: info rows, outside the phase totals.

    `n_devices` divides the device-side ops and bytes (striping; serial
    steps are not divided). None = infer from the `shard.rows.d<i>`
    counters, except on cpu-host, whose stripes share the same cores.
    """
    if n_devices is None:
        n_devices = (1 if prof.name == "cpu-host"
                     else infer_n_devices(counters))
    n_devices = max(1, int(n_devices))
    # ---- consensus
    tier = _dominant_tier(counters, "consensus", DEVICE_POA_TIERS) or "ls"
    total_served = sum(v for k, v in counters.items()
                       if k.startswith("served.consensus."))
    host_served = counters.get("served.consensus.host", 0)
    host_frac = host_served / total_served if total_served else 0.0
    buckets = []
    poa_est = ZERO
    poa_host_cells = 0.0
    for name, raw in sorted(counters.items()):
        m = _POA_CELLS.match(name)
        if not m:
            continue
        d, c = int(m.group(1)), int(m.group(2))
        steps1 = float(raw)                      # sum(depth_i) * C
        ranks_steps = steps1 * NODE_GROWTH       # rank-loop steps
        cells = ranks_steps * c                  # DP cells
        est = CostEstimate(cells * POA_OPS_PER_CELL,
                           steps1 * POA_LAYER_BYTES,
                           ranks_steps / _poa_step_div(tier))
        dev_share = 1.0 - host_frac
        dev_est = _over_devices(est.scaled(dev_share), n_devices)
        sec, verdict = roofline(dev_est, prof)
        sec += host_poa_seconds(cells * host_frac, prof)
        windows = counters.get(f"poa.windows.d{d}.c{c}")
        buckets.append({"kind": "poa", "tier": tier, "depth": d,
                        "class": c, "windows": windows,
                        "cells": cells, "serial_steps": est.serial_steps,
                        "predicted_s": sec, "verdict": verdict})
        poa_est = poa_est.plus(dev_est)
        poa_host_cells += cells * host_frac
    poa_s, poa_verdict = roofline(poa_est, prof)
    poa_s += host_poa_seconds(poa_host_cells, prof)

    # ---- alignment
    a_est = ZERO
    dev_cells = 0.0
    hs_cells = counters.get("align.cells.hirschberg", 0)
    if hs_cells:
        est = _over_devices(
            CostEstimate(hs_cells * EDGE_OPS_PER_CELL,
                         hs_cells * 0.1,
                         hs_cells / prof.align_step_cells),
            n_devices)
        a_est = a_est.plus(est)
        dev_cells += float(hs_cells)
        sec, verdict = roofline(est, prof)
        buckets.append({"kind": "align", "tier": "hirschberg",
                        "cells": float(hs_cells), "predicted_s": sec,
                        "verdict": verdict})
    # the banded path's iterated cells: info rows only, since the
    # flat-band bill is already inside the buckets above (no double
    # count); the flat-to-banded cell ratio is the measured saving
    for phase, cname, opc in (
            ("align", "align.cells.banded", EDGE_OPS_PER_CELL),
            ("poa", "poa.cells.banded", POA_OPS_PER_CELL)):
        bnd = counters.get(cname, 0)
        if bnd:
            best = _over_devices(
                CostEstimate(bnd * opc, bnd * 0.1, 0.0), n_devices)
            sec, verdict = roofline(best, prof)
            buckets.append({"kind": "banded", "phase": phase,
                            "tier": "banded", "cells": float(bnd),
                            "predicted_s": sec, "verdict": verdict})
    align_s, align_verdict = roofline(a_est, prof)
    # the host aligner serves whatever the device buckets did not cover
    total_cells = counters.get("align.cells.total", 0)
    host_cells = max(0.0, float(total_cells) - dev_cells)
    align_s += host_align_seconds(host_cells, prof)
    if host_cells and host_cells >= dev_cells:
        align_verdict = "host-served"

    return {
        "buckets": buckets,
        "n_devices": n_devices,
        "phases": {
            "poa": {"predicted_s": poa_s, "verdict": poa_verdict,
                    "tier": tier,
                    "serial_steps": poa_est.serial_steps},
            "align": {"predicted_s": align_s, "verdict": align_verdict,
                      "serial_steps": a_est.serial_steps},
        },
    }


# -- span-interval math (chunked polishes overlap their phase spans) -------

def span_intervals(doc: dict, name: str) -> List[tuple]:
    """Sorted [(start_us, end_us)] of every complete event named `name`."""
    out = []
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X" \
                and ev.get("name") == name:
            ts = float(ev.get("ts", 0))
            out.append((ts, ts + float(ev.get("dur", 0))))
    return sorted(out)


def union_intervals(intervals) -> List[tuple]:
    """Merge possibly-overlapping intervals into disjoint ones."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(iv) for iv in merged]


def overlap_us(doc: dict, name_a: str, name_b: str) -> float:
    """Wall (µs) during which a span named `name_a` and one named
    `name_b` were open at once (`align.cohort` against `poa.bucket`: the
    chunked polish's phase overlap)."""
    a = union_intervals(span_intervals(doc, name_a))
    b = union_intervals(span_intervals(doc, name_b))
    total = 0.0
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def phase_overlaps_us(doc: dict) -> Dict[str, float]:
    """Nonzero pairwise overlaps between ``phase.*`` span families,
    keyed ``"a+b"`` ({} for a sequential polish)."""
    names = sorted({ev["name"] for ev in doc.get("traceEvents", [])
                    if isinstance(ev, dict) and ev.get("ph") == "X"
                    and isinstance(ev.get("name"), str)
                    and ev["name"].startswith("phase.")})
    out: Dict[str, float] = {}
    for i, na in enumerate(names):
        for nb in names[i + 1:]:
            ov = overlap_us(doc, na, nb)
            if ov > 0:
                out[f"{na[len('phase.'):]}+{nb[len('phase.'):]}"] = ov
    return out


def _bucket_walls_us(doc: dict) -> Dict[tuple, float]:
    """Measured submit-side wall per (kind, key) from the bucket and
    cohort spans (a batch in flight may resolve inside the next bucket's
    span, so these are first-order)."""
    walls: Dict[tuple, float] = {}
    for ev in doc.get("traceEvents", []):
        if not (isinstance(ev, dict) and ev.get("ph") == "X"):
            continue
        args = ev.get("args") or {}
        if ev.get("name") == "poa.bucket":
            key = ("poa", int(args.get("depth", -1)),
                   int(args.get("wl_class", -1)))
        elif ev.get("name") == "align.cohort":
            key = ("align", args.get("tier", "?"),
                   int(args.get("cap", 0) or 0))
        else:
            continue
        walls[key] = walls.get(key, 0.0) + float(ev.get("dur", 0))
    return walls


def validate_trace(doc: dict, prof: MachineProfile) -> dict:
    """Join the predictions against a measured trace.

    Returns {profile, error_bound_ratio, phases: {name: {predicted_s,
    measured_s, error_pct, ratio, within_bound, ...}}, buckets,
    [phase_overlap_s], dropped_events, ok}. Only the modeled phases
    (align, poa) gate `ok`; a phase with no measured wall or no counted
    cells is reported but not gated."""
    metrics = (doc.get("racon_tpu") or {}).get("metrics") or {}
    counters = metrics.get("counters") or {}
    pred = predict_from_counters(counters, prof)

    measured: Dict[str, float] = {}
    for ev in doc.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("ph") == "X" \
                and isinstance(ev.get("name"), str) \
                and ev["name"].startswith("phase."):
            p = ev["name"][len("phase."):]
            measured[p] = measured.get(p, 0.0) + ev.get("dur", 0) / 1e6

    phases = {}
    ok = True
    for name, row in pred["phases"].items():
        meas = measured.get(name)
        p_s = row["predicted_s"]
        entry = dict(row, measured_s=meas)
        if meas is not None and p_s > 0.0:
            entry["error_pct"] = _err_pct(p_s, meas)
            r = _ratio(p_s, meas)
            entry["ratio"] = r
            within = r is not None and r <= prof.error_bound_ratio
            entry["within_bound"] = within
            ok = ok and within
        else:
            entry["within_bound"] = None   # nothing to gate on
        phases[name] = entry

    bwalls = _bucket_walls_us(doc)
    for b in pred["buckets"]:
        if b["kind"] == "poa":
            key = ("poa", b["depth"], b["class"])
        else:
            key = ("align", b["tier"], b.get("cap", 0))
        us = bwalls.get(key)
        if us is not None:
            b["measured_s"] = us / 1e6
            b["error_pct"] = _err_pct(b["predicted_s"], us / 1e6)

    dropped = (doc.get("otherData") or {}).get("dropped_events", 0)
    # the measured walls sum span durations, so a chunked polish's
    # overlapping phases stay comparable; the overlap is reported so a
    # reader knows they did not run back to back
    overlaps = {k: round(v / 1e6, 6)
                for k, v in phase_overlaps_us(doc).items()}
    return {
        "profile": prof.name,
        "error_bound_ratio": prof.error_bound_ratio,
        "phases": phases,
        "buckets": pred["buckets"],
        **({"phase_overlap_s": overlaps} if overlaps else {}),
        "dropped_events": dropped,
        "ok": ok,
    }


# -- a bench's cost-model stamp --------------------------------------------

def bench_cost_model(snapshot: Optional[dict], phase_wall: Dict[str, float],
                     profile_name: str = "auto",
                     platform: Optional[str] = None,
                     n_devices: Optional[int] = None) -> Optional[dict]:
    """The `cost_model` stamp of a bench entry: predicted against
    measured per modeled phase (`phase_wall` keyed by the run report's
    phase names), error %, and the profile used. None when the run
    collected no metrics (obs disarmed)."""
    if not snapshot or not isinstance(snapshot.get("counters"), dict):
        return None
    prof = resolve_profile(profile_name, platform)
    pred = predict_from_counters(snapshot["counters"], prof,
                                 n_devices=n_devices)
    out = {"profile": prof.name, "n_devices": pred["n_devices"],
           "phases": {}}
    ok = True
    for span_name, row in pred["phases"].items():
        report_name = PHASE_ALIASES.get(span_name, span_name)
        meas = phase_wall.get(report_name)
        p_s = row["predicted_s"]
        entry = {"predicted_s": round(p_s, 4),
                 "measured_s": meas,
                 "serial_steps": round(row.get("serial_steps", 0.0), 1),
                 "verdict": row["verdict"]}
        if meas and p_s > 0.0:
            entry["error_pct"] = round(_err_pct(p_s, meas), 1)
            r = _ratio(p_s, meas)
            entry["within_bound"] = (r is not None
                                     and r <= prof.error_bound_ratio)
            ok = ok and entry["within_bound"]
        out["phases"][report_name] = entry
    out["ok"] = ok
    return out


# -- rendering -------------------------------------------------------------

def _fmt_si(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v == 0:
        return "0"
    mag = int(math.floor(math.log10(abs(v)) / 3)) if v else 0
    mag = max(0, min(mag, 4))
    return f"{v / 1000 ** mag:.3g}{('', 'k', 'M', 'G', 'T')[mag]}"


def render_model(rows: List[dict], prof: MachineProfile) -> str:
    lines = [f"machine profile: {prof.name} "
             f"(clock {prof.clock_hz / 1e9:.2f} GHz, "
             f"peak {_fmt_si(prof.peak_flops)}op/s, "
             f"memory {_fmt_si(prof.hbm_bytes_per_s)}B/s, "
             f"serial step {prof.serial_step_s * 1e9:.2f} ns, "
             f"aligner {prof.align_step_cells:.0f} cells a step)",
             f"{'kernel':<22s} {'ops':>8s} {'bytes':>8s} "
             f"{'steps':>8s} {'wall':>10s} {'cycles':>9s}  verdict"]
    for r in rows:
        if r["kind"] == "poa":
            name = f"poa.{r['tier']} d{r['depth']} c{r['class']}"
        else:
            name = f"align.{r['tier']} c{r['cap']} b{r['band']}"
        lines.append(
            f"{name:<22s} {_fmt_si(r['flops']):>8s} "
            f"{_fmt_si(r['hbm_bytes']):>8s} "
            f"{_fmt_si(r['serial_steps']):>8s} "
            f"{r['predicted_s'] * 1e3:>8.3f}ms "
            f"{_fmt_si(r['predicted_cycles']):>9s}  {r['verdict']}")
    return "\n".join(lines)


def render_validation(v: dict) -> str:
    lines = [f"cost-model validation (profile {v['profile']}, "
             f"declared bound {v['error_bound_ratio']:.1f}x)"]
    if v["dropped_events"]:
        lines.append(f"WARNING: trace dropped {v['dropped_events']} "
                     f"span(s) past the bounded buffer — measured walls "
                     f"below may be incomplete")
    lines.append("-- phases " + "-" * 48)
    for name, row in sorted(v["phases"].items()):
        meas = row.get("measured_s")
        err = row.get("error_pct")
        gate = row.get("within_bound")
        mark = ("ok" if gate else "PAST BOUND") if gate is not None \
            else "not gated"
        lines.append(
            f"  phase.{name:<10s} predicted {row['predicted_s']:>9.3f}s  "
            f"measured {'-' if meas is None else f'{meas:9.3f}s'}  "
            f"err {'-' if err is None else f'{err:+7.1f}%'}  "
            f"[{row['verdict']}] {mark}")
    if v.get("phase_overlap_s"):
        lines.append("-- phase overlap (chunked run) " + "-" * 27)
        for k, s in sorted(v["phase_overlap_s"].items()):
            lines.append(f"  {k:<18s} {s:9.3f}s concurrent")
    if v["buckets"]:
        lines.append("-- buckets " + "-" * 47)
        for b in v["buckets"]:
            if b["kind"] == "poa":
                name = f"poa d{b['depth']} c{b['class']}"
                extra = f" x{b['windows']}" if b.get("windows") else ""
            elif b["kind"] == "banded":
                name = f"banded {b['phase']}"
                extra = ""
            else:
                name = f"align {b['tier']}" + (
                    f" c{b['cap']}" if b.get("cap") else "")
                extra = ""
            meas = b.get("measured_s")
            err = b.get("error_pct")
            lines.append(
                f"  {name:<18s}{extra:<6s} cells {_fmt_si(b['cells']):>7s} "
                f"pred {b['predicted_s'] * 1e3:>9.2f}ms "
                f"meas {'-' if meas is None else f'{meas * 1e3:9.2f}ms'} "
                f"err {'-' if err is None else f'{err:+6.0f}%'} "
                f"[{b['verdict']}]")
    verdict = "OK" if v["ok"] else "PREDICTION ERROR PAST DECLARED BOUND"
    lines.append(f"verdict: {verdict}")
    return "\n".join(lines)
