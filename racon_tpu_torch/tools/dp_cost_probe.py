"""What one step of each DP loop shape costs on the card.

Stripped-down DP loops shaped like the POA and aligner kernels' serial
chains, adding back one cost component per mode (csrc/dp_cost_probe.cu,
one thread block per program). Each returns a seed-dependent ``out`` and
a measured count: serial loop iterations for modes 0-14, scored DP cells
for modes 15-18. What each mode measures on an H100:

  mode 0: a 1,024-column DP row (shift, max, linear-gap prefix max,
          write) on 256 threads of 4 columns: per-thread max, warp
          shuffle scan, the 8 warp totals through shared memory between
          two block barriers; the row index is the loop counter
  mode 1: + the rank -> node lookup (a shared-memory `order` load)
  mode 2: + the node's base and in-edge count (shared-memory loads)
  mode 3: + a 2-edge predecessor scan: in-edge table loads (global),
          the key check (shared) and the predecessors' H rows (global)
  mode 4: + the has_out store per edge (shared)
  mode 5: mode 0 without the carry across warps: each warp's 128 columns
          scan and shift on their own (a wrong result of the right
          shape); the cost of the cross-warp pass and its barriers
  mode 6: mode 0 on 1,024 threads of one column each: a 32-warp scan
  mode 7: mode 0 with a radix-4 warp shuffle scan (3 rounds of 3
          independent shuffles) against the binary one (5 rounds)
  mode 8: mode 0 on two independent rows per step (ILP); per-node time
          counts both rows
  mode 9: the lane-lockstep shape: 8 windows of 512 columns per block,
          one warp per window, 16 columns per lane, rows in a 128-row
          ring in global memory, no barriers; per-node time counts the
          8 windows
  mode 10: mode 9 + twelve graph-row loads of 8 values per rank (shared
          memory, a warp sum) and a depth-4 scan over earlier ring rows
  mode 11: mode 1 under the column-compressed loop of the v2 POA kernel
          on keys rank // 2: same-key ranks retire in one iteration, so
          the serial trip count halves
  mode 12: mode 9 under the rank-pair loop: two ranks per iteration
  mode 13: the aligner's band row: 128 columns in registers of one warp,
          one query-code load and one shift + max per row, no scan
  mode 14: mode 13 packed: one code word per 4 rows, trip count R / 4
  mode 15: the band row on 1,024 columns (a block: the shift's carry
          crosses warps through shared memory, one barrier per row);
          counts DP cells
  mode 16: mode 15 on the 128-column banded rung (one warp), the band
          advancing one diagonal per row: 8x fewer cells
  mode 17: banded-POA baseline: a 1,664-column row (13 chunks of 128) of
          an 8-row ring; counts DP cells
  mode 18: mode 17 banded: only a 4-chunk window around the rank's
          backbone column is read, scored and written: 3.25x fewer cells

Every mode computes the same ``out`` and ``steps`` as the JAX package's
Pallas probe (racon_tpu/tools/dp_cost_probe.py), layout experiments
included (mode 5's wrap within 128 columns, the lockstep ring seeded with
``j*g + seed - ring_row``, mode 18's windows that read rows never written
since the ring's seeding). The plain PyTorch versions here repeat that
arithmetic; a seed tensor on the CPU runs them, one on the card runs the
kernel. ``gate()`` holds the compressed modes' measured counts against
their baselines: >= 1.5x fewer serial steps (11 vs 1, 12 vs 9), >= 2x
(14 vs 13), >= 3x fewer cells (16 vs 15, 18 vs 17).

On the card each mode's kernel runs the POA kernels' row design (the row
before in registers, one barrier a row, the graph in shared memory, only
the last row written to global memory; csrc/dp_cost_probe.cu). With
``--baseline SRC.cu`` (another tree's csrc/dp_cost_probe.cu with the same
C interface) that source is built into ``_build/baseline/`` and timed in
the same call, in turns with this build (this, baseline, baseline, this:
each mode's best warm call of each build), and each mode's ``out`` and
``steps`` must be equal; it prints one JSON line a mode and the sums.

Usage: python -m racon_tpu_torch.tools.dp_cost_probe [R] [B] [reps]
           [--device cuda|cpu] [--baseline SRC.cu]
       python -m racon_tpu_torch.tools.dp_cost_probe --gate [--device ...]
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

import torch

from ..ops import cuda_lib

NEG = -(1 << 28)
G = -8
NSLOT = 2048          # node slots (the rank capacity)
ROW = 1024            # flat DP row
LS_W, LS_G, RING, GSLOTS, NE = 512, 8, 128, 16, 12
JC2, CB, RING2 = 13, 4, 8
N_MODES = 19

#: Width of the last DP row (or ring row) `probe(..., rows=True)` returns:
#: mode 8's two rows, the 8 lockstep windows, the band, a whole ring row.
ROW_WIDTH = {**{m: ROW for m in (0, 1, 2, 3, 4, 5, 6, 7, 11, 15)},
             8: 2 * ROW, 9: LS_G * LS_W, 10: LS_G * LS_W, 12: LS_G * LS_W,
             13: 128, 14: 128, 16: 128, 17: JC2 * 128, 18: JC2 * 128}

#: DP columns one program scores per rank, by mode.
COLUMNS = {**{m: ROW for m in (0, 1, 2, 3, 4, 5, 6, 7, 11, 15)},
           8: 2 * ROW, 9: 8 * LS_W, 10: 8 * LS_W, 12: 8 * LS_W,
           13: 128, 14: 128, 16: 128, 17: JC2 * 128, 18: CB * 128}
#: DP rows per rank that per-node times are divided by.
ROWS_PER_RANK = {8: 2, 9: 8, 10: 8, 12: 8}
#: Integer operations per DP cell: shift-add, gap add, max, then -j*g,
#: running max, +j*g for the modes with a prefix max; the band rows
#: (13-16) have no prefix max.
OPS_PER_CELL = {**{m: 6 for m in range(N_MODES)},
                13: 3, 14: 3, 15: 3, 16: 3}


# ---------------------------------------------------------- plain versions

def _shift(x, fill):
    """Shift right by one along the last axis, `fill` entering at 0."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _sc(j, ub):
    return torch.where(j % 4 == ub, 5, -4)


def _row(P, ub, j):
    """One DP row from P: max(diagonal, up), then H = j*g + cummax(V -
    j*g) along the last axis."""
    V = torch.maximum(_shift(P, NEG) + _sc(j, ub), P + G)
    return torch.cummax(V - j * G, -1).values + j * G


def _row_no_carry(P, ub, j):
    """Mode 5: shift and prefix max inside each 128-column segment (the
    shift wraps within the segment; only column 0 takes the fill)."""
    B = P.shape[0]
    ln = torch.roll(P.view(B, 8, 128), 1, -1).reshape(B, ROW).clone()
    ln[:, 0] = NEG
    V = torch.maximum(ln + _sc(j, ub), P + G) - j * G
    return torch.cummax(V.view(B, 8, 128), -1).values.reshape(B, ROW) + j * G


def _plain_rows(mode, R, s):
    """Modes 0-5, 7, 11: rank r is node r; returns (row R, iterations)."""
    level = 0 if mode in (5, 7) else 1 if mode == 11 else mode
    j = torch.arange(ROW, device=s.device, dtype=torch.int64)
    H = {0: j * G + s}
    row = _row_no_carry if mode == 5 else _row

    def work(u):
        ub = u % 4 if level >= 2 else 1
        if level >= 3 and u > 0:      # two in-edges: u-1 and u-2 (>= 0)
            P = torch.full_like(H[0], NEG)
            for src in (max(u - 1, 0), max(u - 2, 0)):
                P = torch.maximum(P, H[src + 1])
        elif level >= 3:              # node 0 has none: the virtual row
            P = H[0]
        else:
            P = H[u]
        H[u + 1] = row(P, ub, j)
        if u > 1:                     # no later rank reads row u - 1
            del H[u - 1]

    it, r = 0, 0
    while r < R:
        work(r)
        # mode 11: keys rank // 2, so rank r + 1 shares r's key when r is
        # even; the other modes step one rank
        pair = mode == 11 and r + 1 < R and (r + 1) // 2 == r // 2
        if pair:
            work(r + 1)
        r += 2 if pair else 1
        it += 1
    return H[R], it


def _plain_ls(mode, R, s):
    """Modes 9, 10, 12: one window of the lockstep ring (the 8 windows
    are identical)."""
    j = torch.arange(LS_W, device=s.device, dtype=torch.int64)
    ring = [j * G + s - i for i in range(RING)]

    def work(r):
        P = ring[r % RING]
        if mode == 10:
            acc = sum(8 * ((r % 128 + (r + e) % GSLOTS) % 7)
                      for e in range(NE))
            for d in range(1, 5):
                if d <= acc % 4 + 1:
                    P = torch.maximum(P, ring[(r - d) % RING])
            P = P + (acc & 1)
        ring[(r + 1) % RING] = _row(P, 1, j)

    for r in range(R):
        work(r)
    it = (R + 1) // 2 if mode == 12 else R
    return ring[R % RING], it


def _plain_band(mode, R, s):
    """Modes 13-16: the band row in registers, no prefix max."""
    width = ROW if mode == 15 else 128
    j = torch.arange(width, device=s.device, dtype=torch.int64)
    x = j * G + s
    for r in range(R):
        qc = r % 5
        col = j + r if mode == 16 else j
        x = torch.maximum(_shift(x, NEG) + torch.where(col % 5 == qc, 5, -4),
                          x + G)
    count = {13: R, 14: (R + 3) // 4, 15: R * ROW, 16: R * 128}[mode]
    return x, count


def _plain_window(mode, R, s):
    """Modes 17, 18: rows of W chunks of 128 on an 8-row ring of 13."""
    W = JC2 if mode == 17 else CB
    j = torch.arange(W * 128, device=s.device, dtype=torch.int64)
    idx = torch.arange(RING2 * JC2 * 128, device=s.device, dtype=torch.int64)
    ring = (idx // 128) % 97 + s
    for r in range(R):
        cb0 = min(max(r * JC2 // R - CB // 2, 0), JC2 - W)
        a = ((r % RING2) * JC2 + cb0) * 128
        b = (((r + 1) % RING2) * JC2 + cb0) * 128
        row = _row(ring[:, a:a + W * 128], 1, j)
        ring[:, b:b + W * 128] = row
    c = (R % RING2) * JC2 * 128
    return ring[:, c:c + JC2 * 128], R * W * 128


def probe_plain(mode: int, R: int, seed: torch.Tensor, rows: bool = False):
    """The plain PyTorch version of `mode` on the seed tensor's device:
    (out i32[B], steps i32[B]), and with `rows` the last DP row (or ring
    row) i32[B, ROW_WIDTH[mode]] as the kernel leaves it."""
    _check(mode, R, seed)
    s = seed.to(torch.int64).view(-1, 1)
    if mode in (9, 10, 12):
        last, count = _plain_ls(mode, R, s)
        last = last.repeat(1, LS_G)
    elif mode in (13, 14, 15, 16):
        last, count = _plain_band(mode, R, s)
    elif mode in (17, 18):
        last, count = _plain_window(mode, R, s)
    else:                             # modes 6 and 8 run mode 0's row
        last, count = _plain_rows(0 if mode in (6, 8) else mode, R, s)
        if mode == 8:
            last = last.repeat(1, 2)
    # modes 6 and 8 read column 0 alone
    out = last[:, 0] if mode in (6, 8) else last[:, 0] + last[:, 1]
    res = (out.to(torch.int32),
           torch.full_like(seed, count, dtype=torch.int32))
    return res + (last.to(torch.int32),) if rows else res


# ------------------------------------------------------------------ kernel

_LIB = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rt_probe_scratch_words.restype = ctypes.c_longlong
    lib.rt_probe_scratch_words.argtypes = [ci, ci]
    lib.rt_probe_launch.restype = ci
    lib.rt_probe_launch.argtypes = [ci, ci, vp, vp, vp, vp, ci, vp]
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _bind(cuda_lib.load("dp_cost_probe"))
    return _LIB


def build_baseline(src: str) -> ctypes.CDLL:
    """Another tree's csrc/dp_cost_probe.cu, built into
    ``_build/baseline/`` with this tree's nvcc flags (needs the card's
    toolkit)."""
    out_dir = os.path.join(cuda_lib.BUILD, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libdp_cost_probe.so")
    log = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", out,
                          os.path.abspath(src)], capture_output=True,
                         text=True)
    if log.returncode:
        raise RuntimeError(f"baseline probe build failed:\n{log.stdout}"
                           f"{log.stderr}")
    return _bind(ctypes.CDLL(out))


@contextlib.contextmanager
def using(lib: ctypes.CDLL):
    """probe() on the card launches `lib`'s kernels inside the block."""
    global _LIB
    saved, _LIB = _lib(), lib
    try:
        yield
    finally:
        _LIB = saved


def _check(mode, R, seed):
    if not 0 <= mode < N_MODES:
        raise ValueError(f"mode must be in [0, {N_MODES}), got {mode}")
    if not 1 <= R <= NSLOT - 1:
        raise ValueError(f"R must be in [1, {NSLOT - 1}] (the node-slot "
                         f"capacity), got {R}")
    if seed.dtype != torch.int32 or seed.dim() != 1:
        raise ValueError("seed must be a 1-D int32 tensor")


def probe(mode: int, R: int, seed: torch.Tensor, rows: bool = False):
    """Run `mode` for R ranks, one program per seed: (out i32[B], steps
    i32[B]) on the seed's device, and with `rows` each program's last DP
    row (or ring row) i32[B, ROW_WIDTH[mode]], the first words of its
    scratch. A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel, or this raises."""
    if seed.device.type == "cpu":
        return probe_plain(mode, R, seed, rows)
    _check(mode, R, seed)
    seed = seed.contiguous()
    B = seed.shape[0]
    out = torch.empty(B, dtype=torch.int32, device=seed.device)
    steps = torch.empty(B, dtype=torch.int32, device=seed.device)
    lib = _lib()
    per = lib.rt_probe_scratch_words(mode, R)
    scratch = torch.empty((B, per), dtype=torch.int32, device=seed.device)
    if B > 0:
        p = cuda_lib.ptr
        err = lib.rt_probe_launch(mode, R, p(seed), p(out), p(steps),
                                  p(scratch), B, cuda_lib.stream_of(seed))
        cuda_lib.check(err, f"DP-cost probe kernel (mode {mode})")
        cuda_lib.count_launch("dp_cost_probe")
    if not rows:
        return out, steps
    return out, steps, scratch[:, :ROW_WIDTH[mode]].clone()


# ---------------------------------------------------------------- gate, table

GATE_CHECKS = (("poa-v2 colstep", 1, 11, 1.5, "serial steps"),
               ("poa-ls rank-pair", 9, 12, 1.5, "serial steps"),
               ("align row-pack", 13, 14, 2.0, "serial steps"),
               ("align banded-band", 15, 16, 3.0, "in-loop cells"),
               ("poa banded-window", 17, 18, 3.0, "in-loop cells"))


def gate(R: int = 32, B: int = 1, device="cuda") -> bool:
    """The measured in-loop counts of the compressed modes against their
    baselines: serial trip counts for the step-compression pairs, scored
    DP cells for the banded pairs. Prints every ratio; False if a floor
    is missed."""
    seed = torch.zeros(B, dtype=torch.int32, device=device)

    def steps_of(mode):
        return int(probe(mode, R, seed)[1][0])

    ok = True
    for name, base_m, new_m, floor, unit in GATE_CHECKS:
        b, n = steps_of(base_m), steps_of(new_m)
        ratio = b / n if n else float("inf")
        good = ratio >= floor
        ok = ok and good
        print(f"{name}: baseline mode {base_m} = {b} {unit}, "
              f"compressed mode {new_m} = {n}, measured ratio "
              f"{ratio:.2f}x (floor {floor}x) "
              f"{'OK' if good else 'FAIL'}")
    return ok


def _time_s(fn, device) -> float:
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def time_modes(R: int = 800, B: int = 16, reps: int = 3,
               device="cuda") -> List[Dict]:
    """Each mode's first call (host clock), best warm call (CUDA events on
    the card), per-node microseconds (warm time over R x B x rows per
    rank), nanoseconds a rank step (warm time over R: the programs run
    side by side, each a chain of R steps), picoseconds a DP cell (warm
    time over the cells all programs score), its counts, DP cells and
    outputs for seeds 0 and 7."""
    device = torch.device(device)
    res = []
    for mode in range(N_MODES):
        seed = torch.zeros(B, dtype=torch.int32, device=device)
        t0 = time.perf_counter()
        out, steps = probe(mode, R, seed)
        o1, st = int(out[0]), int(steps[0])
        first = time.perf_counter() - t0
        # the result must move with the seed, else the loop was folded
        # away and the timing is fiction
        o2 = int(probe(mode, R, seed + 7)[0][0])
        best = min(_time_s(lambda: probe(mode, R, seed + i + 1), device)
                   for i in range(reps))
        rows = R * B * ROWS_PER_RANK.get(mode, 1)
        cells = R * B * COLUMNS[mode]
        res.append(dict(mode=mode, first_s=first, warm_s=best,
                        per_node_us=best / rows * 1e6,
                        ns_per_step=best / R * 1e9,
                        ps_per_cell=best / cells * 1e12, steps=st,
                        cells=cells,
                        ops=R * B * COLUMNS[mode] * OPS_PER_CELL[mode],
                        out_seed0=o1, out_seed7=o2))
    return res


def compare_baseline(src: str, R: int = 800, B: int = 16, reps: int = 3,
                     device="cuda") -> Dict:
    """This build against another tree's probe source `src`, in one call:
    each mode timed in turns (this, baseline, baseline, this; each turn
    ``time_modes``' best warm call of `reps`), the better of each build's
    two turns kept, and both builds' out and steps for seeds 0 and 7
    required equal. Returns {"modes": [...], "ms", "baseline_ms"}."""
    base = build_baseline(src)
    turns = []
    for lib in (None, base, base, None):
        with (using(lib) if lib is not None else contextlib.nullcontext()):
            turns.append(time_modes(R, B, reps, device))
    rows = []
    for mode in range(N_MODES):
        new = [turns[0][mode], turns[3][mode]]
        old = [turns[1][mode], turns[2][mode]]
        for a in new + old:
            if (a["out_seed0"], a["out_seed7"], a["steps"]) != (
                    new[0]["out_seed0"], new[0]["out_seed7"],
                    new[0]["steps"]):
                raise RuntimeError(f"probe mode {mode}: the baseline build "
                                   "and this one disagree")
        ms = min(a["warm_s"] for a in new) * 1e3
        bms = min(a["warm_s"] for a in old) * 1e3
        cells = new[0]["cells"]
        rows.append({"mode": mode, "ms": ms, "baseline_ms": bms,
                     "ms_turns": [a["warm_s"] * 1e3 for a in new],
                     "baseline_ms_turns": [a["warm_s"] * 1e3 for a in old],
                     "ns_per_step": ms * 1e6 / R,
                     "baseline_ns_per_step": bms * 1e6 / R,
                     "ps_per_cell": ms * 1e9 / cells,
                     "baseline_ps_per_cell": bms * 1e9 / cells,
                     "cells": cells, "steps": new[0]["steps"]})
    return {"R": R, "B": B, "modes": rows,
            "ms": sum(r["ms"] for r in rows),
            "baseline_ms": sum(r["baseline_ms"] for r in rows)}


def print_table(rows: List[Dict]) -> None:
    prev = 0.0
    for r in rows:
        folded = (" [FOLDED? output ignores seed — timing is fiction]"
                  if r["out_seed0"] == r["out_seed7"] else "")
        print(f"mode={r['mode']} first={r['first_s']:.2f}s "
              f"warm={r['warm_s']:.4f}s per_node={r['per_node_us']:.3f}us "
              f"step={r['ns_per_step']:.1f}ns cell={r['ps_per_cell']:.2f}ps "
              f"delta={r['per_node_us'] - prev:+.3f}us steps={r['steps']} "
              f"out(seed0)={r['out_seed0']} out(seed7)={r['out_seed7']}"
              f"{folded}")
        prev = r["per_node_us"]


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dp_cost_probe: no CUDA card available; pass "
                         "--device cpu to run the plain versions")
    return dev


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dp_cost_probe",
                                description=__doc__.split("\n")[0])
    p.add_argument("R", type=int, nargs="?", default=800)
    p.add_argument("B", type=int, nargs="?", default=16)
    p.add_argument("reps", type=int, nargs="?", default=3)
    p.add_argument("--gate", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--baseline", help="another tree's csrc/dp_cost_probe.cu,"
                   " timed in the same call")
    args = p.parse_args(argv)
    dev = _device(args.device)
    if args.gate:
        return 0 if gate(device=dev) else 1
    if args.baseline:
        if dev.type != "cuda":
            raise SystemExit("dp_cost_probe: --baseline needs the card")
        res = compare_baseline(args.baseline, args.R, args.B, args.reps, dev)
        for r in res["modes"]:
            print(json.dumps(r))
        print(json.dumps({"R": res["R"], "B": res["B"], "ms": res["ms"],
                          "baseline_ms": res["baseline_ms"],
                          "device": torch.cuda.get_device_name(dev)}))
        return 0
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu (plain versions)")
    print(f"device={name} R={args.R} B={args.B}")
    print_table(time_modes(args.R, args.B, args.reps, dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
