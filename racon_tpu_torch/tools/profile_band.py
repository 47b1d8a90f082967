"""The v2 POA kernel's banded build on the main cell's banded launches.

    python -m racon_tpu_torch.tools.profile_band [--baseline SRC.cu]

Simulates the main cell of ``chip_smoke.py`` (1.0 Mbp genome, 30x
ONT-like reads, seed 11, ``-w 500 -m 5 -x -4 -g -8``) and polishes it on
the card on the banded path (``band=True``, slack 32) with the v2 POA
kernel, timing each banded launch with CUDA events around the launch call
(the path's device ms) and keeping the largest banded launch (by band
cells) of each depth bucket with band hits and without: the six launches
``chip_smoke.py`` checks. On each it prints one JSON line: the banded
build's ms a launch (mean of three calls after a warm-up), its phases (max
and mean ms over the windows, from the kernel's clock64() counts over the
card's highest SM clock), the flat build's ms on the same inputs (colstep
on), and the banded build's at wband 0 (the flat DP through its rows).

With ``--baseline``, a ``poa_v2.cu`` of another tree with the same C
interface (its ``poa_common.cuh`` beside it) is built into
``_build/baseline/`` and run on the same launches through the same
wrapper: its banded ms with colstep on and off, its phases, whether each
of its six outputs equals this build's on every window, and its path
device ms in a second banded polish of the same cell. Each kernel's
registers, spill and shared bytes come from its occupancy export.

Prints the card's name and power limit last. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from .. import TorchPolisher
from ..ops import cuda_lib, poa_driver, poa_v2_cuda
from . import simulate

KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)
NAME = "poa_consensus_v2_band"


def _smi(query: str, units: str = ",nounits") -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader" + units],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def _ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def _phases(st: dict, windows: int, mhz: float) -> dict:
    return {n: [round(mx / (mhz * 1e3), 3),
                round(sm / windows / (mhz * 1e3), 3)]
            for n, sm, mx in zip(poa_v2_cuda.PHASES, st["phase_cycles"],
                                 st["phase_cycles_max"])}


def _build_baseline(src: str) -> ctypes.CDLL:
    out_dir = os.path.join(cuda_lib.BUILD, "baseline")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "libpoa_v2.so")
    log = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-o", out,
                          os.path.abspath(src)], capture_output=True,
                         text=True)
    if log.returncode:
        raise RuntimeError(f"baseline build failed:\n{log.stdout}"
                           f"{log.stderr}")
    lib = ctypes.CDLL(out)
    cur = poa_v2_cuda._lib()
    for name in ("rt_poa_v2_scratch_words", "rt_poa_v2_launch"):
        getattr(lib, name).restype = getattr(cur, name).restype
        getattr(lib, name).argtypes = getattr(cur, name).argtypes
    return lib


@contextlib.contextmanager
def _swapped(lib):
    """The v2 wrapper calls `lib` (None: this tree's library); the wrapper's
    up-front plan check is skipped, since the baseline's plan export may
    take other arguments (its launch plans for itself; the main cell's
    geometries take no global build)."""
    if lib is None:
        yield
        return
    saved = poa_v2_cuda._LIB, poa_v2_cuda.plan
    poa_v2_cuda._LIB, poa_v2_cuda.plan = lib, lambda cfg, band=False: {
        "global_build": False}
    try:
        yield
    finally:
        poa_v2_cuda._LIB, poa_v2_cuda.plan = saved


def _polish(d, keep: dict):
    """One banded polish of `d` with v2; returns the path's banded-launch
    device ms and launch count. Keeps in `keep` the largest banded launch
    of each (depth, any band hit)."""
    real = poa_driver.poa_consensus_v2

    def recorded(cfg, *args, **kw):
        st = {}
        out = real(cfg, *args, stats=st, **kw)
        if kw.get("wband") is not None:
            key = (cfg.depth, bool(out[5].any()))
            if st["cells"] > keep.get(key, (-1,))[0]:
                keep[key] = (st["cells"], cfg, args, kw["wband"])
        return out

    cuda_lib.LAUNCH_EVENTS = []
    poa_driver.poa_consensus_v2 = recorded
    try:
        p = TorchPolisher(d["reads"], d["overlaps"], d["draft"],
                          device="cuda", poa_kernel="v2", band=True, **KW)
        p.initialize()
        p.polish(True)
        torch.cuda.synchronize()
        evs = [e for e in cuda_lib.LAUNCH_EVENTS if e[0] == NAME]
        return sum(a.elapsed_time(b) for _, a, b in evs), len(evs)
    finally:
        poa_driver.poa_consensus_v2 = real
        cuda_lib.LAUNCH_EVENTS = None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another tree's csrc/poa_v2.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_band: no CUDA card available", file=sys.stderr)
        return 2
    cuda_lib.build_all()
    base = _build_baseline(args.baseline) if args.baseline else None
    mhz = float(_smi("clocks.max.sm"))
    fn = poa_v2_cuda.poa_consensus_v2
    with tempfile.TemporaryDirectory(prefix="racon_band_") as tmp:
        d = simulate.generate(os.path.join(tmp, "main"), mbp=1.0,
                              coverage=30, seed=11)
        keep = {}
        path_ms, n = _polish(d, keep)
        line = {"phase": "path", "build": "this", "launches": n,
                "device_ms": path_ms}
        if base is not None:
            with _swapped(base):
                line["baseline_device_ms"], _ = _polish(d, {})
        print(json.dumps(line), flush=True)
    cfg0 = next(iter(keep.values()))[1]
    for build, lib in (("this", None), ("baseline", base)):
        if build == "baseline" and lib is None:
            continue
        with _swapped(lib):
            lib_ = poa_v2_cuda._lib()
            occ = cuda_lib.occupancy(lib_.rt_poa_v2_occupancy,
                                     (cfg0.max_nodes, cfg0.max_len, 1),
                                     cuda_lib.POA_OCCUPANCY, "v2 banded")
        print(json.dumps({"phase": "occupancy", "build": build, **occ}),
              flush=True)
    tot = {}
    for (depth, hit), (cells, cfg, dev_in, wband) in sorted(keep.items()):
        st = {}
        got = fn(cfg, *dev_in, wband=wband, stats=st)
        line = {"phase": "launch", "depth": depth, "hits": int(got[5].sum()),
                "windows": dev_in[0].shape[0], "band_cells": cells,
                "ms": _ms(lambda: fn(cfg, *dev_in, wband=wband)),
                "ms_flat_build": _ms(lambda: fn(cfg, *dev_in)),
                "ms_wband0": _ms(lambda: fn(cfg, *dev_in,
                                            wband=torch.zeros_like(wband))),
                "phases": _phases(st, dev_in[0].shape[0], mhz)}
        if base is not None:
            with _swapped(base):
                bst = {}
                want = fn(cfg, *dev_in, wband=wband, stats=bst)
                torch.cuda.synchronize()
                line["equal_to_baseline"] = [bool(torch.equal(a, b))
                                             for a, b in zip(want, got)]
                line["baseline_ms"] = _ms(lambda: fn(cfg, *dev_in,
                                                     wband=wband))
                line["baseline_ms_no_colstep"] = _ms(lambda: fn(
                    cfg, *dev_in, wband=wband, colstep=False))
                line["baseline_phases"] = _phases(bst, dev_in[0].shape[0],
                                                  mhz)
        for k in ("ms", "ms_flat_build", "ms_wband0", "baseline_ms",
                  "baseline_ms_no_colstep"):
            if k in line:
                tot[k] = tot.get(k, 0.0) + line[k]
        print(json.dumps(line), flush=True)
    print(json.dumps({"phase": "six_launches", **tot}), flush=True)
    print(_smi("name,power.limit", ""), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
