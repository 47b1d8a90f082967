"""Where the time goes in one polish on the card.

    python -m racon_tpu_torch.tools.profile_main [--mbp 1.0] [--coverage 30]

Simulates a dataset (``tools/simulate.py``, seed 11), then polishes it on
the card twice with ``-w 500 -m 5 -x -4 -g -8``:

1. under ``torch.profiler`` (host and device activity): each phase's wall
   time from ``TorchPolisher.stats``, the device time of each kernel
   (POA, edge rows, base case) and of the copies, and the device busy
   share of the whole polish and of the align and consensus phases;
2. under ``cProfile``: the host functions with the most time of their
   own, to name the host bottleneck (cProfile slows Python calls, so only
   the ranking means anything, not the seconds).

Prints one JSON line per pass, then the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

import torch

from .. import TorchPolisher
from ..ops import cuda_lib
from . import simulate

KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)


def _polish(d):
    p = TorchPolisher(d["reads"], d["overlaps"], d["draft"], device="cuda",
                      **KW)
    t0 = time.perf_counter()
    p.initialize()
    p.polish(True)
    return p.stats, time.perf_counter() - t0


def _kernel_group(name: str) -> str:
    for key, group in (("poa_kernel", "poa_consensus"),
                       ("edge_kernel", "hirschberg_edge"),
                       ("base_kernel", "hirschberg_base"),
                       ("Memcpy", "memcpy"), ("Memset", "memset")):
        if key in name:
            return group
    return "other"


def device_pass(d) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        stats, wall = _polish(d)
    dev_ms: dict = {}
    for ev in prof.key_averages():
        # device activities only: a host op (aten::copy_) also carries
        # the device time of what it launched, which would count twice
        us = ev.self_device_time_total
        if ev.device_type == DeviceType.CUDA and us:
            g = _kernel_group(ev.key)
            dev_ms[g] = dev_ms.get(g, 0.0) + us / 1e3
    align_dev = dev_ms.get("hirschberg_edge", 0) + \
        dev_ms.get("hirschberg_base", 0)
    cons_dev = dev_ms.get("poa_consensus", 0)
    return {"pass": "device", "wall_s": wall,
            "phase_s": {k[:-2]: v for k, v in stats.items()
                        if k.endswith("_s")},
            "device_ms": dev_ms, "launches": dict(cuda_lib.LAUNCHES),
            "device_busy": sum(dev_ms.values()) / 1e3 / wall,
            "align_busy": align_dev / 1e3 / stats["align_s"],
            "consensus_busy": cons_dev / 1e3 / stats["consensus_s"],
            "align_jobs": {k: stats["align"][k] for k in ("device", "host")},
            "windows": {k: stats["consensus"][k]
                        for k in ("device", "host_fallback", "backbone")}}


def host_pass(d, top: int = 12) -> dict:
    pr = cProfile.Profile()
    pr.enable()
    stats, wall = _polish(d)
    pr.disable()
    st = pstats.Stats(pr)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    return {"pass": "host", "wall_s": wall,
            "phase_s": {k[:-2]: v for k, v in stats.items()
                        if k.endswith("_s")},
            "self_s": [{"fn": f"{os.path.basename(f)}:{ln}:{fn}",
                        "calls": v[1], "self_s": v[2], "cum_s": v[3]}
                       for (f, ln, fn), v in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="racon-tpu-torch-profile")
    ap.add_argument("--mbp", type=float, default=1.0)
    ap.add_argument("--coverage", type=float, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: needs a CUDA card", file=sys.stderr)
        return 2
    cuda_lib.build_all()
    with tempfile.TemporaryDirectory(prefix="racon_profile_") as tmp:
        d = simulate.generate(tmp, mbp=args.mbp, coverage=args.coverage,
                              seed=11)
        _polish(d)  # warm-up: library loads, allocator, caches
        print(json.dumps(device_pass(d)), flush=True)
        print(json.dumps(host_pass(d)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
