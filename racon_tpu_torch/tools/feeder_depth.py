"""The consensus feeder's depth on the card: one data set polished
sequentially at ``pipeline_depth`` 1 and 2, in turns.

    python -m racon_tpu_torch.tools.feeder_depth [--rounds 3] [--mbp 1.0]

Simulates the chunked cell (``tools/simulate.py``: 1.0 Mbp, 30x, seed
11, four contigs), polishes it once to warm the kernels, then
``2 x rounds`` times with ``-w 500 -m 5 -x -4 -g -8`` and the default POA
kernel, at depths 1, 2, 2, 1, 1, 2, ... (each pair of rounds in ABBA
order, so a drift of the host's speed weighs on both depths alike).
Prints one JSON line a polish (depth, wall, consensus seconds, the
feeder's pack and kernel wall), then one with each depth's median and
the differences (depth 2 less depth 1) of consensus seconds within each
pair of neighbouring polishes, then the card's name and power limit.
Every FASTA must equal the first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time

import torch

from .. import TorchPolisher
from . import simulate

KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)


def _polish(d, depth):
    p = TorchPolisher(d["reads"], d["overlaps"], d["draft"], device="cuda",
                      pipeline_depth=depth, **KW)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    wall = time.perf_counter() - t0
    co = p.stats["consensus"]
    return out, {"depth": depth, "wall_s": wall,
                 "consensus_s": p.stats["consensus_s"],
                 "pack_wall_s": co["pack_wall_s"],
                 "kernel_wall_s": co["kernel_wall_s"],
                 "batches": co["batches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mbp", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("feeder_depth: needs a CUDA card")
    with tempfile.TemporaryDirectory(prefix="feeder_depth_") as tmp:
        d = simulate.generate(tmp, mbp=args.mbp, coverage=30, seed=11,
                              contigs=4)
        want, _ = _polish(d, 2)
        order = [(1, 2, 2, 1)[i % 4] for i in range(2 * args.rounds)]
        runs = []
        for depth in order:
            out, line = _polish(d, depth)
            if out != want:
                raise SystemExit(f"feeder_depth: the FASTA at depth {depth} "
                                 "differs")
            runs.append(line)
            print(json.dumps(line), flush=True)
    pairs = [runs[i + 1]["consensus_s"] - runs[i]["consensus_s"]
             if runs[i]["depth"] == 1 else
             runs[i]["consensus_s"] - runs[i + 1]["consensus_s"]
             for i in range(0, len(runs) - 1, 2)]
    print(json.dumps({
        "median_consensus_s": {
            str(k): statistics.median(r["consensus_s"] for r in runs
                                      if r["depth"] == k) for k in (1, 2)},
        "median_kernel_wall_s": {
            str(k): statistics.median(r["kernel_wall_s"] for r in runs
                                      if r["depth"] == k) for k in (1, 2)},
        "depth2_less_depth1_consensus_s": pairs}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
