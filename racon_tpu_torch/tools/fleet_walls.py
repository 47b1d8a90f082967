"""Where a fleet polish's wall goes on the card: ``cli distrib`` beside
the sequential polish of the same cell, journaled and not.

    python -m racon_tpu_torch.tools.fleet_walls [--rounds 2] [--mbp 1.0]
        [--workers 2 4] [--device cpu]

Builds the CUDA kernels, simulates the chunked cell (``tools/simulate.py``:
1.0 Mbp, 30x, seed 11, four contigs) and polishes it sequentially in this
process with ``-w 500 -m 5 -x -4 -g -8``, plain and then journaled with
fsync (a fleet's chunks always journal). Then ``rounds`` times through
``python -m racon_tpu_torch.cli distrib --chunks 4`` at each of the
``--workers`` counts, the order reversed every other round (ABBA for two
counts). Prints one JSON line a polish (for a distrib run its wall, the
coordinator's start-up and ``run()``, each worker's start-up, the
chunks' walls and their ledger stage seconds summed, from the
coordinator's ``result.json``), then each count's median wall, then the
card's name and power limit. Every FASTA must equal the sequential one.
Needs one CUDA card; ``--device cpu`` rehearses the script on the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch

from .. import TorchPolisher
from ..serve.scheduler import child_env
from . import simulate

KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)


def _sequential(d, device, journal=None):
    p = TorchPolisher(d["reads"], d["overlaps"], d["draft"], device=device,
                      journal_path=journal, **KW)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    return "".join(f">{n}\n{s}\n" for n, s in out), \
        time.perf_counter() - t0


def _distrib(d, device, workers, state):
    out = state + ".fasta"
    cmd = [sys.executable, "-m", "racon_tpu_torch.cli", "distrib",
           "--device", device, "--workers", str(workers), "--chunks", "4",
           "--state-dir", state, "-o", out,
           "-w", str(KW["window_length"]), "-m", str(KW["match"]),
           "-x", str(KW["mismatch"]), "-g", str(KW["gap"]),
           d["reads"], d["overlaps"], d["draft"]]
    env = child_env()
    env.pop("RACON_TORCH_FAULT", None)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, text=True, timeout=1800)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise SystemExit(f"fleet_walls: distrib exited {r.returncode}: "
                         f"{r.stderr[-2000:]}")
    with open(os.path.join(state, "result.json")) as f:
        res = json.load(f)
    with open(out) as f:
        text = f.read()
    stages = {}
    for row in res["chunk_stats"]:
        for k, v in (row.get("stage_s") or {}).items():
            stages[k] = round(stages.get(k, 0.0) + v, 4)
    return text, {"workers": workers, "wall_s": wall,
                  "coordinator_startup_s": res["startup_s"],
                  "coordinator_run_s": res["run_s"],
                  "worker_start": res["worker_start"],
                  "chunk_walls": [row.get("wall_s")
                                  for row in res["chunk_stats"]],
                  "stage_s": stages}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--mbp", type=float, default=1.0)
    ap.add_argument("--workers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("fleet_walls: needs a CUDA card")
        from ..ops import cuda_lib

        print(json.dumps({"build_s": cuda_lib.build_all()}), flush=True)
    with tempfile.TemporaryDirectory(prefix="fleet_walls_") as tmp:
        d = simulate.generate(os.path.join(tmp, "data"), mbp=args.mbp,
                              coverage=30, seed=11, contigs=4)
        want, plain_s = _sequential(d, args.device)
        got, journaled_s = _sequential(d, args.device,
                                       os.path.join(tmp, "seq.journal"))
        if got != want:
            raise SystemExit("fleet_walls: the journaled FASTA differs")
        print(json.dumps({"sequential_s": plain_s,
                          "sequential_journaled_s": journaled_s}),
              flush=True)
        if args.device == "cuda":
            torch.cuda.empty_cache()
        order = []
        for r in range(args.rounds):
            order += args.workers if r % 2 == 0 else args.workers[::-1]
        walls = {w: [] for w in args.workers}
        for i, workers in enumerate(order):
            text, line = _distrib(d, args.device, workers,
                                  os.path.join(tmp, f"run{i}"))
            if text != want:
                raise SystemExit(f"fleet_walls: run {i} ({workers} "
                                 "workers) differs from the sequential "
                                 "FASTA")
            walls[workers].append(line["wall_s"])
            print(json.dumps(line), flush=True)
        print(json.dumps({"median_wall_s": {k: statistics.median(v)
                                            for k, v in walls.items()}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True) if args.device == "cuda" else None
    print(smi.stdout.strip() if smi is not None else "cpu rehearsal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
