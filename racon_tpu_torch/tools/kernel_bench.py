"""Time one POA kernel launch at production geometry on the card.

    python -m racon_tpu_torch.tools.kernel_bench [batch] [depth] [iters]
        [--poa-kernel v2|ls] [--device cuda|cpu]

The JAX package's micro-benchmark (racon_tpu/tools/kernel_bench.py) for
the port's POA kernels: `batch` synthetic ONT-like windows (a 500-base
backbone and `depth` layers at about 11% error, substitutions,
insertions and deletions alike, which grows the graph as real reads do;
``make_batch`` and ``mutate`` are the JAX tool's, so a seed gives the
same arrays) in the -w 500 geometry (poa_driver.make_config), run
through the v2 kernel (the one the JAX tool times) or, with
``--poa-kernel ls``, the default kernel of the polish.

It prints one line: the first call's seconds (the kernel library's load
included), the best of `iters` warm calls (CUDA events on the card),
ms a window, the windows the kernel failed, the most graph nodes a
window used, the card's name and power limit as nvidia-smi gives them,
and the launch's bound from the cost model's count (obs/costmodel.py:
the DP cells the launch needed times POA_OPS_PER_CELL over the card's
INT32 peak, against the bytes of its tensors over its HBM rate; the
larger) and the warm time over it. Without a card it raises;
``--device cpu`` runs the plain PyTorch version, whose times say nothing
of the card (no time over the bound is printed there).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

W = 500


def make_batch(cfg, B, rng, err=0.11):
    """B windows: a backbone mutated from a random 500-base truth, and
    cfg.depth full-span layers mutated from it, weights 1..29 (the JAX
    tool's arrays, draw for draw)."""
    bb = np.zeros((B, cfg.max_backbone), dtype=np.uint8)
    bbw = np.zeros((B, cfg.max_backbone), dtype=np.int32)
    bb_len = np.zeros(B, dtype=np.int32)
    n_layers = np.zeros(B, dtype=np.int32)
    seqs = np.zeros((B, cfg.depth, cfg.max_len), dtype=np.uint8)
    ws = np.zeros((B, cfg.depth, cfg.max_len), dtype=np.int32)
    lens = np.zeros((B, cfg.depth), dtype=np.int32)
    begins = np.zeros((B, cfg.depth), dtype=np.int32)
    ends = np.zeros((B, cfg.depth), dtype=np.int32)

    for b in range(B):
        truth = rng.integers(0, 4, W).astype(np.uint8)
        draft = mutate(truth, err, rng)[:min(cfg.max_backbone, W)]
        bb[b, :len(draft)] = draft
        bb_len[b] = len(draft)
        n_layers[b] = cfg.depth
        for li in range(cfg.depth):
            layer = mutate(truth, err, rng)[:cfg.max_len]
            seqs[b, li, :len(layer)] = layer
            ws[b, li, :len(layer)] = rng.integers(1, 30, len(layer))
            lens[b, li] = len(layer)
            begins[b, li] = 0
            ends[b, li] = len(draft) - 1
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends)


def mutate(seq, rate, rng):
    """Each base substituted, deleted, or followed by an inserted base,
    each at rate / 3."""
    r = rng.random(len(seq))
    out = []
    for i, c in enumerate(seq):
        if r[i] < rate / 3:
            out.append(rng.integers(0, 4))          # substitution
        elif r[i] < 2 * rate / 3:
            pass                                    # deletion
        elif r[i] < rate:
            out.append(c)
            out.append(rng.integers(0, 4))          # insertion
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def run(B: int = 64, depth: int = 32, iters: int = 3, poa_kernel="v2",
        device: str = "cuda", seed: int = 0) -> dict:
    """One kernel_bench measurement (module note): the numbers, and the
    launch's inputs and outputs (``inputs`` and ``outputs``, numpy) for a
    caller that holds them against the plain version."""
    import torch

    from ..obs import costmodel
    from ..ops import poa, poa_driver

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_bench: no CUDA card (--device cpu runs "
                           "the plain version)")
    cfg = poa_driver.make_config(W, depth, 5, -4, -8)
    kernel = poa_driver.kernel_for(poa_kernel)
    packed = make_batch(cfg, B, np.random.default_rng(seed))
    ins = poa.batch_to_tensors(packed, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    out = kernel(cfg, *ins)
    sync()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(iters):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = kernel(cfg, *ins)
            b.record()
            sync()
            times.append(a.elapsed_time(b) / 1e3)
        else:
            t0 = time.perf_counter()
            out = kernel(cfg, *ins)
            times.append(time.perf_counter() - t0)
    st = {}
    kernel(cfg, *ins, stats=st)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *out))
    t_ops = st["cells"] * costmodel.POA_OPS_PER_CELL / costmodel.INT32_OPS_S
    t_bytes = n_bytes / costmodel.HBM_BYTES_S
    best = min(times)
    outs = [t.cpu().numpy() for t in out]
    return {"poa_kernel": poa_kernel, "device": str(dev), "B": B,
            "depth": depth, "iters": iters, "first_s": first_s,
            "warm_ms": best * 1e3, "per_window_ms": best / B * 1e3,
            "failed": int(outs[3].sum()), "max_nodes_used": int(
                outs[4].max()), "cells": st["cells"],
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "over_bound": (best / max(t_ops, t_bytes)
                           if dev.type == "cuda" else None),
            "inputs": packed, "outputs": outs, "cfg": cfg}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m racon_tpu_torch.tools.kernel_bench",
        description="time one POA kernel launch at -w 500 geometry")
    ap.add_argument("batch", type=int, nargs="?", default=64)
    ap.add_argument("depth", type=int, nargs="?", default=32)
    ap.add_argument("iters", type=int, nargs="?", default=3)
    ap.add_argument("--poa-kernel", choices=("v2", "ls"), default="v2")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    r = run(args.batch, args.depth, args.iters, args.poa_kernel,
            args.device)
    line = {k: v for k, v in r.items()
            if k not in ("inputs", "outputs", "cfg")}
    line["card"] = nvidia_smi() if args.device == "cuda" else None
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
