"""Multi-device scaling sweep: windows/s of the default (ls) POA kernel
dispatched through the partitioner at 1, 2 and 4 stripes.

    python -m racon_tpu_torch.tools.multichip [--counts 1,2,4]
        [--repeats 5] [--out PATH]
    python -m racon_tpu_torch.tools.multichip --device cpu --windows 6 \\
        --window 60 --depth 8 --repeats 1        # plain versions, tiny

A port of the JAX package's racon_tpu/tools/multichip.py. Each stripe
count n runs on n real cards where there are that many, and otherwise on
a virtual stripe of n streams of cuda:0 (``["cuda:0"] * n``); each entry
says which (``virtual``). The batch is a main-cell one: ``--windows``
windows of about ``--window`` bases at the main cell's -w 500 geometry
and depth bucket (``tools.batches.poa_batch``, ``--depth`` layers at
most). For each count the batch is launched once single (the reference
outputs), once striped to build and warm, then ``--repeats`` times
striped and timed, each waited for and gathered on the host, so that
windows/s includes the copies both ways.

The sweep runs in this process: torch has no one-way backend
initialisation, so every count can run in one process (the JAX sweep
needs a process a count). The JSON keeps the JAX keys: ``n_devices``
(the cards visible), ``rc``, ``ok`` (every count's outputs equal the
single launch's bit for bit), ``skipped``, ``tail`` (a line a count) and
``scaling`` (one entry a count: its devices, rows a stripe, the timed
wall, windows/s and the ``shard.*`` counters of its timed launches).
``--device cpu`` runs the plain versions, for the CPU tests: its
windows/s are the host's, never a card's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

DEFAULT_COUNTS = (1, 2, 4)
MAIN = dict(window_length=500, match=5, mismatch=-4, gap=-8)


def stripe_devices(n: int, device: str):
    """(devices, virtual): n real cards where there are that many, else n
    streams of cuda:0; n entries of "cpu" on the CPU."""
    if device == "cpu":
        return ["cpu"] * n, n > 1
    if torch.cuda.device_count() >= n:
        return [f"cuda:{i}" for i in range(n)], False
    return ["cuda:0"] * n, True


def main_batch(windows: int, window: int, depth: int, seed: int = 7):
    """(cfg, packed): a batch of `windows` windows of about `window` bases
    (2..depth layers, ONT-like error) at the main cell's geometry and the
    depth bucket that holds `depth` layers."""
    from ..ops import poa_driver
    from . import batches

    bucket = next(b for b in poa_driver.DEPTH_BUCKETS if depth <= b)
    cfg = poa_driver.make_config(MAIN["window_length"], bucket,
                                 MAIN["match"], MAIN["mismatch"],
                                 MAIN["gap"])
    packed = batches.poa_batch(cfg, windows, seed, window,
                               layers=(max(2, depth * 3 // 4), depth))
    return cfg, packed[:9]


def measure(cfg, packed, n: int, device: str, repeats: int, want) -> dict:
    """One stripe count: the batch through a Partitioner over n devices,
    against the single launch's outputs `want`."""
    from .. import obs
    from ..ops import poa_cuda
    from ..parallel.partitioner import Partitioner

    devs, virtual = stripe_devices(n, device)
    part = Partitioner(devs)
    rows = len(packed[0])

    def launch(*ins):
        outs = poa_cuda.poa_consensus(cfg, *ins)
        return outs[:4]

    def once():
        return part.gather(part.stripe(launch, packed))

    t0 = time.perf_counter()
    got = once()                                 # the build and warm-up
    first_s = time.perf_counter() - t0
    obs.reset()
    obs.configure(metrics=True)
    t0 = time.perf_counter()
    for _ in range(repeats):
        got = once()
    wall = time.perf_counter() - t0
    counters = {k: v for k, v in
                ((obs.snapshot() or {}).get("counters") or {}).items()
                if k.startswith("shard.")}
    obs.reset()
    same = all(np.array_equal(a, b) for a, b in zip(got, want))
    return {"stripes": n, "devices": devs, "virtual": virtual,
            "batch": rows, "rows_per_stripe": -(-rows // n),
            "repeats": repeats, "first_s": first_s, "wall_s": wall,
            "windows_per_s": rows * repeats / wall if wall > 0 else None,
            "failed_windows": int(np.asarray(got[3]).sum()),
            "counters": counters, "ok": same}


def sweep(counts=DEFAULT_COUNTS, repeats: int = 5, device: str = "cuda",
          windows: int = 256, window: int = 500, depth: int = 32) -> dict:
    """The sweep's JSON document (module note)."""
    from ..ops import poa_cuda

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the multichip sweep runs on a CUDA card and "
                           "none is available; pass --device cpu to run "
                           "the plain versions")
    cfg, packed = main_batch(windows, window, depth)
    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    ins = [torch.from_numpy(a).to(dev) for a in packed]
    want = tuple(t.cpu().numpy() for t in poa_cuda.poa_consensus(cfg,
                                                                 *ins)[:4])
    scaling, tail = {}, []
    for n in counts:
        e = measure(cfg, packed, n, device, repeats, want)
        scaling[str(n)] = e
        tail.append(f"{n} stripe(s) on {','.join(e['devices'])}: "
                    f"{e['windows_per_s']:.1f} windows/s, "
                    f"{'ok' if e['ok'] else 'OUTPUTS DIFFER'}")
    ok = all(e["ok"] for e in scaling.values())
    return {"n_devices": torch.cuda.device_count() if device == "cuda"
            else 1, "device": device,
            "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                     else "cpu"),
            "rc": 0 if ok else 1, "ok": ok, "skipped": False,
            "tail": "\n".join(tail), "geometry": {
                "max_nodes": cfg.max_nodes, "max_len": cfg.max_len,
                "depth": cfg.depth, "windows": windows, "window": window},
            "scaling": scaling}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch.tools.multichip",
        description="windows/s of the ls POA kernel striped over 1, 2 and "
        "4 devices (real cards, or streams of cuda:0)")
    p.add_argument("--counts", default=",".join(map(str, DEFAULT_COUNTS)),
                   help="stripe counts (default 1,2,4)")
    p.add_argument("--repeats", type=int, default=5,
                   help="timed striped launches a count (default 5)")
    p.add_argument("--windows", type=int, default=256,
                   help="windows a batch (default 256, the polish's "
                   "batch_windows)")
    p.add_argument("--window", type=int, default=500,
                   help="bases a window, about (default 500)")
    p.add_argument("--depth", type=int, default=32,
                   help="layers a window, at most (default 32: the main "
                   "cell's bucket)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default), or cpu for the plain versions")
    p.add_argument("--out", metavar="PATH", default=None,
                   help="also write the JSON here")
    args = p.parse_args(argv)
    counts = sorted({int(c) for c in args.counts.split(",") if c.strip()})
    doc = sweep(counts, max(1, args.repeats), args.device, args.windows,
                args.window, args.depth)
    blob = json.dumps(doc, indent=2, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob)
    print(blob, end="")
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
