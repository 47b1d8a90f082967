#!/usr/bin/env python3
"""Smoke run of racon_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
then, each phase printing one JSON line:

* main: polishes a simulated 1.0 Mbp genome (30x ONT-like reads, PAF
  overlaps, -w 500 -m 5 -x -4 -g -8) on the card, times every kernel
  launch with CUDA events beside its bound from the DP cells it ran, and
  checks that polishing lowers the edit distance to the truth;
* kernel_check: runs each kernel again on the inputs of its largest
  launches in the main run (one per POA depth bucket, per edge band and
  direction, per base-case band), holds each whole batch against the
  plain PyTorch version (tolerance 0: all outputs are integers) and
  times it;
* parity: the card and the CPU polish a small PAF set to the same bytes.

Then a line with every kernel's numbers, the card's name and power limit
as nvidia-smi gives them, and last {"ok": true, "device": {...}}. Any
failure raises and exits non-zero before the last line. Needs one CUDA
card; fails without one.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks: HBM3 bytes/s, and 32-bit integer ops/s (64 INT32 lanes
# per SM x 132 SMs x 1.98 GHz boost, Hopper architecture white paper).
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# Integer ops per DP cell that any implementation of the recurrence does.
POA_OPS_PER_CELL = 6    # diag add, gap add, max, -j*g, running max, +j*g
EDGE_OPS_PER_CELL = 6   # mismatch add, gap add, min, -lane, running min, +lane
BASE_OPS_PER_CELL = 7   # the edge cell plus the move decision

MAIN = dict(window_length=500, match=5, mismatch=-4, gap=-8)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(want, got) -> int:
    return max(int((w.cpu().long() - g.cpu().long()).abs().max())
               if w.numel() else 0 for w, g in zip(want, got))


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / INT32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class MainPathRecorder:
    """Times every kernel launch of the main path and keeps a real cohort.

    Inside ``with`` it replaces the kernel wrappers where the main path
    looks them up (``align_cuda.edge_rows``, ``align_cuda.base_case``,
    ``poa_driver.poa_consensus``) by thin wrappers that call the real
    ones between two CUDA events, count the launch's DP cells and bytes,
    and keep the inputs of the largest launch (by DP cells) of each
    kernel and geometry: POA per depth bucket, the edge kernel per band
    and direction, the base case per band. The real wrappers still
    count their launches. The POA launch counts its cells on the card
    (``stats``), which adds one reduction over the batch to its time."""

    def __init__(self, torch, ac, poa_driver):
        self.torch, self.ac, self.pd = torch, ac, poa_driver
        self.launches = []     # (name, [start, end event], ops, bytes)
        self.largest = {}      # (kernel, geometry) -> (cells, inputs)

    def __enter__(self):
        self.saved = (self.ac.edge_rows, self.ac.base_case,
                      self.pd.poa_consensus)
        edge, base, poa = self.saved

        def edge_rows(scal, q, t, K, backward):
            return self._call("hirschberg_edge", (K, backward),
                              EDGE_OPS_PER_CELL,
                              lambda: edge(scal, q, t, K, backward),
                              lambda out: int(scal[:, 0].sum()) * K,
                              (scal, q, t), (scal, q, t, K, backward))

        def base_case(scal, q, t, K):
            return self._call("hirschberg_base", (K,), BASE_OPS_PER_CELL,
                              lambda: base(scal, q, t, K),
                              lambda out: int(scal[:, 0].sum()) * K,
                              (scal, q, t), (scal, q, t, K))

        def poa_consensus(cfg, *args):
            st = {}
            return self._call("poa_consensus", (cfg.depth,),
                              POA_OPS_PER_CELL,
                              lambda: poa(cfg, *args, stats=st),
                              lambda out: st["cells"], args, (cfg, args))

        self.ac.edge_rows, self.ac.base_case = edge_rows, base_case
        self.pd.poa_consensus = poa_consensus
        return self

    def __exit__(self, *exc):
        self.ac.edge_rows, self.ac.base_case, self.pd.poa_consensus = \
            self.saved
        return False

    def _call(self, name, geom, ops_per_cell, fn, cells_of, ins, keep):
        from racon_tpu_torch.ops import cuda_lib

        ev = [self.torch.cuda.Event(enable_timing=True) for _ in range(2)]
        n0 = cuda_lib.LAUNCHES[name]
        ev[0].record()
        out = fn()
        ev[1].record()
        if cuda_lib.LAUNCHES[name] == n0:       # empty batch: no launch
            return out
        cells = cells_of(out)
        outs = out if isinstance(out, tuple) else (out,)
        self.launches.append((name, ev, ops_per_cell * cells,
                              nbytes(ins) + nbytes(outs)))
        if cells > self.largest.get((name, geom), (-1, None))[0]:
            self.largest[(name, geom)] = (cells, keep)
        return out

    def summary(self):
        """Per kernel: launches, device ms, DP-cell ops, and the bound
        summed over the launches."""
        self.torch.cuda.synchronize()
        res = {}
        for name, ev, ops, nb in self.launches:
            r = res.setdefault(name, {"launches": 0, "device_ms": 0.0,
                                      "ops": 0, "bytes": 0, "bound_ms": 0.0})
            r["launches"] += 1
            r["device_ms"] += ev[0].elapsed_time(ev[1])
            r["ops"] += ops
            r["bytes"] += nb
            r["bound_ms"] += bound(nb, ops)[0]
        for r in res.values():
            r["ms_per_launch"] = r["device_ms"] / r["launches"]
            r["bound_ms_per_launch"] = r["bound_ms"] / r["launches"]
            r["over_bound"] = r["device_ms"] / r["bound_ms"]
        return res

    def inputs(self, name):
        """[(cells, inputs)] of the kept launches of one kernel."""
        return [v for k, v in sorted(self.largest.items(),
                                     key=lambda kv: kv[0]) if k[0] == name]


def _plain_poa_part(cfg, arrays):
    """One process's share of the plain POA run: numpy in, numpy out."""
    import torch

    from racon_tpu_torch.ops import poa

    torch.set_num_threads(1)
    stats = {"cells": 0}
    outs = poa.poa_batch_plain(cfg, *(torch.from_numpy(a) for a in arrays),
                               stats=stats)
    return [o.numpy() for o in outs], stats["cells"]


def plain_poa_parallel(batches, procs: int):
    """The plain POA version on the host for [(cfg, tensors)], each
    batch's windows split over `procs` processes (the plain version loops
    over windows in Python). Returns [(outputs, cells)]."""
    import torch

    jobs, spans = [], []
    for cfg, dev_in in batches:
        host = [t.cpu().numpy() for t in dev_in]
        cuts = np.linspace(0, host[0].shape[0], procs + 1).astype(int)
        spans.append((len(jobs), procs))
        jobs += [(cfg, [a[lo:hi] for a in host])
                 for lo, hi in zip(cuts[:-1], cuts[1:])]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(procs, mp_context=ctx) as ex:
        parts = list(ex.map(_plain_poa_part, *zip(*jobs)))
    res = []
    for first, n in spans:
        mine = parts[first:first + n]
        outs = [np.concatenate([p[0][k] for p in mine]) for k in range(5)]
        res.append(([torch.from_numpy(o) for o in outs],
                    sum(p[1] for p in mine)))
    return res


class Totals:
    """A kernel's check numbers summed over its checked launches."""

    def __init__(self):
        self.err = self.bytes = self.ops = 0
        self.ms = self.plain_ms = 0.0

    def add(self, line, n_bytes, n_ops):
        self.err = max(self.err, line["max_abs_err"])
        self.ms += line["ms"]
        self.plain_ms += line["plain_ms"]
        self.bytes += n_bytes
        self.ops += n_ops

    def row(self):
        b_ms, b_by = bound(self.bytes, self.ops)
        return {"max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def check_poa(torch, poa_cuda, rec):
    """The main path's largest POA launch of each depth bucket, every
    window held against the plain version (on the host, in parallel
    processes; its time is that of all buckets together)."""
    kept = rec.inputs("poa_consensus")
    procs = max(1, min(8, os.cpu_count() or 1))
    t0 = time.perf_counter()
    plain = plain_poa_parallel([inp for _, inp in kept], procs)
    plain_ms = (time.perf_counter() - t0) * 1e3
    tot = Totals()
    for (cells_main, (cfg, dev_in)), (want, cells) in zip(kept, plain):
        kst = {}
        got = poa_cuda.poa_consensus(cfg, *dev_in, stats=kst)
        torch.cuda.synchronize()
        err = max_abs_err(want, got)
        require(err == 0, f"POA kernel (depth {cfg.depth}) differs from "
                f"its plain version by {err}")
        require(kst["cells"] == cells == cells_main,
                f"POA DP cells: kernel {kst['cells']}, plain {cells}, "
                f"main path {cells_main}")
        ms = cuda_ms(torch, lambda: poa_cuda.poa_consensus(cfg, *dev_in), 3)
        n_bytes = nbytes(dev_in) + nbytes(got)
        n_ops = POA_OPS_PER_CELL * cells
        b_ms, b_by = bound(n_bytes, n_ops)
        line = {"phase": "kernel_check", "kernel": "poa_consensus",
                "input": "largest launch of its depth bucket in the main "
                "run", "windows": dev_in[0].shape[0], "depth": cfg.depth,
                "layers_mean": float(dev_in[3].float().mean()),
                "max_nodes": cfg.max_nodes, "max_len": cfg.max_len,
                "dp_cells": cells, "failed": int(got[3].sum()),
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms / len(kept),
                "plain_on": f"host, {procs} processes (all buckets' time "
                "split evenly)", "bound_ms": b_ms, "bound_by": b_by}
        emit(line)
        tot.add(line, n_bytes, n_ops)
    return tot.row()


def check_edge(torch, ac, rec):
    """The main path's largest edge launch of each band and direction,
    the whole batch held against the plain version on the card."""
    tot = Totals()
    for cells, (scal, q, t, K, backward) in rec.inputs("hirschberg_edge"):
        got = ac.edge_rows(scal, q, t, K, backward)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ac.edge_rows_plain(scal, q, t, K, backward)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err([want], [got])
        require(err == 0, f"edge kernel (K={K}, backward={backward}) "
                f"differs from its plain version by {err}")
        ms = cuda_ms(torch, lambda: ac.edge_rows(scal, q, t, K, backward),
                     10)
        n_bytes = nbytes((scal, q, t, got))
        n_ops = EDGE_OPS_PER_CELL * cells
        b_ms, b_by = bound(n_bytes, n_ops)
        R = scal[:, 0].cpu()
        line = {"phase": "kernel_check", "kernel": "hirschberg_edge",
                "input": "largest launch of its band and direction in the "
                "main run", "K": K, "rcap": q.shape[1],
                "backward": backward, "tasks": len(R),
                "rows_mean": float(R.float().mean()), "dp_cells": cells,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "plain_on": "cuda", "bound_ms": b_ms, "bound_by": b_by}
        emit(line)
        tot.add(line, n_bytes, n_ops)
    return tot.row()


def check_base(torch, ac, rec):
    """The main path's largest base-case launch of each band, the whole
    batch held against the plain version (DP on the card, traceback on
    the host)."""
    tot = Totals()
    for cells, (scal, q, t, K) in rec.inputs("hirschberg_base"):
        got = ac.base_case(scal, q, t, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ac.base_plain(scal, q, t, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(want, got)
        require(err == 0, f"base kernel (K={K}) differs from its plain "
                f"version by {err}")
        ms = cuda_ms(torch, lambda: ac.base_case(scal, q, t, K), 10)
        n_bytes = nbytes((scal, q, t)) + nbytes(got)
        n_ops = BASE_OPS_PER_CELL * cells
        b_ms, b_by = bound(n_bytes, n_ops)
        line = {"phase": "kernel_check", "kernel": "hirschberg_base",
                "input": "largest launch of its band in the main run",
                "K": K, "tasks": scal.shape[0], "dp_cells": cells,
                "in_band": int(want[2].sum()), "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                "plain_on": "cuda + host traceback", "bound_ms": b_ms,
                "bound_by": b_by}
        emit(line)
        tot.add(line, n_bytes, n_ops)
    return tot.row()


def read_fasta(path: str) -> bytes:
    with open(path) as f:
        return "".join(ln.strip() for ln in f
                       if not ln.startswith(">")).encode()


def polish(racon_tpu_torch, d, device):
    p = racon_tpu_torch.TorchPolisher(d["reads"], d["overlaps"], d["draft"],
                                      device=device, **MAIN)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    return out, p.stats, time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import racon_tpu_torch
    from racon_tpu_torch import native
    from racon_tpu_torch.ops import align_cuda as ac
    from racon_tpu_torch.ops import cuda_lib, poa_cuda, poa_driver
    from racon_tpu_torch.tools import simulate

    smi = nvidia_smi()
    t0 = time.perf_counter()
    native.ensure_built()
    native_s = time.perf_counter() - t0
    kernels_s = cuda_lib.build_all()
    emit({"phase": "build", "native_s": native_s, "cuda_kernels_s": kernels_s,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    with tempfile.TemporaryDirectory(prefix="racon_smoke_") as tmp:
        # main: 1.0 Mbp, 30x ONT-like reads, PAF overlaps
        t0 = time.perf_counter()
        d = simulate.generate(os.path.join(tmp, "main"), mbp=1.0,
                              coverage=30, seed=11)
        gen_s = time.perf_counter() - t0
        rec = MainPathRecorder(torch, ac, poa_driver)
        cuda_lib.reset_launches()
        with rec:
            out, st, wall = polish(racon_tpu_torch, d, "cuda")
        launches = dict(cuda_lib.LAUNCHES)
        on_main = rec.summary()
        genome = read_fasta(d["genome"])
        draft = read_fasta(d["draft"])
        polished = "".join(s for _, s in out).encode()
        ed_draft = native.edit_distance(draft, genome)
        ed_polished = native.edit_distance(polished, genome)
        al, co = st["align"], st["consensus"]
        emit({"phase": "main", "mbp": 1.0, "coverage": 30,
              "generate_s": gen_s, "wall_s": wall,
              "phase_s": {k[:-2]: v for k, v in st.items()
                          if k.endswith("_s")},
              "align_jobs": {"device": al["device"], "host": al["host"],
                             "host_s": al["host_seconds"]},
              "windows": {"device": co["device"],
                          "host_refailed": co["host_fallback"],
                          "kernel_failed": co["failed"],
                          "backbone": co["backbone"],
                          "layers_dropped": co["layers_dropped"],
                          "batches": co["batches"]},
              "launches": launches, "kernels": on_main,
              "kernel_busy": sum(r["device_ms"] for r in on_main.values())
              / 1e3 / wall, "contigs": len(out),
              "edit_distance": {"draft": ed_draft, "polished": ed_polished}})
        require(al["device"] > 0, "no alignment job was served on the card")
        require(co["device"] > 0, "no window was served on the card")
        for name, n in launches.items():
            require(n > 0, f"kernel {name} was not launched on the main "
                    "path")
        require(ed_polished < ed_draft, "polishing did not lower the edit "
                f"distance ({ed_draft} -> {ed_polished})")

        # each kernel on the main path's largest launches, against its
        # plain version
        checked = {"poa_consensus": check_poa(torch, poa_cuda, rec),
                   "hirschberg_edge": check_edge(torch, ac, rec),
                   "hirschberg_base": check_base(torch, ac, rec)}
        rec.largest.clear()

        # parity: the card and the CPU give the same bytes
        d = simulate.generate(os.path.join(tmp, "parity"), mbp=0.02,
                              seed=11)
        gpu, gstats, g_s = polish(racon_tpu_torch, d, "cuda")
        cpu, cstats, c_s = polish(racon_tpu_torch, d, "cpu")
        require(gpu == cpu, "card and CPU polish the parity set differently")
        emit({"phase": "parity", "mbp": 0.02, "identical": True,
              "cuda_s": g_s, "cpu_s": c_s,
              "align_device": gstats["align"]["device"],
              "windows_device": gstats["consensus"]["device"]})

    src = "racon_tpu_torch/csrc/"
    kernels = [
        dict(name="poa_consensus", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64"),
        dict(name="hirschberg_edge", source=src + "align.cu",
             replaces="racon_tpu/ops/align_pallas.py:112"),
        dict(name="hirschberg_base", source=src + "align.cu",
             replaces="racon_tpu/ops/align_pallas.py:299"),
    ]
    for k in kernels:
        k.update(checked[k["name"]])
        m = on_main[k["name"]]
        k.update(route="cuda", launches=launches[k["name"]], library_ms=None,
                 main_device_ms=m["device_ms"], main_bound_ms=m["bound_ms"])
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
