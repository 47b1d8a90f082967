"""Consensus-phase driver: packs windows into depth-bucketed batches, runs
a POA kernel, trims and installs the results, and re-polishes on the
host every window the kernel flags ``failed``.

A copy of the JAX package's driver (racon_tpu/ops/poa_driver.py) reduced
to one path: no journal, no sanitizer, no band ladder, no sharding, and no
lattice. The kernel is an argument, ``poa_kernel``: "v2"
(ops/poa_v2_cuda.py, the default since it beat ls by more than 10% on
every depth bucket on the card) or "ls" (ops/poa_cuda.py, the JAX
package's default); both compute one function, and neither steps down to
the other. Both keep H in global memory and fit every window class up to
-w 1280 (max_len <= 2047), v2 by planning its shared memory per launch
(poa_v2_cuda.plan), so neither depth nor window class keeps a window off
the card.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from . import poa
from .encoding import decode, encode
from .poa_cuda import poa_consensus
from .poa_v2_cuda import poa_consensus_v2

DEPTH_CAP = 200                    # layers per window, as the reference
DEPTH_BUCKETS = (8, 32, DEPTH_CAP)
NODE_FACTOR = 3                    # max_nodes = 3 x window length
POA_KERNELS = ("ls", "v2")
DEFAULT_POA_KERNEL = "v2"


def window_class(bb_len: int) -> int:
    """Kernel-geometry class for a backbone length: ceil to the 128 grid,
    so short windows run in their own class's geometry."""
    return max(128, (bb_len + 127) // 128 * 128)


def make_config(window_length: int, depth: int, match: int, mismatch: int,
                gap: int) -> poa.PoaConfig:
    def ceil128(x):
        return (x + 127) // 128 * 128

    return poa.PoaConfig(max_nodes=ceil128(NODE_FACTOR * window_length),
                         max_len=ceil128(window_length + window_length // 2),
                         max_backbone=ceil128(window_length), max_edges=12,
                         depth=depth, match=match, mismatch=mismatch,
                         gap=gap)


def tgs_trim(codes: np.ndarray, cov: np.ndarray, n_seqs: int):
    """Low-coverage end trim (reference: src/window.cpp:125-146)."""
    avg = (n_seqs - 1) // 2
    n = len(codes)
    begin = 0
    while begin < n and cov[begin] < avg:
        begin += 1
    end = n - 1
    while end >= 0 and cov[end] < avg:
        end -= 1
    if begin >= end:
        return codes  # chimeric suspicion: keep untrimmed
    return codes[begin:end + 1]


def kernel_for(poa_kernel: str):
    """The POA wrapper for a kernel name, looked up in this module when
    called (so a caller may wrap it here)."""
    if poa_kernel not in POA_KERNELS:
        raise ValueError(f"poa_kernel must be 'ls' or 'v2', got "
                         f"{poa_kernel!r}")
    return poa_consensus if poa_kernel == "ls" else poa_consensus_v2


def run_consensus_phase(pipeline, *, match: int, mismatch: int, gap: int,
                        trim: bool, device="cuda", batch_windows: int = 256,
                        poa_kernel: str = DEFAULT_POA_KERNEL) -> dict:
    """Kernel consensus for every window with at least two layers; the
    backbone for the rest; the host POA for windows the kernel fails.
    `poa_kernel` ("v2", the default, or "ls") picks the kernel.

    Returns {device, host_fallback, backbone, failed, layers_dropped,
    batches, host_seconds}: windows served by the kernel, re-polished on
    the host, passed through as backbone, flagged failed by the kernel,
    layers dropped at admission, kernel batches run, and the wall time of
    the host re-polish."""
    device = torch.device(device)
    kernel_for(poa_kernel)
    n = pipeline.num_windows()
    stats = {"device": 0, "host_fallback": 0, "backbone": 0, "failed": 0,
             "layers_dropped": 0, "batches": 0}
    fallback: List[int] = []

    # Metadata pass: depth buckets, no layer bytes touched.
    jobs = []          # (window_idx, estimated depth, backbone len)
    for i in range(n):
        n_seqs, bb_len, _rank, _is_tgs, _bytes, _tid = \
            pipeline.window_info(i)
        k = n_seqs - 1
        if k < 2:
            # <3 sequences incl. backbone: backbone passthrough
            # (reference: src/window.cpp:68-71)
            wx = pipeline.export_window(i)
            pipeline.set_consensus(i, wx.backbone.tobytes(), False)
            stats["backbone"] += 1
            continue
        jobs.append((i, min(k, DEPTH_CAP), bb_len))

    buckets = {}
    for i, depth, bb in jobs:
        bucket = next(b for b in DEPTH_BUCKETS if depth <= b)
        buckets.setdefault((bucket, window_class(bb)), []).append(
            (i, depth, bb))
    for (depth_bucket, wl_class), bucket_jobs in sorted(buckets.items()):
        cfg = make_config(wl_class, depth_bucket, match, mismatch, gap)
        # depth- and length-homogeneous batches
        bucket_jobs.sort(key=lambda job: (job[1], job[2]))
        for off in range(0, len(bucket_jobs), batch_windows):
            idxs = [i for i, _, _ in bucket_jobs[off:off + batch_windows]]
            chunk = _export_chunk(pipeline, idxs, cfg, fallback, stats)
            if not chunk:
                continue
            packed = _pack(chunk, cfg)
            outs = kernel_for(poa_kernel)(
                cfg, *poa.batch_to_tensors(packed, device))
            stats["batches"] += 1
            _install(pipeline, chunk, _unpack(outs), trim, stats, fallback)

    t0 = time.perf_counter()
    for i in fallback:
        pipeline.consensus_cpu_one(i)
        stats["host_fallback"] += 1
    stats["host_seconds"] = time.perf_counter() - t0
    return stats


def _export_chunk(pipeline, idxs, cfg, fallback, stats):
    """Export window bases for one chunk; apply per-layer admission.

    Returns [(window_idx, export, kept layer indices)]; a window left with
    fewer than two admissible layers goes to the host."""
    chunk = []
    for i in idxs:
        wx = pipeline.export_window(i)
        k = len(wx.lens)
        keep = [j for j in range(k) if 0 < wx.lens[j] <= cfg.max_len]
        stats["layers_dropped"] += int(
            sum(1 for ln in wx.lens[:DEPTH_CAP] if ln > cfg.max_len))
        if len(keep) < len(wx.lens[:DEPTH_CAP]) and len(keep) < 2:
            fallback.append(i)
            continue
        chunk.append((i, wx, keep[:DEPTH_CAP]))
    return chunk


def _pack(chunk, cfg):
    """Numpy batch of the chunk's windows in the kernel's layout: the
    JAX package's 10-tuple, the trailing per-window band row all zero."""
    B = len(chunk)
    bb = np.zeros((B, cfg.max_backbone), dtype=np.uint8)
    bbw = np.zeros((B, cfg.max_backbone), dtype=np.int32)
    bb_len = np.ones(B, dtype=np.int32)   # padded windows: 1-base backbone
    n_layers = np.zeros(B, dtype=np.int32)
    seqs = np.zeros((B, cfg.depth, cfg.max_len), dtype=np.uint8)
    ws = np.zeros((B, cfg.depth, cfg.max_len), dtype=np.int32)
    lens = np.zeros((B, cfg.depth), dtype=np.int32)
    begins = np.zeros((B, cfg.depth), dtype=np.int32)
    ends = np.zeros((B, cfg.depth), dtype=np.int32)
    wband = np.zeros(B, dtype=np.int32)

    for bi, (i, wx, keep) in enumerate(chunk):
        L = len(wx.backbone)
        bb[bi, :L] = encode(wx.backbone)
        bbw[bi, :L] = wx.backbone_weights
        bb_len[bi] = L
        K = len(keep)
        n_layers[bi] = K
        if K == 0:
            continue
        enc = encode(wx.bases)
        offsets = np.concatenate([[0], np.cumsum(wx.lens)]).astype(np.int64)
        kp = np.asarray(keep, dtype=np.int64)
        lens_k = wx.lens[kp].astype(np.int64)
        ML = cfg.max_len
        sflat = seqs[bi].reshape(-1)
        wflat = ws[bi].reshape(-1)
        for li in range(K):
            o = offsets[kp[li]]
            ll = lens_k[li]
            sflat[li * ML:li * ML + ll] = enc[o:o + ll]
            wflat[li * ML:li * ML + ll] = wx.weights[o:o + ll]
        lens[bi, :K] = lens_k
        begins[bi, :K] = wx.begins[kp]
        ends[bi, :K] = wx.ends[kp]
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends, wband)


def _unpack(outs):
    """Kernel outputs -> host numpy (cons_base, cons_cov, cons_len,
    failed)."""
    return tuple(t.cpu().numpy() for t in outs[:4])


def _install(pipeline, chunk, results, trim, stats, fallback):
    cons_base, cons_cov, cons_len, failed = results
    for bi, (i, wx, keep) in enumerate(chunk):
        if failed[bi]:
            fallback.append(i)
            stats["failed"] += 1
            continue
        cl = int(cons_len[bi])
        codes = cons_base[bi, :cl]
        if wx.is_tgs and trim:
            # threshold on the ADMITTED sequence count (backbone + packed
            # layers), as the reference accelerator counts only sequences
            # added to its batch (src/cuda/cudabatch.cpp:139-163,233)
            codes = tgs_trim(codes, cons_cov[bi, :cl], len(keep) + 1)
        pipeline.set_consensus(i, decode(codes), True)
        stats["device"] += 1
