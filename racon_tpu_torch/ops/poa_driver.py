"""Consensus-phase driver: packs windows into depth-bucketed batches, runs
a POA kernel, trims and installs the results, and re-polishes on the
host every window the kernel flags ``failed``.

A copy of the JAX package's driver (racon_tpu/ops/poa_driver.py) reduced
to one path: no journal, no sanitizer, no sharding, and no lattice. The
kernel is an argument, ``poa_kernel``: "ls" (ops/poa_cuda.py, the
default, as in the JAX package, and faster than v2 on every depth bucket
on the card) or "v2" (ops/poa_v2_cuda.py); both compute one function,
and neither steps down to the other. Both keep H in global memory and
plan their shared memory per launch (``plan``), with a wide build of 16
columns a thread where max_len + 1 > 2048 and a global build (the graph
in global memory, DP rows in tiles) where no shared-memory layout fits,
so that every window class up to the int16 node-id limit (-w 10880;
max_nodes 32,640, max_len 16,384) runs on the card. Before any window
runs, the phase checks every bucket's geometry (``check_geometries``)
and raises one ValueError, naming that limit and the largest window
length, where one is beyond it; no window is sent to the host for its
size. A window's global scratch (H and the move records, about 5 bytes
a DP cell) grows with N x max_len: about 95 MB at class 2048, 380 MB at
4096, 2.7 GB at 10,880. So on the card each bucket's batches are capped
by geometry (``batch_cap``): as many windows as the card's free memory
holds, less a margin (``MEMORY_MARGIN``), and at most ``batch_windows``.

With ``band`` (the JAX package's ``RACON_TPU_BAND``) every batch runs the
chosen kernel's banded build: each window gets the half band of its worst
layer's length delta plus ``band_slack`` (ops/band.py), or 0 (flat) where
that band would not be much narrower than the DP row. A window whose
kernel run sets band_hit, or fails, under a band is re-run at twice the
band, at most ``band_max_widenings`` times and below ``max_len // 2``,
then at 0, through the same build; only a failure at 0 goes to the host.
The two banded builds differ where a band cuts the path off (an ls layer
with no end score above NEG fails, and adds nothing to the graph), but the
ladder re-runs every window that fails or hits, so both end in the flat
bytes.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from . import band as _band
from . import poa, poa_cuda
from .encoding import decode, encode
from .poa_cuda import poa_consensus
from .poa_v2_cuda import poa_consensus_v2

DEPTH_CAP = 200                    # layers per window, as the reference
DEPTH_BUCKETS = (8, 32, DEPTH_CAP)
NODE_FACTOR = 3                    # max_nodes = 3 x window length
POA_KERNELS = ("ls", "v2")
DEFAULT_POA_KERNEL = "ls"
#: What a batch leaves of the card's free memory: 1 GiB and a tenth of the
#: rest, for the allocator's rounding, the phase's other tensors and
#: whatever else runs on the card.
MEMORY_MARGIN = (1 << 30, 0.1)


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
    called (so a caller may wrap it here). Each wrapper runs its banded
    build when given ``wband=``."""
    if poa_kernel not in POA_KERNELS:
        raise ValueError(f"poa_kernel must be 'ls' or 'v2', got "
                         f"{poa_kernel!r}")
    return poa_consensus if poa_kernel == "ls" else poa_consensus_v2


def largest_window() -> int:
    """The largest window length (-w) whose window class both POA kernels
    take: node ids are int16, so make_config's max_nodes <= 32767."""
    wl = 128
    while make_config(wl + 128, 1, 0, 0, 0).max_nodes <= poa_cuda.MAX_NODES:
        wl += 128
    return wl


def check_geometries(cfgs, poa_kernel: str) -> None:
    """Before any window runs on the card: both POA kernels take every
    geometry whose node ids fit int16 (max_nodes <= 32767), flat or
    banded, through their global build where no shared-memory layout
    fits. Beyond that limit, raises one ValueError naming it and the
    largest window length (-w) the kernels take."""
    for cfg in cfgs:
        if cfg.max_nodes > poa_cuda.MAX_NODES:
            raise ValueError(
                f"the {poa_kernel} POA kernel does not take windows of "
                f"backbone class {cfg.max_backbone}: max_nodes "
                f"{cfg.max_nodes} is beyond the int16 node-id limit of "
                f"{poa_cuda.MAX_NODES}; the largest window length it takes "
                f"is -w {largest_window()}")


def window_bytes(cfg: poa.PoaConfig) -> int:
    """Device bytes one window of a batch at cfg's geometry takes: its
    global scratch (the global build's, the larger), its inputs, outputs
    and counts. A pure function of the geometry."""
    N, ML, MB, D = cfg.max_nodes, cfg.max_len, cfg.max_backbone, cfg.depth
    inputs = MB * 5 + 8 + D * ML * 5 + D * 12 + 4
    outputs = 2 * N * 4 + 4 + 1 + 4 + 1 + 8 * 8
    return 4 * poa_cuda.scratch_words(cfg, True) + inputs + outputs


def batch_cap(cfg: poa.PoaConfig, free_bytes: int) -> int:
    """How many windows of cfg's geometry a batch may hold on a card with
    `free_bytes` free: the free bytes less MEMORY_MARGIN over
    ``window_bytes``, at least 1."""
    fixed, share = MEMORY_MARGIN
    room = free_bytes - fixed - int(share * max(0, free_bytes - fixed))
    return max(1, room // window_bytes(cfg))


def free_device_bytes(device) -> int:
    """The card's free memory, counting what the caching allocator holds
    but does not use."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)


def initial_poa_band(wx, keep, cfg: poa.PoaConfig, slack: int):
    """w0 (half band) for a window: the worst admitted layer's length less
    its span, plus the slack; None (flat) where the band would not be
    much narrower than the DP row."""
    if not keep:
        return None
    delta = max(abs(int(wx.lens[j]) - (int(wx.ends[j]) - int(wx.begins[j])))
                for j in keep)
    w0 = delta + max(0, slack)
    return w0 if 2 * w0 + 1 < cfg.max_len // 2 else None


def run_consensus_phase(pipeline, *, match: int, mismatch: int, gap: int,
                        trim: bool, device="cuda", batch_windows: int = 256,
                        poa_kernel: str = DEFAULT_POA_KERNEL,
                        band: bool = False,
                        band_slack: int = _band.DEFAULT_SLACK,
                        band_max_widenings: int = _band.DEFAULT_MAX_WIDENINGS
                        ) -> dict:
    """Kernel consensus for every window with at least two layers; the
    backbone for the rest; the host POA for windows the kernel fails.
    `poa_kernel` ("ls", the default, or "v2") picks the kernel; `band`
    runs its banded build with the widening ladder (module note).

    Returns {device, host_fallback, backbone, failed, layers_dropped,
    batches, host_seconds, band}: windows served by the kernel,
    re-polished on the host, passed through as backbone, flagged failed by
    the kernel (at wband 0), layers dropped at admission, kernel batches
    run (re-runs included), the wall time of the host re-polish, and the
    ladder's counts (ops/band.py; all 0 without `band`)."""
    device = torch.device(device)
    kernel_for(poa_kernel)
    n = pipeline.num_windows()
    stats = {"device": 0, "host_fallback": 0, "backbone": 0, "failed": 0,
             "layers_dropped": 0, "batches": 0, "band": _band.new_stats()}
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
    cfgs = {key: make_config(key[1], key[0], match, mismatch, gap)
            for key in buckets}
    if device.type == "cuda":
        check_geometries(cfgs.values(), poa_kernel)
    for key, bucket_jobs in sorted(buckets.items()):
        cfg = cfgs[key]
        # depth- and length-homogeneous batches, as many as the card holds
        bucket_jobs.sort(key=lambda job: (job[1], job[2]))
        per_batch = batch_windows
        if device.type == "cuda":
            per_batch = min(per_batch,
                            batch_cap(cfg, free_device_bytes(device)))
        for off in range(0, len(bucket_jobs), per_batch):
            idxs = [i for i, _, _ in bucket_jobs[off:off + per_batch]]
            chunk = _export_chunk(pipeline, idxs, cfg, fallback, stats)
            if not chunk:
                continue
            if not band:
                outs = kernel_for(poa_kernel)(
                    cfg, *poa.batch_to_tensors(_pack(chunk, cfg), device))
                stats["batches"] += 1
                _install(pipeline, chunk, _unpack(outs), trim, stats,
                         fallback)
                continue
            states = {}
            for i, wx, keep in chunk:
                states[i] = _band.BandState(
                    initial_poa_band(wx, keep, cfg, band_slack))
                stats["band"]["jobs"] += bool(states[i].k)
            while chunk:   # the ladder: re-run the hits until none is left
                packed = _pack(chunk, cfg,
                               [states[i].k or 0 for i, _, _ in chunk])
                outs = kernel_for(poa_kernel)(
                    cfg, *poa.batch_to_tensors(packed, device),
                    wband=torch.from_numpy(packed[9]).to(device))
                stats["batches"] += 1
                chunk = _install(pipeline, chunk, _unpack(outs), trim, stats,
                                 fallback, states, cfg.max_len // 2,
                                 band_max_widenings)

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


def _pack(chunk, cfg, widths=None):
    """Numpy batch of the chunk's windows in the kernel's layout: the
    JAX package's 10-tuple, the trailing row each window's half band
    (`widths`, else 0)."""
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
    if widths is not None:
        wband[:] = widths

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
    failed, and band_hit from the banded build)."""
    return tuple(t.cpu().numpy() for t in outs[:4] + outs[5:])


def _install(pipeline, chunk, results, trim, stats, fallback, states=None,
             band_cap=0, max_widenings=_band.DEFAULT_MAX_WIDENINGS):
    """Installs the chunk's consensus; a failed window goes to the host.
    With band `states`, a window run under a band that hit or failed
    widens instead; returns those windows, to be re-run."""
    cons_base, cons_cov, cons_len, failed = results[:4]
    retry = []
    for bi, (i, wx, keep) in enumerate(chunk):
        st = states.get(i) if states else None
        if st is not None and st.k:
            if results[4][bi] or failed[bi]:
                st.widen_width(band_cap, stats["band"], max_widenings)
                retry.append((i, wx, keep))
                continue
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
    return retry
