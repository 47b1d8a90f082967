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
columns a thread where max_len + 1 > 2048, so that every window class up
to 2048 (-w 2048; max_len 3072) runs on the card. Before any window
runs, the phase checks every bucket's geometry against the card and
raises ValueError, naming the largest window length the kernel takes,
where one does not fit; no window is sent to the host for that. A
window's global scratch (H and the move records) grows with N x max_len:
about 95 MB at class 2048, 24 GB for a batch of 256, which the card's
80 GB holds, so ``batch_windows`` needs no cap by geometry.

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
from . import poa, poa_cuda, poa_v2_cuda
from .encoding import decode, encode
from .poa_cuda import poa_consensus
from .poa_v2_cuda import poa_consensus_v2

DEPTH_CAP = 200                    # layers per window, as the reference
DEPTH_BUCKETS = (8, 32, DEPTH_CAP)
NODE_FACTOR = 3                    # max_nodes = 3 x window length
POA_KERNELS = ("ls", "v2")
DEFAULT_POA_KERNEL = "ls"


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


def check_geometries(cfgs, poa_kernel: str, band: bool) -> None:
    """Before any window runs on the card: each geometry's shared-memory
    plan for `poa_kernel`'s flat or (`band`) banded build. Where one does
    not fit, raises one ValueError naming the largest window length (-w)
    the kernel takes on this card: the largest backbone class whose
    geometry fits (needs the card)."""
    plan = poa_cuda.plan if poa_kernel == "ls" else poa_v2_cuda.plan

    def fits(cfg) -> bool:
        try:
            plan(cfg, band)
        except ValueError:
            return False
        return True

    for cfg in cfgs:
        if fits(cfg):
            continue
        largest = 0
        for wl in range(128, cfg.max_backbone, 128):
            if not fits(make_config(wl, cfg.depth, cfg.match, cfg.mismatch,
                                    cfg.gap)):
                break
            largest = wl
        raise ValueError(
            f"the {poa_kernel} POA kernel does not take windows of backbone "
            f"class {cfg.max_backbone} (max_nodes {cfg.max_nodes}, max_len "
            f"{cfg.max_len}) on this card; the largest window length it "
            f"takes is -w {largest}")


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
        check_geometries(cfgs.values(), poa_kernel, band)
    for key, bucket_jobs in sorted(buckets.items()):
        cfg = cfgs[key]
        # depth- and length-homogeneous batches
        bucket_jobs.sort(key=lambda job: (job[1], job[2]))
        for off in range(0, len(bucket_jobs), batch_windows):
            idxs = [i for i, _, _ in bucket_jobs[off:off + batch_windows]]
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
