"""POA consensus kernel (csrc/poa.cu) and its wrapper.

Replaces the JAX package's lane-lockstep Pallas kernel
``build_lockstep_poa_kernel`` (racon_tpu/ops/poa_pallas_ls.py:64,
pallas_call :876). The kernel computes what ``poa.poa_batch_plain``
computes, one thread block per window, and returns the same five outputs.

What bounds it on an H100: the serial dependency chains of POA (one DP
row after another, the traceback, the graph update), not bytes or integer
throughput. H, (N + 1) x (max_len + 1) int32 per window, lives in a global
scratch allocated here; the graph's keys, bases and rank order live in
shared memory; many windows run at once so that one window's latency
hides behind the others'. Unlike the Pallas kernel there is no rank
distance cap and no VMEM fit check: depth and window class never keep a
window off the card.

The banded build (``wband=``) replaces the Pallas kernel's ``band=True``
build (racon_tpu/ops/poa_pallas_ls.py:64): each window's DP runs under
its half band ``wband`` (0: the flat DP, bit for bit), and the window's
``band_hit`` comes out beside the five outputs. It follows the ls build's
banded semantics, which differ from v2's by two rules (``poa_batch_plain``
with ``kernel="ls"``): an end score no better than NEG fails the layer,
and a layer that fails adds nothing to the graph. It computes every
column, as the Pallas build does, and masks the rest; what bounds it is
the flat build's serial chain.

A tensor on the CPU goes to the plain version; a tensor on the card goes
to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .poa import PoaConfig, poa_batch_plain

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("poa")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_poa_scratch_words.restype = ctypes.c_longlong
        lib.rt_poa_scratch_words.argtypes = [ci, ci, ci]
        lib.rt_poa_launch.restype = ci
        lib.rt_poa_launch.argtypes = [ci] * 8 + [vp] * 18 + [ci, vp]
        _LIB = lib
    return _LIB


def occupancy(cfg: PoaConfig, band: bool = False) -> dict:
    """The kernel's registers, spill bytes, shared bytes and blocks per
    SM at cfg's geometry, flat or banded build (needs the card)."""
    return cuda_lib.occupancy(_lib().rt_poa_occupancy,
                              (cfg.max_nodes, cfg.max_len, int(band)),
                              cuda_lib.POA_OCCUPANCY, "POA kernel")


def check_inputs(cfg: PoaConfig, args, dev) -> int:
    """Both POA wrappers' argument check; returns the batch size."""
    bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends = args
    B, D = bb.shape[0], cfg.depth
    req = cuda_lib.require
    req(bb, "bb", torch.uint8, (B, cfg.max_backbone), dev)
    req(bbw, "bbw", torch.int32, (B, cfg.max_backbone), dev)
    req(bb_len, "bb_len", torch.int32, (B,), dev)
    req(n_layers, "n_layers", torch.int32, (B,), dev)
    req(seqs, "seqs", torch.uint8, (B, D, cfg.max_len), dev)
    req(ws, "ws", torch.int32, (B, D, cfg.max_len), dev)
    for t, name in ((lens, "lens"), (begins, "begins"), (ends, "ends")):
        req(t, name, torch.int32, (B, D), dev)
    if cfg.max_edges > 32 or cfg.max_len + 1 > 2048:
        raise ValueError("POA kernel takes max_edges <= 32 and "
                         f"max_len <= 2047, got {cfg}")
    return B


def poa_consensus(cfg: PoaConfig, bb, bbw, bb_len, n_layers, seqs, ws, lens,
                  begins, ends, stats: Optional[dict] = None, wband=None):
    """Batched POA: (cons_base i32[B,N], cons_cov i32[B,N], cons_len
    i32[B], failed bool[B], n_nodes i32[B]) on the inputs' device.

    Inputs as ``poa.batch_to_tensors`` makes them. `wband`, an i32[B]
    tensor of half bands (0: flat), runs the banded build and appends
    band_hit bool[B] to the outputs. `stats`, when given, accumulates the
    DP cells the batch needed ("cells": under a band those it admits), as
    the plain version counts them; on the card that waits for the
    kernel."""
    args = (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends)
    if bb.device.type == "cpu":
        return poa_batch_plain(cfg, *args, stats=stats, wband=wband,
                               kernel="ls")
    dev = bb.device
    B = check_inputs(cfg, args, dev)
    if wband is not None:
        cuda_lib.require(wband, "wband", torch.int32, (B,), dev)
    N = cfg.max_nodes
    cons_base = torch.empty((B, N), dtype=torch.int32, device=dev)
    cons_cov = torch.empty((B, N), dtype=torch.int32, device=dev)
    cons_len = torch.empty(B, dtype=torch.int32, device=dev)
    failed = torch.empty(B, dtype=torch.bool, device=dev)
    n_nodes = torch.empty(B, dtype=torch.int32, device=dev)
    outs = (cons_base, cons_cov, cons_len, failed, n_nodes)
    if wband is not None:
        outs += (torch.empty(B, dtype=torch.bool, device=dev),)
    if B == 0:
        return outs
    lib = _lib()
    per = lib.rt_poa_scratch_words(N, cfg.max_len, cfg.max_edges)
    scratch = torch.empty((B, per), dtype=torch.int32, device=dev)
    cells = None if stats is None else torch.empty(B, dtype=torch.int64,
                                                    device=dev)
    p = cuda_lib.ptr
    name = "poa_consensus" if wband is None else "poa_consensus_band"
    with cuda_lib.launch_events(name, bb):
        err = lib.rt_poa_launch(
            N, cfg.max_len, cfg.max_backbone, cfg.max_edges, cfg.depth,
            cfg.match, cfg.mismatch, cfg.gap,
            *(p(t) for t in args), None if wband is None else p(wband),
            p(cons_base), p(cons_cov), p(cons_len), p(failed), p(n_nodes),
            None if wband is None else p(outs[5]),
            None if cells is None else p(cells), p(scratch), B,
            cuda_lib.stream_of(bb))
    cuda_lib.check(err, "POA consensus kernel")
    cuda_lib.LAUNCHES[name] += 1
    if cells is not None:
        stats["cells"] = stats.get("cells", 0) + int(cells.sum())
    return outs
