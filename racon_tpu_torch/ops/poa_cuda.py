"""POA consensus kernel (csrc/poa.cu) and its wrapper.

Replaces the JAX package's lane-lockstep Pallas kernel
``build_lockstep_poa_kernel`` (racon_tpu/ops/poa_pallas_ls.py:64,
pallas_call :876). The kernel computes what ``poa.poa_batch_plain``
computes, one thread block per window, and returns the same five outputs.

What bounds it on an H100: one window's serial chain (DP rows, traceback,
graph update), not bytes or integer throughput; a launch lasts as long as
its slowest window. The design takes global round trips, barriers and
searches off that chain: the graph (int16 in-edge sources, keys, bases,
rank order, coverage) lives in shared memory; a DP row reads its
predecessors from a descriptor built for every row in parallel before the
layer, takes the row before it from registers and older near rows from a
shared ring, with one block barrier a row; the DP writes a move record a
cell, exactly the move the ls traceback re-derives from H (in band and
masked), so the walk fetches two steps a trip; the rank order is kept by
one merge a layer, and each position's matched node found by binary
search. H, the move
records and the edge weights live in a global scratch allocated here.
Unlike the Pallas kernel there is no rank distance cap: a predecessor
beyond the ring is read from the global H.

The banded build (``wband=``) replaces the Pallas kernel's ``band=True``
build (racon_tpu/ops/poa_pallas_ls.py:64): each window's DP runs under
its half band ``wband`` (0: the flat DP, bit for bit), and the window's
``band_hit`` comes out beside the five outputs. It follows the ls build's
banded semantics, which differ from v2's by two rules (``poa_batch_plain``
with ``kernel="ls"``): an end score no better than NEG fails the layer,
and a layer that fails adds nothing to the graph. It computes every
column, as the Pallas build does, and masks the rest; what bounds it is
the flat build's serial chain.

The graph grows with the window, so each launch plans its shared memory
(``plan``): a ring of 8 rows at -w 500, fewer for larger windows, and the
in-edge sources in the global scratch where even 2 rows do not fit. A
thread owns up to 8 columns of a DP row; a window whose max_len + 1
exceeds 2048 (make_config's classes above 1280) runs the kernel's wide
build, 16 columns a thread, so the kernels take max_len + 1 <= 4096
(``MAX_COLUMNS``). The shared memory a block caps the ls kernel at
backbone class 2048 (-w 2048, max_len 3072), where ``plan`` raises.

A tensor on the CPU goes to the plain version; a tensor on the card goes
to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .poa import PoaConfig, poa_batch_plain

MAX_NODES = 32767  # node ids are int16 in both POA kernels
#: max_len + 1 both POA kernels take: 256 threads x 16 columns (the wide
#: build; the usual build takes 8 a thread, max_len + 1 <= 2048).
MAX_COLUMNS = 4096
_INVALID_VALUE = 1  # cudaErrorInvalidValue: the graph does not fit
#: The kernel's timed phases, in the order of stats["phase_cycles"].
PHASES = ("init", "dp", "end_pick", "traceback", "update", "order",
          "consensus")

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("poa")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_poa_scratch_words.restype = ctypes.c_longlong
        lib.rt_poa_scratch_words.argtypes = [ci, ci, ci]
        lib.rt_poa_launch.restype = ci
        lib.rt_poa_launch.argtypes = [ci] * 8 + [vp] * 19 + [ci, vp]
        lib.rt_poa_plan.restype = ci
        lib.rt_poa_plan.argtypes = [ci, ci, ci, ci, vp]
        _LIB = lib
    return _LIB


def occupancy(cfg: PoaConfig, band: bool = False) -> dict:
    """The kernel's registers, spill bytes, shared bytes and blocks per
    SM at cfg's geometry, flat or banded build (needs the card)."""
    return cuda_lib.occupancy(_lib().rt_poa_occupancy,
                              (cfg.max_nodes, cfg.max_len, int(band)),
                              cuda_lib.POA_OCCUPANCY, "POA kernel")


def plan_with(fn, cfg: PoaConfig, band: bool, what: str) -> dict:
    """A POA kernel's shared-memory plan at cfg's geometry, for its flat
    or (`band`) banded build, from its library's plan export `fn` (both
    kernels' wrappers); raises ValueError where the graph does not fit."""
    check_geometry(cfg)
    out = (ctypes.c_int * 3)()
    err = fn(cfg.max_nodes, cfg.max_len, cfg.max_edges, int(band), out)
    if err == _INVALID_VALUE:
        raise ValueError(f"{what}: a window of max_nodes={cfg.max_nodes}, "
                         f"max_len={cfg.max_len} does not fit the card's "
                         f"shared memory a block")
    cuda_lib.check(err, f"{what}'s shared-memory plan")
    return dict(zip(("ring", "src_in_shared", "shared_bytes"), out))


def plan(cfg: PoaConfig, band: bool = False) -> dict:
    """How a launch at cfg's geometry lays out a window on this card: the
    DP rows its shared ring holds ("ring": 8, 4 or 2), whether the in-edge
    sources are in shared memory ("src_in_shared") and the dynamic shared
    bytes a block ("shared_bytes"); the banded build's (`band`) is the flat
    build's. Raises ValueError where the graph does not fit the card's
    shared memory a block, or the kernel's limits (needs the card)."""
    return plan_with(_lib().rt_poa_plan, cfg, band, "POA kernel")


def add_phase_cycles(stats: dict, names, cycles) -> None:
    """Both POA wrappers' phase counts: adds a launch's i64[len(names), B]
    clock64() cycles (one row a phase) to stats, summed over the windows
    ("phase_cycles") and the largest window's ("phase_cycles_max")."""
    sums = cycles.sum(dim=1).tolist()
    peaks = cycles.max(dim=1).values.tolist()
    old = stats.get("phase_cycles", [0] * len(names))
    stats["phase_cycles"] = [a + b for a, b in zip(old, sums)]
    old = stats.get("phase_cycles_max", [0] * len(names))
    stats["phase_cycles_max"] = [max(a, b) for a, b in zip(old, peaks)]


def check_geometry(cfg: PoaConfig) -> None:
    """Both POA kernels' limits on cfg's geometry: max_edges <= 32,
    max_len + 1 <= MAX_COLUMNS, max_nodes <= MAX_NODES (ValueError)."""
    if cfg.max_edges > 32 or cfg.max_len + 1 > MAX_COLUMNS:
        raise ValueError("POA kernel takes max_edges <= 32 and max_len + 1 "
                         f"<= {MAX_COLUMNS} (256 threads x 16 columns), got "
                         f"{cfg}")
    if cfg.max_nodes > MAX_NODES:
        raise ValueError(f"POA kernel takes max_nodes <= {MAX_NODES} "
                         f"(int16 node ids), got {cfg.max_nodes}")


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
    check_geometry(cfg)
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
    kernel. On the card only, it also accumulates each phase's clock
    cycles (``PHASES``; thread 0 of each window's block reads
    ``clock64()``): summed over the windows ("phase_cycles") and the
    largest window's ("phase_cycles_max")."""
    args = (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends)
    if bb.device.type == "cpu":
        return poa_batch_plain(cfg, *args, stats=stats, wband=wband,
                               kernel="ls")
    dev = bb.device
    B = check_inputs(cfg, args, dev)
    if wband is not None:
        cuda_lib.require(wband, "wband", torch.int32, (B,), dev)
    plan(cfg, wband is not None)
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
    counts = None if stats is None else torch.empty(
        (1 + len(PHASES), B), dtype=torch.int64, device=dev)
    p = cuda_lib.ptr
    name = "poa_consensus" if wband is None else "poa_consensus_band"
    with cuda_lib.launch_events(name, bb):
        err = lib.rt_poa_launch(
            N, cfg.max_len, cfg.max_backbone, cfg.max_edges, cfg.depth,
            cfg.match, cfg.mismatch, cfg.gap,
            *(p(t) for t in args), None if wband is None else p(wband),
            p(cons_base), p(cons_cov), p(cons_len), p(failed), p(n_nodes),
            None if wband is None else p(outs[5]),
            None if counts is None else p(counts[0]),
            None if counts is None else p(counts[1]), p(scratch), B,
            cuda_lib.stream_of(bb))
    cuda_lib.check(err, "POA consensus kernel")
    cuda_lib.LAUNCHES[name] += 1
    if counts is not None:
        stats["cells"] = stats.get("cells", 0) + int(counts[0].sum())
        add_phase_cycles(stats, PHASES, counts[1:])
    return outs
