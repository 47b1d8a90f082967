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
build, 16 columns a thread. Where no shared-memory layout fits (backbone
class 2176 and up), the plan picks the global build: the graph in the
window's global scratch, each DP row in tiles of 2048 columns, so no
limit on max_len. Node ids are int16 in every build up to max_nodes
32,767 (``INT16_NODES``, backbone class 10,880); above it the global build
takes int32 ids (``wide_ids``; launch names ``*_global32``), which costs
scratch bytes and leaves every other build as it was. So the kernels take
any window length whose scratch fits the card
(``poa_driver.check_memory``).

A tensor on the CPU goes to the plain version; a tensor on the card goes
to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .poa import PoaConfig, poa_batch_plain

#: The most node slots a build with int16 node ids takes; above it the
#: global build takes int32 ids (csrc/poa_common.cuh INT16_NODES).
INT16_NODES = 32767
TILE_COLUMNS = 2048  # the global build's DP row tile: 256 threads x 8
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
        lib.rt_poa_scratch_words.argtypes = [ci, ci, ci, ci]
        lib.rt_poa_launch.restype = ci
        lib.rt_poa_launch.argtypes = [ci] * 8 + [vp] * 19 + [ci, vp]
        lib.rt_poa_plan.restype = ci
        lib.rt_poa_plan.argtypes = [ci, ci, ci, ci, vp]
        lib.rt_poa_layout_bytes.restype = ctypes.c_longlong
        lib.rt_poa_layout_bytes.argtypes = [ci] * 6
        lib.rt_poa_shared_limit.restype = ci
        lib.rt_poa_shared_limit.argtypes = [vp]
        _LIB = lib
    return _LIB


def occupancy(cfg: PoaConfig, band: bool = False) -> dict:
    """The kernel's registers, spill bytes, shared bytes and blocks per
    SM at cfg's geometry, flat or banded build (needs the card)."""
    return cuda_lib.occupancy(_lib().rt_poa_occupancy,
                              (cfg.max_nodes, cfg.max_len, int(band)),
                              cuda_lib.POA_OCCUPANCY, "POA kernel")


def plan_with(fn, cfg: PoaConfig, band: bool, what: str) -> dict:
    """A POA kernel's plan at cfg's geometry, for its flat or (`band`)
    banded build, from its library's plan export `fn` (both kernels'
    wrappers); raises ValueError beyond the kernels' limits."""
    check_geometry(cfg)
    out = (ctypes.c_int * 4)()
    err = fn(cfg.max_nodes, cfg.max_len, cfg.max_edges, int(band), out)
    cuda_lib.check(err, f"{what}'s plan")
    plan = dict(zip(("ring", "src_in_shared", "shared_bytes"), out))
    plan["global_build"] = bool(out[3])
    return plan


def plan(cfg: PoaConfig, band: bool = False) -> dict:
    """How a launch at cfg's geometry lays out a window on this card: the
    DP rows its shared ring holds ("ring": 8, 4 or 2; 0 in the global
    build), whether the in-edge sources are in shared memory
    ("src_in_shared"), the dynamic shared bytes a block ("shared_bytes"),
    and whether no shared-memory layout fits, so that the global build
    runs ("global_build"); the banded build's (`band`) is the flat
    build's. Raises ValueError beyond the kernel's limits (needs the
    card)."""
    return plan_with(_lib().rt_poa_plan, cfg, band, "POA kernel")


def layout_bytes(cfg: PoaConfig, band: bool, ring: int, gsrc: bool) -> int:
    """The dynamic shared bytes of the kernel's layout at cfg's geometry
    with a ring of `ring` rows and the in-edge sources in the global
    scratch where `gsrc`, as ``plan`` holds it against the card's limit
    (the banded build's is the flat build's; needs the card)."""
    return int(_lib().rt_poa_layout_bytes(cfg.max_nodes, cfg.max_len,
                                          cfg.max_edges, int(band), ring,
                                          int(gsrc)))


def shared_limit() -> int:
    """The card's opt-in shared memory a block: the limit ``plan`` fits a
    layout into (needs the card)."""
    out = (ctypes.c_int * 1)()
    cuda_lib.check(_lib().rt_poa_shared_limit(out), "shared memory limit")
    return int(out[0])


def wide_ids(cfg: PoaConfig, global_build: bool) -> bool:
    """Whether a build at cfg's geometry takes int32 node ids: the global
    build above INT16_NODES node slots (csrc/poa_common.cuh wide_ids)."""
    return global_build and cfg.max_nodes > INT16_NODES


def scratch_words(cfg: PoaConfig, global_build: bool) -> int:
    """int32 words of one window's global scratch, as both kernels lay it
    out (csrc/poa_common.cuh scratch_layout and graph_layout): H and the
    move records over (max_nodes + 1) x (max_len + 1) cells, the edge
    weights and in-edge sources, and in the global build the graph, whose
    node-id and band-start arrays (and the sources) take 4 bytes an entry
    with ``wide_ids``, else 2. A pure function of the geometry."""
    N, ML = cfg.max_nodes, cfg.max_len
    ES = (cfg.max_edges + 3) & ~3
    idb = 4 if wide_ids(cfg, global_build) else 2

    def up4(x):
        return (x + 3) & ~3

    def align16(x):
        return (x + 15) & ~15

    cells, edges = (N + 1) * (ML + 1), N * ES
    w = up4(up4(cells + edges) + edges * idb // 4 + (cells + 3) // 4)
    if not global_build:
        return w
    tiles = (ML + TILE_COLUMNS) // TILE_COLUMNS
    sizes = (N * 8, N * 4, N * 4, N * 4, ML * 4, ML * 4, ML * 4,
             tiles * 256 * 4, N * idb, N * idb, N * idb, N * idb, ML * idb,
             N, ML, N, N, N)
    return w + sum(align16(b) for b in sizes) // 4


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
    """Both POA kernels' limit on cfg's geometry: max_edges <= 32
    (ValueError); any max_nodes and max_len."""
    if cfg.max_edges > 32:
        raise ValueError(f"POA kernel takes max_edges <= 32, got {cfg}")


def launch_name(kernel: str, band: bool, global_build: bool,
                ids32: bool = False) -> str:
    """A POA build's launch-count name: the kernel's, then "_band" for
    its banded build and "_global" for its global build, "_global32" for
    the global build with int32 node ids (``wide_ids``)."""
    return kernel + ("_band" if band else "") + (
        ("_global32" if ids32 else "_global") if global_build else "")


def build_name(plan_fn, kernel: str, cfg: PoaConfig, band: bool):
    """(global_build, launch name) of the build a POA wrapper launches at
    cfg's geometry, as its kernel's plan (`plan_fn`) picks it."""
    glob = plan_fn(cfg, band)["global_build"]
    return glob, launch_name(kernel, band, glob, wide_ids(cfg, glob))


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
    largest window's ("phase_cycles_max"). The launch counts under
    ``launch_name``: the build the plan picks (``build_name``)."""
    args = (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends)
    if bb.device.type == "cpu":
        return poa_batch_plain(cfg, *args, stats=stats, wband=wband,
                               kernel="ls")
    dev = bb.device
    B = check_inputs(cfg, args, dev)
    if wband is not None:
        cuda_lib.require(wband, "wband", torch.int32, (B,), dev)
    glob, name = build_name(plan, "poa_consensus", cfg, wband is not None)
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
    per = lib.rt_poa_scratch_words(N, cfg.max_len, cfg.max_edges, int(glob))
    scratch = torch.empty((B, per), dtype=torch.int32, device=dev)
    counts = None if stats is None else torch.empty(
        (1 + len(PHASES), B), dtype=torch.int64, device=dev)
    p = cuda_lib.ptr
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
    cuda_lib.count_launch(name)
    if counts is not None:
        stats["cells"] = stats.get("cells", 0) + int(counts[0].sum())
        add_phase_cycles(stats, PHASES, counts[1:])
    return outs
