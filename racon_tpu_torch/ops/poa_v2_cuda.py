"""The v2 POA consensus kernel (csrc/poa_v2.cu) and its wrapper.

Replaces the JAX package's Pallas kernel ``build_pallas_poa_kernel``
(racon_tpu/ops/poa_pallas.py:73, pallas_call :659), the tier that
``RACON_TPU_POA_KERNEL=v2`` selects there. It computes the same function
as the ls kernel (ops/poa_cuda.py) and the plain version
``poa.poa_batch_plain``.

What bounds it on an H100: one window's serial chain, not bytes or
integer throughput. A batch of up to 256 windows runs at once, one block
each and two blocks an SM, so a launch lasts as long as its slowest
window's chain of DP rows, tracebacks and graph updates, and a DP row
costs what its instructions cost when two windows' warps share the SM.
The design takes global round trips and instructions off that chain: the
graph (int16 in-edge sources, keys, bases, rank order, coverage) lives in
shared memory; a DP row reads near predecessors from a shared ring of the
last rows of H, with its columns unrolled to its share; same-column rank
pairs (``colstep``) run on the two halves of the block at once; the graph
update freezes the rank order, finds each position's matched node in
parallel and merges the layer's new nodes into the order in one pass; the
traceback fetches two steps' move records per trip to memory. H, the move
bytes and the edge weights live in a global scratch allocated here.

The banded build (``wband=``) replaces the Pallas kernel's ``band=True``
build (racon_tpu/ops/poa_pallas.py:73): each window's
DP runs under its half band ``wband`` (0: the flat DP, bit for bit), and
the window's ``band_hit`` comes out beside the five outputs. It computes
every column, as the Pallas build does, and masks the rest. Its DP rows
are the ls kernel's design with v2's cells and records: one block barrier
a row, the row before in registers, and a descriptor and band start a
row built before the layer; it runs no same-column pairs, so its serial
steps are its DP rows whatever ``colstep`` says.

The graph grows with the window, so each launch plans its shared memory
(``plan``; the banded build has a layout of its own): a ring of 8 rows at
-w 500, fewer rows for larger windows, and the in-edge sources in the
global scratch where even 2 rows do not fit. Windows whose max_len + 1
exceeds 2048 run the wide build (16 columns a thread). Where no
shared-memory layout fits (backbone class 2176 and up; 2432 for the flat
build), the plan picks the global build, flat or banded: the graph in the
window's global scratch and the banded build's rows (wband 0 for the flat
one) in tiles of 2048 columns, so no limit on max_len; node ids and band
starts are int16, and int32 in the global build above 32,767 node slots
(``poa_cuda.wide_ids``; launch names ``*_global32``).

A tensor on the CPU goes to the plain version; a tensor on the card goes
to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .poa import PoaConfig, poa_batch_plain
from .poa_cuda import add_phase_cycles, build_name, check_inputs, plan_with

VSLOT = 15        # the move records' virtual-start slot: max_edges <= 15
#: The kernel's timed phases, in the order of stats["phase_cycles"].
PHASES = ("init", "dp", "end_pick", "traceback", "update", "consensus")

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("poa_v2")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_poa_v2_scratch_words.restype = ctypes.c_longlong
        lib.rt_poa_v2_scratch_words.argtypes = [ci, ci, ci, ci]
        lib.rt_poa_v2_launch.restype = ci
        lib.rt_poa_v2_launch.argtypes = [ci] * 9 + [vp] * 20 + [ci, vp]
        lib.rt_poa_v2_plan.restype = ci
        lib.rt_poa_v2_plan.argtypes = [ci, ci, ci, ci, vp]
        _LIB = lib
    return _LIB


def occupancy(cfg: PoaConfig, band: bool = False) -> dict:
    """The kernel's registers, spill bytes, shared bytes and blocks per
    SM at cfg's geometry, flat or banded build (needs the card)."""
    return cuda_lib.occupancy(_lib().rt_poa_v2_occupancy,
                              (cfg.max_nodes, cfg.max_len, int(band)),
                              cuda_lib.POA_OCCUPANCY, "v2 POA kernel")


def plan(cfg: PoaConfig, band: bool = False) -> dict:
    """How a launch of the flat or (`band`) the banded build at cfg's
    geometry lays out a window on this card: the DP rows its shared ring
    holds ("ring": 8, 4 or 2; 0 in the global build), whether the in-edge
    sources are in shared memory ("src_in_shared"), the dynamic shared
    bytes a block ("shared_bytes"), and whether no shared-memory layout
    fits, so that the global build runs ("global_build"). Raises
    ValueError beyond the kernel's limits (needs the card)."""
    return plan_with(_lib().rt_poa_v2_plan, cfg, band, "v2 POA kernel")


def poa_consensus_v2(cfg: PoaConfig, bb, bbw, bb_len, n_layers, seqs, ws,
                     lens, begins, ends, *, colstep: bool = True,
                     stats: Optional[dict] = None, wband=None):
    """Batched POA: (cons_base i32[B,N], cons_cov i32[B,N], cons_len
    i32[B], failed bool[B], n_nodes i32[B]) on the inputs' device.

    Inputs as ``poa.batch_to_tensors`` makes them. `wband`, an i32[B]
    tensor of half bands (0: flat), runs the banded build and appends
    band_hit bool[B] to the outputs. `colstep` pairs same-column ranks
    per serial DP iteration in the flat build (the banded build runs one
    row a step); the outputs do not depend on it. `stats`, when given,
    accumulates the DP cells ("cells") and the serial DP iterations
    ("steps") the batch needed, as the plain version counts them; on the
    card the kernel counts both, and reading them waits for it. On the
    card only, it also accumulates each phase's clock cycles (``PHASES``;
    thread 0 of each window's block reads ``clock64()``): summed over the
    windows ("phase_cycles") and the largest window's
    ("phase_cycles_max"). The launch counts under ``launch_name``: the
    build the plan picks (``poa_cuda.build_name``)."""
    args = (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends)
    if bb.device.type == "cpu":
        return poa_batch_plain(cfg, *args, stats=stats,
                               colstep=colstep and wband is None,
                               wband=wband)
    dev = bb.device
    B = check_inputs(cfg, args, dev)
    if wband is not None:
        cuda_lib.require(wband, "wband", torch.int32, (B,), dev)
    if cfg.max_edges > VSLOT:
        raise ValueError(f"v2 POA kernel takes max_edges <= {VSLOT}, got "
                         f"{cfg.max_edges}")
    glob, name = build_name(plan, "poa_consensus_v2", cfg, wband is not None)
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
    per = lib.rt_poa_v2_scratch_words(N, cfg.max_len, cfg.max_edges,
                                      int(glob))
    scratch = torch.empty((B, per), dtype=torch.int32, device=dev)
    counts = None if stats is None else torch.empty(
        (2 + len(PHASES), B), dtype=torch.int64, device=dev)
    p = cuda_lib.ptr
    with cuda_lib.launch_events(name, bb):
        err = lib.rt_poa_v2_launch(
            N, cfg.max_len, cfg.max_backbone, cfg.max_edges, cfg.depth,
            cfg.match, cfg.mismatch, cfg.gap, int(colstep),
            *(p(t) for t in args), None if wband is None else p(wband),
            p(cons_base), p(cons_cov), p(cons_len), p(failed), p(n_nodes),
            None if wband is None else p(outs[5]),
            None if counts is None else p(counts[0]),
            None if counts is None else p(counts[1]),
            None if counts is None else p(counts[2]), p(scratch), B,
            cuda_lib.stream_of(bb))
    cuda_lib.check(err, "v2 POA consensus kernel")
    cuda_lib.count_launch(name)
    if counts is not None:
        stats["cells"] = stats.get("cells", 0) + int(counts[0].sum())
        stats["steps"] = stats.get("steps", 0) + int(counts[1].sum())
        add_phase_cycles(stats, PHASES, counts[2:])
    return outs
