"""The v2 POA consensus kernel (csrc/poa_v2.cu) and its wrapper.

Replaces the JAX package's Pallas kernel ``build_pallas_poa_kernel``
(racon_tpu/ops/poa_pallas.py:73, pallas_call :659), the tier that
``RACON_TPU_POA_KERNEL=v2`` selects there. It computes the same function
as the ls kernel (ops/poa_cuda.py) and the plain version
``poa.poa_batch_plain``, with the v2 design: per-cell move records, so the
traceback is one load per step; a rank order kept sorted through the
graph update instead of rebuilt per layer; end-node selection fused into
the DP sweep; and with ``colstep`` same-column rank pairs retired in one
serial iteration.

What bounds it on an H100: the serial chains of POA (one DP row after
another, the traceback, the update), not bytes or integer throughput. H
and the move bytes, (N + 1) x (max_len + 1) cells per window, live in a
global scratch allocated here; many windows run at once.

A tensor on the CPU goes to the plain version; a tensor on the card goes
to the kernel, or the wrapper raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .poa import PoaConfig, poa_batch_plain
from .poa_cuda import check_inputs

VSLOT = 15        # the move records' virtual-start slot: max_edges <= 15

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("poa_v2")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_poa_v2_scratch_words.restype = ctypes.c_longlong
        lib.rt_poa_v2_scratch_words.argtypes = [ci, ci, ci]
        lib.rt_poa_v2_launch.restype = ci
        lib.rt_poa_v2_launch.argtypes = [ci] * 9 + [vp] * 17 + [ci, vp]
        _LIB = lib
    return _LIB


def poa_consensus_v2(cfg: PoaConfig, bb, bbw, bb_len, n_layers, seqs, ws,
                     lens, begins, ends, *, colstep: bool = True,
                     stats: Optional[dict] = None):
    """Batched POA: (cons_base i32[B,N], cons_cov i32[B,N], cons_len
    i32[B], failed bool[B], n_nodes i32[B]) on the inputs' device.

    Inputs as ``poa.batch_to_tensors`` makes them. `colstep` pairs
    same-column ranks per serial DP iteration; the outputs do not depend
    on it. `stats`, when given, accumulates the DP cells ("cells") and
    the serial DP iterations ("steps") the batch needed, as the plain
    version counts them; on the card the kernel counts both, and reading
    them waits for it."""
    args = (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends)
    if bb.device.type == "cpu":
        return poa_batch_plain(cfg, *args, stats=stats, colstep=colstep)
    dev = bb.device
    B = check_inputs(cfg, args, dev)
    if cfg.max_edges > VSLOT:
        raise ValueError(f"v2 POA kernel takes max_edges <= {VSLOT}, got "
                         f"{cfg.max_edges}")
    N = cfg.max_nodes
    cons_base = torch.empty((B, N), dtype=torch.int32, device=dev)
    cons_cov = torch.empty((B, N), dtype=torch.int32, device=dev)
    cons_len = torch.empty(B, dtype=torch.int32, device=dev)
    failed = torch.empty(B, dtype=torch.bool, device=dev)
    n_nodes = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return cons_base, cons_cov, cons_len, failed, n_nodes
    lib = _lib()
    per = lib.rt_poa_v2_scratch_words(N, cfg.max_len, cfg.max_edges)
    scratch = torch.empty((B, per), dtype=torch.int32, device=dev)
    counts = None if stats is None else torch.empty((2, B), dtype=torch.int64,
                                                    device=dev)
    p = cuda_lib.ptr
    err = lib.rt_poa_v2_launch(
        N, cfg.max_len, cfg.max_backbone, cfg.max_edges, cfg.depth,
        cfg.match, cfg.mismatch, cfg.gap, int(colstep),
        *(p(t) for t in args),
        p(cons_base), p(cons_cov), p(cons_len), p(failed), p(n_nodes),
        None if counts is None else p(counts[0]),
        None if counts is None else p(counts[1]), p(scratch), B,
        cuda_lib.stream_of(bb))
    cuda_lib.check(err, "v2 POA consensus kernel")
    cuda_lib.LAUNCHES["poa_consensus_v2"] += 1
    if counts is not None:
        cells, steps = counts.sum(dim=1).tolist()
        stats["cells"] = stats.get("cells", 0) + cells
        stats["steps"] = stats.get("steps", 0) + steps
    return cons_base, cons_cov, cons_len, failed, n_nodes
