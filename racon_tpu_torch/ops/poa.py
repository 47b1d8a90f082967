"""Batched partial-order alignment (POA): the plain PyTorch version.

This is the reference both CUDA kernels (ops/poa_cuda.py, csrc/poa.cu;
ops/poa_v2_cuda.py, csrc/poa_v2.cu) are held against, and what their
wrappers run for tensors on the CPU. It is a straight translation of the
JAX package's batched POA, one window at a time:

* the graph lives in fixed-size arrays per window; every node belongs to
  a column with a float32 key (backbone column i has key i, insertion
  columns take keys strictly between their neighbours), so topological
  order is a stable sort by (key, node id);
* per layer: a global sequence-to-graph DP over the subgraph's nodes in
  rank order, whose linear-gap horizontal pass is
  ``H[j] = j*g + cummax(V[j] - j*g)``; a traceback that re-derives each
  move from H; a graph update that merges matched bases into columns,
  allocates insertion columns and bumps edge weights by w[j-1] + w[j];
* consensus: heaviest-bundle scoring over in-edges in rank order, a
  backward walk to a source and a forward walk to a sink, and the node
  coverage of each consensus node.

Under a per-window half band (``wband``, the banded builds) the DP rows
are masked to the band, with the semantics of one of the two Pallas
banded builds: v2's (``_Band``) or ls's (``_walk_ls``), which differ
where a band cuts the path off.

A limit hit (node slots, in-edge slots, traceback budget) sets the
window's ``failed`` flag; the driver re-polishes such a window on the
host. The subgraph is clamped to the n used node slots, as the Pallas
kernels clamp it. All scores are int32, all keys float32: the serial
parts read the tensors through numpy views of the same memory, with
float32 scalars, so that each key operation rounds as the kernel's does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .colstep import n_column_steps

NEG = -(1 << 28)
VSLOT = 15        # move records: the pred slot of the virtual start row
_F = np.float32


class PoaConfig(NamedTuple):
    max_nodes: int = 1536     # node slots per window graph
    max_len: int = 768        # max layer sequence length
    max_backbone: int = 512   # max backbone (window) length
    max_edges: int = 12       # in-edge slots per node
    depth: int = 32           # layer slots (batch bucket)
    match: int = 5
    mismatch: int = -4
    gap: int = -8


class _Graph:
    """One window's graph; the numpy arrays are views of the tensors."""

    def __init__(self, cfg: PoaConfig, bb, bbw, bb_len: int):
        N, E = cfg.max_nodes, cfg.max_edges
        self.t_base = torch.full((N,), -1, dtype=torch.int32)
        self.t_key = torch.full((N,), float("inf"), dtype=torch.float32)
        self.t_cov = torch.zeros(N, dtype=torch.int32)
        self.t_src = torch.full((N, E), -1, dtype=torch.int32)
        self.t_w = torch.zeros((N, E), dtype=torch.int32)
        self.t_base[:bb_len] = bb[:bb_len].to(torch.int32)
        self.t_key[:bb_len] = torch.arange(bb_len, dtype=torch.float32)
        self.t_cov[:bb_len] = 1
        if bb_len > 1:
            w = bbw[:bb_len].to(torch.int32)
            self.t_src[1:bb_len, 0] = torch.arange(bb_len - 1,
                                                   dtype=torch.int32)
            self.t_w[1:bb_len, 0] = w[:-1] + w[1:]
        self.base = self.t_base.numpy()
        self.key = self.t_key.numpy()
        self.cov = self.t_cov.numpy()
        self.src = self.t_src.numpy()
        self.w = self.t_w.numpy()
        self.n = int(bb_len)
        self.failed = False


def _rank_order(key: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Stable sort of `nodes` (ascending ids) by key: ties keep id order."""
    k = torch.from_numpy(key[nodes])
    idx = torch.sort(k, stable=True).indices.numpy()
    return nodes[idx]


def _add_layer(cfg: PoaConfig, g: _Graph, seq: torch.Tensor,
               wts: np.ndarray, L: int, begin: int, end: int, bb_len: int,
               stats: Optional[dict], colstep: bool, wband: int = 0,
               kernel: str = "v2") -> bool:
    """Fold one layer into the graph; returns the layer's band hit (always
    False at wband = 0, the flat DP). Under a band, `kernel` picks the
    banded semantics: v2's (``_Band``) or ls's (``_walk_ls``)."""
    N, E, ML = cfg.max_nodes, cfg.max_edges, cfg.max_len
    gp, ma, mm = cfg.gap, cfg.match, cfg.mismatch
    offset = int(_F(0.01) * _F(bb_len))
    full = begin < offset and end > bb_len - offset
    lo = _F(-np.inf) if full else _F(begin)
    hi = _F(np.inf) if full else _F(end)

    n = g.n
    used_key = g.key[:n]
    sub = np.zeros(N, dtype=bool)
    sub[:n] = (used_key >= lo) & (used_key <= hi)
    order = _rank_order(g.key, np.nonzero(sub)[0])
    n_sub = len(order)

    # --- DP: H[u + 1, j] over the layer's L + 1 columns; row 0 is the
    # virtual start. Rows of nodes not computed (yet) stay NEG.
    jj = torch.arange(L + 1, dtype=torch.int32)
    jg = jj * gp
    H = torch.full((N + 1, L + 1), NEG, dtype=torch.int32)
    H[0] = jg
    seq_l = seq[:L].to(torch.int32)
    band = _Band(cfg, g, order, sub, L, begin, wband) if wband > 0 \
        else None
    Hn, sq = H.numpy(), seq.numpy()
    for u in order:
        if band is not None:
            band.row(Hn, u, sq[:L])
            continue
        srcs = g.src[u]
        sc = torch.where(seq_l == int(g.base[u]), ma, mm).to(torch.int32)
        vs = srcs[(srcs >= 0)]
        vs = vs[sub[vs]]
        if len(vs):
            P = H[torch.from_numpy(vs + 1).long()].amax(dim=0)
        else:
            P = H[0]
        V = P + gp
        V[1:] = torch.maximum(V[1:], P[:-1] + sc)
        H[u + 1] = torch.cummax(V - jg, dim=0).values + jg
    if stats is not None:
        cells = band.cells if band is not None else n_sub * (L + 1)
        stats["cells"] = stats.get("cells", 0) + cells
        steps = n_column_steps(g.key[order]) if colstep else n_sub
        stats["steps"] = stats.get("steps", 0) + steps
        stats["rows"] = stats.get("rows", 0) + n_sub

    # --- traceback from the first best end node in rank order
    has_out = np.zeros(N, dtype=bool)
    srcs = g.src[order].reshape(-1)
    srcs = srcs[srcs >= 0]
    has_out[srcs[sub[srcs]]] = True
    start_u, best = 0, None
    for u in order:
        s = Hn[u + 1, L] if not has_out[u] else NEG
        if best is None or s > best:
            best, start_u = s, u
    pos_node = np.full(L, -1, dtype=np.int64)
    hit = False
    if band is not None:
        start_u, hit = band.end_pick(start_u, best, L)
        if kernel == "ls":
            # rule 1: no end score above NEG fails the layer; rule 2: a
            # layer that fails adds nothing to the graph
            walked = best is not None and best > NEG
            if walked:
                pos_node, touch, walked = _walk_ls(cfg, g, Hn, sub, sq, band,
                                                   int(start_u), L)
                hit |= touch
            if walked:
                _update_graph(cfg, g, pos_node, sq, wts, L)
            else:
                g.failed = True
            return hit
    u, j, steps = int(start_u), L, 0
    limit = N + ML + 2
    walk = band is None or n_sub > 0     # an empty banded subgraph fails
    while walk and not (u == -1 and j == 0) and steps < limit:
        steps += 1
        if u == -1:                  # virtual row: only left moves
            j -= 1
            continue
        if band is not None:
            hit |= band.near(u, j)
        if band is None or u in band.stale:
            move, prd = _rederive(cfg, g, Hn, sub, sq, u, j)
        else:
            move, prd = band.move(u, j)
        if move == 0:                # position j-1 matches u
            if j == 0:               # the banded DP's diagonal off column 0
                break
            pos_node[j - 1] = u
            u, j = prd, j - 1
        elif move == 1:
            u = prd
        else:
            j -= 1
        if j < 0:                    # unreachable for an exact H
            break
    if not (u == -1 and j == 0):
        g.failed = True

    _update_graph(cfg, g, pos_node, sq, wts, L)
    return hit


def _rederive(cfg: PoaConfig, g: _Graph, Hn: np.ndarray, sub: np.ndarray,
              sq: np.ndarray, u: int, j: int, col0: bool = False):
    """The move at (u, j), re-derived from the finished rows of H: the
    diagonal before up, each through the first slot whose row attains the
    cell, else left. Returns (move, predecessor). With `col0` (the ls
    banded build) column 0 has a diagonal too, where the cell is NEG +
    mismatch: the value of a shifted-in NEG plus the mismatch that the
    column's missing base scores."""
    gp, ma, mm = cfg.gap, cfg.match, cfg.mismatch
    cur = Hn[u + 1, j]
    jm1 = max(j - 1, 0)
    sc = ma if int(sq[jm1]) == int(g.base[u]) else mm
    diag0 = col0 and j == 0 and cur == NEG + mm
    diag_pred = up_pred = -1
    any_valid = any_diag = any_up = False
    for s in g.src[u]:
        if s < 0 or not sub[s]:
            continue
        any_valid = True
        if not any_diag and (diag0 or j > 0 and Hn[s + 1, jm1] + sc == cur):
            any_diag, diag_pred = True, int(s)
        if not any_up and Hn[s + 1, j] + gp == cur:
            any_up, up_pred = True, int(s)
    if not any_valid:
        any_diag = diag0 or j > 0 and jm1 * gp + sc == cur
        any_up = j * gp + gp == cur
    if any_diag:                     # priority diag > up > left
        return 0, diag_pred
    if any_up:
        return 1, up_pred
    return 2, -1


class _Band:
    """One layer's banded DP (wband > 0), as the v2 Pallas kernel's banded
    build runs it (racon_tpu/ops/poa_pallas.py, band=True):

    * node u's row is masked to NEG at the columns j with
      ``|j - cexp| > wband``, where ``cexp = int(float32(key[u]) + 0.5) -
      begin`` (truncated, as int32 casts do), after its in-row gap pass;
    * every cell records its move as the kernel does (diagonal before up
      on ties, left only where strictly better, the first slot whose row
      exceeds NEG, else the virtual row), and the traceback follows the
      records, since near the band edge they differ from what H re-derives;
      column 0's diagonal is NEG + mismatch, so a row whose predecessors
      are masked there records it and the walk fails off column 0;
    * a row that reads a predecessor not yet computed (float32 keys equal
      along an edge) re-derives its moves from H, as the CUDA kernel does;
    * band_hit: the best end score's deficit below match x L exceeds
      ``2 |gap| max(wband // 2, 1)``, or the walk comes within one cell of
      the band edge (``|j - cexp| >= wband - 1``) off the virtual row; an
      end score no better than NEG starts the walk on the virtual row.

    ``cells`` counts the cells the band admits (the DP's work). The ls
    banded semantics take its rows, cell count, deficit test and boundary
    test, and walk with ``_walk_ls`` instead of the move records."""

    def __init__(self, cfg, g, order, sub, L, begin, wband):
        self.cfg, self.g, self.sub = cfg, g, sub
        self.jj = np.arange(L + 1, dtype=np.int32)
        self.jg = self.jj * np.int32(cfg.gap)
        self.begin, self.w = begin, wband
        self.MV = np.zeros((cfg.max_nodes + 1, L + 1), dtype=np.int32)
        self.rank = np.full(cfg.max_nodes, cfg.max_nodes, dtype=np.int64)
        self.rank[order] = np.arange(len(order))
        self.stale = set()
        self.cells = 0

    def center(self, u) -> int:
        return int(self.g.key[u] + _F(0.5)) - self.begin

    def row(self, Hn, u, seq):
        """Node u's banded row into Hn[u + 1] (numpy, in place) and its
        move records; `seq` is the layer's L codes."""
        cfg, g = self.cfg, self.g
        L1 = len(self.jj)
        srcs = g.src[u]
        e = np.nonzero(srcs >= 0)[0]
        e = e[self.sub[srcs[e]]]
        done = e[self.rank[srcs[e]] < self.rank[u]]
        if len(done) < len(e):
            self.stale.add(int(u))           # a predecessor not computed yet
        if not len(e):
            P = Hn[0].copy()
            S = np.full(L1, VSLOT, dtype=np.int32)
        elif not len(done):
            P = np.full(L1, NEG, dtype=np.int32)
            S = np.full(L1, VSLOT, dtype=np.int32)
        else:
            # each column: the first slot attaining the max, where the
            # max exceeds NEG (the kernels' strict update from NEG)
            rows = Hn[srcs[done] + 1]
            first = rows.argmax(axis=0)
            mx = rows[first, self.jj]
            S = np.where(mx > NEG, done[first], VSLOT).astype(np.int32)
            P = np.maximum(mx, NEG)
        sc = np.where(seq == g.base[u], cfg.match, cfg.mismatch)
        diag = np.empty(L1, dtype=np.int32)
        diag[0] = NEG + cfg.mismatch
        diag[1:] = P[:-1] + sc
        Ssh = np.empty(L1, dtype=np.int32)
        Ssh[0] = VSLOT
        Ssh[1:] = S[:-1]
        up = P + np.int32(cfg.gap)
        choose_diag = diag >= up
        V = np.where(choose_diag, diag, up)
        vmove = np.where(choose_diag, 4 * Ssh, 1 + 4 * S)
        row = np.maximum.accumulate(V - self.jg) + self.jg
        off = np.abs(self.jj - self.center(u)) > self.w
        row[off] = NEG
        self.MV[u + 1] = np.where(row > V, 2, vmove)
        self.cells += L1 - int(off.sum())
        Hn[u + 1] = row

    def end_pick(self, start_u, best, L):
        cfg = self.cfg
        best_s = NEG if best is None else max(int(best), NEG)
        hit = cfg.match * L - best_s > 2 * (-cfg.gap) * max(self.w // 2, 1)
        if best is not None and best_s <= NEG:
            start_u = -1
        return start_u, bool(hit)

    def near(self, u, j) -> bool:
        return abs(j - self.center(u)) >= self.w - 1

    def move(self, u, j):
        mv = int(self.MV[u + 1, j])
        slot = mv >> 2
        prd = -1 if slot == VSLOT else int(self.g.src[u, slot])
        return mv & 3, prd


def _walk_ls(cfg: PoaConfig, g: _Graph, Hn: np.ndarray, sub: np.ndarray,
             sq: np.ndarray, band: _Band, u: int, L: int):
    """The ls banded build's traceback (racon_tpu/ops/poa_pallas_ls.py,
    band=True) from end node u at column L, over the masked H: at each
    node it walks left to the first cell that a diagonal or an up move
    explains (re-derived, column 0's diagonal included) and takes that
    move. A node where no cell at or left of the entry is explained is
    stuck: the layer fails, and that node's cells are not tested for a
    boundary touch. A diagonal off column 0 into a node fails the layer
    too (the walk enters it left of column 0). Returns (pos_node,
    touch, ok), where touch says that a visited cell came within one cell
    of the band edge."""
    pos_node = np.full(L, -1, dtype=np.int64)
    touch, j, steps = False, L, 0
    limit = cfg.max_nodes + cfg.max_len + 2
    while u != -1:
        near = False
        while True:                  # the node's insertion run
            steps += 1
            if j < 0 or steps > limit:       # stuck
                return pos_node, touch, False
            near |= band.near(u, j)
            move, prd = _rederive(cfg, g, Hn, sub, sq, u, j, col0=True)
            if move != 2:
                break
            j -= 1
        touch |= near
        if move == 0:
            if j == 0:
                return pos_node, touch, prd == -1
            pos_node[j - 1] = u
            j -= 1
        u = prd
    return pos_node, touch, True     # the virtual row: the rest are inserted


def _update_graph(cfg: PoaConfig, g: _Graph, pos_node: np.ndarray,
                  sq: np.ndarray, wts: np.ndarray, L: int) -> None:
    N, ML = cfg.max_nodes, cfg.max_len
    # next matched column key at j' >= j and the remaining insertion-run
    # length, scanned from the end of the max_len row (positions past L
    # are unmatched and count into the run, as the kernel counts them).
    next_key = np.empty(L, dtype=np.float32)
    run_rem = np.empty(L, dtype=np.int64)
    nk, run = _F(np.inf), ML - L
    for j in range(L - 1, -1, -1):
        if pos_node[j] >= 0:
            nk, run = g.key[pos_node[j]], 0
        else:
            run += 1
        next_key[j], run_rem[j] = nk, run

    prev, prev_key, prev_w = -1, _F(-1.0), 0
    for j in range(L):
        b = int(sq[j])
        wj = int(wts[j])
        is_match = pos_node[j] >= 0
        found = -1
        if is_match:
            k0 = g.key[pos_node[j]]
            hit = np.nonzero((g.key == k0) & (g.base == b))[0]
            if len(hit):
                found = int(hit[0])
        nkj = next_key[j]
        hi = nkj if np.isfinite(nkj) else prev_key + _F(1.0)
        rr = _F(run_rem[j])
        lo = prev_key if prev >= 0 else hi - rr - _F(1.0)
        k_new = lo + (hi - lo) / (rr + _F(1.0))
        key_val = k0 if is_match else k_new

        overflow = found < 0 and g.n >= N
        if found >= 0:
            nid = found
        else:
            nid = min(g.n, N - 1)
            if not overflow:
                g.base[nid] = b
                g.key[nid] = key_val
                g.n += 1
        if overflow:
            g.failed = True
        else:
            g.cov[nid] += 1
            if prev >= 0:            # edge prev -> nid, weight w[j-1]+w[j]
                slots = g.src[nid]
                same = np.nonzero(slots == prev)[0]
                if len(same):
                    g.w[nid, same[0]] += prev_w + wj
                else:
                    empty = np.nonzero(slots == -1)[0]
                    if len(empty):
                        g.w[nid, empty[0]] = prev_w + wj
                        g.src[nid, empty[0]] = prev
                    else:
                        g.failed = True
        prev, prev_key, prev_w = nid, g.key[nid], wj


def _consensus(cfg: PoaConfig, g: _Graph):
    N = cfg.max_nodes
    n = g.n
    order = _rank_order(g.key, np.arange(n))
    score = np.zeros(N, dtype=np.int64)
    pred = np.full(N, -1, dtype=np.int64)
    summit, best = int(order[0]), None
    for u in order:
        srcs, ws = g.src[u], g.w[u]
        valid = srcs >= 0
        s, p = 0, -1
        if valid.any():
            wmax = ws[valid].max()
            slot, ps_best = -1, None
            for e in range(len(srcs)):
                if valid[e] and ws[e] == wmax:
                    ps = score[srcs[e]]
                    if ps_best is None or ps > ps_best:
                        slot, ps_best = e, ps
            s, p = int(wmax) + int(ps_best), int(srcs[slot])
        score[u], pred[u] = s, p
        if best is None or s > best:
            best, summit = s, int(u)

    path = []
    u = summit
    while u != -1 and len(path) < N:
        path.append(u)
        u = int(pred[u])
    path.reverse()
    u = summit
    while len(path) < N:
        into = g.src == u                               # edges u -> v
        wv = np.where(into, g.w, NEG).max(axis=1)
        wmax = wv.max()
        if wmax <= NEG:
            break
        cand = np.nonzero(wv == wmax)[0]
        v = int(cand[np.argmax(score[cand])])           # first best
        path.append(v)
        u = v

    cons_base = np.full(N, -1, dtype=np.int32)
    cons_cov = np.zeros(N, dtype=np.int32)
    idx = np.asarray(path, dtype=np.int64)
    cons_base[:len(path)] = g.base[idx]
    cons_cov[:len(path)] = g.cov[idx]
    return cons_base, cons_cov, len(path)


def polish_window(cfg: PoaConfig, bb, bbw, bb_len, n_layers, seqs, ws, lens,
                  begins, ends, stats: Optional[dict] = None,
                  colstep: bool = True, wband: int = 0, kernel: str = "v2"):
    """One window: init graph, fold in layers, consensus. CPU tensors in;
    (cons_base, cons_cov, cons_len, failed, n_nodes, band_hit) out, where
    band_hit ORs the layers' hits under half-band `wband` (0: flat) with
    `kernel`'s banded semantics."""
    bl = int(bb_len)
    g = _Graph(cfg, bb, bbw, bl)
    ln, bg, en = lens.tolist(), begins.tolist(), ends.tolist()
    hit = False
    for li in range(int(n_layers)):
        L = ln[li]
        if L <= 0 or g.failed:
            continue
        hit |= _add_layer(cfg, g, seqs[li], ws[li].numpy(), L, bg[li],
                          en[li], bl, stats, colstep, wband, kernel)
    cb, cc, cl = _consensus(cfg, g)
    return cb, cc, cl, g.failed, g.n, hit


def poa_batch_plain(cfg: PoaConfig, bb, bbw, bb_len, n_layers, seqs, ws,
                    lens, begins, ends, stats: Optional[dict] = None,
                    colstep: bool = True, wband=None, kernel: str = "v2"):
    """Batched POA on the CPU: the same nine arrays, in the same order, as
    the kernels take; returns (cons_base i32[B,N], cons_cov i32[B,N],
    cons_len i32[B], failed bool[B], n_nodes i32[B]) on the CPU.

    `wband`, when given (i32[B], the banded build's input), runs each
    window's DP under its half band (0: flat, exactly the flat outputs)
    and appends band_hit bool[B] to the outputs. `kernel` says whose
    banded build to follow where they differ: "v2"'s (``_Band``: moves
    recorded, an end score no better than NEG starts the walk on the
    virtual row) or "ls"'s (racon_tpu/ops/poa_pallas_ls.py band=True:
    moves re-derived from the masked H by ``_walk_ls``; rule 1, an end
    score no better than NEG fails the layer; rule 2, a layer that fails
    adds nothing to the graph). Without `wband` it changes nothing.

    `stats`, when given, accumulates the DP cells ("cells": those the band
    admits, every cell where wband is 0) and DP rows ("rows": subgraph
    nodes summed over the layers) that the run needed, and the serial DP
    iterations ("steps") of the v2 kernel's loop over each layer's
    subgraph: ``n_column_steps`` of its rank-ordered keys with `colstep`,
    its node count without. The outputs do not depend on `colstep`."""
    args = [t.cpu().contiguous() for t in (bb, bbw, bb_len, n_layers, seqs,
                                            ws, lens, begins, ends)]
    bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends = args
    B, N = bb.shape[0], cfg.max_nodes
    wb = [0] * B if wband is None else wband.cpu().tolist()
    cons_base = torch.empty((B, N), dtype=torch.int32)
    cons_cov = torch.empty((B, N), dtype=torch.int32)
    cons_len = torch.empty(B, dtype=torch.int32)
    failed = torch.empty(B, dtype=torch.bool)
    n_nodes = torch.empty(B, dtype=torch.int32)
    band_hit = torch.empty(B, dtype=torch.bool)
    for b in range(B):
        cb, cc, cl, fl, nn, hit = polish_window(
            cfg, bb[b], bbw[b], bb_len[b], n_layers[b], seqs[b], ws[b],
            lens[b], begins[b], ends[b], stats, colstep, wb[b], kernel)
        cons_base[b] = torch.from_numpy(cb)
        cons_cov[b] = torch.from_numpy(cc)
        cons_len[b], failed[b], n_nodes[b], band_hit[b] = cl, fl, nn, hit
    outs = (cons_base, cons_cov, cons_len, failed, n_nodes)
    return outs if wband is None else outs + (band_hit,)


def batch_to_tensors(packed, device) -> tuple:
    """poa_driver._pack's 10-tuple of numpy arrays -> the nine kernel
    inputs as tensors on `device` (the trailing band row is dropped)."""
    bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends = packed[:9]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    return (t(bb, np.uint8), t(bbw, np.int32), t(bb_len, np.int32),
            t(n_layers, np.int32), t(seqs, np.uint8), t(ws, np.int32),
            t(lens, np.int32), t(begins, np.int32), t(ends, np.int32))
