"""Batched partial-order alignment (POA): the plain PyTorch version.

This is the reference the CUDA kernel (ops/poa_cuda.py, csrc/poa.cu) is
held against, and what the wrapper runs for tensors on the CPU. It is a
straight translation of the JAX package's batched POA, one window at a
time:

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

NEG = -(1 << 28)
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
               stats: Optional[dict]) -> None:
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
    for u in order:
        srcs = g.src[u]
        vs = srcs[(srcs >= 0)]
        vs = vs[sub[vs]]
        if len(vs):
            P = H[torch.from_numpy(vs + 1).long()].amax(dim=0)
        else:
            P = H[0]
        sc = torch.where(seq_l == int(g.base[u]), ma, mm).to(torch.int32)
        V = P + gp
        V[1:] = torch.maximum(V[1:], P[:-1] + sc)
        H[u + 1] = torch.cummax(V - jg, dim=0).values + jg
    if stats is not None:
        stats["cells"] = stats.get("cells", 0) + n_sub * (L + 1)
    Hn = H.numpy()
    sq = seq.numpy()

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
    u, j, steps = int(start_u), L, 0
    limit = N + ML + 2
    while not (u == -1 and j == 0) and steps < limit:
        steps += 1
        if u == -1:                  # virtual row: only left moves
            j -= 1
            continue
        cur = Hn[u + 1, j]
        jm1 = max(j - 1, 0)
        sc = ma if int(sq[jm1]) == int(g.base[u]) else mm
        diag_pred = up_pred = -1
        any_valid = any_diag = any_up = False
        for s in g.src[u]:
            if s < 0 or not sub[s]:
                continue
            any_valid = True
            if not any_diag and j > 0 and Hn[s + 1, jm1] + sc == cur:
                any_diag, diag_pred = True, int(s)
            if not any_up and Hn[s + 1, j] + gp == cur:
                any_up, up_pred = True, int(s)
        if not any_valid:
            any_diag = j > 0 and jm1 * gp + sc == cur
            any_up = j * gp + gp == cur
        if any_diag:                 # priority diag > up > left
            pos_node[j - 1] = u
            u, j = diag_pred, j - 1
        elif any_up:
            u = up_pred
        else:
            j -= 1
        if j < 0:                    # unreachable for an exact H
            break
    if not (u == -1 and j == 0):
        g.failed = True

    _update_graph(cfg, g, pos_node, sq, wts, L)


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
                  begins, ends, stats: Optional[dict] = None):
    """One window: init graph, fold in layers, consensus. CPU tensors in;
    (cons_base, cons_cov, cons_len, failed, n_nodes) out."""
    bl = int(bb_len)
    g = _Graph(cfg, bb, bbw, bl)
    ln, bg, en = lens.tolist(), begins.tolist(), ends.tolist()
    for li in range(int(n_layers)):
        L = ln[li]
        if L <= 0 or g.failed:
            continue
        _add_layer(cfg, g, seqs[li], ws[li].numpy(), L, bg[li], en[li], bl,
                   stats)
    cb, cc, cl = _consensus(cfg, g)
    return cb, cc, cl, g.failed, g.n


def poa_batch_plain(cfg: PoaConfig, bb, bbw, bb_len, n_layers, seqs, ws,
                    lens, begins, ends, stats: Optional[dict] = None):
    """Batched POA on the CPU: the same nine arrays, in the same order, as
    the kernel takes; returns (cons_base i32[B,N], cons_cov i32[B,N],
    cons_len i32[B], failed bool[B], n_nodes i32[B]) on the CPU.

    `stats`, when given, accumulates the DP cell count ("cells") that
    the run needed."""
    args = [t.cpu().contiguous() for t in (bb, bbw, bb_len, n_layers, seqs,
                                            ws, lens, begins, ends)]
    bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends = args
    B, N = bb.shape[0], cfg.max_nodes
    cons_base = torch.empty((B, N), dtype=torch.int32)
    cons_cov = torch.empty((B, N), dtype=torch.int32)
    cons_len = torch.empty(B, dtype=torch.int32)
    failed = torch.empty(B, dtype=torch.bool)
    n_nodes = torch.empty(B, dtype=torch.int32)
    for b in range(B):
        cb, cc, cl, fl, nn = polish_window(
            cfg, bb[b], bbw[b], bb_len[b], n_layers[b], seqs[b], ws[b],
            lens[b], begins[b], ends[b], stats)
        cons_base[b] = torch.from_numpy(cb)
        cons_cov[b] = torch.from_numpy(cc)
        cons_len[b], failed[b], n_nodes[b] = cl, fl, nn
    return cons_base, cons_cov, cons_len, failed, n_nodes


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
