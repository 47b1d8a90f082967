"""racon_tpu_torch's POA against the JAX package's.

One numpy batch goes through the JAX twin (``build_poa_kernel``), the
lane-lockstep Pallas kernel in interpret mode, and the port's plain
PyTorch version on the CPU. The plain version must equal the twin on all
five outputs exactly (tolerance 0: every output is an integer), and the
lockstep kernel on consensus, coverage and length wherever it did not
fail. The CUDA kernel is compared with the plain version in
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch

from racon_tpu.ops import poa as jpoa
from racon_tpu.ops import poa_pallas_ls
from racon_tpu_torch.ops import poa, poa_cuda, poa_driver
from racon_tpu_torch.tools import batches
from tests.test_pallas import mutate
from tests.test_pallas_ls import CFG, _alloc, _set_window


def _args(a):
    return (a["bb"], a["bbw"], a["bb_len"], a["nl"], a["seqs"], a["ws"],
            a["lens"], a["bg"], a["en"])


def _jax(cfg, a):
    return [np.asarray(x) for x in jpoa.build_poa_kernel(cfg)(*_args(a))]


def _plain(cfg, a):
    t = poa.batch_to_tensors(_args(a) + (None,), "cpu")
    return [x.numpy() for x in poa_cuda.poa_consensus(cfg, *t)]


def _assert_equal(want, got):
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                      err_msg=f"output {k}")


def _mixed_batch():
    """The mixed 8-window batch of tests/test_pallas_ls.py: perfect reads,
    rising mutation and depth, quality weights, partial spans, and a
    1-base padding window."""
    rng = random.Random(7)
    a = _alloc(8, CFG)
    truth0 = bytes(rng.choice(b"ACGT") for _ in range(90))
    _set_window(a, 0, truth0, [truth0] * 4)
    for b in range(1, 5):
        truth = bytes(rng.choice(b"ACGT") for _ in range(60 + 15 * b))
        _set_window(a, b, mutate(truth, 0.05 * b, rng),
                    [mutate(truth, 0.05 * b, rng) for _ in range(2 + b)])
    truth5 = bytes(rng.choice(b"ACGT") for _ in range(80))
    layers5 = [mutate(truth5, 0.1, rng) for _ in range(5)]
    w5 = [np.array([rng.randrange(1, 50) for _ in range(len(x))], np.int32)
          for x in layers5]
    _set_window(a, 5, mutate(truth5, 0.1, rng), layers5, weights=w5)
    truth6 = bytes(rng.choice(b"ACGT") for _ in range(120))
    backbone6 = mutate(truth6, 0.08, rng)
    half = len(backbone6) // 2
    lay_a = mutate(truth6[:len(truth6) // 2], 0.08, rng)
    lay_b = mutate(truth6[len(truth6) // 2:], 0.08, rng)
    lay_c = mutate(truth6, 0.08, rng)
    _set_window(a, 6, backbone6, [lay_c, lay_a, lay_b],
                begins=[0, 0, half],
                ends=[len(backbone6) - 1, half - 1, len(backbone6) - 1])
    return a


def _fuzz_batch(seed, cfg=CFG, B=8):
    rng = random.Random(seed)
    a = _alloc(B, cfg)
    for b in range(B):
        truth = bytes(rng.choice(b"ACGT") for _ in range(rng.randrange(40,
                                                                       110)))
        backbone = mutate(truth, rng.uniform(0.02, 0.12), rng)
        nl = rng.randrange(2, cfg.depth + 1)
        layers = [mutate(truth, rng.uniform(0.02, 0.12), rng)
                  for _ in range(nl)]
        w = [np.array([rng.randrange(1, 60) for _ in range(len(x))],
                      np.int32) for x in layers]
        begins, ends = [0] * nl, [len(backbone) - 1] * nl
        if nl >= 3:
            begins[-1], ends[-1] = len(backbone) // 3, 2 * len(backbone) // 3
            layers[-1] = layers[-1][:max(1, len(layers[-1]) // 3)]
            w[-1] = w[-1][:len(layers[-1])]
        _set_window(a, b, backbone, layers, weights=w, begins=begins,
                    ends=ends)
        a["bbw"][b, :len(backbone)] = [rng.randrange(0, 60)
                                       for _ in range(len(backbone))]
    return a


def _lockstep(cfg, a):
    fn = poa_pallas_ls.build_lockstep_poa_kernel(cfg, interpret=True)(
        len(a["bb"]))
    cb, cc, cl, fl, _ = (np.asarray(x) for x in fn(
        a["bb_len"][:, None], a["nl"][:, None], a["lens"], a["bg"],
        a["en"], a["bb"].astype(np.int32), a["bbw"],
        a["seqs"].astype(np.int32), a["ws"]))
    return cb, cc, cl[:, 0], fl[:, 0]


def test_mixed_batch_equals_jax_twin_and_lockstep():
    a = _mixed_batch()
    got = _plain(CFG, a)
    _assert_equal(_jax(CFG, a), got)
    assert not got[3].any()
    cb, cc, cl, fl = _lockstep(CFG, a)
    for b in range(8):
        if fl[b]:
            continue
        n = int(cl[b])
        assert int(got[2][b]) == n
        np.testing.assert_array_equal(got[0][b, :n], cb[b, :n])
        np.testing.assert_array_equal(got[1][b, :n], cc[b, :n])


@pytest.mark.parametrize("seed", [101, 202, 303])
def test_fuzz_equals_jax_twin(seed):
    a = _fuzz_batch(seed)
    _assert_equal(_jax(CFG, a), _plain(CFG, a))


def test_fuzz_equals_lockstep():
    a = _fuzz_batch(404)
    got = _plain(CFG, a)
    cb, cc, cl, fl = _lockstep(CFG, a)
    assert not fl.all()
    for b in np.nonzero(fl == 0)[0]:
        n = int(cl[b])
        assert int(got[2][b]) == n
        np.testing.assert_array_equal(got[0][b, :n], cb[b, :n])
        np.testing.assert_array_equal(got[1][b, :n], cc[b, :n])


def test_depth_200_batch_equals_jax_twin():
    """A batch in the DEPTH_CAP bucket: windows deeper than the 32 bucket."""
    cfg = CFG._replace(depth=poa_driver.DEPTH_CAP)
    rng = random.Random(9)
    a = _alloc(2, cfg)
    for b, nl in enumerate((40, 60)):
        truth = bytes(rng.choice(b"ACGT") for _ in range(45))
        _set_window(a, b, mutate(truth, 0.08, rng),
                    [mutate(truth, 0.08, rng) for _ in range(nl)])
    _assert_equal(_jax(cfg, a), _plain(cfg, a))


def test_overflow_fails_window():
    """Node slots run out: the window is flagged failed, as in the twin."""
    cfg = CFG._replace(max_nodes=128)
    rng = random.Random(3)
    a = _alloc(1, cfg)
    truth = bytes(rng.choice(b"ACGT") for _ in range(100))
    _set_window(a, 0, truth, [bytes(rng.choice(b"ACGT") for _ in range(100))
                              for _ in range(3)])
    want, got = _jax(cfg, a), _plain(cfg, a)
    assert got[3][0] and want[3][0]
    np.testing.assert_array_equal(got[4], want[4])


def test_wrapper_rejects_bad_input():
    t = list(poa.batch_to_tensors(_args(_alloc(2, CFG)) + (None,), "meta"))
    t[0] = t[0].int()
    with pytest.raises(ValueError):
        poa_cuda.poa_consensus(CFG, *t)


# --- models of the CUDA kernel's bookkeeping (csrc/poa.cu), held against
# the plain version on its own graphs

#: Small ls windows (tools.batches): (seed, mutation rate, half bands or
#: None for flat); the banded ones include layers that fail rule 1 and a
#: walk that gets stuck (tests/test_torch_cuda.py LS_BAND_CASES).
LS_CFG = poa.PoaConfig(512, 128, 128, 8, 8, 5, -4, -8)
FAR_CFG = poa.PoaConfig(384, 256, 128, 12, 6, 5, -4, -8)


def _record_model(cfg, g, Hn, sub, rank, sq, u, L, band):
    """The move record csrc/poa.cu's DP writes at each column of node u's
    row, as (move, predecessor) pairs, or None for a row that read a
    predecessor ranked after it (the kernel re-derives those). In band a
    diagonal (up) is taken where the cell equals the largest computed
    predecessor value plus the score (gap), through the first slot that
    attains it; at a masked cell through the first slot whose value is NEG
    less the score (gap); column 0's diagonal (banded) where the cell is
    NEG + mismatch."""
    NEG, gp = poa.NEG, cfg.gap
    srcs = g.src[u]
    valid = [e for e in range(cfg.max_edges) if srcs[e] >= 0 and sub[srcs[e]]]
    if any(rank[srcs[e]] >= rank[u] for e in valid):
        return None
    jj = np.arange(L + 1)
    if valid:
        vals = Hn[srcs[valid] + 1, :L + 1].astype(np.int64)
        preds = [int(srcs[e]) for e in valid]
    else:
        vals = (jj * gp)[None, :]
        preds = [-1]
    M, S = vals.max(axis=0), vals.argmax(axis=0)
    row = Hn[u + 1, :L + 1].astype(np.int64)
    sc = np.where(sq[:L] == g.base[u], cfg.match, cfg.mismatch)
    off = (np.abs(jj - band.center(u)) > band.w if band is not None
           else np.zeros(L + 1, bool))
    out = []
    for j in range(L + 1):
        if band is not None and j == 0 and row[0] == NEG + cfg.mismatch:
            out.append((0, preds[0]))
            continue
        if off[j]:
            d = np.nonzero(vals[:, j - 1] == NEG - sc[j - 1])[0] if j else []
            up = np.nonzero(vals[:, j] == NEG - gp)[0]
            if len(d):
                out.append((0, preds[d[0]]))
            elif len(up):
                out.append((1, preds[up[0]]))
            else:
                out.append((2, -1))
        elif j and row[j] == M[j - 1] + sc[j - 1]:
            out.append((0, preds[S[j - 1]]))
        elif row[j] == M[j] + gp:
            out.append((1, preds[S[j]]))
        else:
            out.append((2, -1))
    return out


def _check_records(cfg, g, Hn, sub, sq, L, band, rederive):
    """Every record of the layer equals the plain version's re-derived
    move at that cell; returns the cells held."""
    order = poa._rank_order(g.key, np.nonzero(sub)[0])
    rank = np.full(cfg.max_nodes, cfg.max_nodes)
    rank[order] = np.arange(len(order))
    held = 0
    for u in order:
        recs = _record_model(cfg, g, Hn, sub, rank, sq, int(u), L, band)
        for j, rec in enumerate(recs or ()):
            want = rederive(cfg, g, Hn, sub, sq, int(u), j,
                            col0=band is not None)
            assert rec == want, (int(u), j, rec, want)
            held += 1
    return held


@pytest.mark.parametrize("case", ["flat", "banded", "far_flat", "far_banded"])
def test_move_record_model_equals_rederive(monkeypatch, case):
    """csrc/poa.cu's move records, modelled in numpy, give at every cell of
    every layer the move the plain ls traceback re-derives from H: flat,
    and banded (masked cells, rule-1 failures, a stuck walk) on small
    windows and on windows with edges longer than any ring of rows."""
    rederive, walk_ls = poa._rederive, poa._walk_ls
    held = []
    seen = set()

    def spy_rederive(cfg, g, Hn, sub, sq, u, j, col0=False):
        if not col0 and id(Hn) not in seen:
            seen.add(id(Hn))
            held.append(_check_records(cfg, g, Hn, sub, sq, Hn.shape[1] - 1,
                                       None, rederive))
        return rederive(cfg, g, Hn, sub, sq, u, j, col0)

    def spy_walk(cfg, g, Hn, sub, sq, band, u, L):
        held.append(_check_records(cfg, g, Hn, sub, sq, L, band, rederive))
        return walk_ls(cfg, g, Hn, sub, sq, band, u, L)

    monkeypatch.setattr(poa, "_rederive", spy_rederive)
    monkeypatch.setattr(poa, "_walk_ls", spy_walk)
    if case.startswith("far"):
        cfg, packed = FAR_CFG, batches.far_pred_batch(FAR_CFG, 2)
        wband = [8, 120]
    else:
        cfg = LS_CFG
        packed = batches.poa_batch(cfg, 3, 5, 60, 0.15)
        wband = [3, 2, 9]
    t = poa.batch_to_tensors(packed, "cpu")
    wb = None if case.endswith("flat") else torch.tensor(wband,
                                                         dtype=torch.int32)
    out = poa.poa_batch_plain(cfg, *t, wband=wb, kernel="ls")
    assert sum(held) > 1000
    if case == "banded":
        assert out[3].any()   # a layer failed: rule 1 or a stuck walk


def _merged_order(key, order, n, nn):
    """csrc/poa.cu's merge_new: the layer's new ids [n, nn) merged into
    the frozen order of the n old ids by counting, each old node at its
    rank plus the new keys below its key, each new one at its place among
    the new (by key, then id) plus the old keys <= its key."""
    new = np.arange(n, nn)
    old_keys = key[order]
    out = np.empty(nn, np.int64)
    for i, o in enumerate(order):
        out[i + int((key[new] < key[o]).sum())] = o
    for m, v in enumerate(new):
        before = int(((key[new] < key[v]) | ((key[new] == key[v]) &
                                             (new < v))).sum())
        out[before + int((old_keys <= key[v]).sum())] = v
    return out


def test_merged_order_model_equals_rank_order(monkeypatch):
    """The rank order csrc/poa.cu keeps by one merge a layer, modelled in
    numpy, equals the stable key-then-id order (_rank_order, which the
    kernel's earlier rebuild_order computed) after every layer of the
    test batches, float32 key collisions included."""
    update = poa._update_graph
    layers = []

    def spy(cfg, g, pos_node, sq, wts, L):
        n = g.n
        order = poa._rank_order(g.key, np.arange(n))
        update(cfg, g, pos_node, sq, wts, L)
        got = _merged_order(g.key, order, n, g.n)
        np.testing.assert_array_equal(got, poa._rank_order(g.key,
                                                           np.arange(g.n)))
        layers.append(g.n - n)

    monkeypatch.setattr(poa, "_update_graph", spy)
    eq_cfg = CFG._replace(max_nodes=384, max_len=256, max_backbone=128,
                          depth=16)
    for cfg, packed in ((LS_CFG, batches.poa_batch(LS_CFG, 4, 4, 80, 0.2)),
                        (eq_cfg, batches.equal_key_batch(eq_cfg)),
                        (FAR_CFG, batches.far_pred_batch(FAR_CFG, 2))):
        poa.poa_batch_plain(cfg, *poa.batch_to_tensors(packed, "cpu"),
                            kernel="ls")
    assert len(layers) > 50 and max(layers) >= 100


def test_far_pred_batch_holds_far_in_subgraph_edges():
    """batches.far_pred_batch's graphs, as the plain version builds them,
    hold an edge whose target ranks more than 64 after its source, and
    the layers after the first (full span: every node in the subgraph)
    read it."""
    packed = batches.far_pred_batch(FAR_CFG)
    bb, bbw, bb_len, nl, seqs, ws, lens, bg, en = poa.batch_to_tensors(
        packed, "cpu")
    n = int(bb_len[0])
    assert (bg == 0).all() and (en == n - 1).all() and (nl > 1).all()
    for b in range(bb.shape[0]):
        g = poa._Graph(FAR_CFG, bb[b], bbw[b], n)
        for li in range(int(nl[b])):
            poa._add_layer(FAR_CFG, g, seqs[b, li], ws[b, li].numpy(),
                           int(lens[b, li]), 0, n - 1, n, None, True)
            if li == 0:
                order = poa._rank_order(g.key, np.arange(g.n))
                rank = np.empty(g.n, np.int64)
                rank[order] = np.arange(g.n)
                far = max(int(rank[v] - rank[s]) for v in range(g.n)
                          for s in g.src[v] if s >= 0)
                assert far > 64
        assert not g.failed
