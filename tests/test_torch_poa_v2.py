"""racon_tpu_torch's v2 POA tier against the JAX package's.

The JAX package's v2 Pallas kernel (``build_pallas_poa_kernel``, interpret
mode on the CPU) and the port's plain PyTorch version, which the port's v2
wrapper runs for CPU tensors, take one numpy batch. ``failed`` must agree
on every window, and all five outputs on every window v2 did not fail
(tolerance 0: every output is an integer). End to end,
``TorchPolisher(device="cpu", poa_kernel="v2")`` must write the same
FASTA as ``racon_tpu.TpuPolisher`` serving its v2 tier in interpret mode.
The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py and by chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import racon_tpu
import racon_tpu_torch
from racon_tpu.ops import colstep as jcolstep
from racon_tpu.ops import poa_pallas
from racon_tpu_torch import cli
from racon_tpu_torch.ops import (colstep, poa, poa_cuda, poa_driver,
                                 poa_v2_cuda)
from racon_tpu_torch.tools import batches
from tests.test_pallas import mutate
from tests.test_pallas_ls import CFG, _alloc, _set_window
from tests.test_torch_poa import _args, _fuzz_batch, _mixed_batch
from tests.test_torch_polish import KW, _paf_dataset


def _pallas_v2(cfg, a, colstep_on):
    fn = poa_pallas.build_pallas_poa_kernel(
        cfg, interpret=True, colstep=colstep_on)(len(a["bb"]))
    cb, cc, cl, fl, nn = (np.asarray(x) for x in fn(
        a["bb_len"][:, None], a["nl"][:, None], a["lens"], a["bg"],
        a["en"], a["bb"].astype(np.int32), a["bbw"],
        a["seqs"].astype(np.int32), a["ws"]))
    return [cb, cc, cl[:, 0], fl[:, 0].astype(bool), nn[:, 0]]


def _plain_v2(cfg, a, colstep_on, stats=None):
    t = poa.batch_to_tensors(_args(a) + (None,), "cpu")
    return [x.numpy() for x in poa_v2_cuda.poa_consensus_v2(
        cfg, *t, colstep=colstep_on, stats=stats)]


def _assert_v2_equal(cfg, a, colstep_on):
    want = _pallas_v2(cfg, a, colstep_on)
    got = _plain_v2(cfg, a, colstep_on)
    np.testing.assert_array_equal(got[3], want[3], err_msg="failed")
    for b in np.nonzero(~want[3])[0]:
        for k, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(
                np.asarray(g[b]).astype(np.int64),
                np.asarray(w[b]).astype(np.int64),
                err_msg=f"window {b} output {k}")
    return got


@pytest.mark.parametrize("colstep_on", [True, False])
def test_mixed_batch_equals_pallas_v2(colstep_on):
    got = _assert_v2_equal(CFG, _mixed_batch(), colstep_on)
    assert not got[3].any()


@pytest.mark.parametrize("colstep_on", [True, False])
@pytest.mark.parametrize("seed", [101, 202, 303])
def test_fuzz_equals_pallas_v2(seed, colstep_on):
    _assert_v2_equal(CFG, _fuzz_batch(seed), colstep_on)


def test_overflow_window_fails_as_pallas_v2():
    """Node slots run out: failed and n_nodes agree with the v2 kernel."""
    cfg = CFG._replace(max_nodes=128)
    rng = random.Random(3)
    a = _alloc(1, cfg)
    truth = bytes(rng.choice(b"ACGT") for _ in range(100))
    _set_window(a, 0, truth, [bytes(rng.choice(b"ACGT") for _ in range(100))
                              for _ in range(3)])
    want, got = _pallas_v2(cfg, a, True), _plain_v2(cfg, a, True)
    assert got[3][0] and want[3][0]
    np.testing.assert_array_equal(got[4], want[4])


_KEY_LISTS = {
    "chain": [0.0, 1.0, 2.0, 3.0],
    "bubble": [0.0, 1.0, 1.0, 2.0],
    "branch_heavy": [0.0, 1.0, 1.0, 1.0, 2.0, 2.0],
    "one_column": [5.0] * 8,
    "empty": [],
    "random": sorted(random.Random(11).choice((0.5, 1.0, 1.5, 2.0, 2.25,
                                               3.0)) for _ in range(37)),
}


@pytest.mark.parametrize("name", sorted(_KEY_LISTS))
def test_colstep_copy_equals_jax(name):
    keys = _KEY_LISTS[name]
    assert colstep.pair_schedule(keys) == jcolstep.pair_schedule(keys)
    assert colstep.n_column_steps(keys) == jcolstep.n_column_steps(keys)
    assert colstep.compression(keys) == jcolstep.compression(keys)
    assert colstep.PACK == jcolstep.PACK


def test_plain_steps_count_column_steps(monkeypatch):
    """stats["steps"] is the sum over layers of n_column_steps of the
    subgraph's rank-ordered keys with colstep, its node count without;
    the cells and the outputs do not depend on colstep."""
    seen = []

    def spy(keys):
        seen.append(np.array(keys))
        return colstep.n_column_steps(keys)

    monkeypatch.setattr(poa, "n_column_steps", spy)
    a = _fuzz_batch(505)
    on, off = {}, {}
    got_on = _plain_v2(CFG, a, True, on)
    got_off = _plain_v2(CFG, a, False, off)
    assert seen and all((np.diff(k) >= 0).all() for k in seen)
    assert on["steps"] == sum(jcolstep.n_column_steps(k) for k in seen)
    assert off["steps"] == on["rows"] == sum(len(k) for k in seen)
    assert on["steps"] < off["steps"]
    assert on["cells"] == off["cells"] > 0
    for w, g in zip(got_on, got_off):
        np.testing.assert_array_equal(w, g)


def test_paf_polish_byte_identical_to_jax_v2(tmp_path, monkeypatch):
    paths = _paf_dataset(tmp_path)
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", poa_kernel="v2",
                                      **KW)
    p.initialize()
    got = p.polish(True)
    for k, v in {"RACON_TPU_PALLAS": "1", "RACON_TPU_POA_KERNEL": "v2",
                 "RACON_TPU_DEVICE_ALIGNER": "hirschberg"}.items():
        monkeypatch.setenv(k, v)
    q = racon_tpu.TpuPolisher(*paths, **KW)
    q.initialize()
    assert got == q.polish(True)
    assert q.report.as_dict()["phases"]["consensus"]["served"]["v2"] > 0
    assert p.stats["consensus"]["device"] > 0


def test_cli_poa_kernel_v2_writes_the_same_fasta(tmp_path, capsys):
    """--poa-kernel v2, --poa-kernel ls and the default write one FASTA."""
    paths = _paf_dataset(tmp_path)
    flags = ["--device", "cpu", "-w", "100", "-m", "5", "-x", "-4", "-g",
             "-8"]
    assert cli.main(flags + ["--poa-kernel", "ls"] + list(paths)) == 0
    ls_out = capsys.readouterr().out
    assert cli.main(flags + ["--poa-kernel", "v2"] + list(paths)) == 0
    assert capsys.readouterr().out == ls_out != ""
    assert cli.main(flags + list(paths)) == 0
    assert capsys.readouterr().out == ls_out


def test_bad_poa_kernel_raises(tmp_path):
    paths = _paf_dataset(tmp_path)
    with pytest.raises(ValueError, match="poa_kernel"):
        racon_tpu_torch.TorchPolisher(*paths, device="cpu",
                                      poa_kernel="xla", **KW)
    with pytest.raises(ValueError, match="poa_kernel"):
        poa_driver.kernel_for("lockstep")
    assert poa_driver.kernel_for("v2") is poa_v2_cuda.poa_consensus_v2


def test_v2_wrapper_rejects_bad_input():
    t = list(poa.batch_to_tensors(_args(_alloc(2, CFG)) + (None,), "meta"))
    bad = list(t)
    bad[0] = bad[0].int()
    with pytest.raises(ValueError, match="bb"):
        poa_v2_cuda.poa_consensus_v2(CFG, *bad)
    with pytest.raises(ValueError, match="max_edges"):
        poa_v2_cuda.poa_consensus_v2(CFG._replace(max_edges=16), *t)


def _late_predecessors(cfg, packed):
    """Per window of an equal_key_batch, over the layers the plain version
    folds in: the subgraph nodes whose in-subgraph predecessors all rank
    after them, and those with some ranked after them, some before."""
    t = poa.batch_to_tensors(packed, "cpu")
    res = []
    for b in range(t[0].shape[0]):
        bb, bbw, bb_len, nl, seqs, ws, lens, begins, ends = (x[b] for x in t)
        n = int(bb_len)
        assert int(np.float32(0.01) * n) == 0   # no layer spans the window
        g = poa._Graph(cfg, bb, bbw, n)
        all_late = mixed = 0
        for li in range(int(nl)):
            if g.failed:
                break
            lo, hi = np.float32(begins[li]), np.float32(ends[li])
            sub = np.zeros(cfg.max_nodes, bool)
            sub[:g.n] = (g.key[:g.n] >= lo) & (g.key[:g.n] <= hi)
            order = poa._rank_order(g.key, np.nonzero(sub)[0])
            rank = {int(u): r for r, u in enumerate(order)}
            for u in order:
                ps = [rank[int(s)] for s in g.src[u] if s >= 0 and sub[s]]
                late = sum(r > rank[int(u)] for r in ps)
                all_late += bool(late) and late == len(ps)
                mixed += 0 < late < len(ps)
            poa._add_layer(cfg, g, seqs[li], ws[li].numpy(), int(lens[li]),
                           int(begins[li]), int(ends[li]), n, None, True)
        res.append((all_late, mixed, g.failed))
    return res


def test_equal_key_batch_meets_late_predecessors():
    """The batch that holds the kernels to the plain version where a DP
    row's predecessor is not computed yet (tests/test_torch_cuda.py) has
    such rows: with every predecessor late (the window then fails), and
    with some late, some not (it may not fail)."""
    cfg = poa.PoaConfig(max_nodes=384, max_len=256, max_backbone=128,
                        depth=16)
    res = _late_predecessors(cfg, batches.equal_key_batch(cfg))
    assert all(a > 0 and f for a, _, f in res if a)
    assert sum(a > 0 for a, _, _ in res) >= 3
    assert any(m > 0 and not f for a, m, f in res)
    plain = poa.poa_batch_plain(cfg, *poa.batch_to_tensors(
        batches.equal_key_batch(cfg), "cpu"))
    assert plain[3].tolist() == [f for _, _, f in res]


def test_v2_two_windows_deep_batch_equals_pallas_v2():
    """Deeper windows than the fuzz batches: 24 layers of 90 bases."""
    rng = random.Random(17)
    a = _alloc(2, CFG)
    for b in range(2):
        truth = bytes(rng.choice(b"ACGT") for _ in range(90))
        _set_window(a, b, mutate(truth, 0.1, rng),
                    [mutate(truth, 0.1, rng) for _ in range(CFG.depth)])
    _assert_v2_equal(CFG, a, True)


def _pair_edges(cfg, packed):
    """Per window over the layers the plain version folds in: the colstep
    pairs (ops/colstep.pair_schedule over the subgraph's rank order) whose
    first node is among the second's in-edge sources, and whether the
    window failed."""
    t = poa.batch_to_tensors(packed, "cpu")
    res = []
    for b in range(t[0].shape[0]):
        bb, bbw, bb_len, nl, seqs, ws, lens, begins, ends = (x[b] for x in t)
        n = int(bb_len)
        assert int(np.float32(0.01) * n) == 0   # no layer spans the window
        g = poa._Graph(cfg, bb, bbw, n)
        joined = 0
        for li in range(int(nl)):
            if g.failed:
                break
            lo, hi = np.float32(begins[li]), np.float32(ends[li])
            sub = np.zeros(cfg.max_nodes, bool)
            sub[:g.n] = (g.key[:g.n] >= lo) & (g.key[:g.n] <= hi)
            order = poa._rank_order(g.key, np.nonzero(sub)[0])
            for r, take in colstep.pair_schedule(g.key[order]):
                joined += take == 2 and order[r] in g.src[order[r + 1]]
            poa._add_layer(cfg, g, seqs[li], ws[li].numpy(), int(lens[li]),
                           int(begins[li]), int(ends[li]), n, None, True)
        res.append((joined, g.failed))
    return res


def test_pair_edge_batch_meets_joined_pairs():
    """The batch that holds the v2 kernel's concurrent colstep pairs to the
    plain version (tests/test_torch_cuda.py) has, in every window, a pair
    of one key joined by an edge, which must run one row after the other;
    three windows fold in every layer, three fail."""
    cfg = poa.PoaConfig(max_nodes=384, max_len=256, max_backbone=128,
                        depth=16)
    packed = batches.pair_edge_batch(cfg)
    res = _pair_edges(cfg, packed)
    assert all(j > 0 for j, _ in res)
    assert [f for _, f in res] == [False] * 3 + [True] * 3
    plain = poa.poa_batch_plain(cfg, *poa.batch_to_tensors(packed, "cpu"))
    assert plain[3].tolist() == [f for _, f in res]


def _insert_sequentially(keys, n, m):
    """The rank order after inserting new ids n..n+m-1 one at a time,
    each after every key <= its own (the sorted order of ids 0..n-1 by
    (key, id) to start)."""
    order = sorted(range(n), key=lambda i: (keys[i], i))
    for v in range(n, n + m):
        pos = sum(keys[o] <= keys[v] for o in order)
        order.insert(pos, v)
    return order


def _merge_rule(keys, n, m):
    """csrc/poa_v2.cu merge_new as numpy: an old node at rank i goes to
    i + (new keys < its key); a new node to its place among the new ones
    (its index where their keys are sorted, else the count of (key, id)
    before it) + (old keys <= its key)."""
    old = sorted(range(n), key=lambda i: (keys[i], i))
    ok = np.array([keys[o] for o in old], dtype=np.float32)
    nk = np.array(keys[n:n + m], dtype=np.float32)
    srt = bool(np.all(nk[:-1] <= nk[1:]))
    out = np.full(n + m, -1)
    for i, o in enumerate(old):
        below = (np.searchsorted(nk, keys[o], side="left") if srt
                 else int((nk < keys[o]).sum()))
        out[i + below] = o
    for q in range(m):
        before = q if srt else int(((nk < nk[q]) |
                                    ((nk == nk[q]) &
                                     (np.arange(m) < q))).sum())
        out[before + np.searchsorted(ok, nk[q], side="right")] = n + q
    return out.tolist()


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=0, max_size=12),
       st.lists(st.integers(0, 6), min_size=0, max_size=12),
       st.booleans())
def test_merge_rule_equals_sequential_insertion(old, new, walk_order):
    """Step d's merge of a layer's new nodes into the frozen rank order
    gives the order that inserting them one by one gives, on float32 keys
    drawn from a pool of seven (so ties are forced among old keys, among
    new keys and between the two), new keys sorted as the walk makes
    them or in any order."""
    pool = np.float32([0.0, 0.5, 1.0, np.float32(1.0) + np.float32(2**-23),
                       2.0, 2.0, 41.0])
    new = sorted(new) if walk_order else new
    keys = [pool[k] for k in old + new]
    n, m = len(old), len(new)
    assert _merge_rule(keys, n, m) == _insert_sequentially(keys, n, m)


def test_default_polisher_and_cli_write_the_jax_fasta(tmp_path, capsys,
                                                      monkeypatch):
    """The default POA kernel (poa_driver.DEFAULT_POA_KERNEL), through
    create_polisher and through the CLI without --poa-kernel, writes the
    FASTA that racon_tpu.TpuPolisher writes."""
    paths = _paf_dataset(tmp_path)
    p = racon_tpu_torch.create_polisher(*paths, device="cpu", **KW)
    assert p.poa_kernel == poa_driver.DEFAULT_POA_KERNEL
    p.initialize()
    got = p.polish(True)
    assert cli.main(["--device", "cpu", "-w", "100", "-m", "5", "-x", "-4",
                     "-g", "-8", *paths]) == 0
    assert capsys.readouterr().out == "".join(f">{n}\n{s}\n"
                                              for n, s in got)
    monkeypatch.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
    q = racon_tpu.TpuPolisher(*paths, **KW)
    q.initialize()
    assert got == q.polish(True)


def _parallel_pair_starts(keys):
    """csrc/poa_v2.cu's step rule as numpy, one rank at a time with no
    carried state: rank r starts a pair where rank r + 1 has its key and
    r is an even distance from the first rank of that key."""
    k = np.asarray(keys, dtype=np.float32)
    first = np.searchsorted(k, k, side="left")
    nxt = np.append(k[1:] == k[:-1], False)
    return [int(r) for r in np.nonzero(nxt & ((np.arange(len(k)) - first)
                                              % 2 == 0))[0]]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(0, 5), min_size=0, max_size=40))
def test_parallel_pair_rule_equals_pair_schedule(ids):
    """The kernel finds each rank's colstep step in parallel; its pairs
    are the greedy ones of ops/colstep.pair_schedule on sorted keys with
    runs of ties of every length."""
    keys = sorted(np.float32(i) / np.float32(3) for i in ids)
    want = [r for r, take in colstep.pair_schedule(keys) if take == 2]
    assert _parallel_pair_starts(keys) == want


def test_default_poa_kernel_is_ls(tmp_path):
    """ls is the default POA kernel of TorchPolisher, create_polisher, the
    consensus driver and the CLI, as RACON_TPU_POA_KERNEL's default is in
    the JAX package (and ls is faster than v2 on every depth bucket on the
    card)."""
    import inspect

    from racon_tpu import config

    assert poa_driver.DEFAULT_POA_KERNEL == "ls"
    assert poa_driver.DEFAULT_POA_KERNEL == \
        config.KNOBS["RACON_TPU_POA_KERNEL"].default
    paths = _paf_dataset(tmp_path)
    assert racon_tpu_torch.TorchPolisher(*paths, device="cpu",
                                         **KW).poa_kernel == "ls"
    assert racon_tpu_torch.create_polisher(*paths, device="cpu",
                                           **KW).poa_kernel == "ls"
    sig = inspect.signature(poa_driver.run_consensus_phase)
    assert sig.parameters["poa_kernel"].default == "ls"
    assert cli.build_arg_parser().get_default("poa_kernel") == "ls"


# --- a model of the banded build's row descriptors and band starts
# (csrc/poa_v2.cu, the pass before each layer's DP), held against the
# plain version's banded rows

D_SLOW, D_ANY, D_STALE, D_ENT = 4, 8, 16, 5


def _desc_model(cfg, g, sub, rank, u, r):
    """The 64-bit descriptor csrc/poa_v2.cu builds for the row of node u at
    rank r: its computed in-subgraph predecessors (rank distance | slot <<
    12, 16 bits each, up to three, in slot order) and its flags."""
    dsc, n = 0, 0
    for e in range(cfg.max_edges):
        sv = int(g.src[u, e])
        if sv < 0:
            break
        if not sub[sv]:
            continue
        dsc |= D_ANY
        if rank[sv] >= r:
            dsc |= D_STALE
            continue
        d = r - int(rank[sv])
        if n < 3 and d < 4096:
            dsc |= (d | e << 12) << (D_ENT + 16 * n)
            n += 1
        else:
            dsc |= D_SLOW
    return dsc | n


def _in_band_model(band, u, L):
    """The banded DP's mask of node u's row from its band start
    (bstart = cexp - wband, int16): a cell is in band where the unsigned
    difference j - bstart is at most 2 wband."""
    bstart = max(band.center(u) - min(band.w, 16384), -32768)
    jj = np.arange(L + 1, dtype=np.int64)
    return (jj - bstart) % 2 ** 32 <= 2 * band.w


@pytest.mark.parametrize("case", ["mutated", "far", "equal_keys"])
def test_band_descriptor_model_equals_plain_rows(monkeypatch, case):
    """csrc/poa_v2.cu's banded rows read their predecessors from a
    descriptor and their mask from a band start, both built before the
    layer; modelled in numpy, at every banded row the descriptor lists the
    plain version's computed predecessors in slot order (the row at each
    rank distance is the slot's source), flags a row with none in the
    subgraph and a row with one not computed yet, and the band start
    gives the plain row's mask."""
    real_row = poa._Band.row
    seen = {"rows": 0, "slow": 0, "stale": 0, "listed": 0, "masked": 0}

    def spy_row(band, Hn, u, seq):
        cfg, g, sub, rank = band.cfg, band.g, band.sub, band.rank
        srcs = g.src[u]
        e = np.nonzero(srcs >= 0)[0]
        e = e[sub[srcs[e]]]
        done = e[rank[srcs[e]] < rank[u]]
        dsc = _desc_model(cfg, g, sub, rank, int(u), int(rank[u]))
        assert bool(dsc & D_ANY) == (len(e) > 0)
        assert bool(dsc & D_STALE) == (len(done) < len(e))
        if dsc & D_SLOW:
            assert len(done) > 3
            seen["slow"] += 1
        else:
            ents = [(dsc >> (D_ENT + 16 * i)) & 0xffff
                    for i in range(dsc & 3)]
            assert [ent >> 12 for ent in ents] == list(done)
            for ent in ents:
                assert rank[srcs[ent >> 12]] == rank[u] - (ent & 0xfff)
            seen["listed"] += len(ents)
        seen["stale"] += bool(dsc & D_STALE)
        real_row(band, Hn, u, seq)
        L = len(band.jj) - 1
        off = np.abs(band.jj - band.center(u)) > band.w
        assert np.array_equal(_in_band_model(band, u, L), ~off)
        seen["rows"] += 1
        seen["masked"] += int(off.sum())

    monkeypatch.setattr(poa._Band, "row", spy_row)
    if case == "mutated":
        cfg = poa_driver.make_config(100, 32, 5, -4, -8)
        packed = batches.poa_batch(cfg, 4, 41, 100, 0.2)
        wband = [1, 4, 12, 40]
    elif case == "far":
        cfg = poa.PoaConfig(384, 256, 128, 12, 6, 5, -4, -8)
        packed = batches.far_pred_batch(cfg, 2)
        wband = [8, 120]
    else:
        cfg = CFG._replace(depth=16)
        packed = batches.equal_key_batch(cfg)
        wband = [6, 6] + [200] * (packed[0].shape[0] - 2)  # wide: late rows
    poa_v2_cuda.poa_consensus_v2(
        cfg, *poa.batch_to_tensors(packed, "cpu"),
        wband=torch.tensor(wband, dtype=torch.int32))
    assert seen["rows"] > 500 and seen["listed"] > seen["rows"] // 2
    assert seen["masked"] > 0
    if case == "mutated":
        assert seen["slow"] > 0
    if case == "equal_keys":
        assert seen["stale"] > 0


def test_banded_build_counts_one_row_a_step():
    """The banded build runs no same-column pairs: its serial steps are its
    DP rows, colstep or not, while the flat build's pairs cut them."""
    cfg = poa_driver.make_config(100, 8, 5, -4, -8)
    t = poa.batch_to_tensors(batches.poa_batch(cfg, 2, 43, 100), "cpu")
    flat, band = {}, {}
    poa_v2_cuda.poa_consensus_v2(cfg, *t, stats=flat)
    poa_v2_cuda.poa_consensus_v2(cfg, *t, stats=band, colstep=True,
                                 wband=torch.tensor([3, 0],
                                                    dtype=torch.int32))
    assert band["steps"] == band["rows"] > 0
    assert flat["steps"] < flat["rows"]


@pytest.mark.parametrize("window", [1500, 2000])
@pytest.mark.parametrize("wrapper", ["ls", "v2"])
def test_wrappers_take_wide_geometries(window, wrapper):
    """Both wrappers' argument check takes make_config's geometries at -w
    1500 and -w 2000 (max_len 2304 and 3072: the wide build), any max_len
    beyond and max_nodes above the int16 node ids (the global build, with
    int32 ids there), and refuses more in-edge slots than the kernels
    have, with a message that names the limit."""
    mod = poa_cuda if wrapper == "ls" else poa_v2_cuda
    cfg = poa_driver.make_config(poa_driver.window_class(window), 8, 5, -4,
                                 -8)
    assert cfg.max_len + 1 > 2048
    t = poa.batch_to_tensors(batches.poa_batch(cfg, 2, 44, 60), "cpu")
    assert mod.check_inputs(cfg, t, torch.device("cpu")) == 2
    wide = cfg._replace(max_len=16384)
    t = poa.batch_to_tensors(batches.poa_batch(wide, 1, 44, 60), "cpu")
    assert mod.check_inputs(wide, t, torch.device("cpu")) == 1
    big = cfg._replace(max_nodes=32768)
    t = poa.batch_to_tensors(batches.poa_batch(big, 1, 44, 60), "cpu")
    assert mod.check_inputs(big, t, torch.device("cpu")) == 1
    assert poa_cuda.wide_ids(big, True)
    slots = cfg._replace(max_edges=33)
    with pytest.raises(ValueError, match="max_edges <= 32"):
        mod.check_inputs(slots, t, torch.device("cpu"))


def test_consensus_phase_checks_every_geometry_before_any_window(
        monkeypatch):
    """On the card, run_consensus_phase checks every bucket's geometry
    against the card's free memory before it exports a window, and where
    one window does not fit (a window of 60,000 bases on an 80 GB card:
    about 81 GB) raises one ValueError that names the largest -w that
    fits; the classes below it pass, those above the int16 node ids
    (11,000: class 11,008, max_nodes 33,024) too."""

    class Windows:
        exported = 0

        def num_windows(self):
            return 4

        def window_info(self, i):
            return (9, (400, 10880, 11000, 60000)[i], 0, True, 0, 0)

        def export_window(self, i):
            Windows.exported += 1
            raise AssertionError("a window ran before the geometry check")

    free = 79 * 10**9
    monkeypatch.setattr(poa_driver, "free_device_bytes", lambda dev: free)
    wl = poa_driver.largest_window(poa_driver.memory_room(free), 8)
    assert 11000 < wl < 60000
    with pytest.raises(ValueError, match=f"class 60032 .*-w {wl}$"):
        poa_driver.run_consensus_phase(Windows(), match=5, mismatch=-4,
                                       gap=-8, trim=True, device="cuda",
                                       band=True)
    assert Windows.exported == 0
