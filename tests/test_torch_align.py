"""racon_tpu_torch's Hirschberg aligner against the JAX package's.

The same numpy task arrays go through the Pallas kernels in interpret mode
and through the port's plain PyTorch versions on the CPU; every output
must be equal (tolerance 0: all outputs are integers). The CUDA kernels
are compared with the plain versions in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch

from racon_tpu.ops import align_pallas as ap
from racon_tpu.ops.encoding import encode as jencode
from racon_tpu_torch import native
from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.tools import batches
from tests.test_align import mutate


def _rand(rng, n):
    return bytes(rng.choice(b"ACGT") for _ in range(n))


def _pairs(seed, count, lo, hi):
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        q = _rand(rng, rng.randrange(lo, hi))
        out.append((q, mutate(q, rng.uniform(0.02, 0.18), rng)))
    return out


def _enc(pairs):
    return [(jencode(np.frombuffer(q, np.uint8)).astype(np.int32),
             jencode(np.frombuffer(t, np.uint8)).astype(np.int32))
            for q, t in pairs]


def _path_cost(ops, q: bytes, t: bytes) -> int:
    i = j = cost = 0
    for op in ops:
        if op == 0:
            cost += q[i] != t[j]
            i += 1
            j += 1
        elif op == 1:
            cost += 1
            i += 1
        else:
            cost += 1
            j += 1
    assert i == len(q) and j == len(t)
    return cost


# K = 256 keeps the ids "False" and "True" it had as the only band tested
EDGE_CASES = [pytest.param(K, bwd, id=str(bwd) if K == 256 else f"{K}-{bwd}")
              for K in (128, 256, 512, 1024, 2048) for bwd in (False, True)]


@pytest.mark.parametrize("K,backward", EDGE_CASES)
def test_edge_rows_plain_equals_pallas(K, backward):
    """The plain edge rows equal the Pallas edge kernel in interpret mode
    at every band the kernels take, in both directions."""
    scal, q, t = batches.edge_tasks(K, K * 2 + backward)
    assert (q[:, :300] == 4).any() and (t == 4).any()
    want = np.asarray(ap._build_edge_kernel(512, K, backward, True, 1)(
        len(scal))(scal, q.astype(np.int32), t.astype(np.int32)))
    got = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, "cpu"), K,
                       backward)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < ac.INF).any(axis=1).sum() >= len(scal) - 2


@pytest.mark.parametrize("K", [256, 512, 1024, 2048])
def test_base_case_plain_equals_pallas(K):
    """Base tasks of three pairs, then: R = 256 exactly, a path that
    leaves the band (ok = 0), S = 0, a positive dmin, and a padding task
    (one row, empty target) as the JAX orchestrator pads its batches."""
    enc = _enc(_pairs(5, 3, 300, 900))
    rng = np.random.default_rng(K)
    B = len(enc) + 5
    RB = ac.BASE_ROWS
    scal = np.zeros((B, 4), np.int32)
    qs = np.zeros((B, RB), np.int32)
    ts = np.full((B, RB + K), 255, np.int32)
    for bi, (q, t) in enumerate(enc):
        R, S = min(len(q), 200), min(len(t), 210)
        gdmin = int(min(0, len(t) - len(q))
                    - (K - 1 - abs(len(t) - len(q))) // 2)
        scal[bi] = (R, S, gdmin, 0)
        qs[bi, :R] = q[:R]
        ts[bi, :S] = t[:S]
    q = rng.integers(0, 4, RB)
    t = q.copy()
    t[rng.random(RB) < 0.1] = rng.integers(0, 4)
    b = len(enc)
    scal[b] = (RB, RB, -(K // 2), 0)                 # R = 256 exactly
    qs[b], ts[b, :RB] = q, t
    scal[b + 1] = (RB, RB, -K - 5, 0)                # end cell out of band
    qs[b + 1], ts[b + 1, :RB] = q, t
    scal[b + 2] = (40, 0, -40, 0)                    # S = 0: all I moves
    qs[b + 2, :40] = q[:40]
    scal[b + 3] = (120, 130, 3, 0)                   # positive dmin
    qs[b + 3, :120], ts[b + 3, :130] = q[:120], t[:130]
    scal[-1, 0] = 1
    kern = ap._build_base_kernel(K, True, 1)[0]
    want = [np.asarray(x) for x in kern(B)(scal, qs, ts)]
    got = ac.base_case(*ac.tasks_to_tensors(scal, qs, ts, "cpu"), K)
    for w, g, name in zip(want, got, ("ops", "cnt", "ok", "dist")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert list(want[2][:5]) == [1, 1, 1, 1, 0]
    assert want[2][b + 2] == 1 and want[2][-1] == 0
    assert want[3][b + 1] == ac.INF and want[3][b + 2] == 40


@pytest.mark.parametrize("seed", [31, 62])
def test_align_pairs_equals_pallas_and_is_optimal(seed):
    """The fuzz pairs of tests/test_align_hirschberg.py: the port's ops
    equal the Pallas engine's, and each path costs the edit distance."""
    pairs = _pairs(seed, 6, 60, 2500)
    enc = _enc(pairs)
    want = ap.align_pairs(enc, interpret=True)
    got = ac.align_pairs([(q.astype(np.uint8), t.astype(np.uint8))
                          for q, t in enc], device="cpu")
    served = 0
    for (q, t), w, g in zip(pairs, want, got):
        assert (w is None) == (g is None)
        if g is None:
            continue
        served += 1
        np.testing.assert_array_equal(g, w)
        assert _path_cost(g, q, t) == native.edit_distance(q, t)
    assert served >= len(pairs) - 1


def test_band_rule_and_host_share():
    assert ac.band_for(100, 3000) == 0
    assert ac.align_pairs([(np.zeros(100, np.uint8),
                            np.zeros(3000, np.uint8))], device="cpu") == [None]
    for n, m in ((300, 320), (4000, 4100), (9000, 9500)):
        assert ac.band_for(n, m) == ap.band_for(n, m)


def test_wrappers_reject_bad_input():
    scal = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    q = torch.zeros((2, 512), dtype=torch.uint8, device="meta")
    t = torch.zeros((2, 768), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        ac.edge_rows(scal, q, t, 300, False)
    with pytest.raises(ValueError):
        ac.edge_rows(scal, q.int(), t, 256, False)


@pytest.mark.parametrize("K", [256, 512, 1024, 2048])
def test_base_chunk_keeps_scratch_within_budget(K):
    """Two bits of moves a cell: a launch of base_chunk(K) tasks fits the
    scratch budget, and one more task would not."""
    assert ac.base_scratch_bytes(K) == ac.BASE_ROWS * K * 2 // 8
    n = ac.base_chunk(K)
    assert n * ac.base_scratch_bytes(K) <= ac.SCRATCH_BUDGET == 512 << 20
    assert (n + 1) * ac.base_scratch_bytes(K) > ac.SCRATCH_BUDGET


@pytest.mark.parametrize("chunk", [1, 3])
def test_align_pairs_ops_do_not_depend_on_chunking(monkeypatch, chunk):
    """align_pairs gives the same ops when the base case is cut into
    launches of `chunk` tasks, and no launch exceeds that size."""
    pairs = [(q.astype(np.uint8), t.astype(np.uint8))
             for q, t in _enc(_pairs(17, 5, 300, 1500))]
    want = ac.align_pairs(pairs, device="cpu")
    sizes = []
    real = ac.base_case

    def counted(scal, q, t, K):
        sizes.append(scal.shape[0])
        return real(scal, q, t, K)

    monkeypatch.setattr(ac, "base_chunk", lambda K: chunk)
    monkeypatch.setattr(ac, "base_case", counted)
    got = ac.align_pairs(pairs, device="cpu")
    assert sizes and max(sizes) <= chunk and sum(sizes) > chunk
    assert sum(w is not None for w in want) >= 4
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


def test_edge_rows_cycles_only_on_the_card():
    """The plain edge rows count no cycles: asking for them raises."""
    scal = torch.tensor([[3, 3, -1, 0]], dtype=torch.int32)
    q = torch.zeros((1, 512), dtype=torch.uint8)
    t = torch.full((1, 512 + 256), 255, dtype=torch.uint8)
    for backward in (False, True):
        with pytest.raises(ValueError):
            ac.edge_rows(scal, q, t, 256, backward,
                         cycles=torch.zeros(1, dtype=torch.int64))


def test_base_case_cycles_only_on_the_card():
    """The plain version counts no cycles: asking it for them raises."""
    scal = torch.zeros((1, 4), dtype=torch.int32)
    q = torch.zeros((1, ac.BASE_ROWS), dtype=torch.uint8)
    t = torch.full((1, ac.BASE_ROWS + 256), 255, dtype=torch.uint8)
    with pytest.raises(ValueError):
        ac.base_case(scal, q, t, 256,
                     cycles=torch.zeros((2, 1), dtype=torch.int64))


@pytest.mark.parametrize("backward", [False, True])
def test_band_cells_counts_the_lanes_in_band(backward):
    """chip_smoke.band_cells, which the aligner's bounds count, equals a
    row-by-row count of the lanes o < K with 0 <= i + dmin + o <= S over
    the rows the DP runs (1..R forward, 0..R-1 backward), padding tasks
    (R = 0) included."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(5)
    K = 512
    scal = np.zeros((40, 4), np.int32)
    scal[:, 0] = rng.integers(0, 300, 40)
    scal[:, 1] = rng.integers(0, 700, 40)
    scal[:, 2] = rng.integers(-K, 60, 40)
    scal[0, :3] = (0, 0, 0)
    want = 0
    o = np.arange(K)
    for R, S, dmin, _ in scal:
        rows = range(R) if backward else range(1, R + 1)
        for i in rows:
            j = i + dmin + o
            want += int(((j >= 0) & (j <= S)).sum())
    got = smoke.band_cells(torch.from_numpy(scal), K, backward)
    assert got == want
    assert 0 < got < smoke.lane_cells(torch.from_numpy(scal), K)


def test_plain_versions_record_no_launch_events():
    """On CPU tensors the wrappers launch nothing, so a caller that
    collects launch events (cuda_lib.LAUNCH_EVENTS) gets none."""
    from racon_tpu_torch.ops import cuda_lib

    scal = torch.tensor([[3, 3, -1, 0]], dtype=torch.int32)
    q = torch.zeros((1, ac.BASE_ROWS), dtype=torch.uint8)
    t = torch.zeros((1, ac.BASE_ROWS + 256), dtype=torch.uint8)
    cuda_lib.LAUNCH_EVENTS = []
    try:
        ac.base_case(scal, q, t, 256)
        ac.edge_rows(scal, q, t, 256, False)
        assert cuda_lib.LAUNCH_EVENTS == []
    finally:
        cuda_lib.LAUNCH_EVENTS = None
