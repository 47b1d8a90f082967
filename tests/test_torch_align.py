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


def _first_round(enc, backward, K=256, rcap=512):
    """First-round Hirschberg halves of every pair in band K."""
    bands, tasks = {}, []
    for i, (q, t) in enumerate(enc):
        n, m = len(q), len(t)
        if ap.band_for(n, m) != K:
            continue
        bands[i] = (K, int(min(0, m - n) - (K - 1 - abs(m - n)) // 2))
        imid = n // 2
        tasks.append(ap._Task(i, imid if backward else 0,
                              n if backward else imid, 0, m))
    return ap._task_arrays(enc, tasks, bands, rcap, K, backward, 1)


@pytest.mark.parametrize("backward", [False, True])
def test_edge_rows_plain_equals_pallas(backward):
    enc = _enc(_pairs(5, 6, 300, 900))
    scal, q, t = _first_round(enc, backward)
    assert len(scal) >= 3
    want = np.asarray(ap._build_edge_kernel(512, 256, backward, True, 1)(
        len(scal))(scal, q, t))
    got = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, "cpu"), 256,
                       backward)
    np.testing.assert_array_equal(got.numpy(), want)


def test_base_case_plain_equals_pallas():
    """Base tasks of three pairs plus a padding task (one row, empty
    target), as the JAX orchestrator pads its batches."""
    K = 256
    enc = _enc(_pairs(5, 3, 300, 900))
    B = len(enc) + 1
    scal = np.zeros((B, 4), np.int32)
    qs = np.zeros((B, ac.BASE_ROWS), np.int32)
    ts = np.full((B, ac.BASE_ROWS + K), 255, np.int32)
    for bi, (q, t) in enumerate(enc):
        R, S = min(len(q), 200), min(len(t), 210)
        gdmin = int(min(0, len(t) - len(q))
                    - (K - 1 - abs(len(t) - len(q))) // 2)
        scal[bi] = (R, S, gdmin, 0)
        qs[bi, :R] = q[:R]
        ts[bi, :S] = t[:S]
    scal[-1, 0] = 1
    kern = ap._build_base_kernel(K, True, 1)[0]
    want = [np.asarray(x) for x in kern(B)(scal, qs, ts)]
    got = ac.base_case(*ac.tasks_to_tensors(scal, qs, ts, "cpu"), K)
    for w, g, name in zip(want, got, ("ops", "cnt", "ok", "dist")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert list(want[2]) == [1, 1, 1, 0]


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
