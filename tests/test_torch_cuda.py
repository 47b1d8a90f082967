"""racon_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports nothing of the JAX package, so on the card's machine it runs
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

All outputs are integers and must be equal (tolerance 0).
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.ops import cuda_lib, poa, poa_cuda
from racon_tpu_torch.tools import batches

pytestmark = pytest.mark.cuda

CFG = poa.PoaConfig(max_nodes=384, max_len=256, max_backbone=128,
                    max_edges=12, depth=8, match=5, mismatch=-4, gap=-8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,window,depth", [(1, 100, 8), (2, 500, 32)])
def test_poa_kernel_equals_plain(card, seed, window, depth):
    cfg = CFG if window <= 128 else poa.PoaConfig(depth=depth)
    cfg = cfg._replace(depth=depth)
    packed = batches.poa_batch(cfg, 8, seed, window)
    want_st, got_st = {}, {}
    want = poa_cuda.poa_consensus(cfg, *poa.batch_to_tensors(packed, "cpu"),
                                  stats=want_st)
    n0 = cuda_lib.LAUNCHES["poa_consensus"]
    got = poa_cuda.poa_consensus(cfg, *poa.batch_to_tensors(packed, card),
                                 stats=got_st)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["poa_consensus"] == n0 + 1
    assert got_st["cells"] == want_st["cells"] > 0
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("K", [256, 1024])
@pytest.mark.parametrize("backward", [False, True])
def test_edge_kernel_equals_plain(card, K, backward):
    rng = np.random.default_rng(K + backward)
    B, rcap = 6, 512
    scal = np.zeros((B, 4), np.int32)
    q = rng.integers(0, 5, (B, rcap)).astype(np.uint8)
    t = np.full((B, rcap + K), 255, np.uint8)
    for b in range(B):
        R = int(rng.integers(1, rcap + 1))
        S = int(rng.integers(max(0, R - K // 4), min(rcap + K, R + K // 4)))
        scal[b] = (R, S, -int(rng.integers(0, K // 2)), 0)
        t[b, :S] = rng.integers(0, 4, S)
    want = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, "cpu"), K, backward)
    got = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, card), K, backward)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("K", [256, 2048])
def test_base_kernel_equals_plain(card, K):
    rng = np.random.default_rng(K)
    B = 5
    scal = np.zeros((B, 4), np.int32)
    q = rng.integers(0, 4, (B, ac.BASE_ROWS)).astype(np.uint8)
    t = np.full((B, ac.BASE_ROWS + K), 255, np.uint8)
    for b in range(B - 1):
        R = int(rng.integers(1, ac.BASE_ROWS + 1))
        S = int(rng.integers(max(0, R - 20), R + 20))
        scal[b] = (R, S, -(K // 2) + int(rng.integers(-5, 5)), 0)
        t[b, :S] = q[b, :S] if S <= ac.BASE_ROWS else rng.integers(0, 4, S)
    scal[-1, 0] = 1                      # padding task
    want = ac.base_case(*ac.tasks_to_tensors(scal, q, t, "cpu"), K)
    got = ac.base_case(*ac.tasks_to_tensors(scal, q, t, card), K)
    for name, w, g in zip(("ops", "cnt", "ok", "dist"), want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)


def test_align_pairs_on_card_equals_cpu(card):
    pairs = batches.align_pairs(7, 8, 200, 3000)
    want = ac.align_pairs(pairs, device="cpu")
    got = ac.align_pairs(pairs, device=card)
    assert sum(g is not None for g in got) >= 6
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
