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

from racon_tpu.ops import poa as jpoa
from racon_tpu.ops import poa_pallas_ls
from racon_tpu_torch.ops import poa, poa_cuda, poa_driver
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
