"""The partitioner's stripes on the card.

Every test here needs an NVIDIA card and skips without one; the file
imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py

A virtual stripe (``["cuda:0"] * m``: m launches on m streams of one
card, parallel/partitioner.py) of each polish-path kernel, the ls and v2
POA kernels flat and banded, the edge kernel both ways and the base case,
at m = 2 (uneven slices here) and 3, equals one launch bit for bit, and
launches m times. One device's stripe runs on the caller's current
stream, a striped one on a stream an entry. A polish of the parity set
striped over two streams gives the unstriped polish's bytes. With two
cards (skipped on one): the polish on cuda:1, and over both cards, gives
cuda:0's bytes.
"""

import numpy as np
import pytest
import torch

from racon_tpu_torch import TorchPolisher
from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.ops import cuda_lib, poa_cuda, poa_driver, poa_v2_cuda
from racon_tpu_torch.parallel.partitioner import Partitioner
from racon_tpu_torch.tools import batches, simulate

pytestmark = pytest.mark.cuda

ARGS = dict(window_length=500, match=5, mismatch=-4, gap=-8)
KERNELS = {"ls": (poa_cuda.poa_consensus, "poa_consensus"),
           "v2": (poa_v2_cuda.poa_consensus_v2, "poa_consensus_v2")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _striped(fn, arrays, m, name):
    """fn over `arrays` striped on m streams of cuda:0, and its launches
    of kernel `name`."""
    part = Partitioner(["cuda:0"] * m)
    n0 = cuda_lib.LAUNCHES[name]
    got = part.gather(part.stripe(fn, arrays), timeout_s=120)
    return got, cuda_lib.LAUNCHES[name] - n0


def _one(fn, arrays, card):
    outs = fn(*(torch.from_numpy(a).to(card) for a in arrays))
    return tuple(t.cpu().numpy() for t in outs)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_poa_virtual_stripe_equals_one_launch(card, kernel, band, m):
    wrapper, name = KERNELS[kernel]
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    packed = batches.poa_batch(cfg, 9, 41, 500)[:9]
    if band:
        name += "_band"
        wband = np.random.default_rng(3).integers(0, 40, 9).astype(np.int32)
        arrays = packed + (wband,)

        def fn(*ins):
            outs = wrapper(cfg, *ins[:9], wband=ins[9])
            return outs[:4] + outs[5:]
    else:
        arrays = packed

        def fn(*ins):
            return wrapper(cfg, *ins)[:4]
    want = _one(fn, arrays, card)
    got, launches = _striped(fn, arrays, m, name)
    assert launches == m
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("backward", [False, True])
def test_edge_virtual_stripe_equals_one_launch(card, backward, m):
    K = 256
    arrays = batches.edge_batch(K, 37, 5, rcap=512)

    def fn(s, q, t):
        return (ac.edge_rows(s, q, t, K, backward),)
    want = _one(fn, arrays, card)
    got, launches = _striped(fn, arrays, m, "hirschberg_edge")
    assert launches == m
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("K", [128, 512])
def test_base_virtual_stripe_equals_one_launch(card, K, m):
    arrays = batches.edge_batch(K, 37, 6, rcap=ac.BASE_ROWS)

    def fn(s, q, t):
        return ac.base_case(s, q, t, K)
    want = _one(fn, arrays, card)
    got, launches = _striped(fn, arrays, m, ac.launch_name(
        "hirschberg_base", K))
    assert launches == m
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_align_pairs_striped_equal_one_device(card):
    pairs = batches.align_pairs(9, 40, 300, 1500)
    want = ac.align_pairs(pairs, device=card)
    got = ac.align_pairs(pairs, device=card,
                         partitioner=Partitioner(["cuda:0"] * 2))
    assert [None if x is None else x.tolist() for x in got] == \
        [None if x is None else x.tolist() for x in want]
    assert any(x is not None for x in got)


def test_parity_set_polish_striped_equals_unstriped(card, tmp_path):
    d = simulate.generate(str(tmp_path), mbp=0.015, seed=11)
    paths = (d["reads"], d["overlaps"], d["draft"])

    def run(**kw):
        cuda_lib.reset_launches()
        p = TorchPolisher(*paths, device="cuda", **ARGS, **kw)
        p.initialize()
        return p.polish(True), dict(cuda_lib.LAUNCHES)

    want, one = run()
    got, two = run(devices=["cuda:0", "cuda:0"])
    assert got == want
    for k in ("poa_consensus", "hirschberg_edge", "hirschberg_base"):
        assert one[k] <= two[k] <= 2 * one[k], k
    assert sum(two.values()) > sum(one.values())


def test_stripe_streams(card):
    """One device: the launch on the caller's current stream (the stream
    the unstriped path always used); two entries: a stream each, neither
    the caller's."""
    caller = torch.cuda.Stream(card)
    seen = []

    def fn(a):
        seen.append(torch.cuda.current_stream(card))
        return (a + 1,)

    rows = (np.arange(6, dtype=np.int32),)
    with torch.cuda.stream(caller):
        for m in (1, 2):
            part = Partitioner(["cuda:0"] * m)
            (got,) = part.gather(part.stripe(fn, rows), timeout_s=60)
            np.testing.assert_array_equal(got, rows[0] + 1)
    assert seen[0] == caller
    assert caller not in seen[1:] and seen[1] != seen[2]


@pytest.fixture
def two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")


def test_polish_on_a_second_card_and_over_two(two_cards, tmp_path):
    """The launches of a polish on cuda:1 run under that card (the
    libraries read its attributes through the runtime's current device),
    alone or striped with cuda:0: cuda:0's bytes."""
    d = simulate.generate(str(tmp_path), mbp=0.015, seed=11)
    paths = (d["reads"], d["overlaps"], d["draft"])

    def run(devices):
        cuda_lib.reset_launches()
        p = TorchPolisher(*paths, device="cuda", devices=devices, **ARGS)
        p.initialize()
        return p.polish(True), dict(cuda_lib.LAUNCHES)

    want, _ = run("cuda:0")
    for devices in ("cuda:1", "cuda:1,cuda:0", 2):
        got, launches = run(devices)
        assert got == want, devices
        assert launches["poa_consensus"] > 0, devices
