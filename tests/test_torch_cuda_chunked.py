"""racon_tpu_torch slice 12 on the card: the POA kernels' global builds
with int32 node ids (above class 10,880) against the plain version, the
launch counts under two threads, and the chunked modes on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports nothing of the JAX package, so on the card's machine it runs
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_chunked.py

All kernel outputs are integers and must be equal (tolerance 0).
"""

import functools
import threading

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import (cuda_lib, poa, poa_cuda, poa_driver,
                                 poa_v2_cuda)
from racon_tpu_torch.tools import batches

pytestmark = pytest.mark.cuda

CFG = poa.PoaConfig(max_nodes=384, max_len=256, max_backbone=128,
                    max_edges=12, depth=8, match=5, mismatch=-4, gap=-8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: The int32 global builds' smallest launch: class 11,008 (max_nodes
#: 33,024), window 1's node ids past 32,767 (batches.wide_id_batch).
WIDE_ID_CFG = poa_driver.make_config(11008, 200, 5, -4, -8)


@functools.lru_cache(maxsize=None)
def _wide_id_case(kernel, wband):
    packed = batches.wide_id_batch(WIDE_ID_CFG)
    wb = None if wband is None else torch.tensor(wband, dtype=torch.int32)
    st = {}
    want = poa.poa_batch_plain(WIDE_ID_CFG,
                               *poa.batch_to_tensors(packed, "cpu"),
                               stats=st, wband=wb, kernel=kernel)
    return packed, want, st


@pytest.mark.parametrize("kernel", ["ls", "v2"])
@pytest.mark.parametrize("wband", [None, (24, 0), (0, 0)])
def test_poa_int32_global_builds_equal_plain(card, kernel, wband):
    """Each kernel's global build with int32 node ids (class 11,008, above
    the int16 ids), flat and banded, equals the plain version on two
    windows, one of whose graphs passes node id 32,767 (32,890 nodes), and
    counts its launch under its own name."""
    packed, want, want_st = _wide_id_case(kernel, wband)
    assert int(want[4][1]) == 32890 and not want[3].any()
    mod = poa_v2_cuda if kernel == "v2" else poa_cuda
    band = wband is not None
    assert mod.plan(WIDE_ID_CFG, band)["global_build"]
    base = "poa_consensus_v2" if kernel == "v2" else "poa_consensus"
    name = poa_cuda.launch_name(base, band, True, True)
    assert name.endswith("_global32")
    assert poa_cuda.build_name(mod.plan, base, WIDE_ID_CFG, band)[1] == name
    kw = {} if not band else {"wband": torch.tensor(wband, dtype=torch.int32,
                                                    device=card)}
    fn = poa_cuda.poa_consensus if kernel == "ls" else \
        poa_v2_cuda.poa_consensus_v2
    n0 = cuda_lib.LAUNCHES[name]
    st = {}
    got = fn(WIDE_ID_CFG, *poa.batch_to_tensors(packed, card), stats=st,
             **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == n0 + 1
    assert st["cells"] == want_st["cells"] > 0
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


#: Class 22,016: max_len 33,024 passes 32,767 (batches.wide_column_batch:
#: a layer of 32,900 bases).
WIDE_COLUMN_CFG = poa_driver.make_config(22016, 8, 5, -4, -8)


@functools.lru_cache(maxsize=None)
def _wide_column_case(kernel, wband):
    packed = batches.wide_column_batch(WIDE_COLUMN_CFG)
    wb = None if wband is None else torch.tensor(wband, dtype=torch.int32)
    st = {}
    want = poa.poa_batch_plain(WIDE_COLUMN_CFG,
                               *poa.batch_to_tensors(packed, "cpu"),
                               stats=st, wband=wb, kernel=kernel)
    return packed, want, st


@pytest.mark.parametrize("kernel", ["ls", "v2"])
@pytest.mark.parametrize("wband", [None, (24, 0), (0, 24)])
def test_poa_int32_global_builds_equal_plain_past_column_32767(card, kernel,
                                                               wband):
    """Each kernel's int32 global build, flat and banded, equals the plain
    version bit for bit at class 22,016, where a layer passes column
    32,767 (32,900 bases) and window 1's graph passes node id 32,767."""
    packed, want, want_st = _wide_column_case(
        None if wband is None else kernel, wband)
    assert packed[6][1, 0] > 32767 and WIDE_COLUMN_CFG.max_len > 32767
    if wband is None:
        assert int(want[4][1]) > 32767
    mod = poa_v2_cuda if kernel == "v2" else poa_cuda
    band = wband is not None
    base = "poa_consensus_v2" if kernel == "v2" else "poa_consensus"
    name = poa_cuda.launch_name(base, band, True, True)
    assert poa_cuda.build_name(mod.plan, base, WIDE_COLUMN_CFG,
                               band)[1] == name
    kw = {} if not band else {"wband": torch.tensor(wband, dtype=torch.int32,
                                                    device=card)}
    fn = poa_cuda.poa_consensus if kernel == "ls" else \
        poa_v2_cuda.poa_consensus_v2
    n0 = cuda_lib.LAUNCHES[name]
    st = {}
    got = fn(WIDE_COLUMN_CFG, *poa.batch_to_tensors(packed, card), stats=st,
             **kw)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == n0 + 1
    assert st["cells"] == want_st["cells"] > 0
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("window", [10880, 11008, 22016])
def test_poa_builds_keep_int16_ids_to_class_10880(card, window):
    """The plan picks int32 node ids only in the global build above
    32,767 node slots: both kernels' scratch layouts agree with
    scratch_words there, and their occupancy reports the int32 builds'
    resources (no spill in the flat ones)."""
    cfg = poa_driver.make_config(window, 8, 5, -4, -8)
    assert poa_cuda.wide_ids(cfg, True) == (window > 10880)
    for lib in (poa_cuda._lib().rt_poa_scratch_words,
                poa_v2_cuda._lib().rt_poa_v2_scratch_words):
        assert lib(cfg.max_nodes, cfg.max_len, cfg.max_edges, 1) == \
            poa_cuda.scratch_words(cfg, True)
    for mod in (poa_cuda, poa_v2_cuda):
        for band in (False, True):
            assert mod.plan(cfg, band)["global_build"]
            occ = mod.occupancy(cfg, band)
            assert occ["blocks_per_sm"] >= 1


def test_launch_counts_exact_under_two_threads(card):
    """LAUNCHES and LAUNCH_EVENTS under launches from two threads at once,
    each on a stream of its own (the pipelined polish's layout): every
    launch counted once, every pair of events kept."""
    cfg = CFG
    packed = batches.poa_batch(cfg, 4, 5, 100)
    dev_in = poa.batch_to_tensors(packed, card)
    want = poa_cuda.poa_consensus(cfg, *dev_in)
    cuda_lib.reset_launches()
    cuda_lib.LAUNCH_EVENTS = []
    errors = []

    def run(n):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(n):
                    got = poa_cuda.poa_consensus(cfg, *dev_in)
                torch.cuda.current_stream().synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(200,))
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        events = cuda_lib.LAUNCH_EVENTS
    finally:
        cuda_lib.LAUNCH_EVENTS = None
    assert not errors, errors
    assert cuda_lib.LAUNCHES["poa_consensus"] == 400
    assert len(events) == 400


def test_pipelined_polish_on_the_card_equals_sequential(card, tmp_path):
    """The chunked modes on the card (pipelined, streamed, both; the
    consensus phase at depth 1 and 3): the FASTA of the sequential polish,
    byte for byte, on a three-contig set."""
    from racon_tpu_torch import TorchPolisher
    from racon_tpu_torch.tools import simulate

    d = simulate.generate(str(tmp_path), mbp=0.03, coverage=10, seed=5,
                          contigs=3)
    paths = (d["reads"], d["overlaps"], d["draft"])
    kw = dict(window_length=500, match=5, mismatch=-4, gap=-8)

    def run(**mode):
        p = TorchPolisher(*paths, **kw, **mode)
        p.initialize()
        return p.polish(True), p.stats

    want, _ = run()
    for mode in (dict(pipeline_phases=True), dict(stream_input=True),
                 dict(pipeline_phases=True, stream_input=True),
                 dict(pipeline_phases=True, pipeline_depth=1),
                 dict(pipeline_depth=3)):
        got, st = run(**mode)
        assert got == want, mode
        if mode.get("pipeline_phases") or mode.get("stream_input"):
            assert st["chunks"] == 3
