"""racon_tpu_torch's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports nothing of the JAX package, so on the card's machine it runs
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

All outputs are integers and must be equal (tolerance 0).
"""

import functools
import subprocess

import numpy as np
import pytest
import torch

from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.ops import (cuda_lib, poa, poa_cuda, poa_driver,
                                 poa_v2_cuda)
from racon_tpu_torch.tools import batches
from racon_tpu_torch.tools import dp_cost_probe as probe

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


@pytest.mark.parametrize("colstep", [True, False])
@pytest.mark.parametrize("seed,window,depth", [(3, 100, 8), (4, 500, 32)])
def test_poa_v2_kernel_equals_plain(card, seed, window, depth, colstep):
    cfg = (CFG if window <= 128 else poa.PoaConfig())._replace(depth=depth)
    packed = batches.poa_batch(cfg, 8, seed, window)
    want_st, got_st = {}, {}
    want = poa_v2_cuda.poa_consensus_v2(
        cfg, *poa.batch_to_tensors(packed, "cpu"), colstep=colstep,
        stats=want_st)
    n0 = cuda_lib.LAUNCHES["poa_consensus_v2"]
    got = poa_v2_cuda.poa_consensus_v2(
        cfg, *poa.batch_to_tensors(packed, card), colstep=colstep,
        stats=got_st)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["poa_consensus_v2"] == n0 + 1
    assert got_st["cells"] == want_st["cells"] > 0
    assert got_st["steps"] == want_st["steps"]
    assert want_st["steps"] == want_st["rows"] or colstep
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_poa_kernels_fail_overflowing_windows_as_plain(card, kernel):
    """112 node slots for windows of about 100 bases: most windows run
    out of slots (the overflow path, then every later layer skipped), and
    every output still equals the plain version's."""
    cfg = CFG._replace(max_nodes=112)
    packed = batches.poa_batch(cfg, 8, 5, 100)
    fn = poa_driver.kernel_for(kernel)
    want = fn(cfg, *poa.batch_to_tensors(packed, "cpu"))
    got = fn(cfg, *poa.batch_to_tensors(packed, card))
    torch.cuda.synchronize()
    assert want[3].sum() >= 4
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("kernel,colstep", [("ls", None), ("v2", True),
                                            ("v2", False)])
def test_poa_kernels_equal_plain_where_keys_collide(card, kernel, colstep):
    """Windows whose float32 column keys collide along edges
    (batches.equal_key_batch): DP rows with predecessors ranked after
    them, so not computed yet, count those as NEG; windows whose every
    such predecessor is late fail, others do not, and every output
    equals the plain version's."""
    cfg = CFG._replace(depth=16)
    packed = batches.equal_key_batch(cfg)
    fn = poa_driver.kernel_for(kernel)
    kw = {} if colstep is None else {"colstep": colstep}
    want = fn(cfg, *poa.batch_to_tensors(packed, "cpu"), **kw)
    got = fn(cfg, *poa.batch_to_tensors(packed, card), **kw)
    torch.cuda.synchronize()
    assert want[3].any() and not want[3].all()
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("colstep", [True, False])
def test_poa_v2_equals_plain_where_pairs_are_joined(card, colstep):
    """Windows where a same-column colstep pair is joined by an edge
    (batches.pair_edge_batch): the kernel must run such a pair one row
    after the other, and counts it as one step."""
    cfg = CFG._replace(depth=16)
    packed = batches.pair_edge_batch(cfg)
    want_st, got_st = {}, {}
    want = poa_v2_cuda.poa_consensus_v2(
        cfg, *poa.batch_to_tensors(packed, "cpu"), colstep=colstep,
        stats=want_st)
    got = poa_v2_cuda.poa_consensus_v2(
        cfg, *poa.batch_to_tensors(packed, card), colstep=colstep,
        stats=got_st)
    torch.cuda.synchronize()
    assert want[3].tolist() == [False] * 3 + [True] * 3
    assert (got_st["cells"], got_st["steps"]) == (want_st["cells"],
                                                  want_st["steps"])
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


def test_poa_v2_equals_plain_on_a_full_depth_200_batch(card):
    """256 windows of 500 bases at the depth-200 bucket's geometry with
    33..48 layers each, the shape of the main path's largest launches,
    colstep on and off. The plain version runs in 8 host processes."""
    cfg = poa_driver.make_config(500, 200, 5, -4, -8)
    packed = batches.poa_batch(cfg, 256, 6, 500, layers=(33, 48))
    dev_in = poa.batch_to_tensors(packed, card)
    (want, pst), = batches.plain_poa_parallel([(cfg, dev_in)], 8)
    for colstep in (True, False):
        st = {}
        got = poa_v2_cuda.poa_consensus_v2(cfg, *dev_in, colstep=colstep,
                                           stats=st)
        torch.cuda.synchronize()
        assert st["cells"] == pst["cells"]
        assert st["steps"] == (pst["steps"] if colstep else pst["rows"])
        for k, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=f"output {k}, colstep "
                                          f"{colstep}")


#: Geometries beyond -w 500 and the v2 flat build's plan each gets on an
#: H100 (227 KiB a block): (config, window, ring rows, sources in shared
#: memory, global build). -w 1280 is the largest window of the usual build
#: (max_len + 1 <= 2048); -w 1500 and -w 2000 (their window classes'
#: geometries, max_len 2304 and 3072) run the wide build; "n6144" is a
#: graph too large to keep its in-edge sources on chip; from class 2176
#: (-w 2176) up no shared-memory layout of the ls kernel fits, from 2432
#: none of v2's flat build, and the global build runs: classes 2176 (ls
#: only), 3072, 4096 and 10,880, the node-id limit (max_nodes 32,640,
#: max_len 16,384).
LARGE = {
    "w1000": (poa_driver.make_config(1000, 32, 5, -4, -8), 1000, 8, 1, 0),
    "w1200": (poa_driver.make_config(1200, 32, 5, -4, -8), 1200, 4, 1, 0),
    "w1280": (poa_driver.make_config(1280, 200, 5, -4, -8), 1280, 2, 1, 0),
    "w1500": (poa_driver.make_config(1536, 32, 5, -4, -8), 1500, 8, 0, 0),
    "w2000": (poa_driver.make_config(2048, 32, 5, -4, -8), 2000, 4, 0, 0),
    "n6144": (CFG._replace(max_nodes=6144, max_len=1024, max_backbone=512,
                           depth=16), 500, 8, 0, 0),
    "w2176": (poa_driver.make_config(2176, 8, 5, -4, -8), 2176, 2, 0, 0),
    "w3072": (poa_driver.make_config(3072, 8, 5, -4, -8), 3072, 0, 0, 1),
    "w4096": (poa_driver.make_config(4096, 8, 5, -4, -8), 4096, 0, 0, 1),
    "w10880": (poa_driver.make_config(10880, 8, 5, -4, -8), 10880, 0, 0, 1),
}
#: The global builds' geometries: (windows, layers) of their batches,
#: kept small, since the plain version runs them on the host.
GLOBAL_BATCH = {"w2176": (3, (2, 4)), "w3072": (3, (2, 4)),
                "w4096": (2, (2, 3)), "w10880": (1, (2, 2))}


@functools.lru_cache(maxsize=None)
def _large_batch(name):
    cfg, window = LARGE[name][:2]
    B, layers = GLOBAL_BATCH.get(name, (8, (6, 16)))
    return batches.poa_batch(cfg, B, 21, window, layers=layers)


@functools.lru_cache(maxsize=None)
def _large_case(name):
    cfg = LARGE[name][0]
    packed = _large_batch(name)
    st = {}
    want = poa_v2_cuda.poa_consensus_v2(
        cfg, *poa.batch_to_tensors(packed, "cpu"), stats=st)
    return packed, want, st


@pytest.mark.parametrize("kernel", ["ls", "v2"])
@pytest.mark.parametrize("name", sorted(LARGE))
def test_poa_kernels_equal_plain_at_large_geometries(card, kernel, name):
    """Both POA kernels launch and equal the plain version at every
    window size poa_driver takes, up to the node-id limit; v2 with the
    plan each geometry should get, and each kernel's global build where
    no shared-memory layout fits (its own launch count)."""
    cfg, _, ring, src_in_shared, glob = LARGE[name]
    packed, want, want_st = _large_case(name)
    dev_in = poa.batch_to_tensors(packed, card)
    st = {}
    mod = poa_v2_cuda if kernel == "v2" else poa_cuda
    plan = mod.plan(cfg)
    if kernel == "v2":
        assert plan == {
            "ring": ring, "src_in_shared": src_in_shared,
            "shared_bytes": poa_v2_cuda.occupancy(cfg)["shared_bytes"],
            "global_build": bool(glob)}
    elif name == "w2176":
        assert plan["global_build"]
    base = "poa_consensus_v2" if kernel == "v2" else "poa_consensus"
    name_run = poa_cuda.launch_name(base, False, plan["global_build"])
    n0 = cuda_lib.LAUNCHES[name_run]
    if kernel == "v2":
        got = poa_v2_cuda.poa_consensus_v2(cfg, *dev_in, stats=st)
    else:
        got = poa_cuda.poa_consensus(cfg, *dev_in, stats=st)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name_run] == n0 + 1
    assert st["cells"] == want_st["cells"] > 0
    if kernel == "v2":
        assert st["steps"] == want_st["steps"]
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("kernel", ["ls", "v2"])
@pytest.mark.parametrize("name", sorted(GLOBAL_BATCH))
def test_poa_global_band_builds_equal_plain(card, kernel, name):
    """Each kernel's banded build at the global builds' geometries (the
    global build wherever no shared-memory layout fits the banded build)
    against the plain version with that kernel's banded semantics: a
    narrow half band, a wide one and wband 0 (the flat outputs)."""
    cfg = LARGE[name][0]
    packed = _large_batch(name)
    B = packed[0].shape[0]
    mod = poa_v2_cuda if kernel == "v2" else poa_cuda
    assert mod.plan(cfg, True)["global_build"] or name == "w2176"
    _assert_band_build_equal(card, cfg, packed, [24, 400, 0][:B], kernel)
    if B == 1:
        _assert_band_build_equal(card, cfg, packed, [0], kernel)


def test_poa_v2_raises_where_the_graph_does_not_fit(card):
    """A graph whose scratch does not fit the card (max_nodes 200,000 by
    max_len 200,000: about 200 GB a window): the wrapper raises on its
    scratch allocation, before any launch."""
    cfg = CFG._replace(max_nodes=200000, max_len=200000)
    dev_in = list(poa.batch_to_tensors(batches.poa_batch(CFG, 1, 22, 100),
                                       card))
    dev_in[4] = torch.zeros((1, CFG.depth, cfg.max_len), dtype=torch.uint8,
                            device=card)
    dev_in[5] = torch.zeros((1, CFG.depth, cfg.max_len), dtype=torch.int32,
                            device=card)
    n0 = dict(cuda_lib.LAUNCHES)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        poa_v2_cuda.poa_consensus_v2(cfg, *dev_in)
    assert cuda_lib.LAUNCHES == n0


@pytest.mark.parametrize("window", [500, 2048, 3072, 10880])
def test_poa_scratch_words_match_the_kernels(card, window):
    """poa_cuda.scratch_words, the pure function the batch cap reads,
    equals both kernels' own scratch layout, with and without the global
    build's graph."""
    cfg = poa_driver.make_config(window, 8, 5, -4, -8)
    for glob in (False, True):
        for lib in (poa_cuda._lib().rt_poa_scratch_words,
                    poa_v2_cuda._lib().rt_poa_v2_scratch_words):
            assert lib(cfg.max_nodes, cfg.max_len, cfg.max_edges,
                       int(glob)) == poa_cuda.scratch_words(cfg, glob)


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_poa_batches_split_by_the_memory_cap(card, kernel, monkeypatch):
    """A class-4096 bucket of five windows on a card whose free memory
    (as poa_driver reads it) holds two windows and the margin: the
    consensus phase, one batch in flight, runs three batches through the
    global build, and every window gets the consensus the CPU run (plain
    version, one batch) gives; with two batches in flight (the default
    depth) each holds one window."""
    cfg = poa_driver.make_config(4096, 8, 5, -4, -8)
    packed = batches.poa_batch(cfg, 5, 24, 4080, layers=(2, 3),
                               shortest=4000)
    assert all(poa_driver.window_class(int(n)) == 4096 for n in packed[2])
    per = poa_driver.window_bytes(cfg)
    fixed, share = poa_driver.MEMORY_MARGIN
    free = int((2.5 * per) / (1 - share)) + fixed
    assert poa_driver.batch_cap(cfg, free) == 2
    assert poa_driver.batch_cap(cfg, free, 2) == 1
    monkeypatch.setattr(poa_driver, "free_device_bytes", lambda dev: free)
    runs = {}
    for dev, depth in (("cpu", 1), ("cuda", 1), ("cuda2", 2)):
        ws = batches.WindowSet(packed)
        cuda_lib.reset_launches()
        st = poa_driver.run_consensus_phase(
            ws, match=5, mismatch=-4, gap=-8, trim=True, device=dev[:4],
            poa_kernel=kernel, pipeline_depth=depth)
        runs[dev] = (ws.consensus, st, dict(cuda_lib.LAUNCHES))
    (want, wst, _), (got, gst, launches) = runs["cpu"], runs["cuda"]
    assert runs["cuda2"][1]["batches"] == 5
    assert runs["cuda2"][0] == want
    assert wst["batches"] == 1 and gst["batches"] == 3
    assert gst["device"] == wst["device"] == 5
    base = "poa_consensus_v2" if kernel == "v2" else "poa_consensus"
    assert launches[base + "_global"] == 3
    assert got == want


def _max_sm_mhz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def test_poa_v2_phase_cycles_fit_in_the_launch(card):
    """Each phase's cycles are non-negative and a window's phases add up
    to no more than the launch lasted, at the card's highest SM clock
    (one window per launch, so the sums are that window's)."""
    cfg = poa.PoaConfig(depth=32)
    packed = batches.poa_batch(cfg, 3, 8, 500)
    dev_in = poa.batch_to_tensors(packed, card)
    mhz = _max_sm_mhz()
    for b in range(3):
        one = [t[b:b + 1].contiguous() for t in dev_in]
        poa_v2_cuda.poa_consensus_v2(cfg, *one)
        st = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        poa_v2_cuda.poa_consensus_v2(cfg, *one, stats=st)
        ev[1].record()
        torch.cuda.synchronize()
        cycles = st["phase_cycles"]
        assert len(cycles) == len(poa_v2_cuda.PHASES)
        assert min(cycles) >= 0 and cycles[1] > 0
        assert st["phase_cycles_max"] == cycles
        assert sum(cycles) <= ev[0].elapsed_time(ev[1]) * mhz * 1e3


#: Each POA build's registers a thread, local (spill) bytes a thread and
#: dynamic shared bytes a block at -w 500 (make_config(500, ...)): the
#: builds the main path runs, which the wide builds (max_len + 1 > 2048)
#: leave as they were. The v2 banded build's, redesigned, have no spill.
W500_RESOURCES = {("ls", False): (127, 0, 107040),
                  ("ls", True): (127, 0, 107040),
                  ("v2", False): (128, 16, 106960)}


@pytest.mark.parametrize("kernel,band", [("ls", False), ("ls", True),
                                         ("v2", False), ("v2", True)])
def test_poa_builds_keep_their_resources_at_w500(card, kernel, band):
    """The -w 500 builds keep their registers, spill and shared bytes; the
    v2 banded build runs within 128 registers with no spill, in the shared
    bytes its plan gives."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    mod = poa_cuda if kernel == "ls" else poa_v2_cuda
    occ = mod.occupancy(cfg, band=band)
    got = (occ["regs"], occ["local_bytes"], occ["shared_bytes"])
    if (kernel, band) in W500_RESOURCES:
        assert got == W500_RESOURCES[kernel, band]
    else:
        assert occ["regs"] <= 128 and occ["local_bytes"] == 0
        assert occ["shared_bytes"] == mod.plan(cfg, band)["shared_bytes"]
    assert occ["blocks_per_sm"] >= 2


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_poa_kernels_run_a_full_batch_at_w2000(card, kernel):
    """256 windows at -w 2000's geometry (backbone class 2048, max_len
    3072: the wide build, one block an SM, about 95 MB of global scratch a
    window), flat and banded: the batch fits the card, and every window
    equals the plain version's run of the same window (the batch tiles
    four windows of two or three layers)."""
    cfg = poa_driver.make_config(2048, 8, 5, -4, -8)
    packed = batches.poa_batch(cfg, 4, 23, 2000, layers=(2, 3))
    wband = torch.tensor([0, 12, 60, 400], dtype=torch.int32)
    fn = poa_driver.kernel_for(kernel)
    small = poa.batch_to_tensors(packed, "cpu")
    tile = torch.arange(256) % 4
    dev_in = [t[tile].contiguous().to(card) for t in small]
    for wb in (None, wband):
        kw = {} if wb is None else {"wband": wb}
        want = fn(cfg, *small, **kw)
        got = fn(cfg, *dev_in, **({} if wb is None else
                                  {"wband": wb[tile].contiguous().to(card)}))
        torch.cuda.synchronize()
        for k, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(g.cpu().numpy(), w[tile].numpy(),
                                          err_msg=f"output {k}, wband {wb}")


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_poa_kernels_fit_two_blocks_an_sm(card, kernel):
    """At the main path's geometry (-w 500) each POA kernel has at least
    two blocks an SM, so a batch of 256 windows is resident at once on the
    card's 132 SMs, within 128 registers a thread."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    mod = poa_cuda if kernel == "ls" else poa_v2_cuda
    occ = mod.occupancy(cfg)
    assert occ["regs"] <= 128
    assert occ["blocks_per_sm"] >= 2


def test_poa_v2_band_build_fits_two_blocks_an_sm(card):
    """The banded build at -w 500: its own shared-memory plan (ring 8, the
    in-edge sources on chip, the row descriptors beside them) and, as the
    flat build, two blocks an SM within 128 registers a thread, with no
    local bytes."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    occ = poa_v2_cuda.occupancy(cfg, band=True)
    plan = poa_v2_cuda.plan(cfg, band=True)
    assert plan["ring"] == 8 and plan["src_in_shared"] == 1
    assert occ["shared_bytes"] == plan["shared_bytes"]
    assert occ["regs"] <= 128 and occ["local_bytes"] == 0
    assert occ["blocks_per_sm"] >= 2


#: Each POA kernel's wrapper and its banded build's launch-count name.
BAND_BUILDS = {"v2": (poa_v2_cuda.poa_consensus_v2, "poa_consensus_v2_band"),
               "ls": (poa_cuda.poa_consensus, "poa_consensus_band")}


def _assert_band_build_equal(card, cfg, packed, wband, kernel="v2"):
    """A kernel's banded build (its global build where the plan says so)
    against the plain version with its banded semantics (all six outputs
    and the band cells; v2 also its serial steps); at wband 0 against the
    flat build as well."""
    fn, name = BAND_BUILDS[kernel]
    mod = poa_v2_cuda if kernel == "v2" else poa_cuda
    if mod.plan(cfg, True)["global_build"]:
        name += "_global"
    wb = torch.as_tensor(np.asarray(wband), dtype=torch.int32)
    want_st, got_st = {}, {}
    want = fn(cfg, *poa.batch_to_tensors(packed, "cpu"), wband=wb,
              stats=want_st)
    dev_in = poa.batch_to_tensors(packed, card)
    n0 = cuda_lib.LAUNCHES[name]
    got = fn(cfg, *dev_in, wband=wb.to(card), stats=got_st)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == n0 + 1
    assert len(got) == 6
    assert got_st["cells"] == want_st["cells"] > 0
    if kernel == "v2":
        assert got_st["steps"] == want_st["steps"]
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=f"output {k}")
    if not wb.any():
        flat = fn(cfg, *dev_in)
        for f, g in zip(flat, got):
            assert torch.equal(f, g)
    return want


@pytest.mark.parametrize("window", [500, 1280, 1500, 2000])
@pytest.mark.parametrize("wband,roll", [(0, 0), (8, 0), (1, 5)])
def test_poa_v2_band_build_equals_plain(card, window, wband, roll):
    """The banded fixture of the JAX package's tests (tools.batches
    band_batch) at -w 500, 1280, 1500 and 2000 (their window classes'
    geometries; the last two the wide build): wband 0 (flat), 8, and 1 on
    layers that drift off the diagonal (every window hits)."""
    cfg = poa_driver.make_config(poa_driver.window_class(window), 4, 5, -4,
                                 -8)
    packed = batches.band_batch(cfg, 4, window + roll, roll)
    want = _assert_band_build_equal(card, cfg, packed, [wband] * 4)
    if roll:
        assert want[5].all()


def test_poa_v2_band_build_equals_plain_on_mixed_bands(card):
    """Mutated windows of 2..32 layers at -w 500, each under its own half
    band (0, narrow ones that hit, wide ones that do not)."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    packed = batches.poa_batch(cfg, 8, 31, 500)
    want = _assert_band_build_equal(card, cfg, packed,
                                    [0, 1, 3, 6, 12, 24, 48, 100])
    assert want[5].any() and not want[5].all()


def test_poa_ls_band_build_fits_two_blocks_an_sm(card):
    """The ls kernel's banded build at -w 500: the flat build's shared
    memory and, as the flat build, two blocks an SM."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    occ = poa_cuda.occupancy(cfg, band=True)
    assert occ["shared_bytes"] == poa_cuda.occupancy(cfg)["shared_bytes"]
    assert occ["blocks_per_sm"] >= 2


@pytest.mark.parametrize("window", [500, 1280, 1500, 2000])
@pytest.mark.parametrize("wband,roll", [(0, 0), (8, 0), (1, 5)])
def test_poa_ls_band_build_equals_plain(card, window, wband, roll):
    """The ls kernel's banded build on band_batch at -w 500, 1280, 1500 and
    2000 (their window classes' geometries; the last two the wide build):
    wband 0 (the flat build's outputs), 8, and 1 on drifting layers."""
    cfg = poa_driver.make_config(poa_driver.window_class(window), 4, 5, -4,
                                 -8)
    packed = batches.band_batch(cfg, 4, window + roll, roll)
    want = _assert_band_build_equal(card, cfg, packed, [wband] * 4, "ls")
    if roll:
        assert want[5].all()


#: Random windows of about 100 bases (tools.batches.poa_batch) as the CPU
#: tests hold the plain ls banded semantics to the Pallas build on them:
#: (seed, rate, half bands); "stuck" has a walk that gets stuck.
LS_BAND_CFG = poa.PoaConfig(512, 128, 128, 8, 8, 5, -4, -8)
LS_BAND_CASES = {
    "s0_r10": (0, 0.1, None), "s4_r10": (4, 0.1, None),
    "s4_r20": (4, 0.2, None), "stuck": (5, 0.15, [3] * 8)}


@pytest.mark.parametrize("case", sorted(LS_BAND_CASES))
def test_poa_ls_band_build_equals_plain_where_rule_1_fails(card, case):
    """Half bands drawn from 1..23: the ls build fails windows whose best
    end score is no better than NEG (rule 1), which v2's banded semantics
    serve; every output equals the plain ls semantics."""
    seed, rate, wband = LS_BAND_CASES[case]
    packed = batches.poa_batch(LS_BAND_CFG, 8, seed, 100, rate)
    if wband is None:
        wband = np.random.default_rng(1000 + seed).integers(1, 24, 8)
    want = _assert_band_build_equal(card, LS_BAND_CFG, packed, wband, "ls")
    assert want[3].any()
    if case != "stuck":
        v2 = poa_v2_cuda.poa_consensus_v2(
            LS_BAND_CFG, *poa.batch_to_tensors(packed, "cpu"),
            wband=torch.as_tensor(wband, dtype=torch.int32))
        assert (want[3] & ~v2[3]).any()


def test_poa_ls_band_build_equals_plain_on_mixed_bands(card):
    """Mutated windows of 2..32 layers at -w 500 under eight half bands in
    one launch of the ls kernel's banded build."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    packed = batches.poa_batch(cfg, 8, 31, 500)
    want = _assert_band_build_equal(card, cfg, packed,
                                    [0, 1, 3, 6, 12, 24, 48, 100], "ls")
    assert want[5].any() and not want[5].all()


@pytest.mark.parametrize("band", [False, True])
def test_poa_ls_phase_cycles_fit_in_the_launch(card, band):
    """The ls kernel's phase cycles, flat and banded build: non-negative,
    the DP's positive, and a window's phases add up to no more than the
    launch lasted at the card's highest SM clock (one window a launch)."""
    cfg = poa.PoaConfig(depth=32)
    packed = batches.poa_batch(cfg, 3, 8, 500)
    dev_in = poa.batch_to_tensors(packed, card)
    kw = {"wband": torch.tensor([24], dtype=torch.int32,
                                device=card)} if band else {}
    mhz = _max_sm_mhz()
    for b in range(3):
        one = [t[b:b + 1].contiguous() for t in dev_in]
        poa_cuda.poa_consensus(cfg, *one, **kw)
        st = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        poa_cuda.poa_consensus(cfg, *one, stats=st, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        cycles = st["phase_cycles"]
        assert len(cycles) == len(poa_cuda.PHASES)
        assert min(cycles) >= 0 and cycles[1] > 0
        assert st["phase_cycles_max"] == cycles
        assert sum(cycles) <= ev[0].elapsed_time(ev[1]) * mhz * 1e3


@pytest.mark.parametrize("wband", [None, [0, 8, 120, 3]])
def test_poa_ls_builds_equal_plain_across_far_predecessors(card, wband):
    """batches.far_pred_batch: rows whose predecessor ranks about 100
    before them, beyond any ring of rows the kernel keeps (so read from
    the global H), flat and under half bands that admit the insertion and
    ones that do not."""
    cfg = CFG._replace(depth=6)
    packed = batches.far_pred_batch(cfg)
    if wband is None:
        want_st, got_st = {}, {}
        want = poa_cuda.poa_consensus(
            cfg, *poa.batch_to_tensors(packed, "cpu"), stats=want_st)
        got = poa_cuda.poa_consensus(
            cfg, *poa.batch_to_tensors(packed, card), stats=got_st)
        torch.cuda.synchronize()
        assert got_st["cells"] == want_st["cells"]
        for k, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=f"output {k}")
    else:
        want = _assert_band_build_equal(card, cfg, packed, wband, "ls")
    # the windows whose band admits the insertion keep it and fold in all
    # layers; the narrow ones fail at the first layer (rule 1 or the walk)
    keep = [0, 1, 2, 3] if wband is None else [0, 2]
    assert not want[3][keep].any() and (want[4][keep] > 200).all()


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_poa_band_builds_equal_plain_where_keys_collide(card, kernel):
    """batches.equal_key_batch under half bands, narrow on two windows and
    wide on the rest: banded rows with predecessors ranked after them
    (the descriptor's stale flag: their moves re-derived from the global
    H) equal the plain version's, all six outputs."""
    cfg = CFG._replace(depth=16)
    packed = batches.equal_key_batch(cfg)
    B = packed[0].shape[0]
    _assert_band_build_equal(card, cfg, packed, [6, 6] + [200] * (B - 2),
                             kernel)


@pytest.mark.parametrize("wband", [[0, 8, 120, 3], [2, 30, 60, 500]])
def test_poa_v2_band_build_equals_plain_across_far_predecessors(card,
                                                                wband):
    """The v2 banded build on batches.far_pred_batch: rows whose
    predecessor ranks about 100 before them (read from the global H, the
    descriptor's rank distance), under half bands that admit the insertion
    and ones that do not."""
    cfg = CFG._replace(depth=6)
    packed = batches.far_pred_batch(cfg)
    _assert_band_build_equal(card, cfg, packed, wband)


@pytest.mark.parametrize("wband", [None, [0, 2, 5, 40]])
def test_poa_ls_builds_equal_plain_at_32_edge_slots(card, wband):
    """max_edges = 32, the most the ls kernel takes: its walk then fetches
    two records a lane instead of one."""
    cfg = CFG._replace(max_edges=32)
    packed = batches.poa_batch(cfg, 4, 12, 100, 0.25)
    if wband is None:
        want = poa_cuda.poa_consensus(cfg,
                                      *poa.batch_to_tensors(packed, "cpu"))
        got = poa_cuda.poa_consensus(cfg,
                                     *poa.batch_to_tensors(packed, card))
        torch.cuda.synchronize()
        for k, (w, g) in enumerate(zip(want, got)):
            np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                          err_msg=f"output {k}")
    else:
        _assert_band_build_equal(card, cfg, packed, wband, "ls")


@pytest.mark.parametrize("mode", range(probe.N_MODES))
def test_probe_kernel_equals_plain(card, mode):
    """out, steps and the whole last DP row (or ring row) of every
    program, so that no column of the row goes unchecked."""
    seed = torch.tensor([0, 7, 123], dtype=torch.int32, device=card)
    want = probe.probe_plain(mode, 50, seed, rows=True)
    n0 = cuda_lib.LAUNCHES["dp_cost_probe"]
    got = probe.probe(mode, 50, seed, rows=True)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES["dp_cost_probe"] == n0 + 1
    assert got[2].shape == want[2].shape == (3, probe.ROW_WIDTH[mode])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


EDGE_BANDS = [128, 256, 512, 1024, 2048]


def _assert_edge_equal(card, scal, q, t, K, backward):
    want = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, "cpu"), K, backward)
    name = ac.launch_name("hirschberg_edge", K)
    n0 = cuda_lib.LAUNCHES[name]
    got = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, card), K, backward)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == n0 + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    return want


@pytest.mark.parametrize("K", EDGE_BANDS)
@pytest.mark.parametrize("backward", [False, True])
def test_edge_kernel_equals_plain(card, K, backward):
    _assert_edge_equal(card, *batches.edge_batch(K, 6, K + backward), K,
                       backward)


@pytest.mark.parametrize("K", EDGE_BANDS)
@pytest.mark.parametrize("backward", [False, True])
def test_edge_kernel_equals_plain_on_special_tasks(card, K, backward):
    """R = 1 with S = 0, R a multiple of neither 4 nor 32, dmin <= -K,
    dmin > 0, S = rcap + K and N codes (batches.edge_tasks): the boundary
    cells the kernel derives without a per-cell test."""
    want = _assert_edge_equal(card, *batches.edge_tasks(K, K * 2 + backward),
                              K, backward)
    assert (want < ac.INF).any(axis=1).sum() >= 8


@pytest.mark.parametrize("K", EDGE_BANDS)
def test_edge_kernel_equals_plain_across_many_code_words(card, K):
    """rcap 4096: rows that cross many 32-row blocks of entering target
    codes and 128-row chunks of query words, in both directions."""
    for backward in (False, True):
        scal, q, t = batches.edge_batch(K, 24, 40 + K + backward, rcap=4096)
        assert scal[:, 0].max() > 2048
        _assert_edge_equal(card, scal, q, t, K, backward)


def test_edge_kernel_cycles_fit_in_the_launch(card):
    """Each task's row-loop cycles are positive, one a task, and the
    largest fits inside the launch's event time at the card's highest SM
    clock; a cycles buffer of the wrong shape raises."""
    K = 1024
    B = 60
    scal, q, t = ac.tasks_to_tensors(*batches.edge_batch(K, B, 3, 2048),
                                     card)
    for backward in (False, True):
        ac.edge_rows(scal, q, t, K, backward)
        cycles = torch.zeros(B, dtype=torch.int64, device=card)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        got = ac.edge_rows(scal, q, t, K, backward, cycles=cycles)
        ev[1].record()
        torch.cuda.synchronize()
        assert torch.equal(got, ac.edge_rows(scal, q, t, K, backward))
        c = cycles.cpu()
        assert c.shape == (B,) and (c > 0).all()
        assert int(c.max()) <= ev[0].elapsed_time(ev[1]) * \
            _max_sm_mhz() * 1e3
        with pytest.raises(ValueError):
            ac.edge_rows(scal, q, t, K, backward, cycles=cycles[:10])


def test_edge_kernel_rejects_unaligned_query(card):
    """The kernel reads q as 32-bit words: a q whose data starts one byte
    into its buffer raises before any launch."""
    K = 256
    scal, q, t = ac.tasks_to_tensors(*batches.edge_batch(K, 4, 9), card)
    buf = torch.zeros(q.numel() + 4, dtype=torch.uint8, device=card)
    q1 = buf[1:1 + q.numel()].view(q.shape)
    q1.copy_(q)
    assert q1.data_ptr() % 4 == 1 and q1.is_contiguous()
    name = ac.launch_name("hirschberg_edge", K)
    n0 = cuda_lib.LAUNCHES[name]
    for backward in (False, True):
        with pytest.raises(ValueError, match="aligned"):
            ac.edge_rows(scal, q1, t, K, backward)
    assert cuda_lib.LAUNCHES[name] == n0


@pytest.mark.parametrize("K", EDGE_BANDS)
def test_edge_kernel_occupancy(card, K):
    for backward in (False, True):
        occ = ac.edge_occupancy(K, backward)
        assert 0 < occ["regs"] <= 255
        assert occ["warps_per_sm"] >= 1
        assert occ["local_bytes"] >= 0


def _base_tasks(K, B, seed):
    """B base tasks at band K: full 256-row tasks with S up to 256 + K,
    tasks of random size near the band's middle, tasks whose path leaves
    the band, R = 1 / S = 0, and a padding task last (R = 1, S = 0,
    dmin = 0). The target is the query with 10% of its codes changed."""
    rng = np.random.default_rng(seed)
    RB = ac.BASE_ROWS
    scal = np.zeros((B, 4), np.int32)
    q = rng.integers(0, 4, (B, RB)).astype(np.uint8)
    t = np.full((B, RB + K), 255, np.uint8)
    for b in range(B - 1):
        kind = b % 4
        if kind == 0:                        # full rows, wide drift
            R, S = RB, int(rng.integers(RB, RB + K + 1))
        elif kind == 1:                      # random size, near diagonal
            R = int(rng.integers(1, RB + 1))
            S = int(rng.integers(max(0, R - K // 4), R + K // 4))
        elif kind == 2:                      # leaves the band
            R = int(rng.integers(1, RB + 1))
            S = int(rng.integers(0, RB + K + 1))
        else:
            R, S = 1, 0
        drift = S - R
        dmin = -((K - 1 - abs(drift)) // 2) + min(0, drift)
        if kind == 2:
            dmin += int(rng.integers(-K, K))
        scal[b] = (R, S, dmin, 0)
        src = np.concatenate([q[b, :R], rng.integers(0, 4, RB + K)])[:S]
        flip = rng.random(S) < 0.1
        src[flip] = rng.integers(0, 4, int(flip.sum()))
        t[b, :S] = src
    scal[-1] = (1, 0, 0, 0)
    return scal, q, t


def _assert_base_equal(card, scal, q, t, K):
    want = ac.base_case(*ac.tasks_to_tensors(scal, q, t, "cpu"), K)
    name = ac.launch_name("hirschberg_base", K)
    n0 = cuda_lib.LAUNCHES[name]
    got = ac.base_case(*ac.tasks_to_tensors(scal, q, t, card), K)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[name] == n0 + 1
    for name, w, g in zip(("ops", "cnt", "ok", "dist"), want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy(),
                                      err_msg=name)
    return want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("K", [128, 256, 512, 1024, 2048])
def test_base_kernel_equals_plain(card, K, seed):
    scal, q, t = _base_tasks(K, 41, K + seed)
    want = _assert_base_equal(card, scal, q, t, K)
    ok = want[2].numpy()
    assert ok.any() and not ok.all()        # paths in and out of band
    assert (scal[:, 0] == ac.BASE_ROWS).any()


def test_base_kernel_equals_plain_across_waves(card):
    """3,000 tasks at K = 256: more warps than the card holds at once, so
    the packed moves' offsets are checked across many blocks."""
    scal, q, t = _base_tasks(256, 3000, 5)
    _assert_base_equal(card, scal, q, t, 256)


@pytest.mark.parametrize("K", [128, 256, 512, 1024, 2048])
def test_base_kernel_has_no_spill(card, K):
    occ = ac.base_occupancy(K)
    assert occ["local_bytes"] == 0
    assert occ["warps_per_sm"] >= 8


def test_base_kernel_cycles_fit_in_the_launch(card):
    """Each task's DP and traceback cycles are positive, and the largest
    task's sum fits inside the launch's event time at the card's highest
    SM clock."""
    K = 1024
    scal, q, t = ac.tasks_to_tensors(*_base_tasks(K, 200, 3), card)
    ac.base_case(scal, q, t, K)
    cycles = torch.zeros((2, 200), dtype=torch.int64, device=card)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    got = ac.base_case(scal, q, t, K, cycles=cycles)
    ev[1].record()
    torch.cuda.synchronize()
    want = ac.base_case(scal, q, t, K)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    c = cycles.cpu()
    assert (c > 0).all()
    assert int(c.sum(0).max()) <= ev[0].elapsed_time(ev[1]) * \
        _max_sm_mhz() * 1e3
    with pytest.raises(ValueError):
        ac.base_case(scal, q, t, K, cycles=cycles[:, :10])


def test_launch_events_time_each_launch_alone(card):
    """With cuda_lib.LAUNCH_EVENTS set to a list, each aligner launch adds
    one (name, start, end) whose events bracket the kernel; unset, none."""
    K = 512
    scal, q, t = ac.tasks_to_tensors(*_base_tasks(K, 40, 4), card)
    cuda_lib.LAUNCH_EVENTS = []
    try:
        ac.base_case(scal, q, t, K)
        ac.base_case(scal, q, t, K)
        events = cuda_lib.LAUNCH_EVENTS
    finally:
        cuda_lib.LAUNCH_EVENTS = None
    torch.cuda.synchronize()
    assert [e[0] for e in events] == ["hirschberg_base"] * 2
    assert all(a.elapsed_time(b) > 0 for _, a, b in events)
    ac.base_case(scal, q, t, K)
    assert cuda_lib.LAUNCH_EVENTS is None


def test_base_kernel_at_k128_equals_plain_across_waves(card):
    """3,000 tasks at K = 128, where two threads share each byte pair of
    moves: the packed offsets across many blocks."""
    scal, q, t = _base_tasks(128, 3000, 6)
    _assert_base_equal(card, scal, q, t, 128)


def test_align_pairs_with_band_overrides_on_card_equals_cpu(card):
    """Band overrides at K = 128 (the banded path's first rung), on pairs
    of which some certify and some hit: ops and hits equal the CPU run's,
    and the K = 128 builds launch."""
    pairs = batches.align_pairs(9, 8, 600, 3000, rate=(0.01, 0.2))
    over = {i: 128 for i in range(len(pairs))}
    want_hits, got_hits = set(), set()
    want = ac.align_pairs(pairs, device="cpu", band_overrides=over,
                          hits=want_hits)
    n0 = cuda_lib.LAUNCHES["hirschberg_edge_k128"]
    got = ac.align_pairs(pairs, device=card, band_overrides=over,
                         hits=got_hits)
    assert cuda_lib.LAUNCHES["hirschberg_edge_k128"] > n0
    assert got_hits == want_hits and 0 < len(want_hits) < len(pairs)
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)


def test_align_pairs_on_card_equals_cpu(card):
    pairs = batches.align_pairs(7, 8, 200, 3000)
    want = ac.align_pairs(pairs, device="cpu")
    got = ac.align_pairs(pairs, device=card)
    assert sum(g is not None for g in got) >= 6
    for w, g in zip(want, got):
        assert (w is None) == (g is None)
        if g is not None:
            np.testing.assert_array_equal(g, w)
