"""racon_tpu_torch above -w 2048: the POA geometry of the kernels' global
build against the JAX package, and poa_driver's limits and batch cap.

From backbone class 2176 up, no shared-memory layout of the POA kernels
fits a block on the card, and each kernel runs its global build
(csrc/poa.cu, csrc/poa_v2.cu); the JAX package serves those classes
through its XLA twin (racon_tpu/ops/poa.py ``build_poa_kernel``). On the
CPU the port's wrappers run the plain version, which must equal the twin
on all five outputs (tolerance 0: integers). The twin copies its whole H
of (max_nodes + 1) x (max_len + 1) cells at every DP row on the CPU, so a
-w 2500 polish through TpuPolisher takes about 12 minutes here (742 s
for the twin alone on two windows of 2,500 bases); the test holds the
batch at -w 2500's geometry (class 2560: max_nodes 7,680, max_len 3,840)
with short windows instead. The CUDA global builds are held against the
plain version in tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from racon_tpu.ops import poa as jpoa
from racon_tpu_torch.ops import poa, poa_cuda, poa_driver, poa_v2_cuda
from racon_tpu_torch.tools import batches


@pytest.fixture(scope="module")
def class_2560():
    """Two windows of about 120 bases with 2-3 layers at -w 2500's
    geometry, and the JAX twin's outputs on them."""
    torch.set_num_threads(1)
    cfg = poa_driver.make_config(poa_driver.window_class(2500), 8, 5, -4, -8)
    assert (cfg.max_nodes, cfg.max_len) == (7680, 3840)
    packed = batches.poa_batch(cfg, 2, 25, 120, layers=(2, 3))
    want = [np.asarray(x) for x in jpoa.build_poa_kernel(cfg)(*packed[:9])]
    return cfg, packed, want


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_class_2560_batch_equals_jax_twin(class_2560, kernel):
    """Each POA wrapper on the CPU (the plain version of its kernel's
    global build) at -w 2500's geometry equals the JAX twin, which
    racon_tpu serves that window class through."""
    cfg, packed, want = class_2560
    got = poa_driver.kernel_for(kernel)(
        cfg, *poa.batch_to_tensors(packed, "cpu"))
    assert not want[3].any()
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      w.astype(np.int64),
                                      err_msg=f"output {k}")


def test_largest_window_is_the_node_id_limit():
    """make_config's max_nodes (3 x the window class, on the 128 grid)
    stays within int16 node ids up to -w 10,880; above it the global
    build takes int32 ids, so the largest window is the one whose
    scratch fits the card: about -w 55,000 on an 80 GB card, by memory
    (about 22.5 x class^2 bytes a window)."""
    cfg = poa_driver.make_config(10880, 8, 5, -4, -8)
    assert (cfg.max_nodes, cfg.max_len) == (32640, 16384)
    assert not poa_cuda.wide_ids(cfg, True)
    big = poa_driver.make_config(11008, 8, 5, -4, -8)
    assert big.max_nodes > poa_cuda.INT16_NODES
    assert poa_cuda.wide_ids(big, True) and not poa_cuda.wide_ids(big, False)
    room = poa_driver.memory_room(79 * 10**9)
    wl = poa_driver.largest_window(room, 8)
    assert 54000 < wl < 57000 and wl % 128 == 0
    assert poa_driver.window_bytes(
        poa_driver.make_config(wl, 8, 0, 0, 0)) <= room
    assert poa_driver.window_bytes(
        poa_driver.make_config(wl + 128, 8, 0, 0, 0)) > room
    for c, gb in ((10880, 2.7), (16384, 6.0), (40064, 36.0)):
        per = poa_driver.window_bytes(poa_driver.make_config(c, 8, 0, 0, 0))
        assert abs(per / 1e9 - gb) < 0.1 * gb
    assert poa_driver.largest_window(10**5, 8) == 0


@pytest.mark.parametrize("kernel", ["ls", "v2"])
def test_check_geometries_names_the_node_id_limit(kernel):
    """check_memory passes every class whose window fits the free memory
    less the margin, above the int16 node ids (class 11,008 and up, the
    int32 global build) too, and raises one ValueError only where a
    single window does not fit, naming the largest -w that does; it
    needs no card."""
    free = 79 * 10**9
    ok = [poa_driver.make_config(wl, 32, 5, -4, -8)
          for wl in (500, 2048, 2176, 4096, 10880, 11008, 40064)]
    poa_driver.check_memory(ok, free, kernel)
    bad = poa_driver.make_config(60032, 8, 5, -4, -8)
    with pytest.raises(ValueError) as e:
        poa_driver.check_memory(ok + [bad], free, kernel)
    msg = str(e.value)
    wl = poa_driver.largest_window(poa_driver.memory_room(free), 8)
    assert f"the {kernel} POA kernel" in msg
    assert "backbone class 60032" in msg
    assert msg.endswith(f"the largest window length that fits is -w {wl}")
    with pytest.raises(ValueError, match="-w 10880$"):
        poa_driver.check_memory(
            [bad], poa_driver.window_bytes(poa_driver.make_config(
                10880, 8, 0, 0, 0)) * 10 // 9 + (1 << 30) + 1000, kernel)


def test_scratch_words_grow_five_bytes_a_cell():
    """A window's scratch is H (4 bytes a DP cell) and the move records
    (1 byte) over (max_nodes + 1) x (max_len + 1) cells, and a little for
    the edges; the global build's graph adds under 2% at every class."""
    for wl in (500, 2048, 3072, 4096, 10880):
        cfg = poa_driver.make_config(wl, 8, 5, -4, -8)
        cells = (cfg.max_nodes + 1) * (cfg.max_len + 1)
        flat = 4 * poa_cuda.scratch_words(cfg, False)
        glob = 4 * poa_cuda.scratch_words(cfg, True)
        assert 5 * cells < flat < 5.1 * cells
        assert flat < glob < 1.02 * flat
        assert glob % 16 == 0


def test_batch_cap_by_geometry():
    """batch_cap, a pure function of the geometry and the free bytes:
    256 windows of depth 200 fit an 80 GB card up to class 3072 (about
    98 MB a window at 2048, 218 MB at 3072), fewer above (385 MB at 4096,
    2.7 GB at 10,880), never fewer than one; the margin is 1 GiB and a
    tenth of the rest."""
    free = 79 * 10**9

    def cap(wl, depth=200, room=free):
        return poa_driver.batch_cap(
            poa_driver.make_config(wl, depth, 5, -4, -8), room)

    assert cap(500) > cap(2048) > cap(3072) >= 256 > cap(4096) > cap(10880)
    assert (cap(3072), cap(4096), cap(10880)) == (321, 182, 26)
    assert cap(10880, room=10**9) == 1
    cfg = poa_driver.make_config(4096, 200, 5, -4, -8)
    per = poa_driver.window_bytes(cfg)
    assert 380e6 < per < 390e6
    fixed, share = poa_driver.MEMORY_MARGIN
    assert (fixed, share) == (1 << 30, 0.1)
    for n in (1, 2, 7):
        room = int(n * per / (1 - share)) + fixed + 1000
        assert poa_driver.batch_cap(cfg, room) == n


def test_window_set_exports_its_batch():
    """tools.batches.WindowSet, the consensus phase's stand-in pipeline in
    the card test of the memory cap: its windows, packed by poa_driver,
    are the batch it was made of, and the CPU consensus phase serves them
    all in one batch."""
    cfg = poa_driver.make_config(256, 8, 5, -4, -8)
    packed = batches.poa_batch(cfg, 3, 26, 250, layers=(2, 4),
                               shortest=240)
    ws = batches.WindowSet(packed)
    chunk = [(i, ws.export_window(i), list(range(int(packed[3][i]))))
             for i in range(3)]
    again = poa_driver._pack(chunk, cfg)
    for k in range(9):
        np.testing.assert_array_equal(again[k], packed[k], err_msg=str(k))
    st = poa_driver.run_consensus_phase(ws, match=5, mismatch=-4, gap=-8,
                                        trim=False, device="cpu")
    assert (st["device"], st["batches"]) == (3, 1)
    want = poa_v2_cuda.poa_consensus_v2(cfg,
                                        *poa.batch_to_tensors(packed, "cpu"))
    for i in range(3):
        bases, polished = ws.consensus[i]
        assert polished and len(bases) == int(want[2][i])

