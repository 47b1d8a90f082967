"""racon_tpu_torch above backbone class 10,880 on the CPU: the POA
kernels' global builds with int32 node ids.

Above 32,767 node slots (make_config's classes above 10,880) only the
global build runs, with int32 node ids (csrc/poa_common.cuh wide_ids):
its launch names, its scratch layout (window_bytes with it) and the plain
version it is held against on the card, on a graph past node id 32,767.
The card tests are in tests/test_torch_cuda_chunked.py; the driver's
memory check in tests/test_torch_global.py.
"""

import torch

from racon_tpu_torch.ops import poa, poa_cuda, poa_driver
from racon_tpu_torch.tools import batches


def test_scratch_words_grow_five_bytes_a_cell_with_int32_ids():
    """Above class 10,880 the scratch is still H and the move records,
    5 bytes a DP cell, with the graph under 2% of it."""
    for wl in (11008, 22016):
        cfg = poa_driver.make_config(wl, 8, 5, -4, -8)
        assert poa_cuda.wide_ids(cfg, True)
        cells = (cfg.max_nodes + 1) * (cfg.max_len + 1)
        flat = 4 * poa_cuda.scratch_words(cfg, False)
        glob = 4 * poa_cuda.scratch_words(cfg, True)
        assert 5 * cells < flat < 5.1 * cells
        assert flat < glob < 1.02 * flat
        assert glob % 16 == 0


def test_int32_global_build_above_class_10880():
    """Above 32,767 node slots the global build takes int32 node ids: its
    launch names end in "_global32", its scratch counts the in-edge
    sources, the four node-id arrays and the band starts at 4 bytes an
    entry (window_bytes with it), and the plain version, which the card's
    int32 builds are held against, carries a graph past node id 32,767
    (batches.wide_id_batch: 32,890 nodes, not failed)."""
    cfg = poa_driver.make_config(11008, 200, 5, -4, -8)
    assert (cfg.max_nodes, cfg.max_len) == (33024, 16512)
    assert poa_cuda.launch_name("poa_consensus_v2", True, True,
                                poa_cuda.wide_ids(cfg, True)) == \
        "poa_consensus_v2_band_global32"
    N, ML, ES = cfg.max_nodes, cfg.max_len, 12
    flat = 4 * poa_cuda.scratch_words(cfg, False)   # int16 sources
    wide = 4 * poa_cuda.scratch_words(cfg, True)

    def align16(x):
        return (x + 15) & ~15

    tiles = (ML + poa_cuda.TILE_COLUMNS) // poa_cuda.TILE_COLUMNS
    graph = sum(align16(b) for b in (
        N * 8, N * 4, N * 4, N * 4, ML * 4, ML * 4, ML * 4,
        tiles * 256 * 4, N * 4, N * 4, N * 4, N * 4, ML * 4, N, ML, N, N,
        N))
    assert 0 <= wide - (flat + N * ES * 2 + graph) < 32
    assert poa_driver.window_bytes(cfg) > wide
    torch.set_num_threads(1)
    packed = batches.wide_id_batch(cfg)
    out = poa.poa_batch_plain(cfg, *poa.batch_to_tensors(packed, "cpu"))
    assert out[4].tolist()[1] == 32890 and not out[3].any()


def test_wide_column_batch_passes_column_32767():
    """batches.wide_column_batch, the card tests' check past column
    32,767: at class 22,016 its long layer (32,900 bases) passes the int16
    range and fits max_len, over a 1,000-base stretch; at class 640 the
    same construction folds into the plain graph, flat equal to banded at
    half band 0 with each kernel's semantics, its long insertion adding a
    node a base."""
    cfg = poa_driver.make_config(22016, 3, 5, -4, -8)
    packed = batches.wide_column_batch(cfg)
    lens, begins, ends = packed[6], packed[7], packed[8]
    assert 32767 < lens[1, 0] == cfg.max_len - 124 == 32900
    assert ends[1, 0] - begins[1, 0] + 1 == 1000
    assert packed[3].tolist() == [3, 2]
    assert poa_cuda.wide_ids(cfg, True)
    torch.set_num_threads(1)
    cfg = poa_driver.make_config(640, 3, 5, -4, -8)
    dev = poa.batch_to_tensors(batches.wide_column_batch(cfg), "cpu")
    flat = poa.poa_batch_plain(cfg, *dev)
    assert not flat[3].any()
    assert int(flat[4][1]) - int(dev[2][1]) >= int(dev[6][1, 0]) - 160
    for kernel in ("ls", "v2"):
        band = poa.poa_batch_plain(cfg, *dev, kernel=kernel,
                                   wband=torch.zeros(2, dtype=torch.int32))
        for a, b in zip(flat, band):
            assert torch.equal(a, b)
