"""The distrib fleet on the card.

Every test here needs an NVIDIA card and skips without one; the file
imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_distrib.py

Two worker processes share the card on a small four-contig set: the
fleet's FASTA is the sequential polish's on the card, no chunk builds or
loads a kernel (the coordinator builds, each worker loads before its
first chunk), and each worker sizes its consensus batches from half the
card (``--memory-share 0.5``: ``poa_driver.sizing_bytes``).
"""

import os

import pytest
import torch

from racon_tpu_torch import TorchPolisher
from racon_tpu_torch.distrib import Coordinator
from racon_tpu_torch.tools import simulate

pytestmark = pytest.mark.cuda

ARGS = dict(window_length=500, match=5, mismatch=-4, gap=-8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = simulate.generate(str(tmp_path_factory.mktemp("distrib")), mbp=0.04,
                          coverage=20, seed=11, contigs=4)
    return d["reads"], d["overlaps"], d["draft"]


def test_two_workers_on_the_card_give_the_sequential_bytes(data, tmp_path):
    p = TorchPolisher(*data, device="cuda", **ARGS)
    p.initialize()
    want = "".join(f">{n}\n{s}\n" for n, s in p.polish(True))
    del p
    torch.cuda.empty_cache()
    coord = Coordinator(*data, str(tmp_path / "coord"), args=ARGS,
                        workers=2, chunks_hint=4)
    out = str(tmp_path / "out.fasta")
    res = coord.run(out, timeout=600)
    with open(out) as f:
        assert f.read() == want
    assert res["served"] == {"fleet": 4, "local": 0}
    assert res["memory_share"] == 0.5
    rows = res["chunk_stats"]
    assert [r["kernel_builds"] for r in rows] == [0] * 4
    assert sum(r["launches"].get("poa_consensus", 0) for r in rows) > 0
    for r in rows:
        half = 0.5 * r["device_total_mb"]
        assert r["memory_share"] == 0.5
        assert 0 < r["device_budget_mb"] <= half
        assert 0 < r["device_peak_mb"] <= half
    assert set(res["telemetry"]["workers"]) <= {"0", "1"}
    assert os.path.isfile(os.path.join(str(tmp_path / "coord"),
                                       "result.json"))
