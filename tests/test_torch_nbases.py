"""N bases (code 4) through the port's plain POA and aligner, against the
JAX package's.

A POA batch whose backbones and layers carry N at 5%
(``tools.batches.poa_batch(n_rate=)``) goes through the JAX twin
(``racon_tpu.ops.poa.build_poa_kernel``) and through the port's plain
version of each POA kernel on the CPU: all five outputs equal (tolerance
0). One pair with N in query and target goes through
``racon_tpu.ops.align_pallas.align_pairs`` in interpret mode and the
port's ``align_pairs`` on the CPU (the edge kernel's and the base case's
plain versions): the same ops. The CUDA kernels are held to these plain
versions on N batches in tests/test_torch_cuda.py and by chip_smoke.py.
"""

import numpy as np
import pytest

from racon_tpu.ops import align_pallas as ap
from racon_tpu.ops import poa as jpoa
from racon_tpu.ops.encoding import encode as jencode
from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.ops import poa, poa_driver
from racon_tpu_torch.tools import batches

CFG = poa.PoaConfig(max_nodes=384, max_len=256, max_backbone=128,
                    max_edges=12, depth=8, match=5, mismatch=-4, gap=-8)


@pytest.fixture(scope="module")
def n_batch():
    packed = batches.poa_batch(CFG, 4, 17, 100, n_rate=0.05)
    want = jpoa.build_poa_kernel(jpoa.PoaConfig(**CFG._asdict()))(
        *packed[:9])
    return packed, [np.asarray(w) for w in want]


@pytest.mark.parametrize("kernel", poa_driver.POA_KERNELS)
def test_plain_poa_with_n_equals_jax_twin(n_batch, kernel):
    packed, want = n_batch
    assert (packed[0] == 4).any() and (packed[4] == 4).any()
    got = poa_driver.kernel_for(kernel)(
        CFG, *poa.batch_to_tensors(packed, "cpu"))
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      w.astype(np.int64),
                                      err_msg=f"output {k}")
    assert not want[3].any()


def test_plain_aligner_with_n_equals_pallas():
    rng = np.random.default_rng(23)
    q = rng.choice(list(b"ACGT"), 300).astype(np.uint8)
    t = q.copy()
    flip = rng.random(300) < 0.08
    t[flip] = rng.choice(list(b"ACGT"), int(flip.sum()))
    q[rng.random(300) < 0.05] = ord("N")
    t[rng.random(300) < 0.05] = ord("N")
    t = np.concatenate([t[:150], t[160:], rng.choice(list(b"ACGT"), 4)
                        .astype(np.uint8)])
    enc = [(jencode(q).astype(np.int32), jencode(t).astype(np.int32))]
    assert (enc[0][0] == 4).any() and (enc[0][1] == 4).any()
    (want,) = ap.align_pairs(enc, interpret=True)
    (got,) = ac.align_pairs([(a.astype(np.uint8), b.astype(np.uint8))
                             for a, b in enc], device="cpu")
    assert want is not None and got is not None
    np.testing.assert_array_equal(got, want)
