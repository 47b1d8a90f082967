"""racon_tpu_torch's ls banded semantics against the JAX package's ls
kernel's banded build (``build_lockstep_poa_kernel(band=True)``).

``poa_batch_plain(wband=, kernel="ls")`` (what ``poa_cuda.poa_consensus``
runs for CPU tensors) must equal the Pallas build in interpret mode on all
six outputs, band_hit included (tolerance 0: every output is an integer):
on tests/test_band.py's banded batches, on random windows whose narrow
bands fail some layers by the ls build's rule 1 (no end score above NEG)
where v2's banded semantics serve them, on walks that reach column 0 of a
node, and on a walk that gets stuck. At wband 0 it gives the flat outputs.
End to end, ``TorchPolisher(device="cpu", poa_kernel="ls", band=True)``
must write the bytes of ``TpuPolisher`` with ``RACON_TPU_BAND=1`` and
``RACON_TPU_POA_KERNEL=ls``, and of its own flat and v2 banded runs.

Each JAX reference is computed once, in a module-scoped fixture (two
interpret-mode builds of the Pallas kernel, two JAX polishes), no test
starts a process, and the plain versions run on one thread: the file
takes about 45 s on one CPU core. The CUDA kernel's banded build is held
against the plain version in tests/test_torch_cuda.py and by
chip_smoke.py.

The ls build's re-derivation also takes a diagonal at column 0 where the
cell is NEG + mismatch. The batches here reach column 0 of nodes, but
never that value: it needs a node in band at column 0 whose predecessors
are all masked there, and since keys grow along edges and a layer's band
bounds how far its leading insertions reach left, a predecessor masked at
column 0 has a successor masked there too. Only predecessors ranked after
their node (float32 keys equal along an edge) give that value, and there
the ls build and the plain version already differ flat.
"""

import numpy as np
import pytest
import torch

import racon_tpu
import racon_tpu_torch
from racon_tpu.ops import poa_driver as jpd
from racon_tpu.ops.poa_pallas_ls import build_lockstep_poa_kernel
from racon_tpu_torch.ops import poa
from racon_tpu_torch.tools import batches
from tests.test_band import _polish_dataset

POLISH_KW = dict(window_length=80, match=5, mismatch=-4, gap=-8)
B = 8                                   # the ls build's windows a program

#: tests/test_band.py's banded POA batches: (seed, roll, half band).
BAND_CFG = poa.PoaConfig(256, 128, 128, 8, 4, 5, -4, -8)
BAND_CASES = {"w0": (0, 0, 0), "w8": (0, 0, 8), "drift_w1": (1, 5, 1),
              "drift_w4": (1, 5, 4)}
#: Random windows of about 100 bases: (seed, mutation rate, half bands);
#: None draws each window's half band from 1..23. "stuck" holds a walk
#: that gets stuck.
RAND_CFG = poa.PoaConfig(512, 128, 128, 8, 8, 5, -4, -8)
RAND_CASES = {"s0_r10": (0, 0.1, None), "s1_r10": (1, 0.1, None),
              "s4_r10": (4, 0.1, None), "s4_r20": (4, 0.2, None),
              "stuck": (5, 0.15, 3)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions on one core: this file shares the machine with
    the suite's other workers and their timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _band_batch(name):
    seed, roll, w = BAND_CASES[name]
    return BAND_CFG, batches.band_batch(BAND_CFG, B, seed, roll), \
        np.full(B, w, np.int32)


def _rand_batch(name):
    seed, rate, w = RAND_CASES[name]
    packed = batches.poa_batch(RAND_CFG, B, seed, 100, rate)
    wb = (np.random.default_rng(1000 + seed).integers(1, 24, B) if w is None
          else np.full(B, w)).astype(np.int32)
    return RAND_CFG, packed, wb


@pytest.fixture(scope="module")
def pallas_ls_band():
    """The Pallas ls banded build's six outputs on every batch here."""
    kern = {cfg: build_lockstep_poa_kernel(cfg, interpret=True,
                                           band=True)(B)
            for cfg in (BAND_CFG, RAND_CFG)}
    out = {}
    for name in list(BAND_CASES) + list(RAND_CASES):
        cfg, packed, wb = (_band_batch if name in BAND_CASES
                           else _rand_batch)(name)
        outs = jpd._submit(kern[cfg], packed[:9] + (wb,), True, True)
        cb, cc, cl, fl, nn, hit = (np.asarray(x) for x in outs)
        out[name] = [cb, cc, cl[:, 0], fl[:, 0].astype(bool), nn[:, 0],
                     hit[:, 0].astype(bool)]
    return out


def _plain(name, **kw):
    cfg, packed, wb = (_band_batch if name in BAND_CASES
                       else _rand_batch)(name)
    t = poa.batch_to_tensors(packed, "cpu")
    return cfg, t, wb, poa.poa_batch_plain(cfg, *t, wband=torch.from_numpy(wb),
                                           **kw)


def _assert_equal(want, got):
    for k, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=f"output {k}")


@pytest.mark.parametrize("case", sorted(BAND_CASES) + sorted(RAND_CASES))
def test_plain_ls_band_equals_pallas_band_build(pallas_ls_band, case):
    """All six outputs on every window; the same inputs at wband 0 give
    the flat plain outputs and no hit."""
    cfg, t, wb, got = _plain(case, kernel="ls")
    _assert_equal(pallas_ls_band[case], got)
    zero = poa.poa_batch_plain(cfg, *t, wband=torch.zeros(B,
                                                          dtype=torch.int32),
                               kernel="ls")
    flat = poa.poa_batch_plain(cfg, *t)
    for f, z in zip(flat, zero):
        assert torch.equal(f, z)
    assert not zero[5].any()
    if case == "drift_w1":
        assert got[5].all()


def test_rule_1_fails_windows_that_v2_serves(pallas_ls_band):
    """On the random batches the ls build fails windows whose best end
    score is no better than NEG, where v2's banded semantics start the
    walk on the virtual row and serve them; the failed windows' graphs
    took nothing from the failing layer (rule 2), so their node counts
    differ from v2's too."""
    rule_1 = nodes = 0
    for case in RAND_CASES:
        _, _, _, ls = _plain(case, kernel="ls")
        _, _, _, v2 = _plain(case)
        _assert_equal(pallas_ls_band[case], ls)
        only_ls = ls[3] & ~v2[3]
        rule_1 += int(only_ls.sum())
        nodes += int((ls[4] != v2[4])[only_ls].sum())
    assert rule_1 > 0 and nodes > 0


def test_walks_through_column_0_and_a_stuck_walk(pallas_ls_band,
                                                 monkeypatch):
    """Walks that re-derive a move at column 0 of a node (an up move off a
    leading deletion), and a walk that gets stuck: the ls build fails
    that layer and adds nothing of it to the graph. Both equal the
    Pallas build."""
    at_col0, walks = [], []
    rederive, walk = poa._rederive, poa._walk_ls

    def spy_rederive(cfg, g, Hn, sub, sq, u, j, col0=False):
        move = rederive(cfg, g, Hn, sub, sq, u, j, col0)
        if col0 and j == 0:
            at_col0.append(move[0])
        return move

    def spy_walk(*args):
        res = walk(*args)
        walks.append(res[2])
        return res

    monkeypatch.setattr(poa, "_rederive", spy_rederive)
    monkeypatch.setattr(poa, "_walk_ls", spy_walk)
    _, _, _, got = _plain("s0_r10", kernel="ls")
    _assert_equal(pallas_ls_band["s0_r10"], got)
    assert at_col0 and 0 not in at_col0      # no diagonal off column 0
    walks.clear()
    _, _, _, got = _plain("stuck", kernel="ls")
    _assert_equal(pallas_ls_band["stuck"], got)
    assert walks.count(False) == 1 and got[3].any()


# ------------------------------------------------------------ end to end

def _jax_polish(paths, slack):
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {"RACON_TPU_BAND": "1", "RACON_TPU_BAND_SLACK": slack,
                     "RACON_TPU_PALLAS": "1", "RACON_TPU_POA_KERNEL": "ls",
                     "RACON_TPU_BATCH_WINDOWS": "8"}.items():
            mp.setenv(k, v)
        p = racon_tpu.TpuPolisher(*paths, **POLISH_KW)
        p.initialize()
        return p.polish(True)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ls_sam_set(tmp_path_factory):
    """tests/test_band.py's SAM set polished by the JAX package on its ls
    banded path at slack 8 and at slack 1."""
    tmp = tmp_path_factory.mktemp("ls_band_sam")
    target = _polish_dataset(tmp)
    paths = [str(tmp / f) for f in ("r.fasta", "o.sam", "t.fasta")]
    return paths, target, {s: _jax_polish(paths, str(s)) for s in (8, 1)}


def _torch(paths, **kw):
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", batch_windows=8,
                                      **POLISH_KW, **kw)
    p.initialize()
    return p.polish(True), p.stats


def test_ls_banded_polish_byte_identical_to_jax_and_flat(ls_sam_set):
    paths, target, want = ls_sam_set
    got, stats = _torch(paths, poa_kernel="ls", band=True, band_slack=8)
    flat, _ = _torch(paths)
    v2_band, _ = _torch(paths, band=True, band_slack=8)
    assert got == want[8] == flat == v2_band
    assert got[0][1] == target
    assert stats["consensus"]["band"]["jobs"] > 0
    assert stats["consensus"]["device"] > 0


def test_ls_banded_polish_at_slack_1_hits_and_equals_jax(ls_sam_set):
    """A half band of 1 (every cell is within one cell of the band edge):
    every banded window hits and widens, and the bytes are the JAX
    package's and the flat run's."""
    paths, _, want = ls_sam_set
    got, stats = _torch(paths, poa_kernel="ls", band=True, band_slack=1)
    assert got == want[1] == want[8]
    counts = stats["consensus"]["band"]
    assert counts["hits"] > 0 and counts["jobs"] > 0
