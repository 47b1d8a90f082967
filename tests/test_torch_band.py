"""racon_tpu_torch's banded path against the JAX package's (RACON_TPU_BAND).

The port's band plan and ladder (ops/band.py), its plain edge and base
case at K = 128, ``align_pairs(band_overrides=...)``, ``run_jobs(band=...)``
and ``poa_batch_plain(wband=...)`` take the same inputs as the JAX
package's Pallas kernels in interpret mode and its orchestration; every output
must be equal (tolerance 0: all outputs are integers or bytes). End to
end, ``TorchPolisher(device="cpu", band=True)`` must write the bytes of
``TpuPolisher`` with ``RACON_TPU_BAND=1``, and of its own flat run.

Each JAX reference output is computed once, in a module-scoped fixture,
at the small shapes of tests/test_band.py, no test starts a process, and
the plain versions run on one thread: the file takes well under a minute
on one CPU core. The CUDA kernels are
held against the plain versions in tests/test_torch_cuda.py and by
chip_smoke.py.
"""

import random

import numpy as np
import pytest
import torch

import racon_tpu
import racon_tpu_torch
from racon_tpu import obs
from racon_tpu.ops import align_pallas as ap
from racon_tpu.ops import band as jband
from racon_tpu.ops import poa as jpoa
from racon_tpu.ops import poa_driver as jpd
from racon_tpu.ops.poa_pallas import build_pallas_poa_kernel
from racon_tpu_torch import cli
from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.ops import band, poa
from racon_tpu_torch.tools import batches
from tests.test_band import (_FakePipe, _enc, _mut, _poa_batch,
                             _polish_dataset, _rand, _shifted_pair)

POLISH_KW = dict(window_length=80, match=5, mismatch=-4, gap=-8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions on one core: this file shares the machine with
    the suite's other workers and their timing-sensitive tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ band plan

PLAN_CASES = [
    # n, m, flat_k, slack, max_widenings
    (800, 800, 256, 32, 2),
    (800, 1200, 512, 32, 2),
    (800, 800, 0, 32, 2),
    (2600, 2600, 512, 80, 2),
    (2600, 2600, 512, 80, 0),
    (2600, 2650, 1024, 32, 3),
    (9000, 8100, 2048, 32, 2),
    (9000, 8990, 1024, 0, 4),
    (300, 310, 128, 32, 2),
    (5000, 5000, 1024, 200, 1),
]


@pytest.mark.parametrize("n,m,flat_k,slack,max_w", PLAN_CASES)
def test_band_plan_and_ladder_equal_jax(monkeypatch, n, m, flat_k, slack,
                                        max_w):
    """initial_width, bucket_for, plan_align_band and the aligner ladder
    (BandState.widen, to exhaustion) against the JAX module, with the
    slack and the widening budget as its knobs."""
    monkeypatch.setenv("RACON_TPU_BAND_SLACK", str(slack))
    monkeypatch.setenv("RACON_TPU_BAND_MAX_WIDENINGS", str(max_w))
    assert band.BAND_BUCKETS == jband.BAND_BUCKETS
    assert band.initial_width(n, m, slack) == jband.initial_width(n, m)
    for w in range(0, 2200, 37):
        assert band.bucket_for(w) == jband.bucket_for(w)
    for wid in range(4):
        assert (band.plan_align_band(n, m, flat_k, wid, slack)
                == jband.plan_align_band(n, m, flat_k, wid))
    k0 = band.plan_align_band(n, m, flat_k, slack=slack)
    if k0 is None:
        return
    mine, theirs, stats = band.BandState(k0), jband.BandState(k0), \
        band.new_stats()
    while mine.k is not None:
        mine.widen(n, m, flat_k, stats, max_w, slack)
        theirs.widen(n, m, flat_k)
        assert (mine.k, mine.widenings) == (theirs.k, theirs.widenings)
        assert theirs.exhausted == (mine.k is None)
    assert stats["fallbacks"] == 1
    assert stats["hits"] == stats["widenings"] + 1


CERT_CASES = [(n, m, k, dist) for n, m in ((800, 800), (800, 860),
                                           (860, 800), (500, 700))
              for k in (128, 256) for dist in (0, 10, 60, 64, 65, 126, 300)]


@pytest.mark.parametrize("n,m,k,dist", CERT_CASES)
def test_ukkonen_certificate_equals_jax(n, m, k, dist):
    gdmin = min(0, m - n) - (k - 1 - abs(m - n)) // 2
    for g in (gdmin, gdmin - 3, gdmin + 70):
        assert band.ukkonen_ok(n, m, k, g, dist) == \
            jband.ukkonen_ok(n, m, k, g, dist)
    assert not band.ukkonen_ok(n, m, k, gdmin, None)


@pytest.mark.parametrize("cap,max_w,k0", [(384, 2, 40), (384, 2, 100),
                                          (96, 3, 30), (384, 0, 8),
                                          (960, 4, 33)])
def test_poa_ladder_equals_jax(monkeypatch, cap, max_w, k0):
    monkeypatch.setenv("RACON_TPU_BAND_MAX_WIDENINGS", str(max_w))
    mine, theirs, stats = band.BandState(k0), jband.BandState(k0), \
        band.new_stats()
    while mine.k is not None:
        mine.widen_width(cap, stats, max_w)
        theirs.widen_width(cap)
        assert (mine.k, mine.widenings) == (theirs.k, theirs.widenings)
        assert theirs.exhausted == (mine.k is None)
    for gap in (-8, -4, 2):
        for w in (1, 2, 7, 64):
            assert band.poa_deficit_bound(gap, w) == \
                jband.poa_deficit_bound(gap, w)


# ------------------------------------------- edge and base case at K = 128

def _k128_tasks(backward):
    """First-round halves at K = 128 of pairs near the diagonal."""
    rng = random.Random(17)
    pairs = []
    for n in (300, 520, 700, 860):
        q = _rand(rng, n)
        pairs.append((q, _mut(rng, q, 0.04)))
    enc = [_enc(q, t) for q, t in pairs]
    K, bands, tasks = 128, {}, []
    for i, (q, t) in enumerate(enc):
        n, m = len(q), len(t)
        bands[i] = (K, int(min(0, m - n) - (K - 1 - abs(m - n)) // 2))
        imid = n // 2
        tasks.append(ap._Task(i, imid if backward else 0,
                              n if backward else imid, 0, m))
    return ap._task_arrays(enc, tasks, bands, 512, K, backward, 1)


@pytest.mark.parametrize("backward", [False, True])
def test_edge_rows_plain_at_k128_equals_pallas(backward):
    scal, q, t = _k128_tasks(backward)
    want = np.asarray(ap._build_edge_kernel(512, 128, backward, True, 1)(
        len(scal))(scal, q, t))
    got = ac.edge_rows(*ac.tasks_to_tensors(scal, q, t, "cpu"), 128,
                       backward)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < ac.INF).any(axis=1).all()


def test_base_case_plain_at_k128_equals_pallas():
    """Base tasks at K = 128: near-diagonal, R = 256 exactly, a path that
    leaves the band, S = 0, a positive dmin, and a padding task."""
    K, RB = 128, ac.BASE_ROWS
    rng = np.random.default_rng(128)
    B = 8
    scal = np.zeros((B, 4), np.int32)
    qs = np.zeros((B, RB), np.int32)
    ts = np.full((B, RB + K), 255, np.int32)
    q = rng.integers(0, 4, RB)
    t = q.copy()
    t[rng.random(RB) < 0.1] = rng.integers(0, 4)
    for b, (R, S, dmin) in enumerate([(200, 210, -60), (RB, RB, -(K // 2)),
                                      (150, 140, -70), (RB, RB, -K - 5),
                                      (40, 0, -40), (120, 130, 3),
                                      (RB, RB + 60, -20)]):
        scal[b] = (R, S, dmin, 0)
        qs[b, :R] = q[:R]
        ts[b, :S] = np.concatenate([t, rng.integers(0, 4, K)])[:S]
    scal[-1, 0] = 1
    kern = ap._build_base_kernel(K, True, 1)[0]
    want = [np.asarray(x) for x in kern(B)(scal, qs, ts)]
    got = ac.base_case(*ac.tasks_to_tensors(scal, qs, ts, "cpu"), K)
    for w, g, name in zip(want, got, ("ops", "cnt", "ok", "dist")):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert want[2][:3].all() and not want[2][3] and want[2][4]
    assert want[3][3] == ac.INF and want[3][4] == 40


# ------------------------------------------------- aligner: band overrides

def _override_pairs():
    """tests/test_band.py's aligner fixtures: three 3% pairs, the
    60-base deletion (optimum on the band edge) and the escape."""
    rng = random.Random(101)
    pairs = []
    for _ in range(3):
        q = _rand(rng, 800)
        pairs.append((q, _mut(rng, q, 0.03)))
    rng = random.Random(7)
    q = _rand(rng, 820)
    pairs.append((q, q[:400] + q[460:]))
    pairs.append(_shifted_pair(random.Random(13), 800, 100, 200, 550))
    return pairs


#: The JAX aligner's one-row-per-step kernels: byte-identical to its packed
#: ones by their contract (config.py RACON_TPU_ALIGN_PACK), and about half
#: the interpret-mode time.
JAX_ALIGN_ENV = {"RACON_TPU_ALIGN_PACK": "0"}


@pytest.fixture(scope="module")
def jax_overrides():
    enc = [_enc(q, t) for q, t in _override_pairs()]
    overrides = {i: 128 for i in range(len(enc))}
    hits = set()
    mp = pytest.MonkeyPatch()
    try:
        for k, v in JAX_ALIGN_ENV.items():
            mp.setenv(k, v)
        res = ap.align_pairs(enc, interpret=True, band_overrides=overrides,
                             hits=hits)
    finally:
        mp.undo()
    return enc, overrides, res, hits


def test_align_pairs_band_overrides_equal_pallas(jax_overrides):
    """Ops arrays and hits equal the Pallas engine's; served banded pairs
    equal the port's flat run."""
    enc, overrides, want, want_hits = jax_overrides
    pairs = [(q.astype(np.uint8), t.astype(np.uint8)) for q, t in enc]
    hits = set()
    got = ac.align_pairs(pairs, device="cpu", band_overrides=overrides,
                         hits=hits)
    assert hits == want_hits
    assert 4 in hits and not {0, 1, 2} <= hits   # the escape hits
    flat = ac.align_pairs(pairs, device="cpu")
    for i, (w, g) in enumerate(zip(want, got)):
        assert (w is None) == (g is None) == (i in hits)
        if g is not None:
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, flat[i])


# ---------------------------------------------------- aligner: run_jobs

def _ladder_pairs():
    """At slack 80: {0: the 2600-base pair whose path strays ~100
    diagonals, which hits at K = 128 and verifies at 256 (one rung)}, and
    {1: the 800-base escape, which hits at 128 and has no rung below its
    flat 256 (exhausted, then flat); 2: a 3% pair, which certifies at
    128}."""
    rng = random.Random(29)
    qa = _rand(rng, 800)
    return ({0: _shifted_pair(random.Random(37), 2600, 100, 900, 1800)},
            {1: _shifted_pair(random.Random(13), 800, 100, 200, 550),
             2: (qa, _mut(rng, qa, 0.03))})


def _jax_run_jobs(pairs):
    mp = pytest.MonkeyPatch()
    obs.reset()
    obs.configure(metrics=True)
    try:
        for k, v in {"RACON_TPU_BAND": "1", "RACON_TPU_BAND_SLACK": "80",
                     **JAX_ALIGN_ENV}.items():
            mp.setenv(k, v)
        pipe = _FakePipe(pairs)
        served = ap.run_jobs(pipe, list(pairs))
        counters = (obs.snapshot() or {}).get("counters") or {}
    finally:
        obs.reset()
        mp.undo()
    return pairs, served, pipe.cigars, {
        k: counters.get(f"band.{k}", 0) for k in band.COUNTS}


#: The ladder's counts of each case of _ladder_pairs.
LADDER_COUNTS = ({"jobs": 1, "hits": 1, "widenings": 1, "fallbacks": 0},
                 {"jobs": 2, "hits": 1, "widenings": 0, "fallbacks": 1})


@pytest.fixture(scope="module", params=[0, 1], ids=["one_rung", "exhaust"])
def jax_ladder(request):
    return request.param, _jax_run_jobs(_ladder_pairs()[request.param])


def _lengths(pairs):
    n = max(pairs) + 1
    out = np.zeros((n, 2), np.int64)
    for j, (q, t) in pairs.items():
        out[j] = len(q), len(t)
    return out


def test_run_jobs_ladder_equals_jax_and_flat(jax_ladder):
    """One rung (case 0), and exhaustion to flat (case 1): the CIGARs
    equal the JAX run's and the port's flat run's, and the ladder's
    counts equal the JAX counters."""
    which, (pairs, want_served, want, want_counts) = jax_ladder
    lengths = _lengths(pairs)
    flat_pipe = _FakePipe(pairs)
    assert ac.run_jobs(flat_pipe, list(pairs), lengths,
                       device="cpu") == len(pairs)
    pipe, got = _FakePipe(pairs), band.new_stats()
    served = ac.run_jobs(pipe, list(pairs), lengths, device="cpu",
                         band=True, band_slack=80, stats=got)
    assert served == want_served == len(pairs)
    assert pipe.cigars == want == flat_pipe.cigars
    assert got == want_counts == LADDER_COUNTS[which]


def test_run_jobs_with_no_widening_runs_flat():
    """band_max_widenings=0: every hit exhausts its ladder at once and
    runs flat; the CIGARs are the flat run's."""
    pairs = {**_ladder_pairs()[0], **_ladder_pairs()[1]}
    lengths = _lengths(pairs)
    flat_pipe = _FakePipe(pairs)
    ac.run_jobs(flat_pipe, list(pairs), lengths, device="cpu")
    pipe, counts = _FakePipe(pairs), band.new_stats()
    assert ac.run_jobs(pipe, list(pairs), lengths, device="cpu", band=True,
                       band_slack=80, band_max_widenings=0,
                       stats=counts) == 3
    assert pipe.cigars == flat_pipe.cigars
    assert counts == {"jobs": 3, "hits": 2, "widenings": 0, "fallbacks": 2}


# ------------------------------------------------------ POA, kernel API

JCFG = jpoa.PoaConfig(max_nodes=256, max_len=128, max_backbone=128,
                      max_edges=8, depth=4, match=5, mismatch=-4, gap=-8)
POA_CASES = {"w0": (0, 0, 0), "w8": (0, 0, 8), "drift_w1": (1, 5, 1),
             "drift_w4": (1, 5, 4)}


@pytest.fixture(scope="module")
def jax_banded_poa():
    B = 2
    kern = build_pallas_poa_kernel(JCFG, interpret=True, band=True)(B)
    out = {}
    for name, (seed, roll, w) in POA_CASES.items():
        packed = _poa_batch(JCFG, B, seed, roll)
        outs = jpd._submit(kern, packed + (np.full(B, w, np.int32),), True,
                           True)
        cb, cc, cl, fl, nn, hit = (np.asarray(x) for x in outs)
        out[name] = (packed, w, [cb, cc, cl[:, 0], fl[:, 0].astype(bool),
                                 nn[:, 0], hit[:, 0].astype(bool)])
    return out


@pytest.mark.parametrize("case", sorted(POA_CASES))
def test_poa_plain_banded_equals_pallas_band_build(jax_banded_poa, case):
    """poa_batch_plain(wband=) against build_pallas_poa_kernel(band=True)
    in interpret mode: all six outputs, band_hit included, on every
    window; wband = 0 is the flat plain run."""
    packed, w, want = jax_banded_poa[case]
    cfg = poa.PoaConfig(*JCFG)
    seed, roll, _ = POA_CASES[case]
    assert all(np.array_equal(a, b) for a, b in
               zip(batches.band_batch(cfg, 2, seed, roll)[:9], packed))
    t = poa.batch_to_tensors(packed + (None,), "cpu")
    st = {}
    got = poa.poa_batch_plain(cfg, *t, wband=torch.full((2,), w,
                                                        dtype=torch.int32),
                              stats=st)
    for k, (wv, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(wv).astype(np.int64),
                                      err_msg=f"output {k}")
    assert st["cells"] > 0
    if w == 0:
        flat = poa.poa_batch_plain(cfg, *t)
        for f, g in zip(flat, got):
            assert torch.equal(f, g)
        assert not got[5].any()
    if case == "drift_w1":
        assert got[5].all()
        assert st["cells"] <= 3 * st["rows"]    # 3 columns a row at most


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def sam_set(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("band_sam")
    target = _polish_dataset(tmp)
    paths = [str(tmp / f) for f in ("r.fasta", "o.sam", "t.fasta")]
    mp = pytest.MonkeyPatch()
    try:
        for k, v in {"RACON_TPU_BAND": "1", "RACON_TPU_BAND_SLACK": "8",
                     "RACON_TPU_PALLAS": "1", "RACON_TPU_POA_KERNEL": "v2",
                     "RACON_TPU_BATCH_WINDOWS": "4"}.items():
            mp.setenv(k, v)
        p = racon_tpu.TpuPolisher(*paths, **POLISH_KW)
        p.initialize()
        want = p.polish(True)
    finally:
        mp.undo()
    return paths, target, want


def _torch(paths, **kw):
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", **POLISH_KW,
                                      **kw)
    p.initialize()
    return p.polish(True), p.stats


def test_banded_polish_byte_identical_to_jax_and_flat(sam_set):
    paths, target, want = sam_set
    got, stats = _torch(paths, band=True, band_slack=8, batch_windows=4)
    flat, _ = _torch(paths)
    assert got == want == flat
    assert got[0][1] == target
    counts = stats["consensus"]["band"]
    assert counts["jobs"] > 0
    assert stats["consensus"]["device"] > 0
    assert stats["align"]["band"] == band.new_stats()   # SAM: no jobs


def test_banded_polish_with_no_widening_equals_flat(sam_set):
    """band_max_widenings=0 with a 1-column slack: the windows that hit
    run flat at once; the bytes are the flat run's."""
    paths, _, want = sam_set
    got, stats = _torch(paths, band=True, band_slack=1,
                        band_max_widenings=0)
    assert got == want
    c = stats["consensus"]["band"]
    assert c["widenings"] == 0 and c["hits"] == c["fallbacks"]


def test_band_cli_flags_and_ls_refusal(sam_set, capsys):
    """The CLI's band flags; ``--poa-kernel ls --band``, which was refused
    until the ls kernel's banded build was ported, writes the same bytes
    as ``--band``."""
    paths, _, want = sam_set
    args = ["--device", "cpu", "-w", "80", "-m", "5", "-x", "-4", "-g", "-8",
            *paths]
    assert cli.main(["--band", "--band-slack", "8", "--band-max-widenings",
                     "1", *args]) == 0
    out = capsys.readouterr().out
    assert out == "".join(f">{n}\n{s}\n" for n, s in want)
    assert cli.main(["--poa-kernel", "ls", "--band", "--band-slack", "8",
                     "--band-max-widenings", "1", *args]) == 0
    assert capsys.readouterr().out == out
