"""racon_tpu_torch's partitioner (parallel/) on the CPU, against the
unstriped calls and against racon_tpu.

The slices a batch is cut into follow ``np.array_split``; a striped
launch counts each device's rows from the slice it launched (where the
rows divide evenly, as the JAX package's ``count_shard_rows`` counts
them), and one device counts nothing. The plain versions of the polish
path's kernels striped over ``["cpu"] * m`` equal the unstriped call at
m = 1, 2 and 3, every launch of a polish runs inside a stripe, and a
polish striped over two and three CPU "devices" gives the unstriped
polish's bytes and racon_tpu.TpuPolisher's (Hirschberg aligner; run once
for the module).
"""

import json

import numpy as np
import pytest
import torch

import racon_tpu
from racon_tpu import obs as jobs
from racon_tpu.ops import batch_exec as jbatch_exec

import racon_tpu_torch
from racon_tpu_torch import cli, obs
from racon_tpu_torch.ops import align_cuda as ac
from racon_tpu_torch.ops import poa, poa_driver
from racon_tpu_torch.ops.poa import poa_batch_plain
from racon_tpu_torch.parallel import (Partitioner, get_partitioner,
                                      reset_partitioner, resolve_devices)
from racon_tpu_torch.parallel.partitioner import split_rows
from racon_tpu_torch.tools import batches, multichip, simulate

KW = dict(window_length=100, match=5, mismatch=-4, gap=-8)
CFG = poa.PoaConfig(max_nodes=384, max_len=256, max_backbone=128,
                    max_edges=12, depth=8, match=5, mismatch=-4, gap=-8)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    obs.reset()
    reset_partitioner()


def _counters():
    return {k: v for k, v in ((obs.snapshot() or {}).get("counters")
                              or {}).items() if k.startswith("shard.")}


# -- device lists ------------------------------------------------------------

def test_devices_parsing(capsys):
    cpu = torch.device("cpu")
    assert resolve_devices(None, "cpu") == (cpu,)
    assert resolve_devices("cpu,cpu", "cpu") == (cpu, cpu)
    assert resolve_devices(["cpu"] * 3, "cpu") == (cpu,) * 3
    assert resolve_devices(" cpu , cpu ", "cpu") == (cpu, cpu)
    assert resolve_devices("1", "cpu") == (cpu,)
    assert resolve_devices(1, "cpu") == (cpu,)
    for bad in ("cuda:0,cuda:0", "bogus", ",", "2", 0, "4,1", "4x1"):
        with pytest.raises(ValueError):
            resolve_devices(bad, "cpu")
    args = cli.build_arg_parser().parse_args(["--devices", "cpu,cpu", "r",
                                              "o", "t"])
    assert args.devices == "cpu,cpu"
    assert cli.build_arg_parser().parse_args(["r", "o", "t"]).devices is None
    assert cli.main(["--device", "cpu", "--devices", "cuda:0,cuda:0", "r.fa",
                     "o.paf", "t.fa"]) == 1
    assert "cuda:0" in capsys.readouterr().err


def test_polisher_launches_through_a_partitioner(tmp_path):
    paths = _paf_set(tmp_path)
    one = racon_tpu_torch.TorchPolisher(*paths, device="cpu", **KW)
    assert one.devices == (torch.device("cpu"),)
    assert one.partitioner.n_devices == 1
    assert one.partitioner is get_partitioner(["cpu"])
    two = racon_tpu_torch.TorchPolisher(*paths, device="cpu",
                                        devices=["cpu", "cpu"], **KW)
    assert two.partitioner.n_devices == 2
    assert two.partitioner is get_partitioner(["cpu", "cpu"])
    assert two.partitioner.cards() == {torch.device("cpu"): 2}


# -- slices and counters -----------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_slices_follow_array_split(m):
    for rows in (0, 1, 2, 5, 7, 8, 9, 17, 256):
        k = Partitioner(["cpu"] * m).stripes(rows)
        assert k == max(1, min(m, rows))
        got = [hi - lo for lo, hi in split_rows(rows, k)]
        assert got == [len(a) for a in np.array_split(np.arange(rows), k)]


@pytest.mark.parametrize("m,rows", [(2, 6), (4, 8), (3, 9), (2, 4)])
def test_even_stripe_counts_as_jax(m, rows):
    """Where the rows divide over the devices (no JAX padding), a striped
    launch's counters equal the JAX package's for the same launch."""
    obs.configure(metrics=True)
    jobs.reset()
    jobs.configure(metrics=True)
    try:
        Partitioner(["cpu"] * m).stripe(lambda a: (a,),
                                        (np.arange(rows, dtype=np.int32),))
        jbatch_exec.count_shard_rows(rows, rows, m)
        want = {k: v for k, v in jobs.snapshot()["counters"].items()
                if k.startswith("shard.")}
        assert _counters() == want
    finally:
        jobs.reset()


def test_stripe_counts_the_rows_each_device_launched():
    obs.configure(metrics=True)
    seen = []

    def fn(a):
        seen.append(a.tolist())
        return (a * 2,)

    part = Partitioner(["cpu"] * 3)
    (got,) = part.gather(part.stripe(fn, (np.arange(7, dtype=np.int32),)))
    assert seen == [[0, 1, 2], [3, 4], [5, 6]]
    np.testing.assert_array_equal(got, np.arange(7) * 2)
    part.stripe(fn, (np.arange(2, dtype=np.int32),))   # two slices of one
    assert _counters() == {"shard.chunks": 2, "shard.rows.d0": 4,
                           "shard.rows.d1": 3, "shard.rows.d2": 2}


def test_one_device_stripe_counts_nothing():
    obs.configure(metrics=True)
    part = Partitioner(["cpu"])
    (got,) = part.gather(part.stripe(lambda a: (a + 1,),
                                     (np.arange(5, dtype=np.int32),)))
    np.testing.assert_array_equal(got, np.arange(1, 6))
    part = Partitioner(["cpu"] * 4)
    part.stripe(lambda a: (a,), (np.arange(1, dtype=np.int32),))
    assert _counters() == {}


def test_gather_returns_each_run_in_turn():
    part = Partitioner(["cpu"] * 2)
    a = part.stripe(lambda x: (x, x + 1), (np.arange(5, dtype=np.int32),))
    b = part.stripe(lambda x: (-x,), (np.arange(3, dtype=np.int32),))
    got = part.gather(a, b)
    assert [g.tolist() for g in got] == [[0, 1, 2, 3, 4], [1, 2, 3, 4, 5],
                                         [0, -1, -2]]


# -- the plain kernels striped -----------------------------------------------

def _edge(backward):
    K = 256

    def fn(s, q, t):
        return (ac.edge_rows(s, q, t, K, backward),)
    return fn, batches.edge_batch(K, 7, 5, rcap=512)


def _base():
    K = 256

    def fn(s, q, t):
        return ac.base_case(s, q, t, K)
    return fn, batches.edge_batch(K, 7, 6, rcap=ac.BASE_ROWS)


def _poa(kernel):
    packed = batches.poa_batch(CFG, 5, 9, 100)[:9]

    def fn(*ins):
        return poa_batch_plain(CFG, *ins, kernel=kernel)[:4]
    return fn, packed


CASES = {"edge_fwd": lambda: _edge(False), "edge_bwd": lambda: _edge(True),
         "base": _base, "poa_ls": lambda: _poa("ls"),
         "poa_v2": lambda: _poa("v2")}


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_striped_plain_kernels_equal_unstriped(case, m):
    fn, arrays = CASES[case]()
    want = tuple(t.numpy() for t in fn(*(torch.from_numpy(a)
                                         for a in arrays)))
    part = Partitioner(["cpu"] * m)
    run = part.stripe(fn, arrays)
    assert len(run.parts) == m and run.events() == []
    got = part.gather(run)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_align_pairs_striped_equal_one_device():
    pairs = batches.align_pairs(9, 6, 300, 900)
    want = ac.align_pairs(pairs, device="cpu")
    for m in (2, 3):
        got = ac.align_pairs(pairs, device="cpu",
                             partitioner=Partitioner(["cpu"] * m))
        assert [None if x is None else x.tolist() for x in got] == \
            [None if x is None else x.tolist() for x in want]
    assert any(x is not None for x in want)


def test_virtual_stripe_splits_its_card():
    """Stripes that share a card split its room: the memory check and the
    batch cap run once a distinct card, with its stripe count."""
    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    free = 8 << 30
    assert poa_driver.batch_cap(cfg, free, 2, stripes=2) == \
        poa_driver.batch_cap(cfg, free, 4)
    fixed, share = poa_driver.MEMORY_MARGIN
    tight = fixed + int(3 * poa_driver.window_bytes(cfg) / 2 / (1 - share))
    poa_driver.check_memory([cfg], tight, "ls")   # room for 1.5 windows
    with pytest.raises(ValueError):
        poa_driver.check_memory([cfg], tight, "ls", stripes=2)
    part = Partitioner(["cpu", "cpu", "cpu"])
    assert part.cards() == {torch.device("cpu"): 3}


# -- the polish striped ------------------------------------------------------

def _paf_set(tmp_path):
    d = simulate.generate(str(tmp_path), mbp=0.002, coverage=8,
                          mean_read=600, seed=5)
    return d["reads"], d["overlaps"], d["draft"]


@pytest.fixture(scope="module")
def polished(tmp_path_factory):
    """(paths, the JAX package's FASTA, the port's unstriped FASTA)."""
    paths = _paf_set(tmp_path_factory.mktemp("parallel"))
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
        jp = racon_tpu.TpuPolisher(*paths, **KW)
        jp.initialize()
        jax_out = jp.polish(True)
    finally:
        mp.undo()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", **KW)
        p.initialize()
        one = p.polish(True)
    finally:
        torch.set_num_threads(n)
    return paths, jax_out, one


@pytest.mark.parametrize("devices", [["cpu", "cpu"], "cpu,cpu,cpu"])
def test_striped_cpu_polish_equals_unstriped_and_jax(polished, devices):
    paths, jax_out, one = polished
    assert one == jax_out
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", devices=devices,
                                      **KW)
    obs.configure(metrics=True)
    p.initialize()
    got = p.polish(True)
    counters = _counters()
    assert got == one
    m = len(p.devices)
    rows = [counters[f"shard.rows.d{i}"] for i in range(m)]
    assert sorted(k for k in counters if k.startswith("shard.rows.")) == \
        [f"shard.rows.d{i}" for i in range(m)]
    # array_split: earlier slices hold at most one row more a launch
    chunks = counters["shard.chunks"]
    assert chunks > 0 and rows == sorted(rows, reverse=True)
    assert rows[0] - rows[-1] <= chunks and rows[-1] >= chunks
    assert p.stats["align"]["device"] > 0
    assert p.stats["consensus"]["device"] > 0


def test_one_device_polish_writes_no_shard_counter(polished):
    paths, _, one = polished
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", **KW)
    obs.configure(metrics=True)
    p.initialize()
    assert p.polish(True) == one
    assert _counters() == {}


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_every_polish_launch_runs_inside_a_stripe(polished, devices,
                                                  monkeypatch):
    """Each kernel call of a polish, one device or two, runs inside
    ``Partitioner.stripe`` (where, on the card, its device and stream are
    made current), on the slice's device."""
    from racon_tpu_torch.parallel import partitioner as pmod

    inside, calls = [], []
    stripe = pmod.Partitioner.stripe

    def traced(self, fn, arrays):
        def wrapped(*ins):
            inside.append(ins[0].device)
            try:
                return fn(*ins)
            finally:
                inside.pop()
        return stripe(self, wrapped, arrays)

    def checked(name, wrapper):
        def call(*a, **k):
            calls.append(name)
            assert inside, f"{name} launched outside a stripe"
            return wrapper(*a, **k)
        return call

    monkeypatch.setattr(pmod.Partitioner, "stripe", traced)
    monkeypatch.setattr(ac, "edge_rows", checked("edge", ac.edge_rows))
    monkeypatch.setattr(ac, "base_case", checked("base", ac.base_case))
    monkeypatch.setattr(poa_driver, "poa_consensus",
                        checked("ls", poa_driver.poa_consensus))
    paths, _, one = polished
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", devices=devices,
                                      **KW)
    p.initialize()
    assert p.polish(True) == one
    assert {"edge", "base", "ls"} <= set(calls)


def test_striped_polish_checks_the_poa_run_point(polished):
    """The striped consensus wait checks the poa.run.<kernel> fault point
    inside the watchdog, as the one-device wait does: a raise there ends
    the polish."""
    from racon_tpu_torch.resilience import faults

    paths = polished[0]
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu",
                                      devices=["cpu", "cpu"], **KW)
    faults.configure("poa.run.ls:raise=RuntimeError")
    try:
        p.initialize()
        with pytest.raises(RuntimeError):
            p.polish(True)
    finally:
        faults.configure(None)


# -- the sweep ---------------------------------------------------------------

def test_multichip_sweep_on_the_cpu(capsys):
    assert multichip.main(["--device", "cpu", "--windows", "5", "--window",
                           "60", "--depth", "8", "--repeats", "1",
                           "--counts", "1,2,3"]) == 0
    doc = json.loads(capsys.readouterr().out)
    for key in ("n_devices", "rc", "ok", "skipped", "tail", "scaling"):
        assert key in doc
    assert doc["ok"] is True and doc["rc"] == 0 and doc["skipped"] is False
    assert sorted(doc["scaling"]) == ["1", "2", "3"]
    for n, e in doc["scaling"].items():
        assert e["ok"] and e["stripes"] == int(n)
        assert e["devices"] == ["cpu"] * int(n)
        assert e["rows_per_stripe"] == -(-5 // int(n))
    assert doc["scaling"]["1"]["counters"] == {}
    assert doc["scaling"]["3"]["counters"] == {
        "shard.chunks": 1, "shard.rows.d0": 2, "shard.rows.d1": 2,
        "shard.rows.d2": 1}
