"""racon_tpu_torch's consensus feeder (ops/batch_exec.py) and the
consensus phase on it, on the CPU.

The feeder's schedule is held against racon_tpu's BatchExecutor: the same
submissions through recording hooks give the same sequence of dispatches,
waits, installs and band re-runs at depths 1, 2 and 3. The consensus
phase (poa_driver.run_consensus_phase, plain versions) gives the same
bytes and the same counts at every depth, flat and banded, and stamps the
pack and kernel wall split.
"""

import numpy as np
import pytest
import torch

from racon_tpu.ops import batch_exec as jbatch_exec
from racon_tpu_torch.ops import batch_exec, poa_driver
from racon_tpu_torch.tools import batches

#: Band re-runs of the recording hooks: batch -> how many times its
#: first item widens.
WIDEN = {1: 2, 3: 1}


class _Log:
    def __init__(self):
        self.log = []
        self.retry = []
        self.widened = {}

    def _widen(self, items):
        first = items[0]
        n = self.widened.get(first, 0)
        if n < WIDEN.get(first, 0):
            self.widened[first] = n + 1
            self.retry = [first]


class _JaxOps(_Log):
    """racon_tpu's ops seam, recording."""

    span_name = "test.chunk"
    async_dispatch = True

    def live_tier(self, ctx, kind):
        return "dev"

    def export(self, ctx, idxs):
        return list(idxs)

    def pack(self, ctx, chunk):
        return chunk

    def dispatch(self, ctx, kind, packed, chunk):
        self.log.append(("dispatch", chunk[0]))
        return chunk

    def attempt(self, ctx, kind, sub):
        self.log.append(("attempt", sub[0]))
        return sub

    def unpack(self, ctx, kind, outs):
        self.log.append(("unpack", outs[0]))
        return outs

    def span_args(self, ctx, chunk, pipelined):
        return {}

    def install(self, ctx, kind, sub, results):
        self.log.append(("install", sub[0]))
        self._widen(sub)

    def widen(self, ctx, kind):
        retry, self.retry = self.retry, []
        return retry

    def done(self, ctx, chunk):
        self.log.append(("done", chunk[0]))


class _TorchOps(_Log):
    """racon_tpu_torch's ops seam, recording."""

    def export(self, ctx, idxs):
        return list(idxs)

    def pack(self, ctx, items):
        return items

    def dispatch(self, ctx, packed, items):
        self.log.append(("dispatch", items[0]))
        return items

    def unpack(self, ctx, handle):
        self.log.append(("unpack", handle[0]))
        return handle

    def attempt(self, ctx, packed, items):
        self.log.append(("attempt", items[0]))
        return items

    def install(self, ctx, items, results):
        self.log.append(("install", items[0]))
        self._widen(items)

    def widen(self, ctx):
        retry, self.retry = self.retry, []
        return retry

    def done(self, ctx, items):
        self.log.append(("done", items[0]))


@pytest.fixture(scope="module")
def jax_schedules():
    """racon_tpu's BatchExecutor schedule of five one-item batches at
    depths 1, 2 and 3, computed once."""
    out = {}
    for depth in (1, 2, 3):
        ops = _JaxOps()
        ex = jbatch_exec.BatchExecutor(ops, depth=depth)
        for i in range(5):
            ex.submit(None, [i])
        ex.flush()
        out[depth] = ops.log
    return out


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_feeder_schedule_equals_jax(jax_schedules, depth):
    """Dispatches, waits, installs, band re-runs and done hooks come in
    racon_tpu's order at each depth: batch N+1 is dispatched before batch
    N is waited on from depth 2 up, and the widen loop drains a batch's
    re-runs before the next wait."""
    ops = _TorchOps()
    ex = batch_exec.BatchExecutor(ops, depth=depth)
    for i in range(5):
        ex.submit(None, [i])
    ex.flush()
    assert ops.log == jax_schedules[depth]
    assert ops.log.count(("attempt", 1)) == 2
    assert ops.log.count(("attempt", 3)) == 1
    assert ex.pack_ns > 0 and ex.kernel_ns > 0


def test_widen_loop_drains():
    """A batch whose items keep widening is re-run until widen returns
    nothing; an empty export runs nothing."""
    ops = _TorchOps()
    WIDEN[7] = 4
    try:
        ex = batch_exec.BatchExecutor(ops, depth=1)
        ex.submit(None, [7])
        ex.submit(None, [])
    finally:
        del WIDEN[7]
    assert [e for e in ops.log if e[0] == "attempt"] == [("attempt", 7)] * 4
    assert ops.log[-1] == ("done", 7) and ops.retry == []


@pytest.fixture(scope="module")
def windows():
    """Nine windows at -w 100 in three depth buckets' worth of layers."""
    torch.set_num_threads(1)
    cfg = poa_driver.make_config(128, 32, 5, -4, -8)
    return batches.poa_batch(cfg, 9, 31, 100, layers=(2, 12))


def _consensus(packed, depth, band):
    ws = batches.WindowSet(packed)
    st = poa_driver.run_consensus_phase(
        ws, match=5, mismatch=-4, gap=-8, trim=True, device="cpu",
        batch_windows=2, pipeline_depth=depth, band=band, band_slack=1)
    return ws.consensus, st


@pytest.mark.parametrize("band", [False, True])
def test_consensus_same_bytes_and_counts_at_every_depth(windows, band):
    """The consensus phase through the feeder at depths 1, 2 and 3 (two
    windows a batch): every window's consensus and every count equal;
    the wall split is stamped and the depth never collapses without a
    budget."""
    runs = [_consensus(windows, depth, band) for depth in (1, 2, 3)]
    want, wst = runs[0]
    assert len(want) == 9 and wst["device"] > 0
    if band:
        assert wst["band"]["jobs"] > 0
    for got, st in runs:
        assert got == want
        assert st["pack_wall_s"] > 0 and st["kernel_wall_s"] > 0
        assert not st["depth_collapsed"]
        strip = {k: v for k, v in st.items()
                 if k not in ("pack_wall_s", "kernel_wall_s",
                              "host_seconds")}
        assert strip == {k: v for k, v in wst.items()
                         if k not in ("pack_wall_s", "kernel_wall_s",
                                      "host_seconds")}


def test_pack_is_single_copy(windows):
    """_pack copies each window's layers once into the batch's arrays:
    the packed batch is the windows' own, with the trailing band row."""
    cfg = poa_driver.make_config(128, 32, 5, -4, -8)
    ws = batches.WindowSet(windows)
    chunk = [(i, ws.export_window(i), list(range(int(windows[3][i]))))
             for i in range(9)]
    packed = poa_driver._pack(chunk, cfg, [3] * 9)
    for k in range(9):
        np.testing.assert_array_equal(packed[k], windows[k], err_msg=str(k))
    assert packed[9].tolist() == [3] * 9
