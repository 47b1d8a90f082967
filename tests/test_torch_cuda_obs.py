"""racon_tpu_torch's trace, journal and watchdog on the card.

Every test here needs an NVIDIA card and skips without one; the file
imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_obs.py

The trace's device track holds one event per launch of the polish, as
many per kernel as ``cuda_lib.LAUNCHES`` counted, with the durations a
caller's ``cuda_lib.LAUNCH_EVENTS`` list times (both sinks see every
launch); a journal written on the card resumes on the CPU to the card's
bytes; a hung batch hits the watchdog.
"""

import json
import time

import pytest
import torch

from racon_tpu_torch import TorchPolisher
from racon_tpu_torch.obs import __main__ as reader
from racon_tpu_torch.ops import cuda_lib
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.resilience.watchdog import WatchdogTimeout
from racon_tpu_torch.tools import simulate

pytestmark = pytest.mark.cuda

KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = simulate.generate(str(tmp_path_factory.mktemp("obs")), mbp=0.02,
                          coverage=20, seed=11)
    return d["reads"], d["overlaps"], d["draft"]


def _run(paths, device="cuda", **kw):
    p = TorchPolisher(*paths, device=device, **KW, **kw)
    p.initialize()
    return p.polish(True), p


def test_device_track_equals_the_launch_counts(data, tmp_path):
    trace = str(tmp_path / "trace.json")
    cuda_lib.reset_launches()
    cuda_lib.LAUNCH_EVENTS = events = []
    try:
        out, _ = _run(data, trace_path=trace)
    finally:
        cuda_lib.LAUNCH_EVENTS = None
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    assert out == _run(data)[0]
    doc, errors = reader.load_trace(trace)
    assert errors == []
    track = reader.device_track(doc)
    assert {k: v["launches"] for k, v in track["kernels"].items()} == \
        launches
    assert len(events) == sum(launches.values())
    torch.cuda.synchronize()
    want_ms = sum(s.elapsed_time(e) for _, s, e in events)
    got_ms = sum(v["busy_us"] for v in track["kernels"].values()) / 1e3
    assert got_ms == pytest.approx(want_ms, rel=0.01)
    assert 0 < track["busy_share"] < 1
    for ev in doc["traceEvents"]:
        if ev.get("cat") == "device":
            assert ev["ts"] >= 0 and ev["dur"] > 0


def test_card_journal_resumes_on_the_cpu(data, tmp_path):
    j = tmp_path / "j"
    want, _ = _run(data, journal_path=str(j), poa_kernel="v2")
    lines = j.read_bytes().splitlines(keepends=True)
    windows = sum(b'"kind": "window"' in ln for ln in lines)
    j.write_bytes(b"".join(lines[:len(lines) - windows // 2]))
    out, p = _run(data, device="cpu", journal_path=str(j),
                  resume_journal=True)
    assert out == want
    phases = p.report.as_dict()["phases"]
    assert phases["consensus"]["served"]["journal"] == \
        windows - windows // 2
    assert phases["alignment"]["served"]["journal"] > 0
    with open(j) as f:
        assert len([json.loads(x) for x in f]) == len(lines)


def test_hung_batch_hits_the_watchdog_on_the_card(data):
    faults.configure("poa.run.ls:hang=30")
    try:
        t0 = time.perf_counter()
        with pytest.raises(WatchdogTimeout, match="ls POA batch"):
            _run(data, device_timeout_s=2.0)
        assert time.perf_counter() - t0 < 25
    finally:
        faults.configure(None)
