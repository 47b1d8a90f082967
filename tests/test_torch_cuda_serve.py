"""The serve daemon on the card.

Every test here needs an NVIDIA card and skips without one; the file
imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serve.py

A warm daemon (a process of its own, started as a user starts it) serves
two jobs with the CPU's bytes and no kernel build or load in either; a
daemon started without the warm-up loads the kernels in its first job
and not in its second. A job whose kernel launch raises fails and is not
re-run on the host lane. The host lane's child (``cli --host``) never
creates a CUDA context.
"""

import os
import subprocess
import sys

import pytest
import torch

from racon_tpu_torch import TorchPolisher
from racon_tpu_torch.ops import cuda_lib
from racon_tpu_torch.resilience import faults
from racon_tpu_torch.serve import (JobSpec, PolishSession, Scheduler,
                                   ServeClient, loadtest)
from racon_tpu_torch.tools import simulate

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(window_length=500, match=5, mismatch=-4, gap=-8)
WAIT = 600


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d = simulate.generate(str(tmp_path_factory.mktemp("serve")), mbp=0.01,
                          coverage=20, seed=11)
    return d["reads"], d["overlaps"], d["draft"]


@pytest.fixture(scope="module")
def cpu_fasta(data):
    p = TorchPolisher(*data, device="cpu", **KW)
    p.initialize()
    return "".join(f">{n}\n{s}\n" for n, s in p.polish(True))


def _serve_two(state, data, extra):
    """Two jobs through a daemon process: their results, and the stats."""
    proc = loadtest.spawn_daemon(state, "cuda", extra_args=extra,
                                 timeout=WAIT)
    try:
        with ServeClient.from_state_dir(state, timeout=WAIT) as c:
            ids = [c.submit(*data, args=KW, submitter=f"c{i}")
                   for i in range(2)]
            results = [c.wait(j, timeout=WAIT)["result"] for j in ids]
            stats = c.stats()
            c.shutdown()
        assert proc.wait(timeout=WAIT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return results, stats


def test_warm_daemon_serves_the_cpu_bytes_without_builds(data, cpu_fasta,
                                                         tmp_path):
    results, stats = _serve_two(str(tmp_path / "warm"), data, [])
    assert stats["session"]["warmed"] is True
    assert stats["session"]["warm_wall_s"] > 0
    assert stats["jobs"] == {"done": 2}
    for res in results:
        assert res["backend"] == "cuda" and res["kernel_builds"] == 0
        with open(res["output"]) as f:
            assert f.read() == cpu_fasta
        assert res["launches"]["poa_consensus"] > 0
        assert res["launches"]["hirschberg_edge"] > 0
    assert results[0]["launches"] == results[1]["launches"]


def test_cold_daemon_loads_the_kernels_in_its_first_job(data, cpu_fasta,
                                                        tmp_path):
    results, _ = _serve_two(str(tmp_path / "cold"), data, ["--no-warm"])
    assert results[0]["cold"] and results[0]["kernel_builds"] >= 1
    assert results[1]["kernel_builds"] == 0
    for res in results:
        with open(res["output"]) as f:
            assert f.read() == cpu_fasta


def test_device_failure_fails_the_job_on_the_card(data, cpu_fasta,
                                                  tmp_path):
    """A raise at the ls POA kernel's run point fails the job with that
    error; the job is not re-run on the host lane, and the next job runs
    on the card with the CPU's bytes."""
    ses = PolishSession(str(tmp_path / "state"), backend="cuda")
    ses.warm()
    sched = Scheduler(ses, queue_depth=4, max_jobs=8)
    ran_on_host = []
    sched._run_host = lambda job: ran_on_host.append(job.id)
    faults.configure("poa.run.ls:raise=RuntimeError")
    sched.start()
    try:
        spec = dict(sequences=data[0], overlaps=data[1], target=data[2],
                    args=dict(KW))
        bad = sched.submit(JobSpec(job_id="bad", **spec))
        assert bad.done.wait(WAIT) and bad.state == "failed"
        assert "injected fault at poa.run.ls" in bad.error
        assert bad.lane == "device" and bad.demotions == []
        faults.configure(None)
        ok = sched.submit(JobSpec(job_id="ok", **spec))
        assert ok.done.wait(WAIT) and ok.state == "done", ok.error
        assert ok.result["kernel_builds"] == 0
        assert ok.result["launches"]["poa_consensus"] > 0
        with open(ok.result["output"]) as f:
            assert f.read() == cpu_fasta
        assert ran_on_host == []
    finally:
        faults.configure(None)
        sched.shutdown(wait=True, timeout=WAIT)
        cuda_lib.reset_launches()


def test_host_child_never_creates_a_cuda_context(data, tmp_path):
    code = ("import sys, torch; from racon_tpu_torch import cli; "
            "rc = cli.main(sys.argv[1:]); "
            "print('initialized', torch.cuda.is_initialized(), "
            "file=sys.stderr); sys.exit(rc)")
    r = subprocess.run(
        [sys.executable, "-c", code, "--host", "-w", "500", "-m", "5", "-x",
         "-4", "-g", "-8", "--trace", str(tmp_path / "t.json"), *data],
        cwd=ROOT, capture_output=True, text=True, timeout=WAIT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "initialized False" in r.stderr
    assert r.stdout.startswith(">")
