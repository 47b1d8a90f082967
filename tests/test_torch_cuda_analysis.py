"""The analysis layer on the card.

Every test here needs an NVIDIA card and skips without one; the file
imports nothing of the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_analysis.py

The launch-plan audit over the driver's whole grid (every window class up
to the card's largest at each depth bucket, both POA kernels flat and
banded) finds no violation, and the CLI's ``--plans`` reports the same;
in a fresh process whose libraries are built, a polish counts each
``kernel.builds.<source>`` at most once and a second polish none; an
armed polish of the main path (PAF overlaps, both phases on the card)
gives the unarmed bytes with no finding.
"""

import pytest
import torch

from racon_tpu_torch import TorchPolisher, obs
from racon_tpu_torch.analysis import build_audit
from racon_tpu_torch.analysis.__main__ import main as analysis_main
from racon_tpu_torch.ops import cuda_lib, poa_driver
from racon_tpu_torch.tools import simulate

pytestmark = pytest.mark.cuda

ARGS = dict(window_length=500, match=5, mismatch=-4, gap=-8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return simulate.generate(str(tmp_path_factory.mktemp("data")),
                             mbp=0.015, seed=11)


def _polish(d, tmp, name, **kw):
    p = TorchPolisher(d["reads"], d["overlaps"], d["draft"], device="cuda",
                      trace_path=str(tmp / f"{name}.trace"), **ARGS, **kw)
    p.initialize()
    out = p.polish(True)
    builds = build_audit.build_counts(obs.snapshot())
    return out, p.report.as_dict().get("sanitize"), builds


def test_plan_audit_covers_the_grid_without_violations(card):
    audit = build_audit.run_plan_audit(card)
    s = audit.summary
    assert audit.violations == [], [v.render() for v in audit.violations]
    assert s["depths"] == list(poa_driver.DEPTH_BUCKETS)
    assert s["grid"] == sum(c // 128 for c in s["largest_class"].values())
    assert min(s["largest_class"].values()) > 10880   # int32 ids reached
    assert s["max_shared_bytes"] <= s["shared_limit"]
    assert 0 < s["variants"] <= poa_driver.POA_BUILD_VARIANTS
    assert len(audit.occupancy) == s["builds"]


def test_plans_cli_exits_clean(card, capsys):
    assert analysis_main(["--plans"]) == 0
    out = capsys.readouterr().out
    assert "[analysis] plans:" in out and "OK: no new violations" in out


def test_build_counts_across_two_polishes(card, data, tmp_path):
    cuda_lib.build_all()
    _, _, first = _polish(data, tmp_path, "first")
    _, _, second = _polish(data, tmp_path, "second")
    assert build_audit.check_build_counts(first, second) == []


def test_armed_main_path_equals_unarmed(card, data, tmp_path):
    plain, section, _ = _polish(data, tmp_path, "plain")
    assert section is None
    armed, section, _ = _polish(data, tmp_path, "armed", sanitize=True,
                                sanitize_parity=1)
    assert armed == plain
    assert section == {"armed": True, "findings": []}
