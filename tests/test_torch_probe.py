"""racon_tpu_torch's DP-cost probe against the JAX package's.

Each mode's plain PyTorch version (what a CPU seed tensor runs) against
the JAX package's Pallas probe in interpret mode, at R=32 with the seeds
0 and 7: ``out`` and ``steps`` must be equal (integers, tolerance 0). The
port's gate prints the same five counts and ratios as the JAX gate. The
CUDA kernel is held against the plain version in tests/test_torch_cuda.py
and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from racon_tpu.tools import dp_cost_probe as jprobe
from racon_tpu_torch.tools import dp_cost_probe as probe

R = 32
SEEDS = (0, 7)


@pytest.mark.parametrize("mode", range(probe.N_MODES))
def test_mode_equals_jax_probe(mode):
    seed = np.array(SEEDS, np.int32).reshape(-1, 1, 1)
    want_out, want_steps = (np.asarray(x).reshape(-1) for x in
                            jprobe.build(mode, R, len(SEEDS), True)(seed))
    out, steps = probe.probe(mode, R, torch.tensor(SEEDS, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), want_out)
    np.testing.assert_array_equal(steps.numpy(), want_steps)
    assert out.dtype == steps.dtype == torch.int32


def test_gate_prints_the_jax_gate_counts(capsys):
    assert jprobe.gate()
    want = capsys.readouterr().out
    assert probe.gate(device="cpu")
    got = capsys.readouterr().out
    assert got == want
    assert got.count("OK") == 5 and "FAIL" not in got


@pytest.mark.parametrize("mode", range(probe.N_MODES))
def test_last_row_holds_out(mode):
    """rows=True adds the last row (or ring row) the kernel is checked on:
    out is made of its first columns, and its width is ROW_WIDTH."""
    seed = torch.tensor(SEEDS, dtype=torch.int32)
    out, steps, last = probe.probe(mode, R, seed, rows=True)
    for a, b in zip((out, steps), probe.probe(mode, R, seed)):
        assert torch.equal(a, b)
    assert last.shape == (len(SEEDS), probe.ROW_WIDTH[mode])
    assert last.dtype == torch.int32
    want = last[:, 0] if mode in (6, 8) else last[:, 0] + last[:, 1]
    assert torch.equal(out, want)


def test_last_row_tells_modes_out_cannot():
    """Mode 5 drops the cross-warp carry of mode 0's row scan: columns 0
    and 1, and so out, are the same; the rest of the row is not. Only the
    whole-row check holds a kernel to the columns out never reads."""
    seed = torch.tensor(SEEDS, dtype=torch.int32)
    out0, _, row0 = probe.probe(0, R, seed, rows=True)
    out5, _, row5 = probe.probe(5, R, seed, rows=True)
    assert torch.equal(out0, out5)
    assert torch.equal(row0[:, :128], row5[:, :128])
    assert not torch.equal(row0, row5)


def test_probe_rejects_bad_arguments():
    seed = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        probe.probe(19, R, seed)
    with pytest.raises(ValueError, match="R must"):
        probe.probe(0, 2048, seed)
    with pytest.raises(ValueError, match="int32"):
        probe.probe(0, R, seed.long())


def test_table_on_cpu_moves_with_the_seed(capsys):
    """main() on the CPU: one line per mode, every output moving with the
    seed (no mode is folded away)."""
    assert probe.main(["8", "2", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device=cpu")
    assert len(lines) == 1 + probe.N_MODES
    assert not any("FOLDED" in ln for ln in lines)
