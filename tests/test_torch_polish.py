"""racon_tpu_torch end to end against racon_tpu, and the port's import
rules.

TorchPolisher(device="cpu") runs the plain PyTorch versions of the
kernels; racon_tpu.TpuPolisher runs on the JAX CPU backend with its
Hirschberg aligner in interpret mode (RACON_TPU_DEVICE_ALIGNER=hirschberg)
and its XLA twin for consensus. The FASTA must be byte-identical.
"""

import ast
import os
import random
import subprocess
import sys

import pytest
import torch

import racon_tpu
import racon_tpu_torch
from racon_tpu_torch import cli
from racon_tpu_torch.tools import simulate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(window_length=100, match=5, mismatch=-4, gap=-8)


def _paf_dataset(tmp_path):
    """400 bp draft, 5 reads at 5% error, PAF overlaps without CIGARs
    (as tests/test_align_hirschberg.py builds it)."""
    rng = random.Random(11)
    truth = "".join(rng.choice("ACGT") for _ in range(400))

    def mut(s, rate):
        out = []
        for c in s:
            r = rng.random()
            if r < rate / 2:
                out.append(rng.choice("ACGT"))
            elif r >= rate:
                out.append(c)
        return "".join(out)

    draft = mut(truth, 0.02)
    reads = [mut(truth, 0.05) for _ in range(5)]
    with open(tmp_path / "t.fasta", "w") as f:
        f.write(f">t\n{draft}\n")
    with open(tmp_path / "r.fasta", "w") as rf, \
            open(tmp_path / "o.paf", "w") as of:
        for i, r in enumerate(reads):
            rf.write(f">r{i}\n{r}\n")
            of.write(f"r{i}\t{len(r)}\t0\t{len(r)}\t+\tt\t{len(draft)}\t0\t"
                     f"{len(draft)}\t{min(len(r), len(draft))}\t"
                     f"{max(len(r), len(draft))}\t60\n")
    return (str(tmp_path / "r.fasta"), str(tmp_path / "o.paf"),
            str(tmp_path / "t.fasta"))


def _jax_polish(paths, monkeypatch):
    monkeypatch.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
    p = racon_tpu.TpuPolisher(*paths, **KW)
    p.initialize()
    return p.polish(True)


def _torch_polish(paths):
    p = racon_tpu_torch.TorchPolisher(*paths, device="cpu", **KW)
    p.initialize()
    return p.polish(True), p.stats


def test_paf_polish_byte_identical_to_jax(tmp_path, monkeypatch):
    paths = _paf_dataset(tmp_path)
    got, stats = _torch_polish(paths)
    assert got == _jax_polish(paths, monkeypatch)
    assert stats["align"]["device"] == 5 and stats["align"]["host"] == 0
    assert stats["consensus"]["device"] > 0


def test_sam_polish_byte_identical_to_jax(tmp_path, monkeypatch):
    d = simulate.generate(str(tmp_path), mbp=0.002, coverage=8,
                          mean_read=600, seed=5)
    paths = (d["reads"], d["overlaps_sam"], d["draft"])
    got, stats = _torch_polish(paths)
    assert got == _jax_polish(paths, monkeypatch)
    assert stats["align"] == {"device": 0, "host": 0,
                              "host_seconds": stats["align"]["host_seconds"]}
    assert stats["consensus"]["device"] > 0


def test_cli_writes_the_polisher_fasta(tmp_path, capsys):
    paths = _paf_dataset(tmp_path)
    want, _ = _torch_polish(paths)
    assert cli.main(["--device", "cpu", "-w", "100", "-m", "5", "-x", "-4",
                     "-g", "-8", *paths]) == 0
    out = capsys.readouterr().out
    assert out == "".join(f">{n}\n{s}\n" for n, s in want)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        racon_tpu_torch.TorchPolisher("r.fa", "o.paf", "t.fa")


def test_import_leaves_jax_out():
    code = ("import sys, racon_tpu_torch, racon_tpu_torch.cli; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'racon_tpu.')) or m == 'racon_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _port_files():
    pkg = os.path.join(ROOT, "racon_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_nothing_of_jax():
    files = list(_port_files())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "racon_tpu"), \
                    f"{path} imports {name}"
