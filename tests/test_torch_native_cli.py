"""The port's native CLI binary (racon_tpu_torch/native/src/rt_main.cpp,
built by ``native.ensure_cli_built`` into build/racon_tpu_torch) against
the JAX package's (racon_tpu/native/build/racon_tpu), on the CPU.

* The death cases of tests/test_death.py, each on inputs made here (no
  reference data): the same exit code as the JAX binary and the same
  standard error, the package's name aside; and ``--version``, ``-h``.
* rampler's ``split`` and ``subsample`` as tests/test_tools.py drives
  them, with the JAX binary's output files.
* The polish: on a simulated PAF set the binary's FASTA is
  byte-identical to ``python -m racon_tpu_torch.cli --host`` and to the
  JAX binary's, with racon's defaults and with ``-u -t 2 -w 200``.
"""

import os
import subprocess

import pytest

import racon_tpu.native as jax_native
from racon_tpu_torch import cli, native
from racon_tpu_torch.tools import simulate

WAIT = 120   # seconds: every subprocess's deadline
SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]


@pytest.fixture(scope="module")
def bins():
    """(the port's binary, the JAX package's), each built if missing."""
    port = native.ensure_cli_built()
    jax_native.ensure_built()
    jax_dir = os.path.dirname(jax_native.__file__)
    jax = os.path.join(jax_dir, "build", "racon_tpu")
    if not os.path.exists(jax):
        subprocess.run(["make", "build/racon_tpu"], cwd=jax_dir,
                       check=True, capture_output=True, timeout=600)
    return port, jax


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = simulate.generate(str(tmp_path_factory.mktemp("native_cli")),
                          mbp=0.005, contigs=2)
    return d["reads"], d["overlaps"], d["draft"]


def _run(binary, *args, cwd=None):
    return subprocess.run([binary, *args], capture_output=True, text=True,
                          timeout=WAIT, cwd=cwd)


def _death_args(case, sim):
    reads, paf, draft = sim
    return {
        "sequences-extension": ["reads.txt", "o.paf", "t.fa"],
        "missing-inputs": [],
        "window-length": ["-w", "0", reads, paf, draft],
        "overlaps-extension": [reads, "o.bed", "t.fa"],
        "target-extension": [reads, paf, "t.bed"],
        "missing-file": [reads, paf, "/nonexistent/x.fasta"],
        "unknown-option": ["--frobnicate", reads, paf, draft],
    }[case]


#: The substring tests/test_death.py looks for in each case's stderr.
DEATH_TEXT = {
    "sequences-extension": "unsupported format extension",
    "missing-inputs": "missing input",
    "window-length": "invalid window length",
    "overlaps-extension": ".mhap",
    "target-extension": "unsupported format extension",
    "missing-file": "unable to open",
    "unknown-option": "frobnicate",
}


@pytest.mark.parametrize("case", sorted(DEATH_TEXT))
def test_death_case_equals_the_jax_binary(bins, sim, case):
    port, jax = bins
    args = _death_args(case, sim)
    got, want = _run(port, *args), _run(jax, *args)
    assert got.returncode == want.returncode == 1
    assert got.stderr.replace("racon_tpu_torch", "racon_tpu") == \
        want.stderr
    assert DEATH_TEXT[case] in got.stderr
    assert got.stdout.startswith("usage: racon_tpu_torch ") == \
        want.stdout.startswith("usage: racon_tpu ")


def test_version_and_help(bins):
    port, jax = bins
    assert _run(port, "--version").stdout == _run(jax, "--version").stdout
    r = _run(port, "-h")
    assert r.returncode == 0
    assert r.stdout.startswith("usage: racon_tpu_torch [options ...]")
    assert "python -m racon_tpu_torch.cli" in r.stdout
    assert "racon_tpu.cli" not in r.stdout


def _write_fasta(path, records):
    with open(path, "w") as f:
        for name, data in records:
            f.write(f">{name}\n{data}\n")


def _files(d):
    return {p: open(os.path.join(d, p)).read()
            for p in sorted(os.listdir(d))}


def test_split_and_subsample(bins, tmp_path):
    """tests/test_tools.py's drive of rampler's subcommands: four chunks
    of the ten 400 bp records, and a 2x subsample of a 400 bp reference;
    the JAX binary writes the same files."""
    port, jax = bins
    recs = [(f"r{i}", "ACGT" * 100) for i in range(10)]
    src = tmp_path / "seqs.fasta"
    _write_fasta(src, recs)
    outs = {}
    for name, binary in (("port", port), ("jax", jax)):
        out = str(tmp_path / name)
        r = _run(binary, "-o", out, "split", str(src), "1000")
        assert r.returncode == 0, r.stderr
        r = _run(binary, "-o", out, "subsample", str(src), "400", "2")
        assert r.returncode == 0, r.stderr
        outs[name] = _files(out)
    chunks = [p for p in outs["port"] if p.startswith("seqs_")
              and p[5:-6].isdigit()]
    assert len(chunks) == 4
    assert sum(outs["port"][c].count(">") for c in chunks) == 10
    assert 2 <= outs["port"]["seqs_2x.fasta"].count(">") <= 3
    assert outs["port"] == outs["jax"]


def test_split_usage_errors(bins, tmp_path):
    port, jax = bins
    for args in (["split", "x.fasta"], ["-o"], ["-o", str(tmp_path),
                                                "subsample", "x.fa"]):
        got, want = _run(port, *args), _run(jax, *args)
        assert got.returncode == want.returncode
        assert got.stderr.replace("racon_tpu_torch", "racon_tpu") == \
            want.stderr


@pytest.mark.parametrize("opts", [[], ["-u", "-t", "2", "-w", "200"]],
                         ids=["defaults", "unpolished-threads-w200"])
def test_polish_equals_cli_host_and_the_jax_binary(bins, sim, opts, capsys):
    port, jax = bins
    args = [*opts, *SCORES, *sim]
    got = _run(port, *args)
    assert got.returncode == 0, got.stderr
    assert cli.main(["--host", *args]) == 0
    host = capsys.readouterr().out
    assert got.stdout == host and host.count(">") >= 1
    assert got.stdout == _run(jax, *args).stdout
