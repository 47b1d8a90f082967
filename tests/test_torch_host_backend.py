"""racon_tpu_torch's host-only backend (create_polisher(backend="host"),
CpuPolisher; the CLI's --host) against racon_tpu's CpuPolisher, on the
CPU: the native host pipeline of each package, on PAF and SAM sets, the
same bytes.
"""

import pytest
import torch

import racon_tpu
import racon_tpu_torch
from racon_tpu_torch import cli
from racon_tpu_torch.tools import simulate
from tests.test_torch_polish import KW, _paf_dataset


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """{name: (paths, racon_tpu.CpuPolisher's FASTA)}: a PAF set without
    CIGARs (the host aligns it), a simulated SAM set and a simulated
    three-contig PAF set, each polished once by the JAX package."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("host")
    (root / "paf").mkdir()
    d = simulate.generate(str(root / "sim"), mbp=0.002, coverage=8,
                          mean_read=600, seed=5)
    d3 = simulate.generate(str(root / "sim3"), mbp=0.003, contigs=3)
    out = {}
    for name, paths in (("paf", _paf_dataset(root / "paf")),
                        ("sam", (d["reads"], d["overlaps_sam"], d["draft"])),
                        ("paf_3_contigs", (d3["reads"], d3["overlaps"],
                                           d3["draft"]))):
        p = racon_tpu.create_polisher(*paths, backend="cpu", **KW)
        p.initialize()
        out[name] = (paths, p.polish(True))
    return out


@pytest.mark.parametrize("name", ["paf", "sam", "paf_3_contigs"])
def test_host_backend_equals_jax_cpu_polisher(sets, name):
    paths, want = sets[name]
    p = racon_tpu_torch.create_polisher(*paths, backend="host", **KW)
    assert isinstance(p, racon_tpu_torch.CpuPolisher)
    p.initialize()
    assert p.polish(True) == want
    assert set(p.stats) == {"initialize_s", "consensus_s", "stitch_s"}


@pytest.mark.parametrize("threads", ["1", "3"])
def test_cli_host_writes_the_jax_fasta(sets, capsys, threads):
    """--host polishes on the host alone (its consensus on -t threads),
    and writes the JAX package's CpuPolisher FASTA."""
    paths, want = sets["paf_3_contigs"]
    assert cli.main(["--host", "-t", threads, "-w", "100", "-m", "5", "-x",
                     "-4", "-g", "-8", *paths]) == 0
    assert capsys.readouterr().out == "".join(f">{n}\n{s}\n"
                                              for n, s in want)


def test_create_polisher_backends(sets):
    paths, _ = sets["sam"]
    p = racon_tpu_torch.create_polisher(*paths, device="cpu", **KW)
    assert isinstance(p, racon_tpu_torch.TorchPolisher)
    with pytest.raises(ValueError, match="backend must be one of"):
        racon_tpu_torch.create_polisher(*paths, backend="cpu", **KW)
    with pytest.raises(TypeError):
        racon_tpu_torch.create_polisher(*paths, backend="host",
                                        device="cpu", **KW)
