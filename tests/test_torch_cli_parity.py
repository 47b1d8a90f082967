"""racon_tpu_torch's CLI against racon_tpu's polisher over racon's flags,
on the CPU, each case through ``cli.main([..., "--report", PATH])``.

Each case's FASTA must be byte-identical to racon_tpu.TpuPolisher's on
the JAX CPU backend (its Hirschberg aligner in interpret mode:
RACON_TPU_DEVICE_ALIGNER=hirschberg), and the report's served counts
must sum to each phase's total: MHAP overlaps with 1-based ordinals,
fragment correction (-f) on read-against-read PAF with and without -u,
--no-trimming, -q 20 -e 0.1, and short reads (150 bp at 30x, -w 200)
flat and banded (--band --band-slack 8 against RACON_TPU_BAND=1,
RACON_TPU_BAND_SLACK=8).
"""

import json
import random

import pytest

import racon_tpu
from racon_tpu_torch import cli
from racon_tpu_torch.tools import simulate
from tests.test_torch_polish import _paf_dataset

SCORES = ["-m", "5", "-x", "-4", "-g", "-8"]
#: The short-read set's genome: 0.005 Mbp cut to 0.0015 so that the JAX
#: polish of it stays within seconds on the CPU.
SHORT_MBP = 0.0015


def _vary_qualities(fastq):
    """Give read k the base quality 12 + 6 * (k % 5), so that -q 20 keeps
    some layers and drops others."""
    with open(fastq) as f:
        lines = f.read().splitlines()
    for k in range(len(lines) // 4):
        q = lines[4 * k + 3]
        lines[4 * k + 3] = chr(33 + 12 + 6 * (k % 5)) * len(q)
    with open(fastq, "w") as f:
        f.write("\n".join(lines) + "\n")


def _paf_to_mhap(paths, out):
    """The PAF overlaps as MHAP: 1-based ordinals of the reads and the
    targets in file order (FASTA files)."""
    def names(path):
        with open(path) as f:
            return {ln[1:].split()[0]: i + 1 for i, ln in
                    enumerate(x for x in f if x.startswith(">"))}

    reads, targets = names(paths[0]), names(paths[2])
    with open(paths[1]) as f, open(out, "w") as o:
        for line in f:
            q, ql, qb, qe, strand, t, tl, tb, te = line.split("\t")[:9]
            o.write(f"{reads[q]} {targets[t]} 0.1 0 "
                    f"{1 if strand == '-' else 0} {qb} {qe} {ql} 0 {tb} "
                    f"{te} {tl}\n")
    return out


def _ava_dataset(tmp_path):
    """Five 400 bp reads at 4% error and their read-against-read PAF
    (as tests/test_fragment_device.py builds them)."""
    rng = random.Random(9)
    truth = "".join(rng.choice("ACGT") for _ in range(400))

    def mutate(s, rate):
        out = []
        for c in s:
            r = rng.random()
            if r < rate / 2:
                out.append(rng.choice("ACGT"))
            elif r >= rate:
                out.append(c)
        return "".join(out)

    reads = [mutate(truth, 0.04) for _ in range(5)]
    with open(tmp_path / "reads.fasta", "w") as f:
        for i, r in enumerate(reads):
            f.write(f">r{i}\n{r}\n")
    with open(tmp_path / "ava.paf", "w") as f:
        for i, a in enumerate(reads):
            for j, b in enumerate(reads):
                if i != j:
                    f.write(f"r{i}\t{len(a)}\t0\t{len(a)}\t+\tr{j}\t"
                            f"{len(b)}\t0\t{len(b)}\t{min(len(a), len(b))}"
                            f"\t{max(len(a), len(b))}\t60\n")
    reads_path = str(tmp_path / "reads.fasta")
    return reads_path, str(tmp_path / "ava.paf"), reads_path


def _jax(paths, kw, drop, monkeypatch, env=()):
    monkeypatch.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
    for k, v in env:
        monkeypatch.setenv(k, v)
    p = racon_tpu.TpuPolisher(*paths, **kw)
    p.initialize()
    return "".join(f">{n}\n{s}\n" for n, s in p.polish(drop))


def _cli(paths, flags, tmp_path, capsys):
    rep = str(tmp_path / "report.json")
    assert cli.main(["--device", "cpu", *flags, "--report", rep,
                     *paths]) == 0
    out = capsys.readouterr().out
    with open(rep) as f:
        phases = json.load(f)["phases"]
    for name, p in phases.items():
        assert sum(p["served"].values()) == p["total"], name
    return out, phases


def _data(case, tmp_path):
    """(paths, CLI flags, TpuPolisher keyword arguments, drop_unpolished,
    JAX knobs) of a case."""
    kw = dict(window_length=100, match=5, mismatch=-4, gap=-8)
    flags = ["-w", "100", *SCORES]
    if case == "mhap":
        r, o, t = _paf_dataset(tmp_path)
        return ((r, _paf_to_mhap((r, o, t), str(tmp_path / "o.mhap")), t),
                flags, kw, True, ())
    if case in ("fragment", "fragment_unpolished"):
        kw["fragment_correction"] = True
        flags = ["-f", *flags]
        if case == "fragment_unpolished":
            return _ava_dataset(tmp_path), ["-u", *flags], kw, False, ()
        return _ava_dataset(tmp_path), flags, kw, True, ()
    if case == "no_trimming":
        kw["trim"] = False
        return _paf_dataset(tmp_path), ["--no-trimming", *flags], kw, True, ()
    if case == "quality_error":
        d = simulate.generate(str(tmp_path), mbp=0.002, coverage=8,
                              mean_read=600, sub=0.02, ins=0.01, dele=0.01,
                              seed=5)
        _vary_qualities(d["reads"])
        kw.update(quality_threshold=20.0, error_threshold=0.1)
        return ((d["reads"], d["overlaps"], d["draft"]),
                ["-q", "20", "-e", "0.1", *flags], kw, True, ())
    d = simulate.generate(str(tmp_path), mbp=SHORT_MBP, coverage=30,
                          mean_read=150, sub=0.008, ins=0.001, dele=0.001,
                          seed=11)
    kw["window_length"] = 200
    flags = ["-w", "200", *SCORES]
    paths = (d["reads"], d["overlaps"], d["draft"])
    if case == "short_reads_band":
        return (paths, ["--band", "--band-slack", "8", *flags], kw, True,
                (("RACON_TPU_BAND", "1"), ("RACON_TPU_BAND_SLACK", "8")))
    return paths, flags, kw, True, ()


@pytest.mark.parametrize("case", [
    "mhap", "fragment", "fragment_unpolished", "no_trimming",
    "quality_error", "short_reads", "short_reads_band"])
def test_cli_equals_jax_polisher(case, tmp_path, capsys, monkeypatch):
    paths, flags, kw, drop, env = _data(case, tmp_path)
    got, phases = _cli(paths, flags, tmp_path, capsys)
    assert got, "nothing polished"
    assert got == _jax(paths, kw, drop, monkeypatch, env)
    assert phases["consensus"]["total"] > 0
    if case == "short_reads_band":
        assert phases["alignment"]["extra"]["band"]["jobs"] > 0
