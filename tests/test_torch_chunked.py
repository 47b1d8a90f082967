"""racon_tpu_torch's chunked polish (pipelined phases, streamed input, the
memory budget) against its sequential polish and racon_tpu's, on the CPU.

TorchPolisher(device="cpu") runs the kernels' plain versions; racon_tpu's
TpuPolisher runs on the JAX CPU backend with its Hirschberg aligner
(RACON_TPU_DEVICE_ALIGNER=hirschberg) under the matching knob
(RACON_TPU_PIPELINE_PHASES=1, RACON_TPU_STREAM_INPUT=1 or both). Each
JAX run is made once per module. The FASTA must be byte-identical: on a
three-contig set (PAF; the same gzipped; MHAP, which the chunked modes
keep sequential), and, where a torn overlap tail degrades a chunk, the
same chunk quarantined with the same output as the JAX package.
"""

import gzip
import os
import shutil

import pytest
import torch

import racon_tpu
from racon_tpu import polisher as jpolisher
from racon_tpu_torch import TorchPolisher, polisher
from racon_tpu_torch.tools import simulate
from tests.test_faults import _write_dataset
from tests.test_torch_polish import KW

MODES = {"pipelined": dict(pipeline_phases=True),
         "streamed": dict(stream_input=True),
         "both": dict(pipeline_phases=True, stream_input=True)}
JAX_KNOBS = {"pipelined": {"RACON_TPU_PIPELINE_PHASES": "1"},
             "streamed": {"RACON_TPU_STREAM_INPUT": "1"},
             "both": {"RACON_TPU_PIPELINE_PHASES": "1",
                      "RACON_TPU_STREAM_INPUT": "1"}}


def _torch_run(paths, **mode):
    p = TorchPolisher(*paths, device="cpu", **KW, **mode)
    p.initialize()
    return p.polish(True), p


def _jax_run(paths, knobs):
    with pytest.MonkeyPatch.context() as mp:
        for k in ("RACON_TPU_PIPELINE_PHASES", "RACON_TPU_STREAM_INPUT",
                  "RACON_TPU_MEM_BUDGET_MB", "RACON_TPU_FAULT"):
            mp.delenv(k, raising=False)
        mp.setenv("RACON_TPU_DEVICE_ALIGNER", "hirschberg")
        for k, v in knobs.items():
            mp.setenv(k, v)
        p = racon_tpu.TpuPolisher(*paths, **KW)
        p.initialize()
        return p.polish(True), p


def _paf_to_mhap(paths, out):
    """The PAF overlaps as MHAP: 1-based ordinals of the reads and the
    targets in file order."""
    def names(path, marker):
        with open(path) as f:
            lines = f.read().splitlines()
        step = 4 if marker == "@" else 2
        return {ln[1:].split()[0]: i + 1
                for i, ln in enumerate(lines[::step])}

    reads, targets = names(paths[0], "@"), names(paths[2], ">")
    with open(paths[1]) as f, open(out, "w") as o:
        for line in f:
            q, ql, qb, qe, strand, t, tl, tb, te = line.split("\t")[:9]
            o.write(f"{reads[q]} {targets[t]} 0.1 0 "
                    f"{1 if strand == '-' else 0} {qb} {qe} {ql} 0 {tb} "
                    f"{te} {tl}\n")
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The three-contig set (PAF, gzipped PAF, MHAP), the port's
    sequential FASTA of it, and the JAX package's FASTA under each
    chunked mode's knobs."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("chunked")
    d = simulate.generate(str(root / "sim"), mbp=0.003, contigs=3)
    paths = (d["reads"], d["overlaps"], d["draft"])
    gz = []
    for path in paths:
        dst = str(root / (os.path.basename(path) + ".gz"))
        with open(path, "rb") as src, gzip.open(dst, "wb") as out:
            shutil.copyfileobj(src, out)
        gz.append(dst)
    mhap = (paths[0], _paf_to_mhap(paths, str(root / "overlaps.mhap")),
            paths[2])
    seq, _ = _torch_run(paths)
    jax = {m: _jax_run(paths, knobs)[0] for m, knobs in JAX_KNOBS.items()}
    return {"paf": paths, "gz": tuple(gz), "mhap": mhap, "seq": seq,
            "jax": jax}


@pytest.mark.parametrize("target", ["plain", "gzip", "unsplittable",
                                    "one_contig"])
def test_split_fasta_equals_jax(tmp_path, target):
    """_split_fasta cuts a target into the JAX package's chunk files
    (verbatim record text, base-balanced), and refuses the same
    unsplittable targets."""
    text = "".join(f">c{i} x\n{'ACGT' * (i + 1)}\nAC\n" for i in range(7))
    path = tmp_path / "t.fasta"
    if target == "gzip":
        path = tmp_path / "t.fasta.gz"
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text({"plain": text, "unsplittable": "junk\n" + text,
                         "one_contig": ">c0\nACGT\n"}[target])
    for hint in (2, 3, 9):
        outs = []
        for split, sub in ((jpolisher._split_fasta, "j"),
                           (polisher._split_fasta, "t")):
            d = tmp_path / f"{sub}{hint}"
            d.mkdir()
            chunks = split(str(path), hint, str(d))
            outs.append(None if chunks is None else
                        [(os.path.basename(c), open(c).read())
                         for c in chunks])
        assert outs[0] == outs[1]
        if target in ("plain", "gzip"):
            assert "".join(t for _, t in outs[1]) == text
        else:
            assert outs[1] is None


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_modes_equal_sequential_and_jax(data, mode):
    got, p = _torch_run(data["paf"], **MODES[mode])
    assert got == data["seq"] == data["jax"][mode]
    st = p.stats
    assert st["chunks"] == 3 and len(st["chunk_s"]) == 3
    assert st["streamed"] == (mode != "pipelined")
    assert st["quarantined"] == [] and st["pressure_level"] == "ok"
    assert st["consensus"]["device"] > 0 and st["align"]["device"] > 0
    assert st["peak_rss_mb"] > 0 and st["overlap_s"] >= 0
    assert not st["collapsed"]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_chunked_modes_on_gzip_inputs(data, mode):
    """Gzipped reads, overlaps and target: each chunked mode (streaming
    decompresses them once into the run's work directory) gives the
    plain inputs' bytes."""
    got, p = _torch_run(data["gz"], **MODES[mode])
    assert got == data["seq"]
    assert p.stats["chunks"] == 3


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mhap_streaming_falls_back_with_its_note(data, mode, capfd):
    """MHAP overlaps name reads and targets by ordinal, which a chunk's
    own target file renumbers: every chunked mode falls back, with a
    NOTE, to the sequential phases, and the bytes are the sequential
    MHAP polish's, which are the PAF polish's. (The JAX package chunks
    MHAP input, streaming falling back to the whole inputs, and its
    chunked FASTA differs from its sequential one there.)"""
    want, _ = _torch_run(data["mhap"])
    capfd.readouterr()
    got, p = _torch_run(data["mhap"], **MODES[mode])
    err = capfd.readouterr().err
    assert got == want == data["seq"]
    assert "chunks" not in p.stats
    assert "NOTE: MHAP overlaps name targets by ordinal" in err


def test_truncated_overlap_tail_quarantines_a_chunk_as_jax(tmp_path):
    """A SAM file torn mid-record: the chunk that owns the tail is
    quarantined and polishes from the working set indexed before the
    tear, as in the JAX package: the same chunk, the same bytes."""
    paths = _write_dataset(tmp_path)
    data = open(paths[1], "rb").read()
    with open(paths[1], "wb") as f:
        f.write(data[:-30])
    got, p = _torch_run(paths, stream_input=True)
    want, jp = _jax_run(paths, JAX_KNOBS["streamed"])
    assert got == want
    jq = jp.report.as_dict()["phases"]["memory"]["quarantined"]
    assert p.stats["quarantined"] == [2]
    assert len(jq) == 1 and "2" in str(jq[0])


def test_worker_exception_is_reraised(data, monkeypatch):
    """An exception on the alignment worker (here in chunk 1's
    alignment) is raised by polish() on the calling thread."""
    calls = []
    real = polisher.run_alignment_phase

    def align(pl, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("alignment failed on the worker")
        return real(pl, **kw)

    monkeypatch.setattr(polisher, "run_alignment_phase", align)
    p = TorchPolisher(*data["paf"], device="cpu", pipeline_phases=True,
                      **KW)
    p.initialize()
    with pytest.raises(RuntimeError, match="failed on the worker"):
        p.polish(True)
    assert not p._worker.is_alive()


@pytest.mark.parametrize("case", ["not_fasta", "one_contig"])
def test_unchunkable_targets_run_sequentially_with_a_note(tmp_path, capfd,
                                                          case):
    from tests.test_torch_polish import _paf_dataset

    paths = _paf_dataset(tmp_path)
    if case == "not_fasta":
        fq = tmp_path / "t.fastq"
        seq = open(paths[2]).read().split("\n")[1]
        fq.write_text(f"@t\n{seq}\n+\n{'I' * len(seq)}\n")
        paths = (paths[0], paths[1], str(fq))
    want, _ = _torch_run(paths)
    capfd.readouterr()
    got, p = _torch_run(paths, pipeline_phases=True, stream_input=True)
    err = capfd.readouterr().err
    assert got == want
    assert "chunks" not in p.stats
    assert ("needs a FASTA target" if case == "not_fasta"
            else "fewer than two contigs") in err


def test_tight_budget_collapses_and_keeps_the_bytes(data):
    """A 64 MiB budget (below this process's RSS): streaming arms, the
    hard watermark latches on the first chunk's poll, working sets go
    through the spill file, the pipeline and the consensus feeder
    collapse, and the bytes are the sequential polish's."""
    got, p = _torch_run(data["paf"], pipeline_phases=True,
                        memory_budget_mb=64)
    st = p.stats
    assert got == data["seq"]
    assert st["streamed"] and st["pressure_level"] == "hard"
    assert st["collapsed"] and st["consensus"]["depth_collapsed"]
    assert st["peak_rss_mb"] > 64 and st["quarantined"] == []
