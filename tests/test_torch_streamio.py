"""racon_tpu_torch's streamed input (streamio.py) and memory budget
(resilience/budget.py) against racon_tpu's, on the CPU.

The same inputs (a three-contig simulated set, PAF and SAM, plain and
gzipped; the identical-read set of tests/test_faults.py) are indexed by
both packages' StreamIndex, whose per-chunk working sets must be
byte-identical; both MemoryBudgets classify the same sequence of RSS
readings to the same levels; the spill file round-trips; and the hard
watermark collapses the consensus feeder to depth 1.
"""

import gzip
import shutil

import pytest
import torch

from racon_tpu import polisher as jpolisher
from racon_tpu import streamio as jstreamio
from racon_tpu.resilience import budget as jbudget
from racon_tpu_torch import polisher, streamio
from racon_tpu_torch.ops.batch_exec import BatchExecutor
from racon_tpu_torch.resilience import budget
from racon_tpu_torch.tools import simulate
from tests.test_faults import _write_dataset


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    """{name: (reads, overlaps, target)}: the simulated three-contig set
    with PAF and with SAM overlaps, the same gzipped, and the
    identical-read set's SAM."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("stream")
    d = simulate.generate(str(root / "sim"), mbp=0.003, contigs=3)
    out = {"paf": (d["reads"], d["overlaps"], d["draft"]),
           "sam": (d["reads"], d["overlaps_sam"], d["draft"])}
    gz = root / "gz"
    gz.mkdir()
    for name, path in (("reads.fastq", d["reads"]),
                       ("overlaps.paf", d["overlaps"]),
                       ("draft.fasta", d["draft"])):
        with open(path, "rb") as src, gzip.open(gz / (name + ".gz"),
                                                "wb") as dst:
            shutil.copyfileobj(src, dst)
    out["paf_gz"] = tuple(str(gz / n) for n in (
        "reads.fastq.gz", "overlaps.paf.gz", "draft.fasta.gz"))
    ident = root / "ident"
    ident.mkdir()
    out["ident_sam"] = _write_dataset(ident)
    return root, out


def _working_sets(mod, split, paths, workdir):
    """Each chunk's realized (reads, overlaps) bytes and its tear."""
    workdir.mkdir()
    chunks = split(paths[2], 3, str(workdir))
    idx = mod.StreamIndex(paths[0], paths[1], chunks, str(workdir))
    out = []
    for ci in range(len(chunks)):
        s, o = idx.materialize(ci).realize(str(workdir))
        out.append((open(s, "rb").read(), open(o, "rb").read(),
                    idx.torn(ci) is None, idx.fmt))
    return out


@pytest.mark.parametrize("name", ["paf", "sam", "paf_gz", "ident_sam"])
def test_stream_index_subsets_equal_jax(sets, name):
    """Both packages' StreamIndex cut the same inputs into the same
    per-chunk working sets, byte for byte (gzip decompressed into the
    work directory), each chunk's reads a subset of the whole."""
    root, data = sets
    paths = data[name]
    want = _working_sets(jstreamio, jpolisher._split_fasta, paths,
                         root / f"jax_{name}")
    got = _working_sets(streamio, polisher._split_fasta, paths,
                        root / f"torch_{name}")
    assert got == want
    assert len(got) == 3 and all(ws[0] and ws[1] for ws in got)


def test_stream_index_refuses_mhap(tmp_path):
    """MHAP overlaps name reads by ordinal, which a subset would renumber:
    StreamUnsupported, as in the JAX package."""
    paths = _write_dataset(tmp_path, overlaps="paf")
    mhap = tmp_path / "ovl.mhap"
    mhap.write_text("1 1 0.1 0 0 0 200 200 0 0 200 200\n")
    chunks = polisher._split_fasta(paths[2], 3, str(tmp_path))
    with pytest.raises(streamio.StreamUnsupported, match="MHAP"):
        streamio.StreamIndex(paths[0], str(mhap), chunks, str(tmp_path))


#: RSS readings (MiB) against a 1,000 MiB budget: up through both
#: watermarks, down again (the hard latch stays), up to soft again.
READINGS = [100, 500, 799, 800, 900, 949, 950, 2000, 600, 10, 850, 960, 0]


@pytest.mark.parametrize("fracs", [(0.8, 0.95), (0.5, 0.6)])
def test_memory_budget_levels_equal_jax(fracs, monkeypatch):
    """The same RSS readings classify to the same levels, and latch the
    hard watermark at the same reading, in both packages' MemoryBudget."""
    monkeypatch.delenv("RACON_TPU_FAULT", raising=False)
    runs = []
    for mod in (jbudget, budget):
        it = iter(READINGS)
        b = mod.MemoryBudget(1000, soft_frac=fracs[0], hard_frac=fracs[1],
                             rss_source=lambda: next(it))
        runs.append([(b.poll(), b.level(), b.hard_latched())
                     for _ in READINGS])
    assert runs[0] == runs[1]
    assert [lv for lv, _, _ in runs[1]].count("hard") >= 3


def test_unbudgeted_polls_ok_and_starts_no_thread():
    b = budget.MemoryBudget(0, rss_source=lambda: 10**9)
    assert not b.enabled and b.poll() == "ok" and not b.hard_latched()
    b.start()
    assert b._thread is None
    assert budget.rss_mb() > 0 and budget.peak_rss_mb() > 0


def test_spill_round_trip(tmp_path):
    """park_bytes writes one spill file that load_spill reads back and
    deletes; a torn spill file raises; a WorkingSet parks and realizes
    through it; the JAX package reads the same file format."""
    blobs = [("seqs", b"ACGT" * 1000), ("ovls", b""), ("x", b"\x00\xff")]
    path = budget.park_bytes(blobs, str(tmp_path / "spill"), "c0")
    assert path and jbudget.load_spill(path) == blobs
    path = budget.park_bytes(blobs, str(tmp_path / "spill"), "c0")
    assert budget.load_spill(path) == blobs
    assert not list((tmp_path / "spill").iterdir())
    path = budget.park_bytes(blobs, str(tmp_path), "torn")
    with open(path, "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="torn spill file"):
        budget.load_spill(path)
    ws = streamio.WorkingSet(4, b"seqbytes", b"ovlbytes", "r.fa", "o.paf")
    assert ws.park(str(tmp_path / "ws")) and ws.parked() and ws.nbytes() == 0
    s, o = ws.realize(str(tmp_path))
    assert open(s, "rb").read() == b"seqbytes"
    assert open(o, "rb").read() == b"ovlbytes"


class _Ops:
    """A feeder's ops that records the order of its hooks' calls."""

    def __init__(self, log):
        self.log = log

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

    def install(self, ctx, items, results):
        pass

    def widen(self, ctx):
        return []


def test_hard_latch_collapses_the_feeder_to_depth_1():
    """At depth 3 the feeder keeps batches in flight until the budget's
    hard watermark latches; from the next submit it drains them and
    resolves each batch as soon as it is dispatched."""
    readings = iter([10, 10, 10, 99, 99, 99, 99, 99])
    b = budget.MemoryBudget(100, rss_source=lambda: next(readings))
    log = []
    ex = BatchExecutor(_Ops(log), depth=3, budget=b)
    for i in range(3):
        b.poll()
        ex.submit(None, [i])
    assert not ex.collapsed and ex.depth == 3
    assert log == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2),
                   ("unpack", 0)]
    b.poll()
    assert b.hard_latched()
    ex.submit(None, [3])
    ex.submit(None, [4])
    ex.flush()
    assert ex.collapsed and ex.depth == 1
    assert log[4:] == [("unpack", 1), ("unpack", 2), ("dispatch", 3),
                       ("unpack", 3), ("dispatch", 4), ("unpack", 4)]
