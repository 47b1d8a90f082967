"""Streaming per-chunk working sets for the chunked polisher.

A copy of the JAX package's module (racon_tpu/streamio.py), without its
trace events. The chunked polisher splits the *target* FASTA into
contiguous contig chunks (``polisher._split_fasta``), but without this
module every chunk's native ``Pipeline`` still parses the **full** reads
and overlaps files, so peak RSS is O(genome) however small the chunks.
This module makes the working set O(chunk):

1. an **index pass** streams the overlaps file once, recording per-chunk
   byte ranges (and, per chunk, which read names its overlaps
   reference), then streams the reads file once, recording each needed
   read record's byte range;
2. at polish time each chunk **materializes** exactly its byte ranges
   into a small subset file pair which the native pipeline parses
   instead of the full inputs, and releases when the chunk is done.

Gzipped inputs are decompressed once into the run's work directory
(constant memory) so ranges are plain byte offsets.  Subsetting only
ever removes records the native parser would ignore for that chunk's
targets anyway — the chunked full-file path already proves that — so
output is byte-identical to the in-memory path.

Formats: PAF (column 6 = target name) and SAM (column 3 = RNAME, ``@``
headers copied to every chunk).  MHAP references reads by ordinal id,
which subsetting would renumber, so MHAP (and anything unrecognized)
raises :class:`StreamUnsupported` and the polisher falls back to the
in-memory path with a NOTE.

Torn input is survivable: a truncated or gzip-corrupt tail marks the
chunks whose ranges the tear could have fed as *torn*; the polisher
routes those chunks to the quarantine path (recorded in the RunReport)
and polishes them from the working set indexed before the tear, while
every other chunk — and the run — proceeds normally.  The in-memory
path, by contrast, hands the corrupt file straight to the native parser
and dies.
"""

from __future__ import annotations

import gzip
import os
import zlib
from typing import Dict, List, Optional, Tuple

from .resilience import budget

#: I/O block size for decompression and range gathering.
_BLOCK = 1 << 20

#: Errors a torn/corrupt input surfaces while streaming.
TORN_ERRORS = (OSError, EOFError, zlib.error, ValueError,
               UnicodeDecodeError)


class StreamUnsupported(Exception):
    """The inputs cannot be streamed (MHAP/unknown overlap format);
    the caller falls back to the in-memory path."""


def _plain_name(path: str) -> str:
    base = os.path.basename(path)
    return base[:-3] if base.endswith(".gz") else base


def _ensure_plain(path: str, workdir: str,
                  tag: str) -> Tuple[str, Optional[Exception]]:
    """A plain (uncompressed) copy of `path` with stable byte offsets.
    Non-gz inputs are used in place.  A corrupt gz tail yields the
    partial decompressed prefix plus the exception (torn input)."""
    if not path.endswith(".gz"):
        return path, None
    out = os.path.join(workdir, f"plain.{tag}.{_plain_name(path)}")
    torn: Optional[Exception] = None
    with open(out, "wb") as dst:
        try:
            with gzip.open(path, "rb") as src:
                while True:
                    # read1, not read: read(n) loops underlying reads to
                    # fill n and a corrupt tail raises mid-fill, throwing
                    # away the already-decompressed prefix; read1 does
                    # one decompression step, so every good block lands
                    # on disk before the tear raises
                    block = src.read1(_BLOCK)
                    if not block:
                        break
                    dst.write(block)
        except TORN_ERRORS as e:
            torn = e
    return out, torn


def chunk_contigs(chunk_paths: List[str]) -> List[List[bytes]]:
    """Per-chunk contig names, parsed from the split chunk FASTAs
    (the first whitespace-delimited token of each ``>`` header)."""
    out: List[List[bytes]] = []
    for cp in chunk_paths:
        names: List[bytes] = []
        with open(cp, "rb") as f:
            for line in f:
                if line.startswith(b">"):
                    names.append(line[1:].split()[0])
        out.append(names)
    return out


def _sniff_format(plain_ovls: str, original: str) -> str:
    """'paf' | 'sam'; raises StreamUnsupported otherwise."""
    base = _plain_name(original).lower()
    if base.endswith(".mhap"):
        raise StreamUnsupported(
            "MHAP overlaps reference reads by ordinal id; streaming "
            "subsets would renumber them")
    with open(plain_ovls, "rb") as f:
        first_data = b""
        for line in f:
            if not line.startswith(b"@"):
                first_data = line
                break
        cols = first_data.rstrip(b"\r\n").split(b"\t")
        if base.endswith(".paf") or (
                len(cols) >= 12 and cols[4] in (b"+", b"-")):
            return "paf"
        if base.endswith(".sam") or (
                len(cols) >= 11 and cols[1].isdigit()
                and cols[3].isdigit()):
            return "sam"
    raise StreamUnsupported(
        f"unrecognized overlap format in {original!r} "
        "(streaming supports PAF and SAM)")


def _add_range(ranges: List[List[int]], start: int, end: int) -> None:
    """Append [start, end), coalescing with a contiguous predecessor so
    contig-grouped files index to ~one range per chunk."""
    if ranges and ranges[-1][1] == start:
        ranges[-1][1] = end
    else:
        ranges.append([start, end])


class WorkingSet:
    """One chunk's materialized reads+overlaps subset.

    Lives in memory between materialization and realization; ``park``
    moves the buffers to a disk spill file under memory pressure
    (the soft-watermark backpressure), ``realize`` writes the subset
    files the native pipeline parses — reloading from the spill file
    first when parked."""

    def __init__(self, chunk_index: int, seqs: bytes, ovls: bytes,
                 seqs_name: str, ovls_name: str):
        self.chunk_index = chunk_index
        self._seqs: Optional[bytes] = seqs
        self._ovls: Optional[bytes] = ovls
        self.seqs_name = seqs_name
        self.ovls_name = ovls_name
        self._spill: Optional[str] = None

    def nbytes(self) -> int:
        if self._spill is not None:
            return 0
        return len(self._seqs or b"") + len(self._ovls or b"")

    def parked(self) -> bool:
        return self._spill is not None

    def park(self, dir_path: str) -> bool:
        """Spill the buffers to disk (no-op when already parked or an I/O
        error aborts the park: the working set then stays in memory)."""
        if self._spill is not None or self._seqs is None:
            return False
        path = budget.park_bytes(
            [("seqs", self._seqs), ("ovls", self._ovls)],
            dir_path, f"chunk{self.chunk_index}")
        if path is None:
            return False
        self._spill = path
        self._seqs = None
        self._ovls = None
        return True

    def realize(self, outdir: str) -> Tuple[str, str]:
        """Write the subset files for the native pipeline and release
        the in-memory buffers.  Raises on a torn spill file."""
        if self._spill is not None:
            pairs = dict(budget.load_spill(self._spill))
            self._spill = None
            self._seqs = pairs["seqs"]
            self._ovls = pairs["ovls"]
        ci = self.chunk_index
        seqs_path = os.path.join(outdir, f"ws{ci}.{self.seqs_name}")
        ovls_path = os.path.join(outdir, f"ws{ci}.{self.ovls_name}")
        with open(seqs_path, "wb") as f:
            f.write(self._seqs or b"")
        with open(ovls_path, "wb") as f:
            f.write(self._ovls or b"")
        self._seqs = None
        self._ovls = None
        return seqs_path, ovls_path

    def release(self) -> None:
        self._seqs = None
        self._ovls = None
        if self._spill is not None:
            try:
                os.unlink(self._spill)
            except OSError:
                pass
            self._spill = None


class StreamIndex:
    """Byte-range index of the reads/overlaps files, per target chunk.

    Built by one streaming pass over each input (constant memory);
    ``materialize(ci)`` then loads chunk ci's working set — O(chunk),
    not O(genome).  ``torn(ci)`` reports chunks a truncated/corrupt
    input tail may have starved; the polisher quarantines those."""

    def __init__(self, sequences_path: str, overlaps_path: str,
                 chunk_paths: List[str], workdir: str):
        self.workdir = workdir
        self.seqs_name = _plain_name(sequences_path)
        self.ovls_name = _plain_name(overlaps_path)
        n = len(chunk_paths)
        self._ovl_ranges: List[List[List[int]]] = [[] for _ in range(n)]
        self._read_ranges: List[List[List[int]]] = [[] for _ in range(n)]
        self._headers: List[List[int]] = []
        self._torn: Dict[int, Exception] = {}

        contig_map: Dict[bytes, int] = {}
        for ci, names in enumerate(chunk_contigs(chunk_paths)):
            for name in names:
                contig_map[name] = ci

        self._plain_ovls, ovl_tear = _ensure_plain(
            overlaps_path, workdir, "ovls")
        self.fmt = _sniff_format(self._plain_ovls, overlaps_path)
        needed = self._index_overlaps(contig_map, ovl_tear)

        self._plain_seqs, seq_tear = _ensure_plain(
            sequences_path, workdir, "seqs")
        self._index_reads(needed, seq_tear)

    # -- index passes -----------------------------------------------------
    def _index_overlaps(self, contig_map: Dict[bytes, int],
                        tear: Optional[Exception]):
        """One pass over the (plain) overlaps file: per-chunk byte
        ranges plus the read names each chunk needs.  Returns
        {read_name: set(chunk ids)}."""
        tname_col = 5 if self.fmt == "paf" else 2
        needed: Dict[bytes, set] = {}
        seen_data = [False] * len(self._ovl_ranges)
        last_ci: Optional[int] = None
        offset = 0
        with open(self._plain_ovls, "rb") as f:
            for line in f:
                ln = len(line)
                if self.fmt == "sam" and line.startswith(b"@"):
                    _add_range(self._headers, offset, offset + ln)
                    offset += ln
                    continue
                complete = line.endswith(b"\n")
                cols = line.rstrip(b"\r\n").split(b"\t")
                ci = None
                if len(cols) > tname_col:
                    ci = contig_map.get(cols[tname_col])
                if not complete:
                    # truncated final record: its chunk (when still
                    # identifiable) ran out of data mid-stream
                    tear = tear or ValueError(
                        f"truncated overlap record at byte {offset} "
                        f"of {self.ovls_name}")
                    if ci is not None:
                        self._torn[ci] = tear
                    break
                if ci is not None:
                    _add_range(self._ovl_ranges[ci], offset, offset + ln)
                    needed.setdefault(cols[0], set()).add(ci)
                    seen_data[ci] = True
                    last_ci = ci
                offset += ln
        if tear is not None:
            # chunks the tear could have starved: the one mid-record at
            # the tear, and any chunk with no overlaps yet (their data,
            # if it existed, was beyond the tear — exact for the usual
            # contig-grouped layout, conservative otherwise)
            if last_ci is not None:
                self._torn.setdefault(last_ci, tear)
            for ci, seen in enumerate(seen_data):
                if not seen:
                    self._torn.setdefault(ci, tear)
        return needed

    def _index_reads(self, needed: Dict[bytes, set],
                     tear: Optional[Exception]) -> None:
        """One pass over the (plain) reads FASTA/FASTQ: the byte range
        of every record a chunk's overlaps reference."""
        found: Dict[bytes, List[int]] = {}
        offset = 0
        with open(self._plain_seqs, "rb") as f:
            first = f.read(1)
            f.seek(0)
            fastq = first == b"@"
            if fastq:
                while True:
                    rec = [f.readline() for _ in range(4)]
                    if not rec[0]:
                        break
                    ln = sum(len(x) for x in rec)
                    if not all(rec):  # file ended mid-record
                        tear = tear or ValueError(
                            f"truncated FASTQ record at byte {offset} "
                            f"of {self.seqs_name}")
                        break
                    name = rec[0][1:].split()[0] if len(rec[0]) > 1 else b""
                    found[name] = [offset, offset + ln]
                    offset += ln
            else:
                name = None
                start = 0
                for line in f:
                    if line.startswith(b">"):
                        if name is not None:
                            found[name] = [start, offset]
                        name = line[1:].split()[0] if len(line) > 1 else b""
                        start = offset
                    offset += len(line)
                if name is not None:
                    found[name] = [start, offset]
        for rname, chunks in needed.items():
            rng = found.get(rname)
            for ci in chunks:
                if rng is not None:
                    _add_range(self._read_ranges[ci], rng[0], rng[1])
                elif tear is not None:
                    # a referenced read the tear swallowed
                    self._torn.setdefault(ci, tear)

    # -- chunk access -----------------------------------------------------
    def torn(self, ci: int) -> Optional[Exception]:
        """The tear that starved chunk ci's working set, if any."""
        return self._torn.get(ci)

    def _gather(self, path: str, ranges: List[List[int]]) -> bytes:
        parts = []
        with open(path, "rb") as f:
            for start, end in ranges:
                f.seek(start)
                todo = end - start
                while todo > 0:
                    block = f.read(min(_BLOCK, todo))
                    if not block:
                        raise ValueError(
                            f"range [{start},{end}) past EOF in {path!r}")
                    parts.append(block)
                    todo -= len(block)
        return b"".join(parts)

    def materialize(self, ci: int) -> WorkingSet:
        """Load chunk ci's working set into memory (subset bytes of the
        reads and overlaps files; SAM headers included).  Raises
        OSError/ValueError on unreadable ranges — the caller routes
        that chunk to the quarantine path."""
        # ranges are deduplicated per chunk, so a read shared by two
        # chunks is loaded once into each chunk's subset
        seqs = self._gather(self._plain_seqs, self._read_ranges[ci])
        ovls = self._gather(
            self._plain_ovls, self._headers + self._ovl_ranges[ci])
        return WorkingSet(ci, seqs, ovls, self.seqs_name, self.ovls_name)
