"""Sequence subsampler and splitter, command-line compatible with the
rampler that the reference racon's wrapper runs (scripts/racon_wrapper.py
upstream):

    python -m racon_tpu_torch.tools.sampler [-o OUTDIR] subsample \
        <sequences> <ref_length> <coverage>
    python -m racon_tpu_torch.tools.sampler [-o OUTDIR] split \
        <sequences> <chunk_size_bytes>

subsample writes <basename>_<coverage>x.<ext>; split writes
<basename>_<i>.<ext>, the names the wrapper (tools/wrapper.py) looks for.
The port's own copy of the JAX package's racon_tpu/tools/sampler.py: the
same files from the same inputs and seed.
"""

from __future__ import annotations

import argparse
import gzip
import os
import random
import sys


def _open_any(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def _fmt(path: str):
    base = path[:-3] if path.endswith(".gz") else path
    for ext in (".fasta", ".fa", ".fna"):
        if base.endswith(ext):
            return "fasta", ".fasta"
    for ext in (".fastq", ".fq"):
        if base.endswith(ext):
            return "fastq", ".fastq"
    print(f"[racon_tpu_torch::sampler] error: unsupported extension in "
          f"{path}", file=sys.stderr)
    sys.exit(1)


def _records(path: str):
    """Yield (header_lines...) record tuples as raw text blocks."""
    fmt, _ = _fmt(path)
    with _open_any(path) as f:
        if fmt == "fasta":
            name, chunks = None, []
            for line in f:
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        yield name, "".join(chunks), None
                    name = line
                    chunks = []
                else:
                    chunks.append(line)
            if name is not None:
                yield name, "".join(chunks), None
        else:
            while True:
                header = f.readline().rstrip("\n")
                if not header:
                    return
                data = f.readline().rstrip("\n")
                f.readline()
                qual = f.readline().rstrip("\n")
                yield header, data, qual


def _write_record(out, rec, fmt):
    name, data, qual = rec
    if fmt == "fasta":
        out.write(f"{name}\n{data}\n")
    else:
        out.write(f"{name}\n{data}\n+\n{qual}\n")


def subsample_path(path: str, coverage: int, outdir: str) -> str:
    """Output naming contract shared with the wrapper's resume probing."""
    _, ext = _fmt(path)
    base_name = os.path.basename(path).split(".")[0]
    return os.path.join(outdir, f"{base_name}_{coverage}x{ext}")


def subsample(path: str, ref_length: int, coverage: int, outdir: str,
              seed: int = 42) -> str:
    """Random subsample of whole reads down to coverage * ref_length bases
    (the rampler contract). The output appears atomically (tmp + rename) so
    an interrupted run never leaves a truncated file for --resume to trust."""
    fmt, _ = _fmt(path)
    target_bases = ref_length * coverage

    records = list(_records(path))
    total = sum(len(r[1]) for r in records)
    rng = random.Random(seed)

    out_path = subsample_path(path, coverage, outdir)

    tmp_path = out_path + ".tmp"
    with open(tmp_path, "w") as out:
        if total <= target_bases:
            for rec in records:
                _write_record(out, rec, fmt)
        else:
            order = list(range(len(records)))
            rng.shuffle(order)
            picked = 0
            chosen = []
            for i in order:
                if picked >= target_bases:
                    break
                chosen.append(i)
                picked += len(records[i][1])
            for i in sorted(chosen):
                _write_record(out, records[i], fmt)
    os.replace(tmp_path, out_path)
    return out_path


def split(path: str, chunk_size: int, outdir: str) -> list:
    """Split into chunks of ~chunk_size bytes of sequence data."""
    fmt, ext = _fmt(path)
    base_name = os.path.basename(path).split(".")[0]
    outputs = []
    out = None
    written = 0
    idx = 0
    for rec in _records(path):
        if out is None or (written >= chunk_size and written > 0):
            if out is not None:
                out.close()
            out_path = os.path.join(outdir, f"{base_name}_{idx}{ext}")
            outputs.append(out_path)
            out = open(out_path, "w")
            written = 0
            idx += 1
        _write_record(out, rec, fmt)
        written += len(rec[1])
    if out is not None:
        out.close()
    return outputs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch.tools.sampler",
        description="sequence subsampler/splitter (rampler-equivalent)")
    p.add_argument("-o", "--out-directory", default=".",
                   help="output directory")
    sub = p.add_subparsers(dest="mode", required=True)
    ps = sub.add_parser("subsample")
    ps.add_argument("sequences")
    ps.add_argument("reference_length", type=int)
    ps.add_argument("coverage", type=int)
    pp = sub.add_parser("split")
    pp.add_argument("sequences")
    pp.add_argument("chunk_size", type=int)

    args = p.parse_args(argv)
    os.makedirs(args.out_directory, exist_ok=True)
    if args.mode == "subsample":
        subsample(args.sequences, args.reference_length, args.coverage,
                  args.out_directory)
    else:
        split(args.sequences, args.chunk_size, args.out_directory)
    return 0


if __name__ == "__main__":
    sys.exit(main())
