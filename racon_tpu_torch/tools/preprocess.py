"""Paired-end read preprocessing: rename Illumina read pairs to unique names
(suffix 1/2) so the polisher can treat them single-end.

    python -m racon_tpu_torch.tools.preprocess <first.fastq> [second.fastq]

The reference racon's scripts/racon_preprocess.py (the same suffix
scheme, FASTQ validation, one or two input files), and it also reads
gzipped input. The port's own copy of the JAX package's
racon_tpu/tools/preprocess.py: the same output from the same input.
"""

from __future__ import annotations

import argparse
import gzip
import sys


def _open_any(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def parse_file(path: str, read_set: set, out) -> None:
    def emit(name, data, qual):
        if len(name) == 0 or len(data) == 0 or len(data) != len(qual):
            print("File is not in FASTQ format", file=sys.stderr)
            sys.exit(1)
        if name in read_set:
            out.write(f"{name}2\n")
        else:
            read_set.add(name)
            out.write(f"{name}1\n")
        out.write(f"{data}\n+\n{qual}\n")

    line_id = 0
    name, data, qual = "", "", ""
    valid = False
    with _open_any(path) as f:
        for line in f:
            if line_id == 0:
                if valid:
                    emit(name, data, qual)
                    valid = False
                name = line.rstrip().split(" ")[0]
                data = ""
                qual = ""
                line_id = 1
            elif line_id == 1:
                if line[0] == "+":
                    line_id = 2
                else:
                    data += line.rstrip()
            else:
                qual += line.rstrip()
                if len(qual) >= len(data):
                    valid = True
                    line_id = 0
    if valid:
        emit(name, data, qual)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch.tools.preprocess",
        description="rename Illumina paired-end reads to unique names")
    p.add_argument("first", help="file with the first read of a pair or both")
    p.add_argument("second", nargs="?",
                   help="optional file with the second reads of the pairs")
    args = p.parse_args(argv)

    read_set = set()
    parse_file(args.first, read_set, sys.stdout)
    if args.second is not None:
        parse_file(args.second, read_set, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
