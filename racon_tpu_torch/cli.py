"""Command line: racon's flags, polishing on a CUDA card.

Usage: python -m racon_tpu_torch.cli [options] <sequences> <overlaps>
       <target sequences> > polished.fasta
"""

from __future__ import annotations

import argparse
import sys

from .native import NativeError
from .polisher import create_polisher


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch",
        description="consensus polishing of long uncorrected reads, with "
        "the alignment and POA kernels on a CUDA card")
    p.add_argument("sequences", help="FASTA/FASTQ file (optionally gzipped) "
                   "containing sequences used for correction")
    p.add_argument("overlaps", help="MHAP/PAF/SAM file (optionally gzipped) "
                   "containing overlaps between sequences and target "
                   "sequences")
    p.add_argument("targets", help="FASTA/FASTQ file (optionally gzipped) "
                   "containing sequences which will be corrected")
    p.add_argument("-u", "--include-unpolished", action="store_true",
                   help="output unpolished target sequences")
    p.add_argument("-f", "--fragment-correction", action="store_true",
                   help="perform fragment correction instead of contig "
                   "polishing (overlaps file should contain dual/self "
                   "overlaps!)")
    p.add_argument("-w", "--window-length", type=int, default=500,
                   help="size of window on which POA is performed (default "
                   "500)")
    p.add_argument("-q", "--quality-threshold", type=float, default=10.0,
                   help="threshold for average base quality of windows used "
                   "in POA (default 10.0)")
    p.add_argument("-e", "--error-threshold", type=float, default=0.3,
                   help="maximum allowed error rate used for filtering "
                   "overlaps (default 0.3)")
    p.add_argument("--no-trimming", action="store_true",
                   help="disables consensus trimming at window ends")
    p.add_argument("-m", "--match", type=int, default=3,
                   help="score for matching bases (default 3)")
    p.add_argument("-x", "--mismatch", type=int, default=-5,
                   help="score for mismatching bases (default -5)")
    p.add_argument("-g", "--gap", type=int, default=-4,
                   help="gap penalty, must be negative (default -4)")
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="number of host threads (default 1)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the kernels run (default cuda; cpu runs "
                   "their plain PyTorch versions)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    try:
        polisher = create_polisher(
            args.sequences, args.overlaps, args.targets, device=args.device,
            fragment_correction=args.fragment_correction,
            window_length=args.window_length,
            quality_threshold=args.quality_threshold,
            error_threshold=args.error_threshold,
            trim=not args.no_trimming,
            match=args.match, mismatch=args.mismatch, gap=args.gap,
            num_threads=args.threads)
        polisher.initialize()
        for name, data in polisher.polish(not args.include_unpolished):
            sys.stdout.write(f">{name}\n{data}\n")
    except NativeError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
