"""Command line: racon's flags, polishing on a CUDA card.

Usage: python -m racon_tpu_torch.cli [options] <sequences> <overlaps>
       <target sequences> > polished.fasta
       python -m racon_tpu_torch.cli serve [daemon options]

``serve`` runs the resident polishing daemon (racon_tpu_torch/serve).

The fault spec (resilience/faults.py) is read from RACON_TORCH_FAULT and
checked up front: a malformed one is one line on stderr and exit 1, as a
journal that belongs to other inputs on --resume-journal is.
"""

from __future__ import annotations

import argparse
import sys

from . import __version__
from .native import NativeError
from .ops import band as _band
from .ops.batch_exec import DEFAULT_DEPTH
from .ops.poa_driver import DEFAULT_POA_KERNEL, POA_KERNELS
from .polisher import create_polisher
from .resilience import faults
from .resilience.journal import JournalError


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
                   help="number of host threads (default 1; the host "
                   "backend's consensus threads)")
    p.add_argument("--host", action="store_true",
                   help="polish on the host alone (the native pipeline, "
                   "the JAX package's default backend); without it the "
                   "kernels run on the card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the kernels run (default cuda; cpu runs "
                   "their plain PyTorch versions)")
    p.add_argument("--poa-kernel", choices=POA_KERNELS,
                   default=DEFAULT_POA_KERNEL,
                   help=f"POA consensus kernel (default {DEFAULT_POA_KERNEL})"
                   ": ls or v2, one window per block each; both give the "
                   "same consensus")
    p.add_argument("--band", action="store_true",
                   help="banded DP on the aligner and the POA kernel, "
                   "with verify-and-widen down to the flat run (same "
                   "output)")
    p.add_argument("--band-slack", type=int, default=_band.DEFAULT_SLACK,
                   help="half-band slack beyond the length delta (default "
                   f"{_band.DEFAULT_SLACK})")
    p.add_argument("--band-max-widenings", type=int,
                   default=_band.DEFAULT_MAX_WIDENINGS,
                   help="band doublings before a job runs flat (default "
                   f"{_band.DEFAULT_MAX_WIDENINGS})")
    p.add_argument("--pipeline-phases", action="store_true",
                   help="split a multi-contig FASTA target into chunks and "
                   "align chunk N+1 while chunk N runs consensus (same "
                   "output)")
    p.add_argument("--handoff-depth", type=int, default=1,
                   help="aligned chunks queued for consensus (default 1; "
                   "the target is split into this plus 2 chunks)")
    p.add_argument("--stream-input", action="store_true",
                   help="each chunk parses only its own byte ranges of "
                   "the reads and overlaps (PAF, SAM), so memory grows "
                   "with the chunk, not the genome (same output)")
    p.add_argument("--memory-budget-mb", type=int, default=0,
                   help="RSS budget in MiB (default 0: none); above 0 it "
                   "arms --stream-input, parks working sets on disk at "
                   "80%% of it and collapses the pipelines at 95%%")
    p.add_argument("--pipeline-depth", type=int, default=DEFAULT_DEPTH,
                   help="consensus batches in flight on the card (default "
                   f"{DEFAULT_DEPTH})")
    p.add_argument("--device-timeout", type=float, default=0.0,
                   metavar="SECONDS",
                   help="watchdog deadline on each wait for the card "
                   "(default 0: none); on expiry the polish ends with "
                   "WatchdogTimeout")
    p.add_argument("--report", metavar="PATH", default=None,
                   help="write a JSON run report (served counts by tier for "
                   "each phase, wall seconds, the armed fault spec) to PATH")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="write a Chrome-trace JSON timeline of the run "
                   "(phase spans, align cohorts, POA buckets and batches, "
                   "on the card a device track of every launch; metrics "
                   "embedded) to PATH; read it with `python -m "
                   "racon_tpu_torch.obs PATH` or ui.perfetto.dev")
    jr = p.add_mutually_exclusive_group()
    jr.add_argument("--journal", metavar="PATH", default=None,
                    help="append every served window and kernel CIGAR to a "
                    "crash-safe journal at PATH (fsynced JSONL; overwrites "
                    "an existing file), so that an interrupted run can be "
                    "resumed")
    jr.add_argument("--resume-journal", metavar="PATH", default=None,
                    help="resume from the journal at PATH: replay what was "
                    "served, compute only the rest and keep appending; the "
                    "output is the uninterrupted run's (exit 1 where the "
                    "journal belongs to other inputs or parameters; a "
                    "missing PATH starts fresh)")
    p.add_argument("--version", action="version", version=__version__)
    return p


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # the subcommand: `serve` hands the rest of the argv to the daemon
    # before the polish flags' parser sees it
    if argv and argv[0] == "serve":
        from .serve.__main__ import main as serve_main
        return serve_main(argv[1:])
    args = build_arg_parser().parse_args(argv)
    try:
        faults.validate()
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    racon = dict(fragment_correction=args.fragment_correction,
                 window_length=args.window_length,
                 quality_threshold=args.quality_threshold,
                 error_threshold=args.error_threshold,
                 trim=not args.no_trimming, match=args.match,
                 mismatch=args.mismatch, gap=args.gap,
                 num_threads=args.threads)
    run = dict(journal_path=args.resume_journal or args.journal,
               resume_journal=args.resume_journal is not None,
               trace_path=args.trace)
    card = dict(device=args.device, poa_kernel=args.poa_kernel,
                band=args.band, band_slack=args.band_slack,
                band_max_widenings=args.band_max_widenings,
                pipeline_phases=args.pipeline_phases,
                handoff_depth=args.handoff_depth,
                stream_input=args.stream_input,
                memory_budget_mb=args.memory_budget_mb,
                pipeline_depth=args.pipeline_depth,
                device_timeout_s=args.device_timeout)
    try:
        if args.host:
            polisher = create_polisher(args.sequences, args.overlaps,
                                       args.targets, backend="host", **run,
                                       **racon)
        else:
            polisher = create_polisher(args.sequences, args.overlaps,
                                       args.targets, **card, **run, **racon)
        polisher.initialize()
        for name, data in polisher.polish(not args.include_unpolished):
            sys.stdout.write(f">{name}\n{data}\n")
        if args.report:
            polisher.report.write(args.report)
    except (JournalError, NativeError) as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
