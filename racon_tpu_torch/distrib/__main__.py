"""``python -m racon_tpu_torch.distrib`` / ``python -m racon_tpu_torch.cli
distrib``: polish with a fleet of worker processes.

The JAX package's flags (racon_tpu/distrib/__main__.py) with ``--tpu``
replaced: the workers run on the card by default, ``--device cpu`` runs
them on the kernels' plain versions, ``--host`` on the host backend, and
``--poa-kernel`` passes through. The JAX package's
``RACON_TPU_DISTRIB_*`` knobs are flags (``--lease-ttl``,
``--heartbeat``, ``--retry-base``, ``--max-retries``, ``--speculate``,
``--fault-worker``). Without a CUDA card the run fails before any worker
is spawned unless given ``--device cpu`` or ``--host``, as the polish
CLI does. The polished FASTA goes to stdout (or ``-o``), the
single-process polish's bytes; a one-line summary of the fleet's
accounting goes to stderr. On the card, a chunk that exhausts its
retries or a fleet that collapses fails the run (exit 1, with the
chunk's last error): its host bytes are never served in the card's
place.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile

from ..ops.poa_driver import DEFAULT_POA_KERNEL, POA_KERNELS
from .common import (DEFAULT_FAULT_WORKER, DEFAULT_LEASE_TTL,
                     DEFAULT_MAX_RETRIES, DEFAULT_RETRY_BASE,
                     DEFAULT_SPECULATE, DEFAULT_WORKERS)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch distrib",
        description="polish with a fault-tolerant fleet of worker "
        "processes (leases, heartbeats, journal resume, speculative "
        "re-dispatch); the output is the single-process polish's bytes")
    p.add_argument("sequences")
    p.add_argument("overlaps")
    p.add_argument("targets")
    p.add_argument("-u", "--include-unpolished", action="store_true",
                   help="output unpolished target sequences")
    p.add_argument("-f", "--fragment-correction", action="store_true",
                   help="perform fragment correction instead of contig "
                   "polishing")
    p.add_argument("-w", "--window-length", type=int, default=500)
    p.add_argument("-q", "--quality-threshold", type=float, default=10.0)
    p.add_argument("-e", "--error-threshold", type=float, default=0.3)
    p.add_argument("--no-trimming", action="store_true")
    p.add_argument("-m", "--match", type=int, default=3)
    p.add_argument("-x", "--mismatch", type=int, default=-5)
    p.add_argument("-g", "--gap", type=int, default=-4)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--host", action="store_true",
                   help="the workers polish on the host backend (the "
                   "native pipeline); without it on the card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the workers' kernels run (default cuda; "
                   "cpu runs their plain PyTorch versions)")
    p.add_argument("--poa-kernel", choices=POA_KERNELS,
                   default=DEFAULT_POA_KERNEL,
                   help=f"POA consensus kernel (default {DEFAULT_POA_KERNEL})")
    p.add_argument("--workers", type=int, default=DEFAULT_WORKERS,
                   help=f"worker processes (default {DEFAULT_WORKERS}); "
                   "each may hold 1 / this of the card's memory")
    p.add_argument("--chunks", type=int, default=None,
                   help="target chunk count hint (default: 2x workers)")
    p.add_argument("--lease-ttl", type=float, default=DEFAULT_LEASE_TTL,
                   help="seconds a chunk's lease lives without a heartbeat "
                   f"(default {DEFAULT_LEASE_TTL:g})")
    p.add_argument("--heartbeat", type=float, default=None,
                   help="workers' heartbeat interval in seconds (default: "
                   "the lease TTL / 3)")
    p.add_argument("--retry-base", type=float, default=DEFAULT_RETRY_BASE,
                   help="retry backoff base in seconds: attempt N waits "
                   f"base x 2^(N-1) (default {DEFAULT_RETRY_BASE:g})")
    p.add_argument("--max-retries", type=int, default=DEFAULT_MAX_RETRIES,
                   help="failures a chunk may have before the coordinator "
                   "polishes it locally (--host, --device cpu) or, on the "
                   f"card, fails the run (default {DEFAULT_MAX_RETRIES})")
    p.add_argument("--speculate", type=float, default=DEFAULT_SPECULATE,
                   help="straggler threshold: a chunk running longer than "
                   "this x the median chunk wall gets a duplicate on an "
                   f"idle worker (default {DEFAULT_SPECULATE:g}; 0: off)")
    p.add_argument("--fault-worker", type=int, default=DEFAULT_FAULT_WORKER,
                   help="the one worker that gets RACON_TORCH_FAULT "
                   f"(default {DEFAULT_FAULT_WORKER})")
    p.add_argument("-o", "--output", metavar="PATH", default=None,
                   help="write the polished FASTA here instead of stdout")
    p.add_argument("--state-dir", metavar="DIR", default=None,
                   help="the coordinator's working directory: chunks, "
                   "journals, worker logs (default: a fresh temporary "
                   "directory)")
    p.add_argument("--timeout", type=float, default=0.0,
                   help="abort the run after this many seconds "
                   "(0: no deadline)")
    p.add_argument("--report", metavar="PATH", default=None,
                   help="write the coordinator's JSON run report (the "
                   "distrib phase: fleet and local served counts, "
                   "re-dispatches, degradations) to PATH")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="write a Chrome-trace JSON of the coordinator, "
                   "with the workers' chunks absorbed, to PATH; each "
                   "chunk's own trace lands in its chunk directory")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from ..resilience import faults
    try:
        faults.validate()
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    backend = "host" if args.host else "cuda"
    if backend == "cuda" and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("[racon_tpu_torch::distrib] no CUDA card is available; "
                  "pass --device cpu or --host", file=sys.stderr)
            return 1

    from ..obs import flight
    from .coordinator import Coordinator

    workdir = args.state_dir or tempfile.mkdtemp(prefix="racon-distrib-")
    out_path = args.output or os.path.join(workdir, "polished.fasta")

    def _on_sigterm(signum, frame):
        # post-mortem before the default death: the coordinator's ring
        # lands beside the worker dumps it would have swept
        flight.dump("sigterm", dir_path=workdir, signal=int(signum))
        raise SystemExit(143)

    signal.signal(signal.SIGTERM, _on_sigterm)
    coord = Coordinator(
        args.sequences, args.overlaps, args.targets, workdir,
        args={
            "window_length": args.window_length,
            "quality_threshold": args.quality_threshold,
            "error_threshold": args.error_threshold,
            "trim": not args.no_trimming,
            "fragment_correction": args.fragment_correction,
            "match": args.match, "mismatch": args.mismatch,
            "gap": args.gap, "num_threads": args.threads,
        },
        include_unpolished=args.include_unpolished, backend=backend,
        device=args.device, poa_kernel=args.poa_kernel,
        workers=args.workers, chunks_hint=args.chunks,
        lease_ttl=args.lease_ttl, heartbeat=args.heartbeat,
        retry_base=args.retry_base, max_retries=args.max_retries,
        speculate=args.speculate, fault_worker=args.fault_worker,
        trace_path=args.trace, report_path=args.report)
    try:
        result = coord.run(out_path, timeout=args.timeout or None)
    except (RuntimeError, TimeoutError, OSError) as e:
        print(f"[racon_tpu_torch::distrib] {e}", file=sys.stderr)
        return 1
    print(f"[racon_tpu_torch::distrib] {json.dumps(result['summary'])}",
          file=sys.stderr)
    if args.output is None:
        with open(out_path) as f:
            sys.stdout.write(f.read())
    return 0


if __name__ == "__main__":
    sys.exit(main())
