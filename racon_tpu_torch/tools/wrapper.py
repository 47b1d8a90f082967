"""Outer workflow wrapper: subsample the reads to a target coverage and/or
split the targets into byte-bounded chunks, then polish each chunk, for
data sets too large for one pipeline pass.

    python -m racon_tpu_torch.tools.wrapper [--split BYTES]
        [--subsample REF_LEN COV] [--jobs N] [--resume DIR] [--host |
        --device cpu] [racon flags] <sequences> <overlaps> <targets>

The reference racon's wrapper (scripts/racon_wrapper.py upstream): the
same flags (--split, --subsample REF_LEN COV), the same work-directory
lifecycle, the chunks' FASTA written to stdout in chunk order. A port of
the JAX package's racon_tpu/tools/wrapper.py on the port's
``create_polisher``: each chunk is polished on the card by default,
``--host`` polishes on the host alone (the native pipeline) and
``--device cpu`` runs the kernels' plain versions (in place of the JAX
wrapper's ``--tpu``, whose default is the host). Beyond the reference:
``--resume DIR`` keeps each chunk's output as a checkpoint and skips the
chunks already polished, and ``--jobs N`` polishes the chunks in N worker
processes (``python -m racon_tpu_torch.cli`` with the same flags), the
multi-host topology: chunks are independent, so hosts need no
collectives, only the ordered gather of their outputs.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

from ..polisher import create_polisher
from . import sampler

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def eprint(*args):
    print(*args, file=sys.stderr, flush=True)


def _check_resume_stamp(args, work_dir: str) -> None:
    """Refuse to reuse checkpoints made from other inputs or flags."""
    def mtime(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return None

    stamp = {
        "sequences": os.path.abspath(args.sequences),
        "sequences_mtime": mtime(args.sequences),
        "overlaps": os.path.abspath(args.overlaps),
        "overlaps_mtime": mtime(args.overlaps),
        "targets": os.path.abspath(args.target_sequences),
        "targets_mtime": mtime(args.target_sequences),
        "split": args.split,
        "subsample": args.subsample,
        "flags": [args.include_unpolished, args.fragment_correction,
                  str(args.window_length), str(args.quality_threshold),
                  str(args.error_threshold), str(args.match),
                  str(args.mismatch), str(args.gap), args.host,
                  args.device],
    }
    stamp_path = os.path.join(work_dir, "wrapper_stamp.json")
    if os.path.isfile(stamp_path):
        with open(stamp_path) as f:
            old = json.load(f)
        if old != stamp:
            eprint("[racon_tpu_torch::wrapper] error: resume directory was "
                   "created with different inputs or parameters; clear it "
                   "or choose another --resume directory")
            sys.exit(1)
    else:
        tmp = stamp_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(stamp, f)
        os.replace(tmp, stamp_path)


def _polisher(args, sequences: str, part: str):
    """A chunk's polisher: on the card (or its plain versions with
    --device cpu), or the native pipeline with --host."""
    racon = dict(fragment_correction=args.fragment_correction,
                 window_length=int(args.window_length),
                 quality_threshold=float(args.quality_threshold),
                 error_threshold=float(args.error_threshold),
                 match=int(args.match), mismatch=int(args.mismatch),
                 gap=int(args.gap), num_threads=int(args.threads))
    if args.host:
        return create_polisher(sequences, os.path.abspath(args.overlaps),
                               part, backend="host", **racon)
    return create_polisher(sequences, os.path.abspath(args.overlaps), part,
                           device=args.device, **racon)


def run(args) -> int:
    # --resume keeps a persistent work directory with each chunk's output:
    # a rerun skips the chunks already polished
    resume = getattr(args, "resume", None)
    if resume:
        work_dir = os.path.abspath(resume)
        os.makedirs(work_dir, exist_ok=True)
    else:
        work_dir = os.path.join(
            os.getcwd(), f"racon_tpu_torch_work_directory_{time.time()}")
        os.makedirs(work_dir, exist_ok=True)
    try:
        sequences = os.path.abspath(args.sequences)
        if resume:
            _check_resume_stamp(args, work_dir)
        if args.subsample is not None:
            ref_len, cov = int(args.subsample[0]), int(args.subsample[1])
            sub_path = sampler.subsample_path(sequences, cov, work_dir)
            if resume and os.path.isfile(sub_path):
                eprint("[racon_tpu_torch::wrapper] reusing subsampled "
                       "sequences")
                sequences = sub_path
            else:
                eprint("[racon_tpu_torch::wrapper] subsampling sequences")
                sequences = sampler.subsample(sequences, ref_len, cov,
                                              work_dir)

        targets = [os.path.abspath(args.target_sequences)]
        if args.split is not None:
            eprint("[racon_tpu_torch::wrapper] splitting target sequences")
            targets = sampler.split(os.path.abspath(args.target_sequences),
                                    int(args.split), work_dir)
            eprint(f"[racon_tpu_torch::wrapper] total number of splits: "
                   f"{len(targets)}")

        jobs = int(getattr(args, "jobs", 1) or 1)
        if jobs > 1 and len(targets) > 1:
            return _run_distributed(args, sequences, targets, work_dir,
                                    resume, jobs)

        for idx, part in enumerate(targets):
            out_path = os.path.join(work_dir, f"polished_{idx}.fasta")
            if resume and os.path.isfile(out_path):
                eprint(f"[racon_tpu_torch::wrapper] chunk {idx}: reusing "
                       "checkpointed result")
                with open(out_path) as f:
                    shutil.copyfileobj(f, sys.stdout)
                continue

            eprint("[racon_tpu_torch::wrapper] polishing chunk")
            polisher = _polisher(args, sequences, part)
            polisher.initialize()
            results = polisher.polish(not args.include_unpolished)
            if resume:
                # into the checkpoint, published atomically, then echoed
                tmp = out_path + ".tmp"
                with open(tmp, "w") as f:
                    for name, data in results:
                        f.write(f">{name}\n{data}\n")
                os.replace(tmp, out_path)
                with open(out_path) as f:
                    shutil.copyfileobj(f, sys.stdout)
            else:
                for name, data in results:
                    sys.stdout.write(f">{name}\n{data}\n")
        return 0
    finally:
        if not resume:
            try:
                shutil.rmtree(work_dir)
            except OSError:
                eprint("[racon_tpu_torch::wrapper] warning: unable to clean "
                       "work directory!")


def _worker_cmd(args, sequences: str, part: str):
    """The CLI command line that polishes one chunk with the wrapper's
    flags."""
    cmd = [sys.executable, "-m", "racon_tpu_torch.cli",
           "-w", str(args.window_length), "-q", str(args.quality_threshold),
           "-e", str(args.error_threshold), "-m", str(args.match),
           "-x", str(args.mismatch), "-g", str(args.gap),
           "-t", str(args.threads)]
    if args.include_unpolished:
        cmd.append("-u")
    if args.fragment_correction:
        cmd.append("-f")
    if args.host:
        cmd.append("--host")
    else:
        cmd += ["--device", args.device]
    return cmd + [sequences, os.path.abspath(args.overlaps), part]


def _run_distributed(args, sequences, targets, work_dir, resume,
                     jobs) -> int:
    """Polish the chunks in `jobs` worker processes at a time (one a
    simulated host) and gather their outputs in chunk order. Each worker
    is an independent pipeline: the scale-out needs no collectives. A
    worker that fails ends the run with exit 1, the others killed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)

    pending = []
    for idx, part in enumerate(targets):
        out_path = os.path.join(work_dir, f"polished_{idx}.fasta")
        if resume and os.path.isfile(out_path):
            continue
        pending.append((idx, part, out_path))

    running = []

    def launch(idx, part, out_path):
        tmp = out_path + ".tmp"
        eprint(f"[racon_tpu_torch::wrapper] worker for chunk {idx}")
        return (idx, out_path, tmp, open(tmp, "wb"),
                subprocess.Popen(_worker_cmd(args, sequences, part),
                                 stdout=subprocess.PIPE, env=env))

    def finish(entry) -> bool:
        idx, out_path, tmp, tmp_f, proc = entry
        shutil.copyfileobj(proc.stdout, tmp_f)
        proc.wait()
        proc.stdout.close()
        tmp_f.close()
        if proc.returncode != 0:
            eprint(f"[racon_tpu_torch::wrapper] error: chunk {idx} worker "
                   f"failed (exit {proc.returncode})")
            return False
        os.replace(tmp, out_path)
        return True

    i = 0
    try:
        while i < len(pending) or running:
            while i < len(pending) and len(running) < jobs:
                running.append(launch(*pending[i]))
                i += 1
            if not finish(running.pop(0)):
                return 1
    finally:
        for _, _, _, tmp_f, proc in running:
            proc.kill()
            proc.wait()
            proc.stdout.close()
            tmp_f.close()

    # the ordered gather
    for idx in range(len(targets)):
        out_path = os.path.join(work_dir, f"polished_{idx}.fasta")
        with open(out_path) as f:
            shutil.copyfileobj(f, sys.stdout)
    sys.stdout.flush()
    return 0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch.tools.wrapper",
        description="racon_tpu_torch with the outer subsample and split "
        "workflow")
    p.add_argument("sequences")
    p.add_argument("overlaps")
    p.add_argument("target_sequences")
    p.add_argument("--split", help="split target sequences into chunks of "
                   "desired size in bytes")
    p.add_argument("--subsample", nargs=2, metavar=("REF_LEN", "COV"),
                   help="subsample sequences to coverage COV given reference "
                   "length REF_LEN")
    p.add_argument("-u", "--include-unpolished", action="store_true")
    p.add_argument("-f", "--fragment-correction", action="store_true")
    p.add_argument("-w", "--window-length", default=500)
    p.add_argument("-q", "--quality-threshold", default=10.0)
    p.add_argument("-e", "--error-threshold", default=0.3)
    # the reference wrapper's score defaults (m=5 x=-4 g=-8), not the
    # polisher's 3/-5/-4
    p.add_argument("-m", "--match", default=5)
    p.add_argument("-x", "--mismatch", default=-4)
    p.add_argument("-g", "--gap", default=-8)
    p.add_argument("-t", "--threads", default=1)
    where = p.add_mutually_exclusive_group()
    where.add_argument("--host", action="store_true",
                       help="polish on the host alone (the native "
                       "pipeline); by default the kernels run on the card")
    where.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                       help="where the kernels run (default cuda; cpu runs "
                       "their plain PyTorch versions)")
    p.add_argument("--resume", metavar="DIR",
                   help="persistent work directory with each chunk's "
                   "output as a checkpoint; a rerun skips finished chunks")
    p.add_argument("--jobs", type=int, default=1,
                   help="polish the chunks in this many worker processes "
                   "at a time (the multi-host fan-out)")
    return p


def main(argv=None) -> int:
    return run(build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
