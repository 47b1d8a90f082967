"""`python -m racon_tpu_torch.serve` / `python -m racon_tpu_torch.cli
serve` — run the resident polishing daemon, or (with ``--stats-watch``)
poll a running daemon's live telemetry without starting one.

The JAX package's flags (racon_tpu/serve/__main__.py) less its fleet
ones, plus ``--device`` and ``--poa-kernel`` (the session's), and the
settings the JAX package reads from its environment knobs:
``--memory-budget-mb``, ``--tenant-quota`` and ``--slo-*``.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import time

from ..fleet import DEFAULT_TENANT_QUOTA
from ..ops.poa_driver import DEFAULT_POA_KERNEL, POA_KERNELS
from .session import (DEFAULT_MAX_JOBS, DEFAULT_MEMORY_BUDGET_MB,
                      DEFAULT_METRICS_PORT, DEFAULT_PORT, DEFAULT_QUEUE_DEPTH,
                      DEFAULT_WINDOW_BUDGET)


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch serve",
        description="Resident polishing daemon: kernels stay loaded on the "
        "card across jobs, a queue-based scheduler multiplexes concurrent "
        "submissions onto one card, every job journals for "
        "preemption-safe resume (protocol: newline-JSON over localhost "
        "TCP; see racon_tpu_torch/serve/server.py).")
    p.add_argument("--state-dir", default="./racon-serve",
                   help="daemon state directory: serve.json (bound port) "
                   "plus one subdirectory per job holding its spec, "
                   "journal, trace, report, and polished output "
                   "(default ./racon-serve)")
    p.add_argument("--port", type=int, default=DEFAULT_PORT,
                   help="TCP port to bind on 127.0.0.1 (default "
                   f"{DEFAULT_PORT}: ephemeral, written to serve.json)")
    p.add_argument("--backend", choices=("cuda", "host"), default="cuda",
                   help="session backend for the device lane: cuda "
                   "(TorchPolisher) or host (the native pipeline; its jobs "
                   "run on the host lane) (default cuda)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the cuda backend's kernels run (default "
                   "cuda; cpu runs their plain PyTorch versions)")
    p.add_argument("--poa-kernel", choices=POA_KERNELS,
                   default=DEFAULT_POA_KERNEL,
                   help=f"POA consensus kernel (default {DEFAULT_POA_KERNEL})")
    p.add_argument("--queue-depth", type=int, default=DEFAULT_QUEUE_DEPTH,
                   help="queued-job admission cap (default "
                   f"{DEFAULT_QUEUE_DEPTH})")
    p.add_argument("--max-jobs", type=int, default=DEFAULT_MAX_JOBS,
                   help="unfinished-job admission cap (default "
                   f"{DEFAULT_MAX_JOBS})")
    p.add_argument("--window-budget", type=int, default=DEFAULT_WINDOW_BUDGET,
                   help="per-job window budget; bigger jobs run on the "
                   f"host lane (default {DEFAULT_WINDOW_BUDGET}: unlimited)")
    p.add_argument("--tenant-quota", type=int, default=DEFAULT_TENANT_QUOTA,
                   help="unfinished jobs one submitter may hold (default "
                   f"{DEFAULT_TENANT_QUOTA}: unlimited)")
    p.add_argument("--memory-budget-mb", type=int,
                   default=DEFAULT_MEMORY_BUDGET_MB,
                   help="daemon RSS budget in MiB for admission: above 80%% "
                   "of it submissions shed to the host lane, above 95%% "
                   f"they are rejected (default {DEFAULT_MEMORY_BUDGET_MB}: "
                   "none)")
    p.add_argument("--slo-latency-s", default="",
                   help="job-latency SLO targets in seconds: a bare float "
                   "is the default target, key=value pairs per submitter "
                   "(default: none)")
    p.add_argument("--slo-availability", type=float, default=0.99,
                   help="SLO availability objective (default 0.99)")
    p.add_argument("--slo-shed-burn", type=float, default=0.0,
                   help="burn rate above which new submissions shed to the "
                   "host lane (default 0: never)")
    p.add_argument("--no-warm", action="store_true",
                   help="skip the startup build and load of the kernels (the "
                   "first job then pays them)")
    p.add_argument("--no-host-lane", action="store_true",
                   help="disable the host lane (jobs over the window "
                   "budget then run on the device lane)")
    p.add_argument("--metrics-port", type=int, default=DEFAULT_METRICS_PORT,
                   help="Prometheus exposition HTTP port on 127.0.0.1 "
                   f"(GET /metrics; default {DEFAULT_METRICS_PORT}: "
                   "disabled — the `metrics` wire op still works)")
    p.add_argument("--stats-watch", action="store_true",
                   help="do not start a daemon: connect to the one whose "
                   "serve.json lives in --state-dir and print its stats "
                   "(one JSON line per poll), then exit")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between --stats-watch polls (default 2)")
    p.add_argument("--count", type=int, default=1,
                   help="number of --stats-watch polls before exiting "
                   "(default 1; 0 = poll until the daemon goes away)")
    return p


def stats_watch(state_dir: str, interval: float, count: int) -> int:
    """Poll a running daemon's ``stats`` op and print one JSON line per
    sample.  Exits 0 after ``count`` polls, 1 if the daemon cannot be
    reached (including when it goes away mid-watch)."""
    from .client import ServeClient, ServeError
    polls = 0
    while True:
        try:
            with ServeClient.from_state_dir(state_dir, timeout=10.0) as c:
                resp = c.stats()
        except (OSError, ValueError, ServeError) as e:
            print(f"[racon_tpu_torch::serve] stats-watch: daemon "
                  f"unreachable: {e}", file=sys.stderr)
            return 1
        resp.pop("ok", None)
        print(json.dumps(resp, sort_keys=True), flush=True)
        polls += 1
        if count > 0 and polls >= count:
            return 0
        time.sleep(max(0.1, interval))


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.stats_watch:
        return stats_watch(args.state_dir, args.interval, args.count)

    from ..resilience import faults
    try:
        faults.validate()
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    if args.backend == "cuda" and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("[racon_tpu_torch::serve] no CUDA card is available; "
                  "pass --device cpu or --backend host", file=sys.stderr)
            return 1

    from .server import ServeDaemon

    daemon = ServeDaemon(
        args.state_dir, backend=args.backend, port=args.port,
        queue_depth=args.queue_depth, max_jobs=args.max_jobs,
        window_budget=args.window_budget, warm=not args.no_warm,
        host_lane=not args.no_host_lane, metrics_port=args.metrics_port,
        device=args.device, poa_kernel=args.poa_kernel,
        tenant_quota=args.tenant_quota,
        memory_budget_mb=args.memory_budget_mb,
        slo_settings=dict(latency_s=args.slo_latency_s,
                          availability=args.slo_availability,
                          shed_burn=args.slo_shed_burn))

    from .. import obs
    from ..obs import flight
    obs.set_role("serve")
    flight.set_dir(args.state_dir)

    def _stop(signum, frame):
        print(f"[racon_tpu_torch::serve] signal {signum}: shutting down "
              f"(queued jobs stay recoverable)", file=sys.stderr)
        flight.dump("sigterm", dir_path=args.state_dir, signal=int(signum))
        daemon.stop(wait=False)

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    daemon.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
