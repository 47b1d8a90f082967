"""Shared pieces of the distrib coordinator, its workers and the fleet
plane: the blocking request/response helper over the serve wire format
(serve/protocol.py, one JSON object per line), the settings' defaults,
and the command lines and environments of the processes they start.

A copy of the JAX package's module (racon_tpu/distrib/common.py) with
its ``RACON_TPU_DISTRIB_*`` knobs as arguments, defaulting to these
constants: the fleet's size (``DEFAULT_WORKERS``), the lease TTL
(``DEFAULT_LEASE_TTL`` s), the retry backoff's base
(``DEFAULT_RETRY_BASE`` s: attempt N waits base * 2^(N-1)), the failures
a chunk may have before it runs locally (``DEFAULT_MAX_RETRIES``), the
straggler threshold (``DEFAULT_SPECULATE`` x the median chunk wall; 0:
off) and the one worker that gets ``RACON_TORCH_FAULT``
(``DEFAULT_FAULT_WORKER``). The heartbeat interval is a third of the
TTL unless given, never below ``HEARTBEAT_FLOOR``.
"""

from __future__ import annotations

import os
import socket
import sys
from typing import List, Optional

from ..resilience import faults
from ..serve.protocol import read_message, write_message

DEFAULT_WORKERS = 2
DEFAULT_LEASE_TTL = 10.0
DEFAULT_RETRY_BASE = 0.25
DEFAULT_MAX_RETRIES = 3
DEFAULT_SPECULATE = 2.5
DEFAULT_FAULT_WORKER = 0

#: Floor on the heartbeat interval: a TTL small enough to push TTL/3
#: below it would turn the worker's renewal loop into a busy spin.
HEARTBEAT_FLOOR = 0.05


class WireError(ConnectionError):
    """The peer closed the connection or answered ``ok: false``."""


def rpc(f, msg: dict) -> dict:
    """One request/response exchange on a buffered socket file; raises
    WireError on EOF or an ``ok: false`` answer."""
    write_message(f, msg)
    resp = read_message(f)
    if resp is None:
        raise WireError(f"peer closed the connection (op "
                        f"{msg.get('op')!r})")
    if not resp.get("ok"):
        raise WireError(str(resp.get("error", "request failed")))
    return resp


def fleet_stats(port: int, host: str = "127.0.0.1",
                timeout: float = 5.0) -> dict:
    """One scrape of a running coordinator's live telemetry (the
    ``stats`` op). Raises WireError or OSError where it is not
    reachable."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        with sock.makefile("rwb") as f:
            return rpc(f, {"op": "stats"})


def heartbeat_interval(ttl: float = DEFAULT_LEASE_TTL,
                       heartbeat: Optional[float] = None) -> float:
    """The workers' renewal interval: `heartbeat` where given, else a
    third of the lease TTL (two missed beats still renew in time);
    never below HEARTBEAT_FLOOR."""
    return max(HEARTBEAT_FLOOR,
               float(heartbeat) if heartbeat else ttl / 3.0)


def worker_env(index: int, fault_worker: int = DEFAULT_FAULT_WORKER) -> dict:
    """A worker's environment: this process's, with this racon_tpu_torch
    first on the import path; ``RACON_TORCH_FAULT`` only for worker
    `fault_worker`, so that a spec kills a known worker and not the
    fleet."""
    from ..serve.scheduler import child_env

    env = child_env()
    if index != fault_worker:
        env.pop(faults.ENV, None)
    return env


def worker_args(device: str, backend: str, poa_kernel: str,
                memory_share: float) -> List[str]:
    """A worker's settings as its command-line arguments
    (distrib/worker.py)."""
    return ["--device", str(device), "--backend", str(backend),
            "--poa-kernel", str(poa_kernel),
            "--memory-share", repr(float(memory_share))]


def local_command(args: dict, include_unpolished: bool, sequences: str,
                  overlaps: str, target: str, journal: str) -> List[str]:
    """The fleet's local rung for one chunk: ``python -m
    racon_tpu_torch.cli --host`` (the host backend's bytes) resuming
    `journal`."""
    cmd = [sys.executable, "-m", "racon_tpu_torch.cli", "--host",
           "-w", str(args["window_length"]),
           "-q", str(args["quality_threshold"]),
           "-e", str(args["error_threshold"]),
           "-m", str(args["match"]), "-x", str(args["mismatch"]),
           "-g", str(args["gap"]), "-t", str(args["num_threads"]),
           "--resume-journal", journal]
    if not args["trim"]:
        cmd.append("--no-trimming")
    if args["fragment_correction"]:
        cmd.append("-f")
    if include_unpolished:
        cmd.append("-u")
    return cmd + [sequences, overlaps, target]


def process_age_s() -> Optional[float]:
    """Seconds since this process started (from /proc), or None where
    that cannot be read: a worker's and the coordinator's start-up cost
    (the interpreter and the imports) in the run's telemetry."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return round(up - ticks / os.sysconf("SC_CLK_TCK"), 3)


def on_card(backend: str, device: str) -> bool:
    """Whether workers with this backend and device launch kernels on the
    card: then the controller builds the CUDA sources once (nvcc alone,
    under cuda_lib's file lock, no CUDA context) before it spawns any
    worker, and each worker loads them before its first chunk."""
    return backend == "cuda" and str(device).startswith("cuda")
