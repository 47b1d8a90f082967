"""One chunk-worker of the ``racon_tpu_torch distrib`` fleet.

A copy of the JAX package's worker (racon_tpu/distrib/worker.py). A
worker is a client of the coordinator (coordinator.py) or the fleet
plane (fleet/plane.py): it opens two connections — commands and
heartbeats — says ``hello``, then loops ``fetch`` → polish → ``result``
until told to ``drain``. Each chunk runs through the port's
``create_polisher`` (backend "cuda" on the worker's ``device``, or
"host") with the assigned journal resumed, so a chunk re-dispatched
after a crash replays its predecessor's journaled prefix (the
``journal_replayed`` count rides back in the result stats as the proof).
While a chunk is in flight a daemon thread renews its lease on the
heartbeat connection at the interval the ``hello`` answer advertised.

Its settings are arguments (``distrib.common.worker_args``): the device
its kernels run on ("cuda", or "cpu" for their plain versions), its
default backend, the POA kernel, and the share of the card's memory it
may hold (``--memory-share``, 1 / its pool's ceiling:
``poa_driver.sizing_bytes``). A worker on the card loads every CUDA
library before its first fetch (the controller has built them), so each
chunk's ``kernel_builds`` is 0.

Result stats: the JAX ones — wall, records, polished bases,
``journal_replayed``, ``kernel_wall_s``, RSS and the ledger's
``stage_s`` — and the chunk's kernel launches by name
(``cuda_lib.LAUNCHES``), ``kernel_builds``, the memory share and, on
the card, the process's peak reserved device memory.

Fault points (resilience/faults.py): ``mem.oom`` before each chunk's
polish, ``worker.heartbeat`` before each renewal (a raise silently stops
renewing: the lease expires), ``worker.result`` after the chunk is
journaled and written, before its delivery (``kill=1`` there is the
canonical crash: the re-dispatched chunk resumes from the journal).

**A sticky CUDA error.** After an illegal address a process's CUDA
context launches nothing more. A worker whose chunk raised
``torch.AcceleratorError``, or a ``cuda_lib.DeviceError`` with a sticky
code from one of the port's launch functions (``is_sticky``), reports
the chunk's error and then exits with
``STICKY_EXIT``: the controller counts it dead, as it counts an EOF, and
re-dispatches the chunk, which resumes from its journal; the fleet
plane's autoscaler replaces the worker up to its floor. (A JAX worker
lives on to fetch the next chunk.)
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import sys
import threading
import time
from typing import Optional

from .. import obs
from ..obs import context, flight, ledger
from ..ops.poa_driver import DEFAULT_POA_KERNEL, POA_KERNELS
from .common import WireError, on_card, process_age_s, rpc

#: A worker's exit code after a sticky CUDA error.
STICKY_EXIT = 70


class DeviceLost(RuntimeError):
    """A chunk raised a sticky CUDA error: this process's context can
    launch nothing more."""


def is_sticky(exc: BaseException) -> bool:
    """Whether `exc`, or an exception it was raised from, is a
    ``torch.AcceleratorError`` (the error a poisoned context raises where
    torch sees it first) or a ``cuda_lib.DeviceError`` with a sticky code
    (where one of the port's launch functions sees it first)."""
    import torch

    from ..ops.cuda_lib import DeviceError

    cls = getattr(torch, "AcceleratorError", None)
    seen = set()
    while exc is not None and id(exc) not in seen:
        if cls is not None and isinstance(exc, cls):
            return True
        if isinstance(exc, DeviceError) and exc.sticky:
            return True
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return False


def load_kernels(device: str, backend: str) -> None:
    """A worker on the card: build what is stale (nothing, after the
    controller's build) and load every CUDA library, before the first
    chunk, so that no chunk counts a build or a load."""
    if not on_card(backend, device):
        return
    import torch

    from ..ops import cuda_lib

    torch.cuda.set_device(torch.device(device).index or 0)
    cuda_lib.build_all()
    for name in cuda_lib.SOURCES:
        cuda_lib.load(name)


def _device_stats(device: str, share: float) -> dict:
    """The process's peak reserved device memory and its share's budget
    now ({} off the card)."""
    if not device.startswith("cuda"):
        return {}
    import torch

    from ..ops import poa_driver

    dev = torch.device(device)
    _, total = torch.cuda.mem_get_info(dev)
    mib = float(1 << 20)
    return {"device_peak_mb": round(torch.cuda.max_memory_reserved(dev)
                                    / mib, 1),
            "device_budget_mb": round(poa_driver.sizing_bytes(dev, share)
                                      / mib, 1),
            "device_total_mb": round(total / mib, 1)}


def _polish_chunk(a: dict, device: str = "cuda", backend: str = "cuda",
                  poa_kernel: str = DEFAULT_POA_KERNEL,
                  memory_share: float = 1.0) -> dict:
    """Run one assigned chunk; returns the result stats."""
    from ..ops import cuda_lib
    from ..polisher import create_polisher
    from ..resilience import budget, faults

    # the memory seam: kill=1 is an OOM-style SIGKILL of this worker
    # mid-chunk; a raise is a modeled allocation failure (chunk error)
    faults.check("mem.oom")
    t0 = time.monotonic()
    chunk_dir = os.path.dirname(a["output"]) or "."
    # trace-context propagation: the dispatch's {trace_id, parent} pair,
    # activated before create_polisher so that the fresh tracer stamps
    # it; a flight dump from this chunk lands in the chunk directory
    ctx = a.get("trace")
    context.activate(ctx)
    flight.set_dir(chunk_dir)
    trace_path = (os.path.join(chunk_dir, f"trace.a{a['attempt']}.json")
                  if ctx else None)
    backend = a.get("backend") or backend
    kw = dict(a.get("args") or {})
    if backend == "cuda":
        kw.update(device=device, poa_kernel=poa_kernel,
                  device_memory_share=memory_share)
    # the chunk's launches alone: counts from 0, no caller's event list
    cuda_lib.reset_launches()
    cuda_lib.LAUNCH_EVENTS = None
    polisher = create_polisher(
        a["sequences"], a["overlaps"], a["target"], backend=backend,
        journal_path=a["journal"], resume_journal=True,
        trace_path=trace_path, **kw)
    if not obs.enabled():
        # metrics in memory, so that the chunk counts its kernel builds
        obs.configure(metrics=True)
    with obs.span("distrib.chunk", chunk=a["index"], attempt=a["attempt"],
                  trace_id=(ctx or {}).get("trace_id"),
                  parent=(ctx or {}).get("parent")):
        polisher.initialize()
        out = polisher.polish(not a.get("include_unpolished"))
    part = a["output"] + ".part"
    with open(part, "w") as f:
        for name, data in out:
            f.write(f">{name}\n{data}\n")
    os.replace(part, a["output"])
    replayed = sum(rep.served.get("journal", 0)
                   for rep in polisher.report.phases.values())
    # kernel wall: the served wall of the two DP phases
    kernel_wall = sum(sum(rep.wall_s.values())
                      for name, rep in polisher.report.phases.items()
                      if name in ("alignment", "consensus"))
    # the ledger's fragment: per-stage seconds off this chunk's report,
    # plus the build and replay overlays (obs/ledger.py)
    stage_s = ledger.stage_seconds(polisher.report.summary())
    stage_s.update(ledger.overlay_seconds(obs.snapshot()))
    rss = round(budget.peak_rss_mb(), 1)
    obs.event("mem.rss", rss_mb=rss, chunk=a["index"])
    return {
        "wall_s": round(time.monotonic() - t0, 4),
        "records": len(out),
        "polished_bp": sum(len(data) for _, data in out),
        "journal_replayed": replayed,
        "kernel_wall_s": round(kernel_wall, 4),
        "rss_mb": rss,
        "stage_s": stage_s,
        "launches": {k: v for k, v in cuda_lib.LAUNCHES.items() if v},
        "kernel_builds": obs.counter_total("kernel.builds."),
        "memory_share": memory_share,
        **(_device_stats(device, memory_share) if backend == "cuda"
           else {}),
    }


def _heartbeat_loop(hb_f, worker: int, index: int, attempt: int,
                    interval: float, stop: threading.Event) -> None:
    """Renew the chunk's lease until told to stop. Any failure —
    injected (worker.heartbeat) or real — silently ends renewal: the
    lease TTL turns heartbeat loss into a re-dispatch."""
    from ..resilience import faults

    while not stop.wait(interval):
        try:
            faults.check("worker.heartbeat")
            resp = rpc(hb_f, {"op": "heartbeat", "worker": worker,
                              "chunk": index, "attempt": attempt})
        except Exception:  # noqa: BLE001 — heartbeat loss is a modeled
            # failure mode, not a crash: the lease expires
            return
        if resp.get("cancel"):
            return   # superseded; no point renewing a dead lease


def run_worker(port: int, worker: int, device: str = "cuda",
               backend: str = "cuda", poa_kernel: str = DEFAULT_POA_KERNEL,
               memory_share: float = 1.0, poll_s: float = 0.2,
               start: Optional[dict] = None) -> int:
    """Serve chunks until drained; returns the chunks done. Raises
    DeviceLost after reporting a chunk that raised a sticky CUDA error.
    `start` (the process's start-up seconds) rides the ``hello``."""
    from ..resilience import faults
    main_sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    hb_sock = socket.create_connection(("127.0.0.1", port), timeout=600)
    main_f = main_sock.makefile("rwb")
    hb_f = hb_sock.makefile("rwb")
    chunks_done = 0
    try:
        hello = rpc(main_f, {"op": "hello", "worker": worker,
                             "start": start or {}})
        interval = float(hello.get("heartbeat") or 1.0)
        while True:
            resp = rpc(main_f, {"op": "fetch", "worker": worker})
            if resp.get("drain"):
                break
            if resp.get("wait"):
                time.sleep(float(resp.get("poll_s") or poll_s))
                continue
            a = resp["chunk"]
            stop = threading.Event()
            hb = threading.Thread(
                target=_heartbeat_loop,
                args=(hb_f, worker, a["index"], a["attempt"], interval,
                      stop),
                name="distrib-heartbeat", daemon=True)
            hb.start()
            try:
                stats = _polish_chunk(a, device=device, backend=backend,
                                      poa_kernel=poa_kernel,
                                      memory_share=memory_share)
            except Exception as e:  # noqa: BLE001 — a failed chunk is
                # reported; the worker lives on unless its context is lost
                stop.set()
                hb.join()
                err = f"{type(e).__name__}: {e}"
                flight.dump("chunk_error", chunk=a["index"],
                            attempt=a["attempt"], error=err)
                obs.release(write=False)
                rpc(main_f, {"op": "error", "worker": worker,
                             "chunk": a["index"], "attempt": a["attempt"],
                             "error": err})
                if is_sticky(e):
                    raise DeviceLost(err) from e
                continue
            stop.set()
            hb.join()
            # ship this chunk's span buffer and metrics with the result
            # (None when the dispatch carried no trace context), then
            # scope the per-chunk tracer out
            ship = obs.shipment() if a.get("trace") else None
            obs.release(write=True)
            # the chaos seam: journaled and written, not yet delivered
            faults.check("worker.result")
            msg = {"op": "result", "worker": worker,
                   "chunk": a["index"], "attempt": a["attempt"],
                   "output": a["output"], "stats": stats}
            if ship is not None:
                msg["obs"] = ship
            rpc(main_f, msg)
            chunks_done += 1
    finally:
        for f, s in ((main_f, main_sock), (hb_f, hb_sock)):
            try:
                f.close()
                s.close()
            except OSError:
                pass
    return chunks_done


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch distrib worker",
        description="one chunk-worker process of a distrib fleet "
        "(spawned by the coordinator or the fleet plane; not normally run "
        "by hand)")
    p.add_argument("--port", type=int, required=True,
                   help="the coordinator's TCP port on 127.0.0.1")
    p.add_argument("--worker", type=int, required=True,
                   help="this worker's index in the fleet")
    p.add_argument("--device", default="cuda",
                   help="where the kernels run (default cuda; cpu runs "
                   "their plain versions)")
    p.add_argument("--backend", choices=("cuda", "host"), default="cuda",
                   help="the backend of a chunk that names none")
    p.add_argument("--poa-kernel", choices=POA_KERNELS,
                   default=DEFAULT_POA_KERNEL)
    p.add_argument("--memory-share", type=float, default=1.0,
                   help="the share of the card's memory this worker may "
                   "hold (default 1)")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    obs.set_role(f"worker{args.worker}")
    if threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            # post-mortem before dying: the ring of recent spans and
            # events lands in the current chunk's directory
            flight.dump("sigterm", signal=int(signum))
            raise SystemExit(143)

        signal.signal(signal.SIGTERM, _on_sigterm)
    tag = f"[racon_tpu_torch::distrib] worker {args.worker}"
    try:
        # the start-up cost: the interpreter and the imports, then the
        # kernels' load (on the card, with the CUDA context)
        start = {"imports_s": process_age_s()}
        t0 = time.monotonic()
        load_kernels(args.device, args.backend)
        start["load_s"] = round(time.monotonic() - t0, 3)
        done = run_worker(args.port, args.worker, device=args.device,
                          backend=args.backend, poa_kernel=args.poa_kernel,
                          memory_share=args.memory_share, start=start)
    except DeviceLost as e:
        print(f"{tag}: the card's context is lost ({e}); exiting so that "
              f"the chunk is re-dispatched", file=sys.stderr)
        return STICKY_EXIT
    except (WireError, OSError) as e:
        # the coordinator went away: the run is over (or it crashed,
        # which its own caller reports)
        print(f"{tag}: {e}", file=sys.stderr)
        return 1
    print(f"{tag} drained after {done} chunk(s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
