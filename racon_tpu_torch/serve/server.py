"""The serve daemon: localhost TCP, newline-JSON protocol.

A copy of the JAX package's daemon (racon_tpu/serve/server.py) without
the fleet plane. Its settings are arguments, each defaulting to its JAX
knob's default (session.py). One JSON object per line in each
direction.  Requests carry an ``op``:

* ``ping``     -> ``{"ok": true, "pid": ..., "backend": ...}``
* ``submit``   -> admit a job (fields of serve.session.JobSpec);
  response carries the assigned ``job_id``.
* ``status``   -> job lifecycle snapshot (state, lane, demotions).
* ``result``   -> terminal outcome; ``"wait": true`` blocks (this
  connection's thread only) until the job finishes or ``timeout``.
* ``cancel``   -> cancel queued immediately / running best-effort.
* ``stats``    -> scheduler + session counters, the SLO engine's state
  and the finished jobs' latency ledger summed by stage.
* ``metrics``  -> Prometheus text exposition + SLO engine snapshot
  (the same text ``--metrics-port`` serves over HTTP).
* ``shutdown`` -> acknowledge, then stop the daemon gracefully.

Errors never kill the daemon: a malformed line gets
``{"ok": false, "error": ...}`` on that connection; a client that
disconnects mid-job only loses its socket — the job keeps running and
its result stays queryable by id from any new connection.  The bound
port is written to ``<state_dir>/serve.json`` so clients (and the
load-test harness) can find a daemon started with port 0.

Restart story: on start the daemon re-queues every job directory with a
spec but no result (scheduler.recover) — combined with the per-job
journals, a daemon preempted mid-job resumes the job instead of
recomputing it.

Threads: the connection threads never touch the card — ``stats`` and
``metrics`` read counters under locks; only the device lane's worker
thread launches kernels (``start``'s warm-up, before any job, only
builds and loads the libraries).
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
from typing import Optional

from .. import obs
from ..fleet import DEFAULT_TENANT_QUOTA
from ..obs import export as obs_export
from ..obs import slo
from ..ops.poa_driver import DEFAULT_POA_KERNEL
from .protocol import read_message, write_message
from .scheduler import AdmissionError, Scheduler
from .session import (DEFAULT_MAX_JOBS, DEFAULT_MEMORY_BUDGET_MB,
                      DEFAULT_METRICS_PORT, DEFAULT_PORT, DEFAULT_QUEUE_DEPTH,
                      DEFAULT_WARMUP, DEFAULT_WINDOW_BUDGET, JobSpec,
                      PolishSession)


class ServeDaemon:
    """`backend` ("cuda" or "host"), `device` and `poa_kernel` are the
    session's (session.py); the admission settings the scheduler's;
    `slo` the SLO engine's settings (obs/slo.py; none: its defaults)."""

    def __init__(self, state_dir: str, backend: str = "cuda",
                 port: int = DEFAULT_PORT,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 max_jobs: int = DEFAULT_MAX_JOBS,
                 window_budget: int = DEFAULT_WINDOW_BUDGET,
                 warm: bool = DEFAULT_WARMUP,
                 host_lane: bool = True,
                 metrics_port: int = DEFAULT_METRICS_PORT,
                 device="cuda", poa_kernel: str = DEFAULT_POA_KERNEL,
                 tenant_quota: int = DEFAULT_TENANT_QUOTA,
                 memory_budget_mb: int = DEFAULT_MEMORY_BUDGET_MB,
                 slo_settings: Optional[dict] = None):
        self.state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self.session = PolishSession(state_dir, backend=backend,
                                     device=device, poa_kernel=poa_kernel)
        if slo_settings is not None:
            slo.reset(**slo_settings)
        self.scheduler = Scheduler(self.session, queue_depth=queue_depth,
                                   max_jobs=max_jobs,
                                   window_budget=window_budget,
                                   host_lane=host_lane,
                                   tenant_quota=tenant_quota,
                                   memory_budget_mb=memory_budget_mb)
        self._warm = warm
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self.port = self._sock.getsockname()[1]
        self._accept_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        # Prometheus exposition endpoint (obs/export.py): 0 = disabled;
        # the `metrics` wire op serves the same text either way
        self.metrics_port = metrics_port
        self._httpd = None
        self._httpd_thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Warm the kernels, recover unfinished jobs, start accepting."""
        with open(os.path.join(self.state_dir, "serve.json"), "w") as f:
            json.dump({"host": "127.0.0.1", "port": self.port,
                       "pid": os.getpid(),
                       "backend": self.session.backend}, f)
            f.write("\n")
        if self._warm:
            wall = self.session.warm()
            if self.session.warmed:
                print(f"[racon_tpu_torch::serve] built and loaded the "
                      f"kernels in {wall:.2f}s", file=sys.stderr)
        self.scheduler.start()
        recovered = self.scheduler.recover()
        if recovered:
            print(f"[racon_tpu_torch::serve] recovered {len(recovered)} "
                  f"unfinished job(s): {', '.join(recovered)}",
                  file=sys.stderr)
        self._sock.listen(16)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="serve-accept", daemon=True)
        self._accept_thread.start()
        self._start_metrics_http()

    def serve_forever(self) -> None:
        self.start()
        print(f"[racon_tpu_torch::serve] listening on 127.0.0.1:{self.port} "
              f"(state: {self.state_dir}, backend: {self.session.backend}, "
              f"device: {self.session.device})", file=sys.stderr)
        self._stopping.wait()
        self.scheduler.shutdown(wait=True)

    def stop(self, wait: bool = True) -> None:
        if not self._stopping.is_set():
            self._stopping.set()
            try:
                self._sock.close()
            except OSError:
                pass
            self._stop_metrics_http()
        if wait:
            self.scheduler.shutdown(wait=True)

    # -- metrics exposition -------------------------------------------------

    def _metrics_scrape(self) -> dict:
        """One scrape: obs registry snapshot (None when disarmed) + SLO
        engine state + instantaneous queue gauges, rendered as
        Prometheus text (obs/export.py).  Shared by the `metrics` wire
        op and the --metrics-port HTTP endpoint."""
        st = self.scheduler.stats()
        gauges = {
            "serve_queued_jobs": sum(st.get("queued", {}).values()),
            "serve_running_jobs": st.get("jobs", {}).get("running", 0),
        }
        snap = slo.engine().snapshot()
        return {"text": obs_export.prometheus_text(
                    metrics=obs.snapshot(), slo=snap, gauges=gauges),
                "slo": snap}

    def _start_metrics_http(self) -> None:  # concurrency: _httpd set once before the accept loop starts
        """Optional localhost HTTP exposition (`GET /metrics`); the
        stdlib threading server keeps the daemon dependency-free."""
        if not self.metrics_port or self.metrics_port <= 0:
            return
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):              # noqa: N802 — stdlib contract
                if self.path.split("?")[0].rstrip("/") not in ("",
                                                               "/metrics"):
                    self.send_error(404)
                    return
                body = daemon._metrics_scrape()["text"].encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log lines
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", self.metrics_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self.metrics_port = self._httpd.server_address[1]
        self._httpd_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-metrics-http",
            daemon=True)
        self._httpd_thread.start()
        print(f"[racon_tpu_torch::serve] metrics exposition on "
              f"http://127.0.0.1:{self.metrics_port}/metrics",
              file=sys.stderr)

    def _stop_metrics_http(self) -> None:  # concurrency: atomic swap; a double stop gets None and no-ops
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except OSError:
                pass

    # -- accept / connection handling --------------------------------------

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return   # socket closed by stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name="serve-conn", daemon=True)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """One thread per connection; a client vanishing mid-exchange
        closes only this socket."""
        try:
            f = conn.makefile("rwb")
            while True:
                try:
                    req = read_message(f)
                    if req is None:
                        return
                    resp = self._dispatch(req)
                except AdmissionError as e:
                    resp = {"ok": False, "error": str(e),
                            "rejected": "admission"}
                except (ValueError, KeyError, TypeError,
                        json.JSONDecodeError) as e:
                    resp = {"ok": False, "error": f"{e}"}
                except Exception as e:  # noqa: BLE001 — one bad request
                    # must not take down the connection (or the daemon)
                    resp = {"ok": False,
                            "error": f"{type(e).__name__}: {e}"}
                write_message(f, resp)
                if resp.get("bye"):
                    self.stop(wait=False)
                    return
        except (OSError, BrokenPipeError, ConnectionResetError):
            pass   # client went away; the daemon does not care
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- protocol ----------------------------------------------------------

    def _dispatch(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "pid": os.getpid(),
                    "backend": self.session.backend, "port": self.port}
        if op == "submit":
            spec = JobSpec.from_dict(
                {k: v for k, v in req.items() if k != "op"})
            job = self.scheduler.submit(spec)
            return {"ok": True, "job_id": job.id, "lane": job.lane,
                    "demotions": list(job.demotions)}
        if op == "status":
            job = self.scheduler.get(str(req["job_id"]))
            return {"ok": True, **job.as_status()}
        if op == "result":
            job = self.scheduler.get(str(req["job_id"]))
            if req.get("wait"):
                timeout = req.get("timeout")
                if not job.done.wait(None if timeout is None
                                     else float(timeout)):
                    # status last-but-error-wins: as_status()'s error
                    # field is None for a live job and must not clobber
                    # the timeout message
                    return {**job.as_status(), "ok": False,
                            "error": f"timeout waiting for {job.id}"}
            if not job.done.is_set():
                return {**job.as_status(), "ok": False,
                        "error": f"job {job.id} is {job.state}"}
            return {**job.as_status(), "ok": job.state == "done",
                    "result": job.result}
        if op == "cancel":
            return {"ok": True,
                    **self.scheduler.cancel(str(req["job_id"]))}
        if op == "stats":
            return {"ok": True, **self.scheduler.stats()}
        if op == "metrics":
            return {"ok": True, **self._metrics_scrape()}
        if op == "shutdown":
            return {"ok": True, "bye": True}
        raise ValueError(f"unknown op {op!r}; expected one of ping/submit/"
                         f"status/result/cancel/stats/metrics/shutdown")
