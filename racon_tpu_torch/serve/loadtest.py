"""Load-test harness for the serve daemon.

A copy of the JAX package's harness (racon_tpu/serve/loadtest.py)
without its ``--docs`` rewrite of the JAX package's benchmark page and
its elastic-fleet series (the pool timeline and the saturation curve).

Closed-loop load generation: N client threads, each with its own socket,
each looping submit -> wait over its share of synthetic polish jobs
(``tools/simulate.py`` data).  Reports end-to-end latency percentiles
(p50/p95/p99 — queueing included, that is the point), aggregate
throughput over the makespan, per-job service walls, and the
cold-first-job vs warm-job delta that quantifies what the resident
session amortizes (kernel builds and loads happen once, or zero times
when the startup warm-up ran).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional

from ..obs import ledger as joblog
from .client import ServeClient, ServeError
from .scheduler import child_env


def percentile(values: List[float], p: float) -> float:
    """Linearly interpolated percentile on a non-empty list — the same
    estimator `obs critpath` uses and `obs.metrics.hist_quantile`
    approximates per bucket, so percentiles agree across the harness,
    the analyzer, and the metrics registry."""
    vs = sorted(values)
    if len(vs) == 1:
        return vs[0]
    pos = (p / 100.0) * (len(vs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vs) - 1)
    return round(vs[lo] + (pos - lo) * (vs[hi] - vs[lo]), 6)


def spawn_daemon(state_dir: str, backend: str = "cuda",
                 extra_args: Optional[List[str]] = None,
                 env: Optional[dict] = None,
                 timeout: float = 300.0) -> subprocess.Popen:
    """Start a daemon subprocess (``python -m racon_tpu_torch.cli
    serve``) on an ephemeral port and wait until it answers ping
    (startup includes the warm-up, so the deadline is generous).  stderr
    goes to <state_dir>/daemon.stderr.log."""
    os.makedirs(state_dir, exist_ok=True)
    # a serve.json left by an earlier daemon life names its port: gone
    # before the new daemon writes its own
    try:
        os.remove(os.path.join(state_dir, "serve.json"))
    except OSError:
        pass
    cmd = [sys.executable, "-m", "racon_tpu_torch.cli", "serve",
           "--state-dir", state_dir, "--port", "0",
           "--backend", backend] + (extra_args or [])
    with open(os.path.join(state_dir, "daemon.stderr.log"), "w") as err_f:
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                stderr=err_f, env=child_env(env))
    deadline = time.monotonic() + timeout
    while True:
        if proc.poll() is not None:
            raise RuntimeError(
                f"serve daemon exited {proc.returncode} during startup "
                f"(see {state_dir}/daemon.stderr.log)")
        try:
            with ServeClient.from_state_dir(state_dir, timeout=5.0) as c:
                c.ping()
            return proc
        except (OSError, ValueError, ServeError):
            if time.monotonic() > deadline:
                proc.kill()
                proc.wait()
                raise RuntimeError(
                    f"serve daemon not reachable after {timeout}s") from None
            time.sleep(0.2)


def run_loadtest(port: int, paths: dict, jobs: int, clients: int,
                 polish_args: Optional[dict] = None,
                 backend: str = "", timeout: float = 1200.0,
                 tenants: int = 1, priority_levels: int = 1,
                 profiles: Optional[List[dict]] = None) -> dict:
    """Drive an already-running daemon with `jobs` synthetic jobs from
    `clients` concurrent client threads; returns the summary dict (see
    module docstring for the metrics).

    Mixed multi-tenant load: jobs round-robin over `tenants` submitter
    identities and `priority_levels` priority lanes, and `profiles` (a
    list of polish-arg dicts layered over `polish_args`) varies the job
    shape — together they exercise the scheduler's tenant fairness,
    quota, and priority paths, not just its throughput.  Each wait has
    the deadline `timeout`."""
    polish_args = polish_args or {}
    clients = max(1, min(clients, jobs))
    tenants = max(1, tenants)
    priority_levels = max(1, priority_levels)
    per_job: List[Optional[dict]] = [None] * jobs
    errors: List[str] = []
    barrier = threading.Barrier(clients)
    t_start = time.monotonic()

    def client_loop(ci: int) -> None:
        try:
            with ServeClient(port, timeout=timeout) as c:
                barrier.wait()
                for ji in range(ci, jobs, clients):
                    tenant = f"tenant{ji % tenants}"
                    priority = ji % priority_levels
                    args = dict(polish_args)
                    if profiles:
                        args.update(profiles[ji % len(profiles)])
                    t0 = time.monotonic()
                    job_id = c.submit(paths["reads"], paths["overlaps"],
                                      paths["draft"], args=args,
                                      backend=backend,
                                      submitter=tenant, priority=priority)
                    resp = c.wait(job_id, timeout=timeout)
                    res = resp.get("result") or {}
                    per_job[ji] = {
                        "job_id": job_id,
                        "latency_s": round(time.monotonic() - t0, 4),
                        "t_done": round(time.monotonic() - t_start, 4),
                        "service_s": res.get("wall_s"),
                        "cold": bool(res.get("cold")),
                        "kernel_builds": res.get("kernel_builds"),
                        "polished_bp": res.get("polished_bp", 0),
                        "backend": res.get("backend"),
                        "ledger": res.get("ledger"),
                        "client": ci,
                        "tenant": tenant,
                        "priority": priority,
                    }
        except (ServeError, OSError, threading.BrokenBarrierError) as e:
            errors.append(f"client {ci}: {type(e).__name__}: {e}")

    stats_samples: List[dict] = []
    stop_poll = threading.Event()

    def stats_loop() -> None:
        # live-telemetry scrape: the daemon's `stats` op once a second
        # while the clients drive it — queue depths and the telemetry
        # ring under load, not just the end-state.  Polling is
        # observation and must never fail (or silently abandon) the
        # run: errors are tolerated per sample — a slow or restarting
        # daemon costs one data point and a reconnect, not the rest of
        # the series — and the cadence follows a monotonic deadline so
        # slow scrapes do not stretch the sampling interval.
        c: Optional[ServeClient] = None
        next_t = time.monotonic()
        try:
            while not stop_poll.is_set():
                try:
                    if c is None:
                        c = ServeClient(port, timeout=min(timeout, 15.0))
                    resp = c.stats()
                    resp.pop("ok", None)
                    resp["t"] = round(time.monotonic() - t_start, 3)
                    stats_samples.append(resp)  # concurrency: append-only; read after join
                except (ServeError, OSError, ValueError):
                    if c is not None:   # drop the sample, keep the series
                        c.close()
                        c = None
                next_t += 1.0
                delay = next_t - time.monotonic()
                if delay <= 0:
                    next_t = time.monotonic()  # fell behind: re-anchor
                    delay = 0.05
                stop_poll.wait(delay)
        finally:
            if c is not None:
                c.close()

    threads = [threading.Thread(target=client_loop, args=(ci,),
                                name=f"loadtest-c{ci}", daemon=True)
               for ci in range(clients)]
    poller = threading.Thread(target=stats_loop, name="loadtest-stats",
                              daemon=True)
    poller.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    makespan = time.monotonic() - t_start
    stop_poll.set()
    poller.join(timeout=5.0)

    # end-of-run SLO scrape: burn rates + alert state off the daemon's
    # own engine (the `metrics` wire op).  Tolerated failure -> None,
    # so the harness still drives daemons predating the op.
    slo_snap = None
    try:
        with ServeClient(port, timeout=min(timeout, 15.0)) as c:
            slo_snap = c.metrics().get("slo")
    except (ServeError, OSError, ValueError):
        pass

    completed = [r for r in per_job if r is not None]
    if not completed:
        raise RuntimeError("loadtest completed no jobs: "
                           + ("; ".join(errors) or "unknown"))
    lat = [r["latency_s"] for r in completed]
    cold = [r for r in completed if r["cold"]]
    warm = [r for r in completed
            if not r["cold"] and r["service_s"] is not None]
    warm_wall = sum(r["service_s"] for r in warm)
    warm_bp = sum(r["polished_bp"] for r in warm)
    cold_wall = cold[0]["service_s"] if cold else None
    warm_mean = round(warm_wall / len(warm), 4) if warm else None
    summary = {
        "jobs": jobs,
        "clients": clients,
        "tenants": tenants,
        "priority_levels": priority_levels,
        "completed": len(completed),
        "errors": errors,
        "makespan_s": round(makespan, 4),
        "polished_bp": sum(r["polished_bp"] for r in completed),
        "throughput_mbps": round(
            sum(r["polished_bp"] for r in completed) / 1e6 / makespan, 6),
        "latency_s": {
            "p50": percentile(lat, 50),
            "p95": percentile(lat, 95),
            "p99": percentile(lat, 99),
            "mean": round(sum(lat) / len(lat), 4),
            "max": max(lat),
        },
        "service_s": {
            "cold_first_job": cold_wall,
            "warm_mean": warm_mean,
            "cold_warm_delta": (round(cold_wall - warm_mean, 4)
                                if cold_wall is not None
                                and warm_mean is not None else None),
        },
        "warm_mbps": (round(warm_bp / 1e6 / warm_wall, 6)
                      if warm_wall else None),
        "warm_kernel_builds": sum(r["kernel_builds"] or 0 for r in warm),
        # scraped daemon-side telemetry: sample count, the peak queued
        # depth seen across polls, and the final sample (with the
        # daemon's own telemetry ring) — bounded, not the full series
        "daemon_stats": {
            "samples": len(stats_samples),
            "max_queued": max(
                (sum((s.get("queued") or {}).values())
                 for s in stats_samples), default=0),
            "last": stats_samples[-1] if stats_samples else None,
        },
        # aggregated latency ledger over the completed jobs (where the
        # wall went, stage by stage) + the daemon's per-tenant SLO
        # snapshot scraped at the end of the run
        "ledger": joblog.summarize(r.get("ledger") for r in completed),
        "slo": slo_snap,
        "per_job": completed,
    }
    return summary


# -- report ---------------------------------------------------------------

def render_markdown(summary: dict, workload: str) -> str:
    """The summary as a markdown table (the JAX package's rows, less its
    fleet series and its docs-block markers)."""
    lat = summary["latency_s"]
    svc = summary["service_s"]
    mix = ""
    if summary.get("tenants", 1) > 1 or summary.get("priority_levels", 1) > 1:
        mix = (f", mixed over {summary['tenants']} tenants / "
               f"{summary['priority_levels']} priority levels")
    lines = [
        f"Measured by `python -m racon_tpu_torch.serve.loadtest` — "
        f"{workload}; "
        f"{summary['jobs']} jobs from {summary['clients']} concurrent "
        f"clients against one daemon{mix}:",
        "",
        "| metric | value |",
        "|---|---|",
        f"| throughput (makespan) | "
        f"{summary['throughput_mbps']:.4f} Mbp/s |",
        f"| warm-path throughput | "
        + (f"{summary['warm_mbps']:.4f} Mbp/s |"
           if summary["warm_mbps"] is not None else "n/a |"),
        f"| latency p50 / p95 / p99 | {lat['p50']:.2f} / {lat['p95']:.2f} "
        f"/ {lat['p99']:.2f} s |",
        f"| cold first job (service) | "
        + (f"{svc['cold_first_job']:.2f} s |"
           if svc["cold_first_job"] is not None else "n/a |"),
        f"| warm job mean (service) | "
        + (f"{svc['warm_mean']:.2f} s |"
           if svc["warm_mean"] is not None else "n/a |"),
        f"| cold-vs-warm delta | "
        + (f"{svc['cold_warm_delta']:.2f} s |"
           if svc["cold_warm_delta"] is not None else "n/a |"),
        f"| kernel builds in warm jobs | {summary['warm_kernel_builds']} |",
    ]
    return "\n".join(lines)


# -- CLI --------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="racon_tpu_torch loadtest",
        description="Drive a racon_tpu_torch serve daemon with concurrent "
        "synthetic polish jobs; report throughput + latency percentiles "
        "+ the cold-vs-warm first-job delta.")
    p.add_argument("--jobs", type=int, default=6)
    p.add_argument("--clients", type=int, default=3)
    p.add_argument("--tenants", type=int, default=1,
                   help="round-robin jobs over this many submitter "
                   "identities (exercises tenant fairness + quotas)")
    p.add_argument("--priority-levels", type=int, default=1,
                   help="round-robin jobs over priorities 0..N-1 "
                   "(exercises the priority lanes)")
    p.add_argument("--mix-profiles", action="store_true",
                   help="alternate job shapes (full vs half window "
                   "length) so the load is not uniform")
    p.add_argument("--queue-depth", type=int, default=None,
                   help="spawned daemon's queued-job admission cap")
    p.add_argument("--max-jobs", type=int, default=None,
                   help="spawned daemon's unfinished-job admission cap")
    p.add_argument("--metrics-port", type=int, default=None,
                   help="spawned daemon's Prometheus-text HTTP port "
                   "(0 disables; lets CI scrape /metrics mid-run)")
    p.add_argument("--port", type=int, default=None,
                   help="drive an already-running daemon on this port "
                   "(default: spawn a fresh one)")
    p.add_argument("--state-dir", default=None,
                   help="state dir for the spawned daemon (default: "
                   "a temporary directory)")
    p.add_argument("--backend", choices=("cuda", "host"), default="cuda")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="spawned daemon's device (default: its own, cuda)")
    p.add_argument("--mbp", type=float, default=0.01,
                   help="synthetic workload megabases per job's draft "
                   "(default 0.01)")
    p.add_argument("--coverage", type=int, default=6)
    p.add_argument("-w", "--window-length", type=int, default=500)
    p.add_argument("-m", "--match", type=int, default=3)
    p.add_argument("-x", "--mismatch", type=int, default=-5)
    p.add_argument("-g", "--gap", type=int, default=-4)
    p.add_argument("--no-warm", action="store_true",
                   help="spawned daemon skips its startup build and load of "
                   "the kernels (its first job then pays them)")
    p.add_argument("--json", action="store_true",
                   help="print the full summary JSON (per-job rows "
                   "included) instead of the short text")
    p.add_argument("--markdown", action="store_true",
                   help="print the summary as a markdown table instead")
    args = p.parse_args(argv)

    import tempfile

    from ..tools import simulate

    workdir = args.state_dir or tempfile.mkdtemp(prefix="racon_serve_lt.")
    data_dir = os.path.join(workdir, "data")
    paths = simulate.generate(data_dir, mbp=args.mbp,
                              coverage=args.coverage)
    polish_args = {"window_length": args.window_length,
                   "match": args.match, "mismatch": args.mismatch,
                   "gap": args.gap}
    workload = (f"{args.mbp} Mbp draft x {args.coverage}x coverage, "
                f"-w {args.window_length} -m {args.match} -x "
                f"{args.mismatch} -g {args.gap}, backend {args.backend}"
                + (", no warm-up" if args.no_warm else ""))

    extra: List[str] = []
    for flag, val in (("--device", args.device),
                      ("--queue-depth", args.queue_depth),
                      ("--max-jobs", args.max_jobs),
                      ("--metrics-port", args.metrics_port)):
        if val is not None:
            extra += [flag, str(val)]
    if args.no_warm:
        extra.append("--no-warm")
    profiles = None
    if args.mix_profiles:
        profiles = [{}, {"window_length": max(50, args.window_length // 2)}]
        workload += ", mixed profiles"
    proc = None
    if args.port is None:
        proc = spawn_daemon(os.path.join(workdir, "state"), args.backend,
                            extra_args=extra or None)
        with open(os.path.join(workdir, "state", "serve.json")) as f:
            port = json.load(f)["port"]
    else:
        port = args.port
    try:
        summary = run_loadtest(port, paths, args.jobs, args.clients,
                               polish_args=polish_args,
                               tenants=args.tenants,
                               priority_levels=args.priority_levels,
                               profiles=profiles)
    finally:
        if proc is not None:
            try:
                with ServeClient(port, timeout=10.0) as c:
                    c.shutdown()
                proc.wait(timeout=30)
            except (OSError, ServeError, ValueError,
                    subprocess.TimeoutExpired):
                proc.kill()

    if args.markdown:
        print(render_markdown(summary, workload))
    elif args.json:
        print(json.dumps(summary, indent=1))
    else:
        slim = {k: v for k, v in summary.items() if k != "per_job"}
        print(json.dumps(slim, indent=1))
    return 0 if not summary["errors"] and \
        summary["completed"] == summary["jobs"] else 1


if __name__ == "__main__":
    sys.exit(main())
