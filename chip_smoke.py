#!/usr/bin/env python3
"""Smoke run of racon_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the native host library and the CUDA kernels from this checkout,
then, each phase printing one JSON line (with t_s, the seconds since the
smoke started):

* main: polishes a simulated 1.0 Mbp genome (30x ONT-like reads, PAF
  overlaps, -w 500 -m 5 -x -4 -g -8) on the card with the default POA
  kernel (poa_driver.DEFAULT_POA_KERNEL), times every kernel launch with
  CUDA events around the launch call alone (cuda_lib.LAUNCH_EVENTS)
  beside its bound from the DP cells it needed, and checks that
  polishing lowers the edit distance to the truth;
  main_aligner_by_band gives the main run's aligner launches, device ms
  and lane cells per band K;
* main_v2 (or main_ls): the same polish with the other POA kernel,
  recorded the same way; its FASTA must be byte-identical to the main
  run's;
* main_band: the same polish on the banded path (band=True, slack 32:
  v2's banded build, the aligner's K = 128 builds and the verify-and-widen
  ladder), recorded the same way, with the ladder's counts for both
  phases; whether its FASTA equals the main run's, and if not the first
  window that differs, is printed (main_band_vs_flat), not required;
* main_ls_band: the same banded polish with the ls POA kernel (its banded
  build), recorded and compared the same way (main_ls_band_vs_flat);
* lowerr and lowerr_band: a PacBio-HiFi-like set (0.5 Mbp, 30x, 8 kb
  reads, about 1% error) polished flat and banded, recorded the same way;
  lowerr_band_vs_flat gives FASTA equality and the aligner's launches,
  device ms and lane cells per band K in both runs;
* occupancy: each POA build's registers, spill bytes, shared bytes and
  blocks per SM at the main path's geometry, and the shared-memory plans
  (ls; v2 flat and banded);
* kernel_check: runs each kernel again on the inputs of its largest
  launches in its path's run (one per POA depth bucket, per edge band and
  direction, per base-case band; the v2 kernel, colstep on and off, on
  the POA launches; v2's banded build on main_band's banded launches, the
  ls banded build on main_ls_band's; the
  K = 128 builds on lowerr_band's), holds it against the plain PyTorch
  version (tolerance 0: all outputs are integers; the aligner's whole
  batch; a POA build's outputs on up to PLAIN_SAMPLE windows of the
  launch, spread evenly over it, the banded build's hit windows first,
  since the plain POA version loops over windows in Python on the host;
  the banded build at wband = 0 on the whole launch against the flat
  build) and times the whole launch; the v2 lines also give the kernel's per-phase times (init,
  dp, end_pick, traceback, update, consensus: max and mean over the
  launch's windows, from clock64() cycles over the card's highest SM
  clock), printed as "v2 POA phases" lines; each ls launch, flat and
  banded, prints an "ls POA phases" line the same way (init, dp,
  end_pick, traceback, update, order, consensus), and each v2 banded
  launch a "v2 POA phases" line; each base-case band prints a
  "base case phases" line the same way (dp and traceback, max and mean
  over the launch's tasks) and an occupancy line (registers, spill bytes,
  resident warps per SM); each edge launch prints an "edge phases" line
  (tasks, rows mean, ns a row, max and mean over the launch's tasks, from
  the kernel's clock64() cycles over the card's highest SM clock, and the
  launch's waves: tasks over SMs x resident warps an SM), is timed in
  three rounds of ten calls (min, median, max of the rounds' means: the
  spread between calls), and each edge band and direction prints an
  occupancy line; the aligner's bounds count the band cells its
  DP needs (the lanes o of row i with 0 <= i + dmin + o <= S), and its
  lines also give the cells its warps run (R x K, "lane_cells"); the
  banded POA build's bound counts the cells its band admits;
* poa_decision: v2 over ls and colstep over flat on each depth bucket's
  largest launch, the numbers that settle the default POA kernel (ls
  unless v2 is at least 10% faster on every bucket);
* parity: the card (both POA kernels) and the CPU polish a small PAF set
  to the same bytes; parity_band and parity_ls_band: the same set on the
  banded path (slack 8) with each POA kernel, on the card and on the CPU,
  the same bytes and ladder counts (the three CPU polishes run in worker
  processes from the start; the parity and host lines come after
  wide_11008's, since the banded CPU polishes are the smoke's longest
  path);
* wide: a small set at -w 1500 (window class 1536, max_len 2304: both POA
  kernels' wide builds, 16 columns a thread) polished on the card with
  each POA kernel, recorded as the main run is (device ms and bound from
  the DP cells of each launch), and on the CPU (plain versions, in a
  worker process): the same bytes, the edit distance to the truth
  lowered, every window with at least two layers served on the card; then
  each wide build's registers, spill bytes, shared bytes and blocks per
  SM at -w 1500's and -w 2000's geometries;
* wide_3000: a set at -w 3000 (window class 3072: max_nodes 9,216, max_len
  4,608, where no shared-memory layout fits, so both POA kernels run
  their global build: the graph in global memory, DP rows in tiles)
  polished on the card with each POA kernel, flat and banded (slack 8),
  recorded the same way, and flat on the CPU: the flat runs' bytes equal
  the CPU's, no window sent to the host, each global build launched;
  each global build then held against the plain version on its path's
  largest launch (kernel_check lines, the banded ones as the other banded
  builds are), and an occupancy line for each global build at classes
  3072, 4096 and 10,880;
* wide_11008: a set of one window at -w 11008 (window class 11,008:
  max_nodes 33,024, above the int16 node ids, so both POA kernels run
  their global build with int32 node ids) polished the same way, flat and
  banded, on the card, and flat on the CPU: the same bytes; each int32
  build then held against the plain version (on the host) on its
  smallest launch, batches.wide_id_batch (two windows of class 11,008,
  one whose graph passes node id 32,767), flat and banded, and an
  occupancy line at classes 11,008 and 22,016;
* host: the host backend (create_polisher(backend="host"), the native
  pipeline alone) on the parity set: its wall and its edit distance to
  the truth (below the draft's); whether its bytes equal the card's is
  printed, not required;
* chunked: the main cell's reads at half its scale in four contigs
  (CHUNKED: simulate.generate(mbp=0.5, contigs=4)), polished on the card
  sequentially, with pipelined phases, and pipelined and streamed under a
  memory budget that does not bind: the same FASTA; a line a mode with the wall by phase,
  the consensus feeder's pack and kernel wall, the seconds in which
  alignment (and the whole of a chunk's parse, alignment and windows)
  overlapped consensus, the process's peak RSS and the chunk count
  (three: handoff_depth 1 + 2);
* journal (after main_<other kernel>, on the main cell): a polish with no
  journal, trace or recorder (the walls' baseline); (a) a journaled polish,
  uninterrupted: its wall, the records (CIGARs and windows), the journal's
  bytes and the seconds in fsync, and the wall of the same polish
  journaled without fsync (journal_fsync=False); (b) a child process
  ``python -m racon_tpu_torch.cli --journal J`` with RACON_TORCH_FAULT=
  journal.append:batch=N:kill=1, N = (a)'s CIGAR records and half its
  window records, which must die by SIGKILL; (c) ``--resume-journal J``
  in this process: the main FASTA, fewer POA launches than main, and the
  replayed CIGARs and windows under the report's "journal" tier;
* trace: the main polish with trace_path and its report (a list in
  cuda_lib.LAUNCH_EVENTS beside it): the main FASTA; the device track's
  launches per kernel equal to the launch counts and its summed durations
  within 1% of the LAUNCH_EVENTS sum; its wall, the phase walls from the
  port's trace reader, the device's busy share of the polish, and the
  host gaps between launches by their enclosing span (obs/__main__.py
  device_track);
* costmodel (after trace): the cost model (obs/costmodel.py) on the
  traced main polish: ``obs model --profile h100 --json``, then
  validate_trace under h100: each modeled phase's predicted and measured
  seconds and their ratio, each beside its kernels' busy time on the
  device track (the prediction over it, and its share of the phase), and
  the bucket joins; the DP-cell counters must equal the counts
  recomputed from the polish's pipeline, the h100 profile's aligner cells
  a step must lie within its bound of this run's reading, and
  validate's ``ok`` is printed as computed (a ratio past the profile's
  bound is a finding, not a failure);
* kernel_bench: tools/kernel_bench.py on both POA kernels (64 windows,
  depth 32, 3 warm calls): ms, the cost model's bound, ms over it, and
  both kernels' outputs on 2 sampled windows equal to the plain
  version's; then one kernel_check line per POA kernel on a batch with N
  (code 4) at 5% in backbones and layers, every window equal to the
  plain version;
* watchdog: the parity set on the card with RACON_TORCH_FAULT's
  poa.run.ls:hang=60 (through faults.configure) and device_timeout_s=2:
  WatchdogTimeout within 15 s of the polish's start;
* serve: the resident daemon (``python -m racon_tpu_torch.cli serve``, a
  process of its own, started by
  ``serve.loadtest.spawn_daemon``). A first daemon, started with
  RACON_TORCH_FAULT="journal.append:batch=3:kill=1", dies by SIGKILL in
  a parity-set job; a second one on the same state directory recovers
  that job and resumes it to the card's bytes (journal_replayed >= 1)
  while two clients submit main-cell jobs at once and a third a
  parity-set job with window_budget=1: each main job's FASTA is main's,
  its kernel_builds 0, its trace's device track main's launch counts of
  the ls POA kernel, the edge kernel and the base case (the path's
  launches, read from the daemon's own counts, reset per job); the
  budget job runs on the host lane with the host backend's bytes; every
  job ends done (a device-lane job that raises fails, and is never
  re-run on the host lane). SIGTERM then ends the daemon with exit 0
  within 30 s. Lines: the daemon's start to ready and warm-up wall, each
  job's wall, queue wait and lane, the daemon's stats (SLO, ledger), and
  the main jobs' walls against the plain main polish;
* distrib, distrib_kill, distrib_w4, serve_fleet: worker processes that
  share the card, once the CPU polishes of the pool have ended. distrib:
  the chunked cell (the chunked phase's data) through ``python -m
  racon_tpu_torch.cli distrib --workers 2 --chunks 4 --trace --report``;
  its FASTA must equal the chunked phase's sequential one, its four
  chunks be served by the fleet and none locally, kernel_builds be 0 in
  every chunk (the coordinator builds, each worker loads before its first
  chunk), and the ls POA, edge and base-case kernels be launched, summed
  over the chunks (each worker sets its counts to 0 before a chunk and
  reports them with it); the line gives the wall against the sequential
  polish's, each worker's chunk walls, peak RSS and peak reserved device
  memory, each worker's start-up (imports, the kernels' load, spawn to
  hello), and the card's busy share from the chunks' traces merged as
  ``obs merge`` merges them, and ``obs critpath`` on the coordinator's
  trace (its dispatches and the chunk spans the workers shipped): each
  job's stages and unattributed share, every chunk under a job and the
  stages summing to the job's wall (required);
  the coordinator must have made no CUDA context. distrib_kill: the same on FLEET_SMALL (half the chunked
  cell's scale, against its own sequential polish) with
  RACON_TORCH_FAULT="worker.result:kill=1", which the coordinator hands
  to worker 0 alone: the same FASTA, one worker dead, the killed chunk
  re-dispatched and resumed from its journal (journal_replayed > 0).
  distrib_w4: FLEET_SMALL at four workers. serve_fleet: a daemon with
  ``--fleet-min 1 --fleet-max 2``, started before distrib so that its
  start overlaps the distrib runs, given one chunked-cell job: the
  sequential FASTA, the job done, kernel_builds 0, no CUDA context in
  the daemon; the line gives the plane's stats (workers, pool timeline,
  steals, reclaims, the workers' start-up);
* stripe, multichip, wrapper (after the fleet phases). stripe: the main
  cell polished with its launches striped over a virtual stripe
  (devices=["cuda:0", "cuda:0"]: two streams of one card;
  parallel/partitioner.py), traced: main's FASTA; each path kernel (ls
  POA, edge, base case) launched twice as often as on main but for the
  launches too small to stripe, which the line counts
  (unsplit_launches), all launches main's plus the striped ones
  (shard.chunks); the rows each stream launched (shard.rows.d0, d1,
  counted from its slices) at least one a striped launch and d0 at most
  one a striped launch above d1 (a batch's slices differ by one row at
  most); the device track's launches equal to the counts. The line gives
  the wall beside main's and the traced main's, and the busy share.
  Where the host has two cards, the same polish with devices=2 (one
  device track a card); with one, the line says that it did not run and
  why. multichip: the
  port's sweep (tools/multichip.py) at 1, 2 and 4 stripes on main-cell
  batches of the ls kernel, real cards where there are that many, else
  virtual: every count's outputs equal to one launch's; windows/s and
  rows a stripe. wrapper: FLEET_SMALL through ``python -m
  racon_tpu_torch.tools.wrapper --split <bytes>`` (one contig a chunk)
  on the card, sequentially and with --jobs 2: the same four contigs,
  byte for byte;
* probe: the DP-cost probe's gate and per-mode timing table on the card
  (python -m racon_tpu_torch.tools.dp_cost_probe; a "probe mode" line per
  mode with its ns a rank step and ps a DP cell), then every mode held
  against its plain version run on the card.

Each path (main, main_<other kernel>, journal, journal_resume, trace,
main_band, main_ls_band, lowerr,
lowerr_band, wide_ls, wide_v2, wide_3000_<kernel>, wide_3000_<kernel>_band,
wide_11008_<kernel>, wide_11008_<kernel>_band, chunked_<mode>, stripe,
stripe_2cards, probe) runs
with the launch counts set to 0 just before it and read just after; every
kernel of the path must have launched (the banded paths: their POA
kernel's banded build and the K = 128 edge build, and on lowerr_band the
K = 128 base case; on main_band and main_ls_band the flat aligner builds
as the ladder's floor; on the -w 3000 paths the kernel's global build, on
the -w 11008 paths its int32 global build), and no other POA kernel's
build.

Then a line with every kernel's numbers, the card's name and power limit
as nvidia-smi gives them, and last {"ok": true, "device": {...}}. Any
failure raises and exits non-zero before the last line. Needs one CUDA
card; fails without one. ``--keep DIR`` copies the trace phase's trace and
report into DIR.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor

# The card's peaks (H100 SXM: HBM3 bytes/s, 32-bit integer ops/s) and the
# integer ops a DP cell of each kernel does, as the cost model bills them
# (racon_tpu_torch/obs/costmodel.py; it imports no torch).
from racon_tpu_torch.obs.costmodel import (BASE_OPS_PER_CELL,
                                           EDGE_OPS_PER_CELL, HBM_BYTES_S,
                                           INT32_OPS_S, POA_OPS_PER_CELL)

ROOT = os.path.dirname(os.path.abspath(__file__))

MAIN = dict(window_length=500, match=5, mismatch=-4, gap=-8)
# The parity set: small, because its CPU polish runs the plain versions,
# one window and one DP row at a time in Python (its two banded polishes,
# ≈12 minutes at 0.02 Mbp and 9.5–11 at 0.015, are the smoke's longest
# path).
PARITY_MBP = 0.015
PARITY_SLACK = 8          # the banded parity run's slack
# The wide set: windows of 1,500 bases (the POA kernels' wide builds); its
# CPU polish runs the plain versions beside the other phases.
WIDE_MBP = 0.01
WIDE_WINDOW = 1500
# The -w 3000 set: two windows of class 3072 (the POA kernels' global
# builds) and the draft's last bases; its CPU polish runs beside the rest.
WIDE3_MBP = 0.006
WIDE3_WINDOW = 3000
# The -w 11008 set: one window of class 11,008 (max_nodes 33,024, above the
# int16 node ids: both POA kernels' global builds with int32 ids); its CPU
# polish runs beside the rest.
WIDE11_MBP = 0.011
WIDE11_WINDOW = 11008
WIDE11_COVERAGE = 10
CHUNK_PHASES = ("parse", "align", "windows", "consensus", "stitch")
# The chunked cell: the main cell's reads and width at half its scale, in
# four contigs, polished on the card sequentially and by two chunked modes
# (and by the fleet phases). The streamed-only mode runs in the CPU tests
# and tests/test_torch_cuda_chunked.py, not here: the smoke's time, as the
# half scale is.
CHUNKED = dict(mbp=0.5, coverage=30, seed=11, contigs=4)
# The fleet phases: four chunks, one a contig; distrib_kill and
# distrib_w4 on half the chunked cell's scale (the smoke's time).
DISTRIB_CHUNKS = 4
FLEET_SMALL = dict(CHUNKED, mbp=0.25)
# The most windows of one launch that a POA check holds against the plain
# version, which loops over windows in Python on the host: every window of
# a smaller launch, an even spread of a larger one's (the smoke's time).
PLAIN_SAMPLE = 32
# The host processes that run the plain versions of the POA checks.
PLAIN_PROCS = 10
NO_BINDING_BUDGET_MB = 1 << 20   # 1 TiB: arms streaming, never binds
CHUNKED_MODES = {
    "sequential": {},
    "pipelined": dict(pipeline_phases=True),
    "pipelined_streamed_budget": dict(
        pipeline_phases=True, stream_input=True,
        memory_budget_mb=NO_BINDING_BUDGET_MB)}
# The low-error cell: PacBio-HiFi-like reads, about 1% error.
LOWERR = dict(mbp=0.5, coverage=30, mean_read=8000, sub=0.005, ins=0.0025,
              dele=0.0025, seed=11)


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the smoke
    started (t_s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sm_clock_mhz() -> float:
    """The card's highest SM clock, MHz, as nvidia-smi reports it: the
    rate at which the kernels' clock64() counts when the card runs at full
    clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
        timeout=60).stdout
    return float(out.strip().splitlines()[0])


def phase_ms(names, st, windows: int, mhz: float) -> dict:
    """Per phase: ms of the window that spent the most cycles in it, and
    the mean over the launch's windows (cycles over the SM clock)."""
    return {n: {"max_ms": mx / (mhz * 1e3), "mean_ms": sm / windows
                / (mhz * 1e3)}
            for n, sm, mx in zip(names, st["phase_cycles"],
                                 st["phase_cycles_max"])}


def print_phases(label: str, phases: dict, ms: float) -> None:
    """One "<kernel> POA phases" line: per phase the max and mean ms over
    the launch's windows (phase_ms), after the launch's own ms."""
    print(f"{label} ({ms:.2f} ms a launch; max / mean ms over windows): "
          + ", ".join(f"{n} {v['max_ms']:.2f} / {v['mean_ms']:.2f}"
                      for n, v in phases.items()), flush=True)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def max_abs_err(want, got) -> int:
    return max(int((w.cpu().long() - g.cpu().long()).abs().max())
               if w.numel() else 0 for w, g in zip(want, got))


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def poa_bytes(dev_in, outs, wband=None) -> int:
    """Bytes a POA launch must move, whatever its padding: each window's
    backbone (a code and an int32 weight a base), its kept layers' bases
    and weights, their lengths, begins and ends, and the window's
    scalars; the consensus it writes (base and coverage, int32, up to its
    length) and the per-window outputs; the half bands."""
    bb_len, n_layers, lens = dev_in[2], dev_in[3], dev_in[6]
    kept = (lens.new_tensor(list(range(lens.shape[1])))[None, :]
            < n_layers[:, None])
    n_in = (5 * int(bb_len.sum()) + 5 * int(lens[kept].sum())
            + 12 * int(kept.sum()) + 8 * bb_len.numel())
    cons_len = outs[2]
    n_out = 8 * int(cons_len.sum()) + nbytes(outs[2:])
    return n_in + n_out + (0 if wband is None else nbytes((wband,)))


def band_cells(scal, K: int, backward: bool = False) -> int:
    """Cells of the aligner's DP that lie in band, summed over tasks: at
    row i, the lanes o < K with 0 <= i + dmin + o <= S, for rows 1..R
    (forward, base case) or 0..R-1 (backward). Out-of-band lanes hold INF
    and no output reads them, so a bound counts only these."""
    import torch

    s = scal.int()
    R, S, dmin = s[:, 0:1], s[:, 1:2], s[:, 2:3]
    o = torch.arange(K, dtype=torch.int32, device=s.device)
    first, last = (0, R - 1) if backward else (1, R)
    lo = (-dmin - o).clamp(min=first)
    hi = torch.minimum(S - dmin - o, last)
    return int((hi - lo + 1).clamp(min=0).sum())


def lane_cells(scal, K: int) -> int:
    """Cells the aligner's warps run: R rows of all K lanes a task."""
    return int(scal[:, 0].sum()) * K


def bound(n_bytes: int, n_ops: int):
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = n_ops / INT32_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class MainPathRecorder:
    """Times every kernel launch of the main path and keeps a real cohort.

    Inside ``with`` it replaces the kernel wrappers where the main path
    looks them up (``align_cuda.edge_rows``, ``align_cuda.base_case``,
    ``poa_driver.poa_consensus``, ``poa_driver.poa_consensus_v2``) by thin
    wrappers that call the real ones, count the launch's DP cells and
    bytes, and keep the inputs of the largest launch (by DP cells) of each
    kernel and geometry: POA per depth bucket (a banded build's per depth
    bucket with band hits and without), the edge kernel per band
    and direction, the base case per band. The real wrappers still count
    their launches, and time each one with the two CUDA events they
    record around the launch call alone (``cuda_lib.LAUNCH_EVENTS``),
    which leaves out their checks and allocations. The POA launches count
    their cells (and v2 its serial steps) on the card (``stats``); the
    aligner's cells are those in band (``band_cells``)."""

    def __init__(self, torch, ac, poa_driver):
        self.torch, self.ac, self.pd = torch, ac, poa_driver
        self.launches = []     # (name, (start, end event), ops, bytes,
                               #  geometry, lane cells)
        self.largest = {}      # (kernel, geometry) -> (cells, inputs)
        self.steps = 0         # v2 POA serial DP steps, all launches
        self.windows = {}      # window -> consensus the kernels installed

    def __enter__(self):
        from racon_tpu_torch.ops import cuda_lib
        from racon_tpu_torch.pipeline import Pipeline

        self.saved = (self.ac.edge_rows, self.ac.base_case,
                      self.pd.poa_consensus, self.pd.poa_consensus_v2,
                      Pipeline.set_consensus)
        cuda_lib.LAUNCH_EVENTS = []
        edge, base, poa, poa_v2, set_consensus = self.saved
        name_of = self.ac.launch_name

        def edge_rows(scal, q, t, K, backward):
            return self._call(name_of("hirschberg_edge", K), (K, backward),
                              EDGE_OPS_PER_CELL,
                              lambda: edge(scal, q, t, K, backward),
                              lambda out: band_cells(scal, K, backward),
                              (scal, q, t), (scal, q, t, K, backward),
                              lane_cells(scal, K))

        def base_case(scal, q, t, K):
            return self._call(name_of("hirschberg_base", K), (K,),
                              BASE_OPS_PER_CELL,
                              lambda: base(scal, q, t, K),
                              lambda out: band_cells(scal, K),
                              (scal, q, t), (scal, q, t, K),
                              lane_cells(scal, K))

        def record_consensus(pl, i, consensus, polished):
            self.windows[i] = bytes(consensus)
            return set_consensus(pl, i, consensus, polished)

        def poa_call(name, fn, cfg, args, kw):
            from racon_tpu_torch.ops import poa_cuda, poa_v2_cuda

            st = {}
            wband = kw.get("wband")
            # the build the wrapper launches, as its plan picks it
            mod = poa_cuda if name == "poa_consensus" else poa_v2_cuda
            build = poa_cuda.build_name(mod.plan, name, cfg,
                                        wband is not None)[1]

            def cells_of(out):
                self.steps += st.get("steps", 0)
                return st["cells"]

            # a banded build: the largest launch of each depth bucket with
            # band hits, and the largest without
            return self._call(
                build, (cfg.depth,) if wband is None else
                (lambda out: (cfg.depth, bool(out[5].any()))),
                POA_OPS_PER_CELL,
                lambda: fn(cfg, *args, stats=st, **kw), cells_of,
                args + ((wband,) if wband is not None else ()),
                (cfg, args) if wband is None else (cfg, args, wband))

        def poa_consensus(cfg, *args, **kw):
            return poa_call("poa_consensus", poa, cfg, args, kw)

        def poa_consensus_v2(cfg, *args, **kw):
            return poa_call("poa_consensus_v2", poa_v2, cfg, args, kw)

        self.ac.edge_rows, self.ac.base_case = edge_rows, base_case
        self.pd.poa_consensus = poa_consensus
        self.pd.poa_consensus_v2 = poa_consensus_v2
        Pipeline.set_consensus = record_consensus
        return self

    def __exit__(self, *exc):
        from racon_tpu_torch.ops import cuda_lib
        from racon_tpu_torch.pipeline import Pipeline

        cuda_lib.LAUNCH_EVENTS = None
        (self.ac.edge_rows, self.ac.base_case, self.pd.poa_consensus,
         self.pd.poa_consensus_v2, Pipeline.set_consensus) = self.saved
        return False

    def _call(self, name, geom, ops_per_cell, fn, cells_of, ins, keep,
              lanes=None):
        from racon_tpu_torch.ops import cuda_lib

        n0 = cuda_lib.LAUNCHES[name]
        k0 = len(cuda_lib.LAUNCH_EVENTS)
        out = fn()
        if cuda_lib.LAUNCHES[name] == n0:       # empty batch: no launch
            return out
        timed = cuda_lib.LAUNCH_EVENTS[k0:]
        require(len(timed) == 1 and timed[0][0] == name,
                f"{name}: one launch, timed by its wrapper, expected; got "
                f"{[e[0] for e in timed]}")
        ev = timed[0][1:]
        cells = cells_of(out)
        if callable(geom):
            geom = geom(out)
        outs = out if isinstance(out, tuple) else (out,)
        self.launches.append((name, ev, ops_per_cell * cells,
                              nbytes(ins) + nbytes(outs), geom, lanes))
        if cells > self.largest.get((name, geom), (-1, None))[0]:
            self.largest[(name, geom)] = (cells, keep)
        return out

    def summary(self):
        """Per kernel: launches, device ms, DP-cell ops, and the bound
        summed over the launches."""
        self.torch.cuda.synchronize()
        res = {}
        for name, ev, ops, nb, _, _ in self.launches:
            r = res.setdefault(name, {"launches": 0, "device_ms": 0.0,
                                      "ops": 0, "bytes": 0, "bound_ms": 0.0})
            r["launches"] += 1
            r["device_ms"] += ev[0].elapsed_time(ev[1])
            r["ops"] += ops
            r["bytes"] += nb
            r["bound_ms"] += bound(nb, ops)[0]
        for r in res.values():
            r["ms_per_launch"] = r["device_ms"] / r["launches"]
            r["bound_ms_per_launch"] = r["bound_ms"] / r["launches"]
            r["over_bound"] = r["device_ms"] / r["bound_ms"]
        return res

    def per_band(self):
        """The aligner's launches by kernel and band K: launches, device
        ms and the lane cells (R x K) its warps ran."""
        self.torch.cuda.synchronize()
        res = {}
        for name, ev, _, _, geom, lanes in self.launches:
            if lanes is None:
                continue
            r = res.setdefault(name, {}).setdefault(geom[0], {
                "launches": 0, "device_ms": 0.0, "lane_cells": 0})
            r["launches"] += 1
            r["device_ms"] += ev[0].elapsed_time(ev[1])
            r["lane_cells"] += lanes
        return res

    def inputs(self, name):
        """[(cells, inputs)] of the kept launches of one kernel."""
        return [v for k, v in sorted(self.largest.items(),
                                     key=lambda kv: kv[0]) if k[0] == name]


class Totals:
    """A kernel's check numbers summed over its checked launches."""

    def __init__(self):
        self.err = self.bytes = self.ops = 0
        self.ms = self.plain_ms = 0.0

    def add(self, line, n_bytes, n_ops):
        self.err = max(self.err, line["max_abs_err"])
        self.ms += line["ms"]
        self.plain_ms += line["plain_ms"]
        self.bytes += n_bytes
        self.ops += n_ops

    def row(self):
        b_ms, b_by = bound(self.bytes, self.ops)
        return {"max_abs_err": self.err, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": b_ms, "bound_by": b_by}


def spread(n: int, k: int = PLAIN_SAMPLE):
    """Indices of up to `k` of `n` windows spread evenly over them (all of
    them when n <= k)."""
    import torch

    return torch.linspace(0, n - 1, min(n, k)).round().long().unique()


def check_poa(torch, poa_cuda, rec, procs, ex):
    """The main path's largest POA launch of each depth bucket, held
    against the plain version on up to PLAIN_SAMPLE windows of it spread
    evenly over the launch (the plain version runs on the host, on the
    pool `ex` of `procs` processes; its time is that of all buckets'
    samples together): the sampled outputs equal, and the DP cells the
    kernel counts equal the plain version's on the sample and the main
    path's on the whole launch. The time and the bound are the whole
    launch's. Returns the kernel's totals and, for the v2 check, the kept
    launches with their samples, the plain outputs and stats and the plain
    time. Each launch also prints an "ls POA phases" line (phase_ms of the
    kernel's clock64() phase counts)."""
    from racon_tpu_torch.tools.batches import plain_poa_parallel

    mhz = sm_clock_mhz()
    kept = rec.inputs("poa_consensus")
    require(kept, "no POA launch of the main run was kept to check")
    samples = []
    for _, (cfg, dev_in) in kept:
        idx = spread(dev_in[0].shape[0]).to(dev_in[0].device)
        samples.append((idx, [t[idx].contiguous() for t in dev_in]))
    t0 = time.perf_counter()
    plain = plain_poa_parallel([(cfg, sub) for (_, (cfg, _)), (_, sub) in
                                zip(kept, samples)], procs, ex=ex)
    plain_ms = (time.perf_counter() - t0) * 1e3
    tot = Totals()
    per_bucket = {}
    for (cells_main, (cfg, dev_in)), (idx, sub), (want, pst) in zip(
            kept, samples, plain):
        kst, sst = {}, {}
        got = poa_cuda.poa_consensus(cfg, *dev_in, stats=kst)
        poa_cuda.poa_consensus(cfg, *sub, stats=sst)
        torch.cuda.synchronize()
        err = max_abs_err(want, [g[idx] for g in got])
        require(err == 0, f"POA kernel (depth {cfg.depth}) differs from "
                f"its plain version by {err}")
        require(sst["cells"] == pst["cells"] and kst["cells"] == cells_main,
                f"POA DP cells: kernel {sst['cells']} on the sample, plain "
                f"{pst['cells']}; kernel {kst['cells']} on the launch, main "
                f"path {cells_main}")
        cells = kst["cells"]
        ms = cuda_ms(torch, lambda: poa_cuda.poa_consensus(cfg, *dev_in), 3)
        phases = phase_ms(poa_cuda.PHASES, kst, dev_in[0].shape[0], mhz)
        print_phases(f"ls POA phases, depth {cfg.depth}, "
                     f"{dev_in[0].shape[0]} windows, flat", phases, ms)
        n_bytes = poa_bytes(dev_in, got)
        n_ops = POA_OPS_PER_CELL * cells
        b_ms, b_by = bound(n_bytes, n_ops)
        line = {"phase": "kernel_check", "kernel": "poa_consensus",
                "input": "largest launch of its depth bucket in the main "
                "run", "windows": dev_in[0].shape[0], "depth": cfg.depth,
                "layers_mean": float(dev_in[3].float().mean()),
                "max_nodes": cfg.max_nodes, "max_len": cfg.max_len,
                "dp_cells": cells, "failed": int(got[3].sum()),
                "plain_windows": len(idx), "plain_dp_cells": pst["cells"],
                "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms / len(kept),
                "plain_on": f"host, {procs} processes, the sampled windows "
                "(all buckets' time split evenly)", "bound_ms": b_ms,
                "bound_by": b_by, "phases": phases, "sm_clock_mhz": mhz}
        emit(line)
        tot.add(line, n_bytes, n_ops)
        per_bucket[cfg.depth] = ms
    return (tot.row(), per_bucket), (kept, samples, plain, plain_ms)


def check_poa_v2(torch, poa_v2_cuda, checked):
    """The v2 kernel, colstep on and off, on the ls main run's kept POA
    launches, against the plain outputs check_poa computed on their
    sampled windows: every sampled output equal; on the sample the
    kernel's cells and serial steps equal the plain version's (steps
    without colstep are the DP rows), on the whole launch its cells equal
    the ls kernel's. Each line also holds the kernel's per-phase times
    (max and mean over the launch's windows, from its clock64() phase
    counts over the SM clock)."""
    kept, samples, plain, plain_ms = checked
    mhz = sm_clock_mhz()
    tot = Totals()
    per_bucket = {}
    for (cells_main, (cfg, dev_in)), (idx, sub), (want, pst) in zip(
            kept, samples, plain):
        line = {"phase": "kernel_check", "kernel": "poa_consensus_v2",
                "input": "largest ls launch of its depth bucket in the main "
                "run", "windows": dev_in[0].shape[0], "depth": cfg.depth,
                "dp_cells": cells_main, "plain_windows": len(idx),
                "plain_dp_cells": pst["cells"]}
        for colstep in (True, False):
            kst, sst = {}, {}
            got = poa_v2_cuda.poa_consensus_v2(cfg, *dev_in, colstep=colstep,
                                               stats=kst)
            poa_v2_cuda.poa_consensus_v2(cfg, *sub, colstep=colstep,
                                         stats=sst)
            torch.cuda.synchronize()
            err = max_abs_err(want, [g[idx] for g in got])
            want_steps = pst["steps"] if colstep else pst["rows"]
            require(err == 0, f"v2 POA kernel (depth {cfg.depth}, colstep "
                    f"{colstep}) differs from its plain version by {err}")
            require(sst["cells"] == pst["cells"] and
                    sst["steps"] == want_steps and
                    kst["cells"] == cells_main,
                    f"v2 POA counts (colstep {colstep}): kernel {sst} on the "
                    f"sample, plain cells {pst['cells']}, steps {want_steps}; "
                    f"kernel cells {kst['cells']} on the launch, ls "
                    f"{cells_main}")
            ms = cuda_ms(torch, lambda: poa_v2_cuda.poa_consensus_v2(
                cfg, *dev_in, colstep=colstep), 3)
            key = "colstep" if colstep else "flat"
            phases = phase_ms(poa_v2_cuda.PHASES, kst, dev_in[0].shape[0],
                              mhz)
            line.update({f"max_abs_err_{key}": err, f"ms_{key}": ms,
                         f"steps_{key}": kst["steps"],
                         f"phases_{key}": phases, "sm_clock_mhz": mhz})
            print_phases(f"v2 POA phases, depth {cfg.depth}, "
                         f"{dev_in[0].shape[0]} windows, {key}", phases, ms)
        line["dp_rows"] = line["steps_flat"]
        line["step_ratio"] = line["steps_flat"] / line["steps_colstep"]
        n_bytes = poa_bytes(dev_in, got)
        n_ops = POA_OPS_PER_CELL * cells_main
        b_ms, b_by = bound(n_bytes, n_ops)
        line.update({"max_abs_err": max(line["max_abs_err_colstep"],
                                        line["max_abs_err_flat"]),
                     "ms": line["ms_colstep"],
                     "plain_ms": plain_ms / len(kept),
                     "plain_on": "the ls check's host pass on the sampled "
                     "windows (one plain version for both kernels)",
                     "bound_ms": b_ms, "bound_by": b_by})
        emit(line)
        tot.add(line, n_bytes, n_ops)
        per_bucket[cfg.depth] = (line["ms_colstep"], line["ms_flat"])
    return tot.row(), per_bucket


def poa_decision(default, ls_ms, v2_ms):
    """The numbers that settle which POA kernel and which v2 DP loop to
    keep, each depth bucket's largest launch timed in this run: v2 (with
    colstep) over ls, and v2 with colstep over v2 without. ls, the JAX
    package's default, stays the default unless v2 is at least 10% faster
    than ls on every bucket (ls_stays_default false); the colstep loop
    stays where it is at least 5% faster than the flat loop on every
    bucket."""
    buckets = sorted(ls_ms)
    require(buckets and sorted(v2_ms) == buckets,
            "the POA decision needs both kernels timed on every bucket")
    v2_over_ls = {d: v2_ms[d][0] / ls_ms[d] for d in buckets}
    colstep_over_flat = {d: v2_ms[d][0] / v2_ms[d][1] for d in buckets}
    return {"phase": "poa_decision", "default": default,
            "ls_ms": ls_ms, "v2_ms": {d: v2_ms[d][0] for d in buckets},
            "v2_flat_ms": {d: v2_ms[d][1] for d in buckets},
            "v2_over_ls": v2_over_ls,
            "ls_stays_default": not all(r <= 0.9 for r in
                                        v2_over_ls.values()),
            "colstep_over_flat": colstep_over_flat,
            "colstep_beats_flat_by_5pct": all(
                r <= 0.95 for r in colstep_over_flat.values())}


def check_poa_band(torch, fn, kernel, rec, procs, run, name=None, *, ex):
    """start_poa_band's check, waited for."""
    return start_poa_band(torch, fn, kernel, rec, procs, run, name, ex=ex)()


def start_poa_band(torch, fn, kernel, rec, procs, run, name=None, *, ex):
    """A POA kernel's banded build (`fn` is its wrapper; `kernel` "v2" or
    "ls", whose banded semantics the plain version runs) on the `run`'s
    largest banded launch of each depth bucket, with band hits and
    without: at wband = 0 every output equals the flat build's on the
    card; at the ladder's wband the six outputs (band_hit included) equal
    the plain version's on a sample of the launch's windows (its hit
    windows first, up to 16, and up to 16 others; the plain version runs
    on the host in `procs` jobs on the pool `ex`), and the band cells the
    kernel counts equal the plain version's on that sample. The time is the
    whole launch's; the bound counts its band cells. Each launch also
    prints a "<kernel> POA phases" line from the banded run's clock64()
    phase counts. `name` is the build's launch-count name (the kernel's
    banded build unless given: its global build). Runs the kernel and
    queues the plain version, then returns a function that waits for it,
    holds the two against each other and gives the kernel's totals."""
    from racon_tpu_torch.ops import poa_cuda, poa_v2_cuda
    from racon_tpu_torch.tools.batches import plain_poa_submit

    mhz = sm_clock_mhz()
    names = (poa_cuda if kernel == "ls" else poa_v2_cuda).PHASES
    name = name or BAND_NAME[kernel]
    kept = rec.inputs(name)
    require(kept, f"no {name} launch was kept to check")
    runs, samples = [], []
    for _, (cfg, dev_in, wband) in kept:
        kst = {}
        got = fn(cfg, *dev_in, wband=wband, stats=kst)
        zero = fn(cfg, *dev_in, wband=torch.zeros_like(wband))
        flat = fn(cfg, *dev_in)
        torch.cuda.synchronize()
        err0 = max_abs_err(flat, zero[:5])
        require(err0 == 0 and not zero[5].any(),
                f"{kernel} banded build at wband 0 (depth {cfg.depth}) "
                f"differs from the flat build by {err0}")
        hit = got[5].cpu()
        idx = torch.cat([torch.nonzero(hit)[:16, 0],
                         torch.nonzero(~hit)[:16, 0]]).sort().values
        sub = [t[idx.to(t.device)].contiguous() for t in dev_in]
        runs.append((cfg, dev_in, wband, got, kst, idx, err0))
        samples.append((cfg, sub, wband[idx.to(wband.device)].contiguous()))
    t0 = time.perf_counter()
    pending = plain_poa_submit(samples, procs, ex, kernel)
    return lambda: finish_poa_band(torch, fn, kernel, names, name, run, mhz,
                                   procs, runs, samples, pending, t0)


def finish_poa_band(torch, fn, kernel, names, name, run, mhz, procs, runs,
                    samples, pending, t0):
    """The second half of start_poa_band."""
    plain = pending()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tot = Totals()
    for (cfg, dev_in, wband, got, kst, idx, err0), (want, pst), \
            (_, sub, swb) in zip(runs, plain, samples):
        err = max_abs_err(want, [g[idx.to(g.device)] for g in got])
        require(err == 0, f"{kernel} banded build (depth {cfg.depth}) "
                f"differs from its plain version by {err}")
        sst = {}
        fn(cfg, *sub, wband=swb, stats=sst)
        require(sst["cells"] == pst["cells"],
                f"band cells: kernel {sst['cells']}, plain {pst['cells']}")
        ms = cuda_ms(torch, lambda: fn(cfg, *dev_in, wband=wband), 3)
        ms_flat = cuda_ms(torch, lambda: fn(cfg, *dev_in), 3)
        phases = phase_ms(names, kst, dev_in[0].shape[0], mhz)
        print_phases(f"{kernel} POA phases, depth {cfg.depth}, "
                     f"{dev_in[0].shape[0]} windows, banded, "
                     f"{int(got[5].sum())} band hits", phases, ms)
        n_bytes = poa_bytes(dev_in, got, wband)
        n_ops = POA_OPS_PER_CELL * kst["cells"]
        b_ms, b_by = bound(n_bytes, n_ops)
        line = {"phase": "kernel_check", "kernel": name,
                "input": "largest banded launch of its depth bucket (with "
                f"band hits or without) in the {run} run",
                "windows": dev_in[0].shape[0],
                "depth": cfg.depth, "wband_mean": float(wband.float().mean()),
                "wband_zero": int((wband == 0).sum()),
                "band_hits": int(got[5].sum()), "failed": int(got[3].sum()),
                "band_cells": kst["cells"], "plain_windows": len(idx),
                "plain_band_cells": pst["cells"],
                "max_abs_err": err, "max_abs_err_wband0_vs_flat": err0,
                "ms": ms, "ms_flat_build": ms_flat,
                "plain_ms": plain_ms / len(runs),
                "plain_on": f"host, {procs} processes, the sampled windows "
                "(all buckets' time split evenly)", "bound_ms": b_ms,
                "bound_by": b_by, "phases": phases, "sm_clock_mhz": mhz}
        emit(line)
        tot.add(line, n_bytes, n_ops)
    return tot.row()


def check_edge(torch, ac, rec, name="hirschberg_edge", run="main"):
    """The `run`'s largest launch of kernel `name` for each band and
    direction, the whole batch held against the plain version on the
    card, and timed in three rounds of ten calls (min, median and max of
    the rounds' means: the spread between calls). Each launch also prints
    an "edge phases" line (ns a row, max and mean over the launch's tasks,
    from the kernel's clock64() cycles over the card's highest SM clock,
    and the launch's waves), and each band and direction of the kernel an
    occupancy line."""
    tot = Totals()
    kept = rec.inputs(name)
    require(kept, f"no {name} launch of the {run} run was kept to check")
    mhz = sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cells, (scal, q, t, K, backward) in kept:
        B = scal.shape[0]
        cycles = torch.zeros(B, dtype=torch.int64, device=scal.device)
        got = ac.edge_rows(scal, q, t, K, backward, cycles=cycles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ac.edge_rows_plain(scal, q, t, K, backward)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err([want], [got])
        require(err == 0, f"edge kernel (K={K}, backward={backward}) "
                f"differs from its plain version by {err}")
        rounds = sorted(cuda_ms(torch, lambda: ac.edge_rows(
            scal, q, t, K, backward), 10) for _ in range(3))
        ms = rounds[1]
        n_bytes = nbytes((scal, q, t, got))
        n_ops = EDGE_OPS_PER_CELL * cells
        b_ms, b_by = bound(n_bytes, n_ops)
        lanes = lane_cells(scal, K)
        R = scal[:, 0].cpu()
        occ = ac.edge_occupancy(K, backward)
        run_rows = R > 0
        ns_row = (cycles.cpu()[run_rows].double() / R[run_rows].double()
                  / mhz * 1e3)
        phases = {"tasks": B, "rows_mean": float(R.float().mean()),
                  "ns_per_row_max": float(ns_row.max()),
                  "ns_per_row_mean": float(ns_row.mean()),
                  "waves": B / (sms * occ["warps_per_sm"]),
                  "sm_clock_mhz": mhz}
        print(f"edge phases, K={K}, backward={backward}: "
              + json.dumps(phases), flush=True)
        line = {"phase": "kernel_check", "kernel": name,
                "input": "largest launch of its band and direction in the "
                f"{run} run", "K": K, "rcap": q.shape[1],
                "backward": backward, "tasks": len(R),
                "rows_mean": float(R.float().mean()), "band_cells": cells,
                "lane_cells": lanes, "ps_per_lane_cell": ms * 1e9 / lanes,
                "max_abs_err": err, "ms": ms,
                "ms_rounds": {"min": rounds[0], "median": rounds[1],
                              "max": rounds[2]},
                "plain_ms": plain_ms,
                "plain_on": "cuda", "bound_ms": b_ms, "bound_by": b_by,
                "phases": phases}
        emit(line)
        tot.add(line, n_bytes, n_ops)
    for K in ((128,) if name.endswith("_k128") else ac.BANDS):
        for backward in (False, True):
            emit({"phase": "occupancy", "kernel": name, "K": K,
                  "backward": backward, **ac.edge_occupancy(K, backward)})
    return tot.row()


def check_base(torch, ac, rec, name="hirschberg_base", run="main"):
    """The `run`'s largest launch of base-case kernel `name` for each band,
    the whole batch held against the plain version (DP on the card,
    traceback on the host). Each band also prints the kernel's phases (DP
    rows and traceback: max and mean over the launch's tasks, from its
    clock64() cycles over the card's highest SM clock) and its occupancy
    line."""
    tot = Totals()
    kept = rec.inputs(name)
    require(kept, f"no {name} launch of the {run} run was kept to check")
    mhz = sm_clock_mhz()
    for cells, (scal, q, t, K) in kept:
        B = scal.shape[0]
        cycles = torch.zeros((2, B), dtype=torch.int64, device=scal.device)
        got = ac.base_case(scal, q, t, K, cycles=cycles)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ac.base_plain(scal, q, t, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = max_abs_err(want, got)
        require(err == 0, f"base kernel (K={K}) differs from its plain "
                f"version by {err}")
        ms = cuda_ms(torch, lambda: ac.base_case(scal, q, t, K), 10)
        lanes = lane_cells(scal, K)
        n_bytes = nbytes((scal, q, t)) + nbytes(got)
        n_ops = BASE_OPS_PER_CELL * cells
        b_ms, b_by = bound(n_bytes, n_ops)
        cyc = cycles.cpu().double()
        phases = {n: {"max_ms": float(c.max()) / (mhz * 1e3),
                      "mean_ms": float(c.mean()) / (mhz * 1e3)}
                  for n, c in zip(("dp", "traceback"), cyc)}
        print(f"base case phases, K={K}, {B} tasks ({ms:.3f} ms a launch; "
              "max / mean ms over tasks): " + ", ".join(
                  f"{n} {v['max_ms']:.3f} / {v['mean_ms']:.4f}"
                  for n, v in phases.items()), flush=True)
        line = {"phase": "kernel_check", "kernel": name,
                "input": f"largest launch of its band in the {run} run",
                "K": K, "tasks": B, "band_cells": cells,
                "lane_cells": lanes, "ps_per_lane_cell": ms * 1e9 / lanes,
                "tasks_in_band": int(want[2].sum()), "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "plain_on": "cuda + host traceback", "bound_ms": b_ms,
                "bound_by": b_by, "phases": phases, "sm_clock_mhz": mhz}
        emit(line)
        emit({"phase": "occupancy", "kernel": name, "K": K,
              **ac.base_occupancy(K)})
        tot.add(line, n_bytes, n_ops)
    return tot.row()


def read_fasta(path: str) -> bytes:
    with open(path) as f:
        return "".join(ln.strip() for ln in f
                       if not ln.startswith(">")).encode()


def polish(racon_tpu_torch, d, device, poa_kernel="ls", band=None,
           window_length=MAIN["window_length"]):
    """One polish of data set `d`; `band`, when given, is the banded
    path's slack (band=True)."""
    kw = {} if band is None else dict(band=True, band_slack=band)
    return polish_with(racon_tpu_torch, d, device, poa_kernel=poa_kernel,
                       **{**MAIN, "window_length": window_length}, **kw)


def polish_with(racon_tpu_torch, d, device, **kw):
    """One polish of data set `d` with TorchPolisher's keyword arguments
    `kw` (MAIN's by default): (FASTA records, stats, seconds)."""
    p = racon_tpu_torch.TorchPolisher(d["reads"], d["overlaps"], d["draft"],
                                      device=device, **{**MAIN, **kw})
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    return out, p.stats, time.perf_counter() - t0


def cpu_polish(d, band=None, poa_kernel="v2",
               window_length=MAIN["window_length"]):
    """The port's CPU polish of `d` (the plain versions), in a worker
    process of its own: (FASTA records, stats, seconds)."""
    import torch

    sys.path.insert(0, ROOT)
    import racon_tpu_torch

    torch.set_num_threads(1)
    return polish(racon_tpu_torch, d, "cpu", poa_kernel, band,
                  window_length)


# The launch-count names of each poa_kernel's flat and banded builds.
POA_NAME = {"ls": "poa_consensus", "v2": "poa_consensus_v2"}
BAND_NAME = {"ls": "poa_consensus_band", "v2": "poa_consensus_v2_band"}


def check_launches(path: str, launches: dict, poa_kernel=None,
                   band_names=()) -> None:
    """Every kernel of the path launched; a polish path (poa_kernel given)
    launched its POA kernel's build (on a banded path, whose band_names are
    the kernels it must launch, the banded build) and no other POA
    build."""
    names = (("dp_cost_probe",) if poa_kernel is None else
             (POA_NAME[poa_kernel], "hirschberg_edge", "hirschberg_base"))
    names = band_names or names
    for name in names:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the {path} path")
    if poa_kernel is None:
        return
    own = (BAND_NAME if band_names else POA_NAME)[poa_kernel]
    for name in (*POA_NAME.values(), *BAND_NAME.values()):
        if name != own:
            require(launches[name] == 0, f"the {path} path launched {name}")


def band_vs_flat(path: str, band_run, flat_run) -> dict:
    """A banded run against the flat run of the same cell: whether the
    FASTA is the same and, where it is not, how many windows' consensus
    differs (or was installed by the kernels in one run only) and the
    first of them. Printed, not required: the banded path gives the flat
    bytes by the reference's design, and a difference is a fault to log."""
    same = band_run[0] == flat_run[0]
    line = {"phase": f"{path}_vs_flat", "identical": same}
    if not same:
        wb, wf = band_run[1].windows, flat_run[1].windows
        diff = sorted(i for i in set(wb) | set(wf) if wb.get(i) != wf.get(i))
        line.update(windows_differing=len(diff),
                    first_window_differing=diff[0] if diff else None)
    return line


def run_main(torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d,
             gen_s, poa_kernel, path, band=None, band_names=(), mbp=1.0):
    """One recorded polish of a cell (the main cell unless `d` is another
    data set of `mbp` Mbp), banded where `band` (the slack) is given: the
    launch counts are set to 0 just before it and read just after."""
    rec = MainPathRecorder(torch, ac, poa_driver)
    cuda_lib.reset_launches()
    with rec:
        out, st, wall = polish(racon_tpu_torch, d, "cuda", poa_kernel, band)
    launches = dict(cuda_lib.LAUNCHES)
    on_main = rec.summary()
    genome = read_fasta(d["genome"])
    draft = read_fasta(d["draft"])
    polished = "".join(s for _, s in out).encode()
    ed_draft = native.edit_distance(draft, genome)
    ed_polished = native.edit_distance(polished, genome)
    al, co = st["align"], st["consensus"]
    line = {"phase": path, "poa_kernel": poa_kernel, "mbp": mbp,
            "coverage": 30, "generate_s": gen_s, "wall_s": wall,
            "phase_s": {k[:-2]: v for k, v in st.items()
                        if k.endswith("_s")},
            "align_jobs": {"device": al["device"], "host": al["host"],
                           "host_s": al["host_seconds"]},
            "windows": {"device": co["device"],
                        "host_refailed": co["host_fallback"],
                        "kernel_failed": co["failed"],
                        "backbone": co["backbone"],
                        "layers_dropped": co["layers_dropped"],
                        "batches": co["batches"]},
            "launches": launches, "kernels": on_main,
            "kernel_busy": sum(r["device_ms"] for r in on_main.values())
            / 1e3 / wall, "contigs": len(out),
            "edit_distance": {"draft": ed_draft, "polished": ed_polished}}
    if poa_kernel == "v2":
        line["poa_v2_steps"] = rec.steps
    if band is not None:
        line.update(band_slack=band, band={"align": al["band"],
                                           "consensus": co["band"]})
    emit(line)
    require(al["device"] > 0, "no alignment job was served on the card")
    require(co["device"] > 0, "no window was served on the card")
    check_launches(path, launches, poa_kernel, band_names)
    require(ed_polished < ed_draft, "polishing did not lower the edit "
            f"distance ({ed_draft} -> {ed_polished})")
    return out, rec, launches, on_main, wall


def recorded_polish(torch, racon_tpu_torch, ac, poa_driver, cuda_lib, d,
                    kernel, window_length, band=None):
    """One polish of `d` on the card, recorded as the main run is
    (MainPathRecorder: each launch's device ms, DP cells and bound), with
    the launch counts set to 0 just before it and read just after:
    (FASTA records, stats, seconds, launches, per-kernel summary,
    recorder)."""
    rec = MainPathRecorder(torch, ac, poa_driver)
    cuda_lib.reset_launches()
    with rec:
        out, st, wall = polish(racon_tpu_torch, d, "cuda", kernel, band,
                               window_length)
    launches = dict(cuda_lib.LAUNCHES)
    return out, st, wall, launches, rec.summary(), rec


def poa_summary(summary, names) -> dict:
    """The POA builds' launches, device ms and bound ms of a recorded run."""
    return {n: {k: summary[n][k] for k in ("launches", "device_ms",
                                           "bound_ms")}
            for n in names if n in summary}


def wide_phase(torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d,
               cpu_run):
    """The wide set (-w 1500) on the card with each POA kernel, each polish
    recorded (recorded_polish: its POA launches' device ms and bound from
    their DP cells), against the CPU polish of the plain versions
    (`cpu_run`, a future): the same bytes, the edit distance to the truth
    lowered, and every window with at least two layers served on the card
    (none to the host). Then the wide builds' resources at -w 1500's and
    -w 2000's geometries."""
    from racon_tpu_torch.ops import poa_cuda, poa_v2_cuda

    runs = {}
    for kernel in ("ls", "v2"):
        runs[kernel] = recorded_polish(torch, racon_tpu_torch, ac,
                                       poa_driver, cuda_lib, d, kernel,
                                       WIDE_WINDOW)
        launches = runs[kernel][3]
        check_launches(f"wide_{kernel}", launches, kernel)
        co = runs[kernel][1]["consensus"]
        require(co["device"] > 0 and co["host_fallback"] == 0 and
                co["failed"] == 0, f"wide_{kernel}: windows went to the "
                f"host ({co})")
    cpu, cst, cpu_s = cpu_run.result()
    require(runs["ls"][0] == runs["v2"][0] == cpu, "the wide set's FASTAs "
            "differ between the POA kernels or between card and CPU")
    genome, draft = read_fasta(d["genome"]), read_fasta(d["draft"])
    polished = "".join(s for _, s in cpu).encode()
    ed = (native.edit_distance(draft, genome),
          native.edit_distance(polished, genome))
    require(ed[1] < ed[0], f"the wide polish did not lower the edit distance "
            f"({ed[0]} -> {ed[1]})")
    co = runs["ls"][1]["consensus"]
    emit({"phase": "wide", "mbp": WIDE_MBP, "window_length": WIDE_WINDOW,
          "identical": True, "cuda_ls_s": runs["ls"][2],
          "cuda_v2_s": runs["v2"][2], "cpu_s": cpu_s,
          "launches": {k: r[3][POA_NAME[k]] for k, r in runs.items()},
          "poa_device_ms": {k: r[4][POA_NAME[k]]["device_ms"]
                            for k, r in runs.items()},
          "poa_bound_ms": {k: r[4][POA_NAME[k]]["bound_ms"]
                           for k, r in runs.items()},
          "poa": {k: poa_summary(r[4], (POA_NAME[k],))
                  for k, r in runs.items()},
          "windows": {k: co[k] for k in ("device", "host_fallback",
                                         "backbone", "failed")},
          "cpu_windows_device": cst["consensus"]["device"],
          "edit_distance": {"draft": ed[0], "polished": ed[1]}})
    for wl in (1536, 2048):
        emit(occupancy_line(poa_driver, poa_cuda, poa_v2_cuda, wl, "wide"))


def occupancy_line(poa_driver, poa_cuda, poa_v2_cuda, wl, build) -> dict:
    """Each POA build's plan, registers, spill bytes, shared bytes and
    blocks per SM at window class `wl`'s geometry (depth 32)."""
    cfg = poa_driver.make_config(wl, 32, MAIN["match"], MAIN["mismatch"],
                                 MAIN["gap"])
    return {"phase": "occupancy", "build": build, "window_class": wl,
            "max_nodes": cfg.max_nodes, "max_len": cfg.max_len,
            "ls_plan": poa_cuda.plan(cfg),
            "ls_band_plan": poa_cuda.plan(cfg, band=True),
            "v2_plan": poa_v2_cuda.plan(cfg),
            "v2_band_plan": poa_v2_cuda.plan(cfg, band=True),
            "poa_consensus": poa_cuda.occupancy(cfg),
            "poa_consensus_band": poa_cuda.occupancy(cfg, band=True),
            "poa_consensus_v2": poa_v2_cuda.occupancy(cfg),
            "poa_consensus_v2_band": poa_v2_cuda.occupancy(cfg, band=True)}


# The launch-count names of each poa_kernel's global builds, flat and banded.
GLOBAL_NAME = {k: v + "_global" for k, v in POA_NAME.items()}
GLOBAL_BAND_NAME = {k: v + "_global" for k, v in BAND_NAME.items()}


# ... and of their global builds with int32 node ids (classes above 10,880).
GLOBAL32_NAME = {k: v + "32" for k, v in GLOBAL_NAME.items()}
GLOBAL32_BAND_NAME = {k: v + "32" for k, v in GLOBAL_BAND_NAME.items()}


def global_runs(torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d,
                cpu_run, phase, window, mbp, flat_names, band_names,
                lower_ed=True):
    """A set at a window of `window` bases through both POA kernels'
    global builds (`flat_names`, `band_names`: the launch names of each
    kernel's flat and banded one) on the card, flat and banded (slack
    PARITY_SLACK), each polish recorded with the launch counts set to 0
    just before it and read just after: each path launched its kernel's
    global build (banded on the banded paths), no other kernel's POA
    build, and sent no window to the host; the flat FASTAs equal the CPU
    polish's (`cpu_run`, plain versions), and (`lower_ed`) the polish
    lowers the edit distance to the truth; whether each banded FASTA
    equals the flat one is printed (the `phase` line). Returns the runs by
    path."""
    runs = {}
    for kernel in ("ls", "v2"):
        for band in (None, PARITY_SLACK):
            path = f"{phase}_{kernel}" + ("_band" if band else "")
            r = recorded_polish(torch, racon_tpu_torch, ac, poa_driver,
                                cuda_lib, d, kernel, window, band)
            runs[path] = r
            launches = r[3]
            own = (band_names if band else flat_names)[kernel]
            need = (own, "hirschberg_edge") if band else (
                own, "hirschberg_edge", "hirschberg_base")
            for name in need:   # a banded job's edge rows at K = 128 count
                n = launches[name] + (launches["hirschberg_edge_k128"]
                                      if band and name == need[1] else 0)
                require(n > 0, f"kernel {name} was not launched on the "
                        f"{path} path")
            for other in ("ls", "v2"):
                if other != kernel:
                    for n in (POA_NAME, BAND_NAME, GLOBAL_NAME,
                              GLOBAL_BAND_NAME, GLOBAL32_NAME,
                              GLOBAL32_BAND_NAME):
                        require(launches[n[other]] == 0,
                                f"{path} launched {n[other]}")
            co = r[1]["consensus"]
            require(co["device"] > 0 and co["host_fallback"] == 0 and
                    co["failed"] == 0, f"{path}: windows went to the host "
                    f"({co})")
    cpu, cst, cpu_s = cpu_run.result()
    flat = runs[f"{phase}_ls"][0]
    require(flat == runs[f"{phase}_v2"][0] == cpu, f"the {phase} set's "
            "FASTAs differ between the POA kernels or between card and CPU")
    genome, draft = read_fasta(d["genome"]), read_fasta(d["draft"])
    polished = "".join(s for _, s in cpu).encode()
    ed = (native.edit_distance(draft, genome),
          native.edit_distance(polished, genome))
    require(ed[1] < ed[0] or not lower_ed, f"the {phase} polish did not "
            f"lower the edit distance ({ed[0]} -> {ed[1]})")
    names = (*POA_NAME.values(), *BAND_NAME.values(),
             *GLOBAL_NAME.values(), *GLOBAL_BAND_NAME.values(),
             *GLOBAL32_NAME.values(), *GLOBAL32_BAND_NAME.values())
    emit({"phase": phase, "mbp": mbp, "window_length": window,
          "identical": True,
          "banded_equals_flat": {p: r[0] == flat for p, r in runs.items()
                                 if p.endswith("_band")},
          "cuda_s": {p: r[2] for p, r in runs.items()}, "cpu_s": cpu_s,
          "poa": {p: poa_summary(r[4], names) for p, r in runs.items()},
          "band": {p: r[1]["consensus"]["band"] for p, r in runs.items()
                   if p.endswith("_band")},
          "windows": {p: {k: r[1]["consensus"][k] for k in (
              "device", "host_fallback", "backbone", "failed")}
              for p, r in runs.items()},
          "cpu_windows_device": cst["consensus"]["device"],
          "edit_distance": {"draft": ed[0], "polished": ed[1]},
          "lengths": {"genome": len(genome), "polished": len(polished)}})
    return runs


def path_counts(runs, phase, flat_names, band_names):
    """Each global build's path (launches, summary) from global_runs."""
    path_of = {flat_names[k]: runs[f"{phase}_{k}"][3:5] for k in ("ls", "v2")}
    path_of.update({band_names[k]: runs[f"{phase}_{k}_band"][3:5]
                    for k in ("ls", "v2")})
    return path_of


def wide3_phase(torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d,
                cpu_run, procs, ex):
    """The -w 3000 set (window class 3072: both POA kernels' global
    builds, int16 node ids) through global_runs; then each global build on
    its path's largest launch against the plain version (start_global,
    start_poa_band; their plain passes on the pool `ex` at once), and an
    occupancy line per global geometry. Returns
    (kernel-check rows, path of each global build: (launches,
    summary))."""
    from racon_tpu_torch.ops import poa_cuda, poa_v2_cuda

    runs = global_runs(torch, racon_tpu_torch, native, ac, poa_driver,
                       cuda_lib, d, cpu_run, "wide_3000", WIDE3_WINDOW,
                       WIDE3_MBP, GLOBAL_NAME, GLOBAL_BAND_NAME)
    # the three checks' plain passes (a few windows each, every window a
    # job) run on the pool at once
    pending = {"flat": start_global(torch, runs["wide_3000_ls"][5], procs,
                                    ex)}
    for kernel in ("ls", "v2"):
        fn = (poa_cuda.poa_consensus if kernel == "ls"
              else poa_v2_cuda.poa_consensus_v2)
        pending[kernel] = start_poa_band(
            torch, fn, kernel, runs[f"wide_3000_{kernel}_band"][5], procs,
            f"wide_3000_{kernel}_band", GLOBAL_BAND_NAME[kernel], ex=ex)
    rows = pending.pop("flat")()
    for kernel, finish in pending.items():
        rows[GLOBAL_BAND_NAME[kernel]] = finish()
    for wl in (3072, 4096, 10880):
        emit(occupancy_line(poa_driver, poa_cuda, poa_v2_cuda, wl, "global"))
    return rows, path_counts(runs, "wide_3000", GLOBAL_NAME,
                             GLOBAL_BAND_NAME)


def wide11_phase(torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d,
                 cpu_run, plain):
    """The -w 11008 set (window class 11,008, above the int16 node ids:
    both POA kernels' global builds with int32 ids) through global_runs;
    then each int32 build on its smallest launch against the plain
    version (check_global32, with `plain`), and an occupancy line at
    classes 11,008 and 22,016. The set's one window spans its contig, so
    racon's trim of the low-coverage ends (reads of ≈8 kb cover a
    contig's first and last kilobases thinly) cuts ≈1.5 kb, and the
    polish does not lower the edit distance to the truth: printed, not
    required; the bytes must be the CPU's. Returns (kernel-check rows,
    path of each int32 build)."""
    from racon_tpu_torch.ops import poa_cuda, poa_v2_cuda

    runs = global_runs(torch, racon_tpu_torch, native, ac, poa_driver,
                       cuda_lib, d, cpu_run, "wide_11008", WIDE11_WINDOW,
                       WIDE11_MBP, GLOBAL32_NAME, GLOBAL32_BAND_NAME,
                       lower_ed=False)
    rows = check_global32(torch, plain)
    for wl in (11008, 22016):
        emit(occupancy_line(poa_driver, poa_cuda, poa_v2_cuda, wl,
                            "global32"))
    return rows, path_counts(runs, "wide_11008", GLOBAL32_NAME,
                             GLOBAL32_BAND_NAME)


#: The int32 builds' check batch: batches.wide_id_batch at class 11,008,
#: depth 200, and the banded builds' half bands.
WIDE_ID_WBAND = (24, 0)


def wide_id_config():
    from racon_tpu_torch.ops import poa_driver

    return poa_driver.make_config(WIDE11_WINDOW, 200, MAIN["match"],
                                  MAIN["mismatch"], MAIN["gap"])


def plain_wide_id(band_kernel=None):
    """The plain version on the int32 builds' check batch, in a worker
    process: flat, or under WIDE_ID_WBAND with `band_kernel`'s banded
    semantics; (numpy outputs, stats, ms)."""
    import torch

    sys.path.insert(0, ROOT)
    from racon_tpu_torch.ops import poa
    from racon_tpu_torch.tools import batches

    torch.set_num_threads(1)
    cfg = wide_id_config()
    wb = None if band_kernel is None else torch.tensor(WIDE_ID_WBAND,
                                                       dtype=torch.int32)
    st = {}
    t0 = time.perf_counter()
    outs = poa.poa_batch_plain(
        cfg, *poa.batch_to_tensors(batches.wide_id_batch(cfg), "cpu"),
        stats=st, wband=wb, kernel=band_kernel or "v2")
    return [o.numpy() for o in outs], st, (time.perf_counter() - t0) * 1e3


def check_global32(torch, plain):
    """Each POA kernel's int32 global build, flat and banded
    (WIDE_ID_WBAND), on its smallest launch: batches.wide_id_batch at
    class 11,008, depth 200, two windows, one of whose graphs passes node
    id 32,767 (32,890 nodes), held against the plain version on the host
    (`plain`: futures of plain_wide_id, flat and for each kernel's banded
    semantics), the DP cells equal; each timed (three calls) beside its
    bound, with its phases line."""
    from racon_tpu_torch.ops import poa, poa_cuda, poa_v2_cuda
    from racon_tpu_torch.tools import batches

    mhz = sm_clock_mhz()
    cfg = wide_id_config()
    dev_in = poa.batch_to_tensors(batches.wide_id_batch(cfg), "cuda")
    wband = torch.tensor(WIDE_ID_WBAND, dtype=torch.int32, device="cuda")
    runs = {k: f.result() for k, f in plain.items()}
    flat_plain = runs[None][:2]
    require(int(flat_plain[0][4][1]) == 32890,
            "the wide-id batch's graph does not pass node id 32,767")
    rows = {}
    for kernel, mod in (("ls", poa_cuda), ("v2", poa_v2_cuda)):
        fn = (mod.poa_consensus if kernel == "ls" else mod.poa_consensus_v2)
        for band, (want, pst, plain_ms) in ((False, runs[None]),
                                            (True, runs[kernel])):
            want = [torch.from_numpy(w) for w in want]
            kw = {"wband": wband} if band else {}
            name = (GLOBAL32_BAND_NAME if band else GLOBAL32_NAME)[kernel]
            require(poa_cuda.build_name(mod.plan, POA_NAME[kernel], cfg,
                                        band)[1] == name,
                    f"{kernel}: class 11,008 does not take {name}")
            kst = {}
            got = fn(cfg, *dev_in, stats=kst, **kw)
            torch.cuda.synchronize()
            err = max_abs_err(want, got)
            require(err == 0, f"{name} differs from its plain version by "
                    f"{err}")
            require(kst["cells"] == pst["cells"], f"{name} cells: kernel "
                    f"{kst['cells']}, plain {pst['cells']}")
            ms = cuda_ms(torch, lambda: fn(cfg, *dev_in, **kw), 3)
            phases = phase_ms(mod.PHASES, kst, 2, mhz)
            print_phases(f"{kernel} POA phases, depth 200, 2 windows, int32 "
                         "global build" + (", banded" if band else ""),
                         phases, ms)
            n_bytes = poa_bytes(dev_in, got, wband if band else None)
            n_ops = POA_OPS_PER_CELL * pst["cells"]
            b_ms, b_by = bound(n_bytes, n_ops)
            line = {"phase": "kernel_check", "kernel": name,
                    "input": "batches.wide_id_batch: 2 windows of class "
                    "11,008, one with 32,890 nodes", "windows": 2,
                    "depth": 200, "max_nodes": cfg.max_nodes,
                    "max_len": cfg.max_len, "n_nodes": got[4].tolist(),
                    "wband": wband.tolist() if band else None,
                    "dp_cells": pst["cells"], "failed": int(got[3].sum()),
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "plain_on": "host, one process",
                    "bound_ms": b_ms, "bound_by": b_by, "phases": phases,
                    "sm_clock_mhz": mhz}
            emit(line)
            tot = Totals()
            tot.add(line, n_bytes, n_ops)
            rows[name] = tot.row()
    return rows


def chunked_phase(racon_tpu_torch, native, cuda_lib, d, gen_s):
    """The chunked cell polished on the card in each CHUNKED_MODES mode,
    each with the launch counts set to 0 just before it and read just
    after: every mode's FASTA equal to the sequential one's, the edit
    distance to the truth lowered, the ls kernel and both aligner kernels
    launched in each; one line a mode with the wall by phase, the
    consensus feeder's pack and kernel wall, the seconds in which
    alignment (and the whole of a chunk's parse, alignment and windows)
    overlapped consensus, the process's peak RSS (this smoke's, not the
    polish's alone: the phases before it ran in this process) and the
    chunk count."""
    from racon_tpu_torch.resilience.budget import peak_rss_mb

    runs = {}
    for mode in CHUNKED_MODES:
        cuda_lib.reset_launches()
        out, st, wall = polish_with(racon_tpu_torch, d, "cuda",
                                    **CHUNKED_MODES[mode])
        runs[mode] = (out, st, wall, dict(cuda_lib.LAUNCHES), peak_rss_mb())
    seq = runs["sequential"][0]
    genome, draft = read_fasta(d["genome"]), read_fasta(d["draft"])
    ed = (native.edit_distance(draft, genome), native.edit_distance(
        "".join(s for _, s in seq).encode(), genome))
    for mode, (out, st, wall, launches, rss) in runs.items():
        co = st["consensus"]
        emit({"phase": "chunked", "mode": mode, **CHUNKED_MODES[mode],
              "mbp": CHUNKED["mbp"], "contigs": CHUNKED["contigs"],
              "generate_s": gen_s, "wall_s": wall,
              "phase_s": {k[:-2]: v for k, v in st.items()
                          if k[:-2] in CHUNK_PHASES},
              "pack_wall_s": co["pack_wall_s"],
              "kernel_wall_s": co["kernel_wall_s"],
              "overlap_s": st.get("overlap_s", 0.0),
              "prep_overlap_s": st.get("prep_overlap_s", 0.0),
              "peak_rss_mb": rss, "chunks": st.get("chunks", 1),
              "chunk_s": st.get("chunk_s"),
              "pressure_level": st.get("pressure_level"),
              "quarantined": st.get("quarantined"),
              "identical": out == seq,
              "windows": {k: co[k] for k in ("device", "host_fallback",
                                             "backbone", "failed",
                                             "batches")},
              "align_jobs": {k: st["align"][k] for k in ("device",
                                                         "host")},
              "launches": {k: v for k, v in launches.items() if v},
              "edit_distance": {"draft": ed[0], "polished": ed[1]}})
        require(out == seq, f"the chunked set's {mode} FASTA differs from "
                "the sequential one's")
        check_launches(f"chunked_{mode}", launches, "ls")
        require(mode == "sequential" or st.get("chunks") == 3,
                f"the {mode} polish did not run in three chunks (the "
                "split's hint: handoff_depth 1 + 2)")
    require(ed[1] < ed[0], "the chunked polish did not lower the edit "
            f"distance ({ed[0]} -> {ed[1]})")
    return seq, runs["sequential"][2]


def fasta_text(records) -> str:
    return "".join(f">{n}\n{s}\n" for n, s in records)


def distrib_run(reader, d, tmp, name, workers, fault=None):
    """One ``python -m racon_tpu_torch.cli distrib`` polish of `d` on the
    card with `workers` workers and DISTRIB_CHUNKS chunks, traced, with
    `fault` as RACON_TORCH_FAULT (the coordinator hands it to worker 0
    alone): (its FASTA, its wall, the coordinator's result.json, the
    device track of every chunk trace merged as ``obs merge`` merges
    them, the fleet breakdown of those merged with the coordinator's
    trace, which holds the dispatches, and critpath_summary's reading of
    the coordinator's trace)."""
    import glob

    from racon_tpu_torch.serve.scheduler import child_env

    state = os.path.join(tmp, name)
    out = os.path.join(tmp, f"{name}.fasta")
    trace = os.path.join(tmp, f"{name}.trace.json")
    cmd = [sys.executable, "-m", "racon_tpu_torch.cli", "distrib",
           "--workers", str(workers), "--chunks", str(DISTRIB_CHUNKS),
           "--state-dir", state, "--trace", trace, "--report",
           os.path.join(tmp, f"{name}.report.json"), "-o", out,
           "-w", str(MAIN["window_length"]), "-m", str(MAIN["match"]),
           "-x", str(MAIN["mismatch"]), "-g", str(MAIN["gap"]),
           d["reads"], d["overlaps"], d["draft"]]
    env = child_env()
    env.pop("RACON_TORCH_FAULT", None)
    if fault:
        env["RACON_TORCH_FAULT"] = fault
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, text=True, timeout=900)
    wall = time.perf_counter() - t0
    require(r.returncode == 0, f"{name}: distrib exited {r.returncode}: "
            f"{r.stderr[-2000:]}")
    with open(os.path.join(state, "result.json")) as f:
        result = json.load(f)
    with open(out) as f:
        text = f.read()
    traces = sorted(glob.glob(os.path.join(state, "chunks", "*",
                                           "trace.a*.json")))
    docs = []
    for path in [trace] + traces:
        doc, errors = reader.load_trace(path)
        require(not errors, f"{name}: trace {path}: {errors[:5]}")
        docs.append(doc)
    track = reader.device_track(reader.merge_traces(docs[1:], traces))
    return text, wall, result, track, reader.fleet_breakdown(
        reader.merge_traces(docs, [trace] + traces)), \
        critpath_summary(name, docs[0])


def critpath_summary(phase, doc) -> dict:
    """``obs critpath`` on a distrib run's coordinator trace, the merged
    timeline of the run: its dispatches, and each chunk's spans as the
    worker shipped them with its result (merging the chunk traces into it
    as well would count every chunk span twice). Required: every chunk of
    the run appears under a job, and each job's stages and unattributed
    wall sum to its wall without overshooting it. Returns each job's
    stages (ms) and unattributed share."""
    from racon_tpu_torch.obs import critpath

    res = critpath.analyze(doc, profile="h100")
    chunk_ids = {(ev.get("args") or {}).get("chunk")
                 for ev in doc["traceEvents"]
                 if ev.get("ph") == "X" and ev.get("name") == "distrib.chunk"}
    require(chunk_ids == set(range(DISTRIB_CHUNKS)), f"{phase}: critpath "
            f"sees chunks {sorted(chunk_ids, key=str)}")
    require(res["jobs"] and sum(j["chunks"] for j in res["jobs"]) ==
            res["chunks"], f"{phase}: critpath attributes "
            f"{[j['chunks'] for j in res['jobs']]} of {res['chunks']} "
            "chunk spans to jobs")
    jobs = []
    for j in res["jobs"]:
        staged = sum(j["path_us"].values())
        require(abs(staged + j["unattributed_us"] - j["wall_us"]) <= 1.0 +
                0.5 * len(j["path_us"]) and staged <= j["wall_us"] + 1.0 +
                0.5 * len(j["path_us"]), f"{phase}: job {j['job']}'s "
                f"stages {staged} us and unattributed {j['unattributed_us']}"
                f" us against its wall {j['wall_us']} us")
        jobs.append({"job": j["job"], "chunks": j["chunks"],
                     "wall_ms": j["wall_us"] / 1e3,
                     "stages_ms": {k: v / 1e3 for k, v in j["path_us"].items()},
                     "unattributed_ms": j["unattributed_us"] / 1e3,
                     "unattributed_frac": j["unattributed_frac"]})
    return {"chunk_spans": res["chunks"], "jobs": jobs}


def distrib_line(phase, workers, mbp, text, wall, result, track, seq_fasta,
                 seq_wall, breakdown, crit):
    """A distrib phase's line, after its checks that hold for every
    phase: the sequential FASTA, every chunk served by the fleet (none
    locally), kernel_builds 0 in every chunk, the ls POA, edge and
    base-case kernels launched, summed over the chunks, the dispatch ->
    chunk parenting of the merged traces, and no CUDA context in the
    coordinator."""
    require(text == seq_fasta, f"{phase}: the FASTA differs from the "
            "sequential polish's")
    served = result["served"]
    require(result["chunks"] == DISTRIB_CHUNKS and
            served.get("fleet") == DISTRIB_CHUNKS and
            not served.get("local"), f"{phase}: served {served} of "
            f"{result['chunks']} chunks")
    rows = result["chunk_stats"]
    builds = [r.get("kernel_builds") for r in rows]
    require(builds == [0] * DISTRIB_CHUNKS, f"{phase}: kernel_builds by "
            f"chunk {builds}")
    launches = {}
    for r in rows:
        for k, v in (r.get("launches") or {}).items():
            launches[k] = launches.get(k, 0) + v
    for k in ("poa_consensus", "hirschberg_edge", "hirschberg_base"):
        require(launches.get(k, 0) > 0, f"{phase}: kernel {k} was not "
                "launched in any chunk")
    require(not breakdown["violations"], f"{phase}: the merged traces: "
            f"{breakdown['violations']}")
    require(result["cuda_context"] is False, f"{phase}: the coordinator "
            "created a CUDA context")
    per_worker = {w: {k: s.get(k) for k in ("chunks", "chunk_walls",
                                            "rss_mb", "device_peak_mb")}
                  for w, s in result["telemetry"]["workers"].items()}
    return {"phase": phase, "workers": workers, "chunks": result["chunks"],
            "mbp": mbp, "wall_s": wall, "sequential_wall_s": seq_wall,
            "vs_sequential": wall / seq_wall, "served": served,
            "counters": result["counters"],
            "memory_share": result["memory_share"],
            "build_s": result["build_s"],
            "coordinator_startup_s": result["startup_s"],
            "coordinator_run_s": result["run_s"],
            "worker_start": result["worker_start"],
            "per_worker": per_worker,
            "chunks_by_index": [
                {k: r.get(k) for k in ("index", "worker", "attempt",
                                       "attempts", "wall_s",
                                       "journal_replayed",
                                       "kernel_builds")} for r in rows],
            "device_budget_mb": sorted({r.get("device_budget_mb")
                                        for r in rows}),
            "launches": launches, "device_busy_share": track["busy_share"],
            "device_busy_ms": track["busy_us"] / 1e3,
            "polish_extent_s": track["polish_us"] / 1e6,
            "critpath": crit, "identical": True}


def fleet_phases(torch, racon_tpu_torch, simulate, d, seq, seq_wall, tmp):
    """The fleet on the card (module note): distrib on the chunked cell
    against its sequential polish (the chunked phase's), distrib_kill and
    distrib_w4 on FLEET_SMALL against its own sequential polish run just
    before them, and serve_fleet: a daemon started first, in a thread,
    so that its start (and its floor worker's) overlaps the distrib runs,
    as a resident daemon's does, then given one chunked-cell job.
    Returns FLEET_SMALL's data set and its sequential FASTA text."""
    import threading

    from racon_tpu_torch.obs import __main__ as reader
    from racon_tpu_torch.serve import ServeClient, loadtest

    # the workers are other processes on the card: this one's cached
    # blocks go back first
    torch.cuda.empty_cache()
    state = os.path.join(tmp, "serve_fleet")
    daemon = {}

    def start_daemon():
        t0 = time.perf_counter()
        try:
            daemon["proc"] = loadtest.spawn_daemon(state, "cuda", extra_args=[
                "--fleet-min", "1", "--fleet-max", "2"], timeout=300)
        except Exception as e:  # noqa: BLE001 - required below
            daemon["error"] = repr(e)
        daemon["ready_s"] = time.perf_counter() - t0

    starter = threading.Thread(target=start_daemon, name="serve-fleet")
    starter.start()
    try:
        runs = [("distrib", 2, None, d, fasta_text(seq), seq_wall,
                 CHUNKED["mbp"])]
        d_small = simulate.generate(os.path.join(tmp, "fleet_small"),
                                    **FLEET_SMALL)
        small_seq, _, small_wall = polish_with(racon_tpu_torch, d_small,
                                               "cuda")
        torch.cuda.empty_cache()
        small = (d_small, fasta_text(small_seq), small_wall,
                 FLEET_SMALL["mbp"])
        runs += [("distrib_kill", 2, "worker.result:kill=1", *small),
                 ("distrib_w4", 4, None, *small)]
        for phase, workers, fault, data, want, want_wall, mbp in runs:
            text, wall, result, track, breakdown, crit = distrib_run(
                reader, data, tmp, phase, workers, fault)
            line = distrib_line(phase, workers, mbp, text, wall, result,
                                track, want, want_wall, breakdown, crit)
            if fault:
                c = result["counters"]
                redone = [r for r in result["chunk_stats"]
                          if r["attempts"] > 1 and r["journal_replayed"] > 0]
                require(c.get("workers_dead") == 1, f"{phase}: workers "
                        f"dead {c.get('workers_dead')}")
                require(redone, f"{phase}: no chunk was re-dispatched with "
                        f"a journal replay: {line['chunks_by_index']}")
                line.update(fault=fault,
                            redispatched=[r["index"] for r in redone])
            emit(line)

        # serve_fleet: the daemon's device lane runs through its plane
        starter.join(300)
        proc = daemon.get("proc")
        require(proc is not None, f"serve_fleet: the daemon did not start: "
                f"{daemon.get('error')}")
        with ServeClient.from_state_dir(state, timeout=900) as c:
            t0 = time.perf_counter()
            jid = c.submit(d["reads"], d["overlaps"], d["draft"],
                           args=dict(MAIN))
            resp = c.wait(jid, timeout=900)
            latency = time.perf_counter() - t0
            stats = c.stats()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        starter.join(300)
        proc = daemon.get("proc")
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    require(resp["state"] == "done" and resp["lane"] == "device",
            f"serve_fleet: the job: {resp.get('state')} "
            f"{resp.get('error')}")
    res = resp["result"]
    with open(res["output"]) as f:
        require(f.read() == fasta_text(seq), "serve_fleet: the job's FASTA "
                "differs from the chunked cell's sequential polish")
    require(res["fleet"]["served"] == {"fleet": DISTRIB_CHUNKS},
            f"serve_fleet: served {res['fleet']}")
    require(res["kernel_builds"] == 0, f"serve_fleet: the job built or "
            f"loaded {res['kernel_builds']} kernels")
    require(rc == 0, f"serve_fleet: the daemon exited {rc} on SIGTERM")
    fleet = stats["fleet"]
    require(fleet["cuda_context"] is False, "serve_fleet: the daemon "
            "created a CUDA context")
    emit({"phase": "serve_fleet", "mbp": CHUNKED["mbp"],
          "fleet_min": 1, "fleet_max": 2, "ready_s": daemon["ready_s"],
          "latency_s": latency, "wall_s": res["wall_s"],
          "sequential_wall_s": seq_wall, "queued_s": resp["queued_s"],
          "kernel_builds": res["kernel_builds"],
          "launches": res["launches"], "served": res["fleet"],
          "workers": fleet["workers"], "timeline": fleet["timeline"],
          "steals": fleet["counters"].get("steals", 0),
          "reclaims": fleet["counters"].get("lease_reclaimed", 0),
          "counters": fleet["counters"],
          "memory_share": fleet["memory_share"],
          "worker_start": fleet["worker_start"],
          "per_worker": fleet["per_worker"], "identical": True})
    return small[:2]


# The launch counts a polish path of the default POA kernel reads.
PATH_KERNELS = ("poa_consensus", "hirschberg_edge", "hirschberg_base")


def striped_polish(torch, racon_tpu_torch, cuda_lib, reader, d, devices,
                   main_run, tmp, name):
    """The main cell polished with its launches striped over `devices`,
    traced, with the launch counts set to 0 just before it and read just
    after: the main FASTA; each path kernel launched between main's count
    and twice it (a launch too small to stripe runs once), the launches
    in all main's plus the striped launches (shard.chunks: at two
    stripes a striped launch is two); shard.rows.d* as array_split cuts
    (each at least one row a striped launch, d0 at most one a striped
    launch above d1); the device track's launches equal to the counts,
    per card. Returns its line."""
    main_out, main_launches, main_wall = main_run[0], main_run[2], \
        main_run[4]
    tr = os.path.join(tmp, f"{name}.trace.json")
    cuda_lib.reset_launches()
    p = racon_tpu_torch.TorchPolisher(d["reads"], d["overlaps"], d["draft"],
                                      device="cuda", devices=devices,
                                      trace_path=tr, **MAIN)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    m = len(p.devices)
    require(p.partitioner.n_devices == m == 2,
            f"{name}: the polish did not stripe over two devices")
    require(out == main_out, f"{name}: the striped polish's FASTA differs "
            "from main's")
    doc, errors = reader.load_trace(tr)
    require(not errors, f"{name}: the trace has schema violations: "
            f"{errors[:5]}")
    counters = reader.breakdown(doc)["counters"]
    chunks = counters.get("shard.chunks", 0)
    unsplit = {}
    for k in PATH_KERNELS:
        got, want = launches.get(k, 0), main_launches[k]
        require(want <= got <= m * want, f"{name}: {k} launched {got} "
                f"times, main {want}")
        unsplit[k] = m * want - got
    require(set(launches) == set(PATH_KERNELS), f"{name}: launched "
            f"{sorted(launches)}")
    require(sum(launches.values()) == sum(main_launches[k] for k in
                                          PATH_KERNELS) + (m - 1) * chunks,
            f"{name}: {launches} launches against main's and {chunks} "
            "striped launches")
    rows = {k: v for k, v in counters.items()
            if k.startswith("shard.rows.d")}
    d = [rows.get(f"shard.rows.d{i}", 0) for i in range(m)]
    require(len(rows) == m and chunks > 0 and d[-1] >= chunks
            and 0 <= d[0] - d[-1] <= chunks,
            f"{name}: stripes {rows} over {chunks} striped launches")
    track = reader.device_track(doc, top=4)
    track_launches = {k: v["launches"] for k, v in track["kernels"].items()}
    require(track_launches == launches, f"{name}: the device track's "
            f"launches {track_launches} differ from the counts {launches}")
    cards = sorted({ev["args"].get("card", 0) for ev in doc["traceEvents"]
                    if isinstance(ev, dict) and ev.get("cat") == "device"})
    want_cards = sorted({dev.index for dev in p.devices})
    require(cards == want_cards, f"{name}: device tracks of cards {cards}, "
            f"expected {want_cards}")
    return {"phase": name, "devices": [str(x) for x in p.devices],
            "wall_s": wall, "main_wall_s": main_wall,
            "phase_s": {k[:-2]: v for k, v in p.stats.items()
                        if k.endswith("_s")},
            "launches": launches,
            "main_launches": {k: main_launches[k] for k in PATH_KERNELS},
            "unsplit_launches": unsplit, "striped_launches": chunks,
            "shard_rows": rows, "cards_traced": cards,
            "device_busy_share": track["busy_share"],
            "device_busy_ms": track["busy_us"] / 1e3,
            "polish_extent_ms": track["polish_us"] / 1e3,
            "kernels": track["kernels"], "identical": True}


def stripe_phase(torch, racon_tpu_torch, cuda_lib, d, main_run,
                 trace_wall, tmp):
    """stripe: the main cell on a virtual stripe (two streams of cuda:0),
    and where the host has two cards, on both (``devices=2``)."""
    from racon_tpu_torch.obs import __main__ as reader

    torch.cuda.empty_cache()
    line = striped_polish(torch, racon_tpu_torch, cuda_lib, reader, d,
                          ["cuda:0", "cuda:0"], main_run, tmp, "stripe")
    line["trace_wall_s"] = trace_wall
    n = torch.cuda.device_count()
    if n > 1:
        line["two_cards"] = striped_polish(
            torch, racon_tpu_torch, cuda_lib, reader, d, 2, main_run, tmp,
            "stripe_2cards")
    else:
        line["two_cards"] = {"ran": False, "why": f"{n} card visible: the "
                             "two-card stripe needs two"}
    emit(line)


def multichip_phase(torch):
    """multichip: the port's sweep (tools/multichip.py) at 1, 2 and 4
    stripes on main-cell batches; every count's outputs must equal the
    single launch's."""
    from racon_tpu_torch.tools import multichip

    doc = multichip.sweep((1, 2, 4), repeats=5, device="cuda")
    require(doc["ok"], f"multichip: outputs differ: {doc['tail']}")
    emit({"phase": "multichip", "ok": True, "n_devices": doc["n_devices"],
          "geometry": doc["geometry"],
          "scaling": {n: {k: e[k] for k in (
              "devices", "virtual", "rows_per_stripe", "windows_per_s",
              "wall_s", "first_s", "failed_windows", "counters")}
              for n, e in doc["scaling"].items()}})


def wrapper_phase(d, tmp, seq_text):
    """wrapper: FLEET_SMALL through ``python -m
    racon_tpu_torch.tools.wrapper --split <bytes>`` on the card, once
    sequentially and once with --jobs 2 (CLI workers): the two stdouts
    byte-identical, four contigs. Whether they equal the data set's
    one-process polish is printed."""
    with open(d["draft"]) as f:
        sizes = [len(rec.split("\n", 1)[1].replace("\n", ""))
                 for rec in f.read().split(">")[1:]]
    split = min(sizes)        # each chunk one contig
    base = [sys.executable, "-m", "racon_tpu_torch.tools.wrapper",
            "--split", str(split), "-w", "500", "-m", "5", "-x", "-4", "-g",
            "-8", d["reads"], d["overlaps"], d["draft"]]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    outs, walls = {}, {}
    for name, extra in (("sequential", []), ("jobs2", ["--jobs", "2"])):
        cwd = os.path.join(tmp, f"wrapper_{name}")
        os.makedirs(cwd)
        t0 = time.perf_counter()
        r = subprocess.run(base + extra, cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=600)
        walls[name] = time.perf_counter() - t0
        require(r.returncode == 0, f"wrapper {name}: exit {r.returncode}: "
                f"{r.stderr[-2000:]}")
        outs[name] = r.stdout
    require(outs["sequential"] == outs["jobs2"], "wrapper: --jobs 2 gives "
            "other bytes than the sequential run")
    contigs = outs["sequential"].count(">")
    require(contigs == len(sizes) == 4, f"wrapper: {contigs} contigs of "
            f"{len(sizes)}")
    emit({"phase": "wrapper", "mbp": FLEET_SMALL["mbp"], "split": split,
          "chunks": len(sizes), "contigs": contigs,
          "sequential_s": walls["sequential"], "jobs2_s": walls["jobs2"],
          "identical": True,
          "equals_one_polish": outs["sequential"] == seq_text})


def host_phase(racon_tpu_torch, native, d, gpu, procs):
    """The host backend (create_polisher(backend="host"): the native
    pipeline alone, consensus on `procs` threads) on the parity set: its
    wall and its edit distance to the truth, which must be below the
    draft's; whether its FASTA equals the card's (`gpu`) is printed, not
    required (the host aligner may take another path of equal cost)."""
    p = racon_tpu_torch.create_polisher(
        d["reads"], d["overlaps"], d["draft"], backend="host", **MAIN,
        num_threads=procs)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    wall = time.perf_counter() - t0
    genome, draft = read_fasta(d["genome"]), read_fasta(d["draft"])
    ed = (native.edit_distance(draft, genome), native.edit_distance(
        "".join(s for _, s in out).encode(), genome))
    emit({"phase": "host", "mbp": PARITY_MBP, "threads": procs,
          "wall_s": wall, "phase_s": p.stats, "equals_card": out == gpu,
          "edit_distance": {"draft": ed[0], "polished": ed[1]}})
    require(ed[1] < ed[0], "the host backend did not lower the edit "
            f"distance ({ed[0]} -> {ed[1]})")


def start_global(torch, rec, procs, ex):
    """Both POA kernels' flat global builds on the ls -w 3000 run's
    largest global launch of each depth bucket, every window held against
    the plain version (on the host, in `procs` jobs on the pool `ex`; one
    plain pass for both kernels), the DP cells (and v2's serial steps,
    colstep on) equal the plain version's; each timed (three calls) beside
    its bound. Each launch prints a "<kernel> POA phases" line. Queues the
    plain version and returns a function that waits for it, runs the
    checks and gives each build's totals."""
    from racon_tpu_torch.tools.batches import plain_poa_submit

    kept = rec.inputs(GLOBAL_NAME["ls"])
    require(kept, "no global POA launch of the -w 3000 run was kept")
    t0 = time.perf_counter()
    pending = plain_poa_submit([inp for _, inp in kept], procs, ex)
    return lambda: finish_global(torch, kept, procs, pending, t0)


def finish_global(torch, kept, procs, pending, t0):
    """The second half of start_global."""
    from racon_tpu_torch.ops import poa_cuda, poa_v2_cuda

    mhz = sm_clock_mhz()
    plain = pending()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rows = {}
    for kernel, mod in (("ls", poa_cuda), ("v2", poa_v2_cuda)):
        fn = (mod.poa_consensus if kernel == "ls" else mod.poa_consensus_v2)
        tot = Totals()
        for (_, (cfg, dev_in)), (want, pst) in zip(kept, plain):
            require(mod.plan(cfg)["global_build"], f"{kernel}: the -w 3000 "
                    f"geometry {cfg} does not take the global build")
            kst = {}
            got = fn(cfg, *dev_in, stats=kst)
            torch.cuda.synchronize()
            err = max_abs_err(want, got)
            require(err == 0, f"{kernel} global build (depth {cfg.depth}) "
                    f"differs from its plain version by {err}")
            require(kst["cells"] == pst["cells"] and
                    (kernel == "ls" or kst["steps"] == pst["steps"]),
                    f"{kernel} global build counts: kernel {kst}, plain "
                    f"{pst}")
            ms = cuda_ms(torch, lambda: fn(cfg, *dev_in), 3)
            phases = phase_ms(mod.PHASES, kst, dev_in[0].shape[0], mhz)
            print_phases(f"{kernel} POA phases, depth {cfg.depth}, "
                         f"{dev_in[0].shape[0]} windows, global build",
                         phases, ms)
            n_bytes = poa_bytes(dev_in, got)
            n_ops = POA_OPS_PER_CELL * pst["cells"]
            b_ms, b_by = bound(n_bytes, n_ops)
            line = {"phase": "kernel_check", "kernel": GLOBAL_NAME[kernel],
                    "input": "largest global launch of its depth bucket in "
                    "the wide_3000_ls run", "windows": dev_in[0].shape[0],
                    "depth": cfg.depth, "max_nodes": cfg.max_nodes,
                    "max_len": cfg.max_len, "dp_cells": pst["cells"],
                    "failed": int(got[3].sum()), "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms / len(kept),
                    "plain_on": f"host, {procs} processes (one pass for "
                    "both kernels, beside the banded global builds' "
                    "plain passes)", "bound_ms": b_ms, "bound_by": b_by,
                    "phases": phases, "sm_clock_mhz": mhz}
            emit(line)
            tot.add(line, n_bytes, n_ops)
        rows[GLOBAL_NAME[kernel]] = tot.row()
    return rows


def probe_phase(torch, probe, cuda_lib):
    """The DP-cost probe's path on the card: its gate and its per-mode
    timing tables at R=800 for B=16 (the JAX probe's default) and B=528
    (four programs per SM), with the launch counts set to 0 just before
    and read just after. Then every mode against its plain version run
    on the card: at R=32 for the seeds 0 and 7, and at the table's shape
    (R=800, B=16), which also times the plain versions. Each check holds
    out, steps and every program's whole last DP row (or ring row)."""
    import contextlib
    import io

    cuda_lib.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gate_ok = probe.gate(device="cuda")
    tables = {B: probe.time_modes(800, B, 3, "cuda") for B in (16, 528)}
    launches = dict(cuda_lib.LAUNCHES)
    gate_out = buf.getvalue()
    print(gate_out, end="", flush=True)
    require(gate_ok and gate_out.count("OK") == 5,
            f"probe gate failed:\n{gate_out}")
    check_launches("probe", launches)
    bound_sum = {}
    for B, rows in tables.items():
        print(f"dp_cost_probe on the card: R=800 B={B}", flush=True)
        probe.print_table(rows)
        for r in rows:
            require(r["out_seed0"] != r["out_seed7"],
                    f"probe mode {r['mode']} ignores its seed")
            r["bound_ms"], r["bound_by"] = bound(12 * B, r["ops"])
            r["ns_per_row"] = r["per_node_us"] * 1e3
            r["over_bound"] = r["warm_s"] * 1e3 / r["bound_ms"]
            print(f"probe mode {r['mode']}, R=800 B={B}: "
                  f"{r['warm_s'] * 1e3:.4f} ms, {r['ns_per_step']:.1f} ns a "
                  f"rank step, {r['ps_per_cell']:.3f} ps a DP cell",
                  flush=True)
        bound_sum[B] = sum(r["bound_ms"] for r in rows)
        emit({"phase": "probe", "R": 800, "B": B, "modes": rows})

    err, plain_s, small = 0, 0.0, []
    for mode in range(probe.N_MODES):
        seed = torch.tensor([0, 7], dtype=torch.int32, device="cuda")
        want = probe.probe_plain(mode, 32, seed, rows=True)
        got = probe.probe(mode, 32, seed, rows=True)
        require(got[2].shape == want[2].shape,
                f"probe mode {mode}: last rows of shape {tuple(got[2].shape)}"
                f", plain {tuple(want[2].shape)}")
        e = max_abs_err(want, got)
        small.append({"mode": mode, "out": got[0].tolist(),
                      "steps": got[1].tolist(),
                      "row_width": got[2].shape[1], "max_abs_err": e})
        seed = torch.arange(16, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = probe.probe_plain(mode, 800, seed, rows=True)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        e = max(e, max_abs_err(want, probe.probe(mode, 800, seed,
                                                 rows=True)))
        require(e == 0, f"probe mode {mode} differs from its plain version "
                f"by {e}")
        err = max(err, e)
    emit({"phase": "probe_check", "R32_seeds_0_7": small,
          "R800_B16_max_abs_err": err, "plain_s_R800_B16": plain_s,
          "gate": gate_out.splitlines()})
    return launches, {"max_abs_err": err,
                      "ms": sum(r["warm_s"] for r in tables[16]) * 1e3,
                      "plain_ms": plain_s * 1e3, "bound_ms": bound_sum[16],
                      "bound_by": "operations"}



MAIN_CLI = ["-w", str(MAIN["window_length"]), "-m", str(MAIN["match"]),
            "-x", str(MAIN["mismatch"]), "-g", str(MAIN["gap"])]


def journal_records(path: str) -> dict:
    """Record counts of a journal by kind."""
    counts = {}
    with open(path) as f:
        for line in f:
            kind = json.loads(line)["kind"]
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def poa_launches(launches: dict) -> int:
    return sum(v for k, v in launches.items() if k.startswith("poa_"))


def journal_phase(racon_tpu_torch, cuda_lib, d, main_run, tmp):
    """The main cell without journal, trace or recorder (the baseline of
    the walls), then journaled (a) and journaled without fsync, a CLI
    child killed by SIGKILL at the journal append after all CIGARs and
    half the windows (b), and its journal resumed here (c). Returns the
    baseline's seconds."""
    main_out, main_launches, main_wall = main_run[0], main_run[2], main_run[4]
    cuda_lib.reset_launches()
    plain, _, plain_s = polish_with(racon_tpu_torch, d, "cuda")
    require(plain == main_out, "the plain polish's FASTA differs from main's")

    ja = os.path.join(tmp, "a.journal")
    cuda_lib.reset_launches()
    p = racon_tpu_torch.TorchPolisher(d["reads"], d["overlaps"], d["draft"],
                                      device="cuda", journal_path=ja, **MAIN)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    wall_a = time.perf_counter() - t0
    fsync_s = p.journal.fsync_s
    launches_a = dict(cuda_lib.LAUNCHES)
    check_launches("journal", launches_a, "ls")
    require(out == main_out, "the journaled polish's FASTA differs from "
            "main's")
    recs = journal_records(ja)
    cigars, windows = recs.get("cigar", 0), recs.get("window", 0)
    require(cigars > 0 and windows > 1, f"journal records {recs}")
    # the same without fsync: what the journal costs besides its fsyncs
    cuda_lib.reset_launches()
    nosync, _, nosync_s = polish_with(
        racon_tpu_torch, d, "cuda",
        journal_path=os.path.join(tmp, "n.journal"), journal_fsync=False)
    require(nosync == main_out, "the journaled polish without fsync differs "
            "from main's")

    n = cigars + windows // 2
    jb = os.path.join(tmp, "b.journal")
    env = {**os.environ, "RACON_TORCH_FAULT":
           f"journal.append:batch={n}:kill=1"}
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-m", "racon_tpu_torch.cli", *MAIN_CLI, "--journal",
         jb, d["reads"], d["overlaps"], d["draft"]], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, timeout=900)
    child_s = time.perf_counter() - t0
    require(child.returncode == -signal.SIGKILL,
            f"the journaled child exited {child.returncode}, not by "
            f"SIGKILL: {child.stderr.decode()[-2000:]}")
    recs_b = journal_records(jb)
    require(recs_b.get("cigar") == cigars and
            recs_b.get("window") == windows // 2,
            f"the killed child left {recs_b}, expected {cigars} CIGARs and "
            f"{windows // 2} windows")

    cuda_lib.reset_launches()
    p = racon_tpu_torch.TorchPolisher(d["reads"], d["overlaps"], d["draft"],
                                      device="cuda", journal_path=jb,
                                      resume_journal=True, **MAIN)
    t0 = time.perf_counter()
    p.initialize()
    out = p.polish(True)
    wall_c = time.perf_counter() - t0
    launches_c = dict(cuda_lib.LAUNCHES)
    phases = p.report.as_dict()["phases"]
    require(out == main_out, "the resumed polish's FASTA differs from main's")
    require(poa_launches(launches_c) < poa_launches(main_launches),
            "the resumed polish did not launch fewer POA kernels than main "
            f"({poa_launches(launches_c)} >= {poa_launches(main_launches)})")
    require(phases["alignment"]["served"]["journal"] == cigars and
            phases["consensus"]["served"]["journal"] == windows // 2,
            f"the resumed report's journal counts: {phases}")
    for name, ph in phases.items():
        require(sum(ph["served"].values()) == ph["total"],
                f"the resumed report's {name} served counts do not sum to "
                "its total")
    emit({"phase": "journal", "wall_s": wall_a, "plain_wall_s": plain_s,
          "main_wall_s": main_wall, "records": {"cigar": cigars,
                                                "window": windows},
          "journal_bytes": os.path.getsize(ja),
          "fsync_s": fsync_s, "no_fsync_wall_s": nosync_s,
          "child_killed_at_record": n, "child_s": child_s,
          "resume_wall_s": wall_c,
          "resume_launches": {k: v for k, v in launches_c.items() if v},
          "main_poa_launches": poa_launches(main_launches),
          "resume_served": {k: v["served"] for k, v in phases.items()},
          "identical": True})
    return plain_s


def trace_phase(torch, racon_tpu_torch, cuda_lib, d, main_run, plain_s, tmp,
                keep):
    """The main polish traced, with its report, and a LAUNCH_EVENTS list
    of its own beside the trace's device track. Returns its wall, its
    trace, pipeline_cells of its pipeline (taken between initialize and
    polish, out of the wall) and its stats."""
    from racon_tpu_torch.obs import __main__ as reader

    from racon_tpu_torch.pipeline import Pipeline

    main_out, main_wall = main_run[0], main_run[4]
    tr = os.path.join(tmp, "main.trace.json")
    # phase 1's job lengths, read before any alignment (a job's lengths
    # are gone once its CIGAR is set)
    pl = Pipeline(d["reads"], d["overlaps"], d["draft"], **MAIN)
    pl.prepare()
    lengths = pl.align_job_lengths()
    del pl
    cuda_lib.reset_launches()
    cuda_lib.LAUNCH_EVENTS = events = []
    try:
        p = racon_tpu_torch.TorchPolisher(d["reads"], d["overlaps"],
                                          d["draft"], device="cuda",
                                          trace_path=tr, **MAIN)
        t0 = time.perf_counter()
        p.initialize()
        t1 = time.perf_counter()
        cells = pipeline_cells(p._pipeline, lengths)
        t2 = time.perf_counter()
        out = p.polish(True)
        wall = time.perf_counter() - t0 - (t2 - t1)
    finally:
        cuda_lib.LAUNCH_EVENTS = None
    launches = {k: v for k, v in cuda_lib.LAUNCHES.items() if v}
    check_launches("trace", cuda_lib.LAUNCHES, "ls")
    require(out == main_out, "the traced polish's FASTA differs from main's")
    doc, errors = reader.load_trace(tr)
    require(not errors, f"the trace has schema violations: {errors[:5]}")
    track = reader.device_track(doc, top=8)
    track_launches = {k: v["launches"] for k, v in track["kernels"].items()}
    require(track_launches == launches, "the device track's launches "
            f"{track_launches} differ from the launch counts {launches}")
    torch.cuda.synchronize()
    events_ms = sum(s.elapsed_time(e) for _, s, e in events)
    track_ms = sum(v["busy_us"] for v in track["kernels"].values()) / 1e3
    require(abs(track_ms - events_ms) <= 0.01 * events_ms,
            f"the device track's {track_ms} ms differ from LAUNCH_EVENTS' "
            f"{events_ms} ms by more than 1%")
    report = p.report.as_dict()
    for name, ph in report["phases"].items():
        require(sum(ph["served"].values()) == ph["total"],
                f"the traced report's {name} served counts do not sum")
    require(all(v["ok"] for v in report["obs"]["served_sum"].values()),
            "the report's served counts disagree with the metrics")
    if keep:
        os.makedirs(keep, exist_ok=True)
        shutil.copy(tr, os.path.join(keep, "main.trace.json"))
        p.report.write(os.path.join(keep, "main.report.json"))
    gaps = dict(list(track["gaps_by_span"].items())[:8])
    emit({"phase": "trace", "wall_s": wall, "plain_wall_s": plain_s,
          "main_wall_s": main_wall,
          "phase_walls_ms": {k: v / 1e3 for k, v in
                             reader.phase_walls_us(doc).items()},
          "device_busy_share": track["busy_share"],
          "device_busy_ms": track["busy_us"] / 1e3,
          "polish_extent_ms": track["polish_us"] / 1e3,
          "track_ms": track_ms, "launch_events_ms": events_ms,
          "kernels": track["kernels"],
          "host_gaps_by_span_ms": {
              k: {"gaps": v["gaps"], "sum_ms": v["sum_us"] / 1e3,
                  "max_ms": v["max_us"] / 1e3} for k, v in gaps.items()},
          "top_gaps_ms": [{"span": g["span"], "gap_ms": g["gap_us"] / 1e3,
                           "at_ms": g["start_us"] / 1e3}
                          for g in track["top_gaps"]],
          "served": {k: v["served"] for k, v in report["phases"].items()},
          "trace_events": len(doc["traceEvents"]),
          "dropped_events": doc["otherData"]["dropped_events"]})
    return wall, tr, cells, p.stats


def pipeline_cells(pl, lengths) -> dict:
    """The DP-cell and window counters a traced polish of pipeline `pl`
    must count, recomputed from the pipeline once its windows are built
    (before the consensus phase; stitching frees them) and from its
    phase-1 job `lengths` (Pipeline.align_job_lengths after prepare, before alignment):
    windows and admitted depth x class per POA bucket, as the consensus
    driver buckets them, and phase 1's Hirschberg and need-band cells,
    as the aligner's formulas give them."""
    import numpy as np

    from racon_tpu_torch.obs import costmodel
    from racon_tpu_torch.ops import align_cuda, poa_driver

    out = {}
    for i in range(pl.num_windows()):
        n_seqs, bb_len = pl.window_info(i)[:2]
        if n_seqs - 1 < 2:
            continue
        depth = min(n_seqs - 1, poa_driver.DEPTH_CAP)
        d = next(b for b in poa_driver.DEPTH_BUCKETS if depth <= b)
        c = poa_driver.window_class(bb_len)
        for name, n in ((f"poa.windows.d{d}.c{c}", 1),
                        (f"poa.cells.d{d}.c{c}", depth * c)):
            out[name] = out.get(name, 0) + n
    L = np.asarray(lengths, dtype=np.int64)
    if len(L):
        mx = L.max(axis=1)
        out["align.cells.total"] = int(
            (mx * costmodel.band_need(L[:, 0], L[:, 1])).sum())
        out["align.cells.hirschberg"] = sum(
            2 * int(m) * align_cuda.band_for(int(a), int(b))
            for (a, b), m in zip(L, mx))
    return out


def costmodel_phase(tr: str, cells: dict, stats: dict):
    """The cost model (obs/costmodel.py) on the traced main polish (its
    trace `tr`, its stats): ``obs model --profile h100 --json``, then
    validate_trace under h100, each modeled phase's predicted and
    measured seconds and their ratio, and the bucket joins. Beside each
    phase, its kernels' busy time on the trace's device track
    (``device_s``), the prediction over it (the model's error against the
    card's own time) and its share of the phase's wall (how much of the
    phase is the card's work). Required: the trace reads, both modeled
    phases have a measured and a predicted wall above 0, the DP-cell
    counters equal `cells` (pipeline_cells of the polish), the windows in
    buckets equal those stats counts as the card's or the host's, and the
    profile's ``align_step_cells`` lies within its declared bound of the
    one this run reads (the Hirschberg cells of a serial step at the
    aligner kernels' busy rate). Whether the prediction falls within the
    profile's bound (``ok``) is printed, not required."""
    import contextlib
    import io

    from racon_tpu_torch.obs import __main__ as reader
    from racon_tpu_torch.obs import costmodel

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = reader.main(["model", "--profile", "h100", "--json"])
    require(rc == 0, f"obs model --profile h100 exited {rc}")
    model = json.loads(buf.getvalue())
    doc, errors = reader.load_trace(tr)
    require(not errors, f"the trace has schema violations: {errors[:5]}")
    prof = costmodel.profile("h100")
    v = costmodel.validate_trace(doc, prof)
    for name in ("align", "poa"):
        ph = v["phases"][name]
        require((ph["measured_s"] or 0) > 0 and ph["predicted_s"] > 0,
                f"costmodel: phase {name}: predicted {ph['predicted_s']} s, "
                f"measured {ph['measured_s']} s")
    kernels = reader.device_track(doc)["kernels"]
    device_s = {ph: sum(k["busy_us"] for n, k in kernels.items()
                        if n.startswith(prefix)) / 1e6
                for ph, prefix in (("align", "hirschberg"),
                                   ("poa", "poa_consensus"))}
    counters = doc["racon_tpu"]["metrics"]["counters"]
    step_cells = (counters["align.cells.hirschberg"] * prof.serial_step_s
                  / device_s["align"])
    off = max(step_cells / prof.align_step_cells,
              prof.align_step_cells / step_cells)
    require(off <= prof.error_bound_ratio, "costmodel: the h100 profile's "
            f"align_step_cells {prof.align_step_cells} is {off:.2f}x the "
            f"{step_cells:.1f} this run reads")
    got = {k: n for k, n in counters.items()
           if k.startswith(("poa.windows.d", "poa.cells.d", "align.cells."))}
    require(got == cells, f"costmodel: the trace's counters {got}, the "
            f"pipeline's {cells}")
    windows = sum(n for k, n in cells.items() if k.startswith("poa.windows"))
    cons = stats["consensus"]
    require(windows == cons["device"] + cons["host_fallback"],
            f"costmodel: {windows} windows in buckets, stats "
            f"{cons['device']} on the card and {cons['host_fallback']} on "
            "the host")
    emit({"phase": "costmodel", "profile": prof.name,
          "error_bound_ratio": prof.error_bound_ratio,
          "serial_step_s": prof.serial_step_s,
          "align_step_cells": {"profile": prof.align_step_cells,
                               "read": step_cells},
          "phases": {k: {**{f: ph.get(f) for f in (
              "predicted_s", "measured_s", "ratio", "error_pct",
              "within_bound", "verdict", "serial_steps")},
              "device_s": device_s[k],
              "predicted_over_device": ph["predicted_s"] / device_s[k],
              "device_share": device_s[k] / ph["measured_s"]}
              for k, ph in v["phases"].items()},
          "ok": v["ok"], "buckets": v["buckets"],
          "counters": {k: n for k, n in counters.items()
                       if ".cells" in k or k.startswith("poa.windows")},
          "model": model["rows"]})
    print(costmodel.render_validation(v), flush=True)


def kernel_bench_phase(torch):
    """tools/kernel_bench.py on both POA kernels (B = 64 windows, depth
    32, 3 warm calls): ms, the cost model's bound and ms over it; each
    kernel's outputs on 2 sampled windows equal to the plain version's on
    those windows (tolerance 0)."""
    from racon_tpu_torch.ops import poa, poa_driver
    from racon_tpu_torch.tools import kernel_bench

    for kernel in ("v2", "ls"):
        r = kernel_bench.run(64, 32, 3, kernel, "cuda")
        idx = [0, 37]
        sub = tuple(a[idx] for a in r["inputs"])
        t0 = time.perf_counter()
        want = poa_driver.kernel_for(kernel)(
            r["cfg"], *poa.batch_to_tensors(sub, "cpu"))
        plain_s = time.perf_counter() - t0
        err = max_abs_err(want, [torch.from_numpy(o[idx])
                                 for o in r["outputs"]])
        require(err == 0, f"kernel_bench: the {kernel} kernel differs from "
                f"its plain version by {err} on windows {idx}")
        emit({"phase": "kernel_bench",
              **{k: v for k, v in r.items()
                 if k not in ("inputs", "outputs", "cfg")},
              "plain_windows": idx, "plain_s": plain_s, "max_abs_err": err})


def check_n_bases(torch, ex):
    """Both POA kernels on a batch with N (code 4) at 5% in backbones and
    layers (tools.batches.poa_batch, 32 windows of -w 500 and 2..32
    layers), each held against the plain version on every window
    (tolerance 0; the plain version on the pool `ex`): one kernel_check
    line a kernel."""
    from racon_tpu_torch.ops import poa, poa_driver
    from racon_tpu_torch.tools.batches import plain_poa_parallel, poa_batch

    cfg = poa_driver.make_config(500, 32, 5, -4, -8)
    packed = poa_batch(cfg, 32, 41, 500, n_rate=0.05)
    dev_in = poa.batch_to_tensors(packed, "cuda")
    t0 = time.perf_counter()
    ((want, pst),) = plain_poa_parallel([(cfg, dev_in)], PLAIN_PROCS, ex=ex)
    plain_ms = (time.perf_counter() - t0) * 1e3
    for kernel, name in POA_NAME.items():
        fn = poa_driver.kernel_for(kernel)
        st = {}
        got = fn(cfg, *dev_in, stats=st)
        torch.cuda.synchronize()
        err = max_abs_err(want, got)
        require(err == 0 and st["cells"] == pst["cells"], f"the {kernel} POA "
                f"kernel on the N batch: max_abs_err {err}, cells "
                f"{st['cells']} against the plain version's {pst['cells']}")
        ms = cuda_ms(torch, lambda: fn(cfg, *dev_in), 3)
        b_ms, b_by = bound(poa_bytes(dev_in, got),
                           POA_OPS_PER_CELL * st["cells"])
        emit({"phase": "kernel_check", "kernel": name,
              "input": "tools.batches.poa_batch(n_rate=0.05): N (code 4) "
              "in backbones and layers", "windows": int(packed[0].shape[0]),
              "depth": cfg.depth,
              "n_codes": int((packed[0] == 4).sum() + (packed[4] == 4).sum()),
              "dp_cells": st["cells"], "failed": int(got[3].sum()),
              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
              "plain_on": f"host, {PLAIN_PROCS} processes, every window",
              "bound_ms": b_ms, "bound_by": b_by})


def watchdog_phase(racon_tpu_torch, d):
    """The parity set on the card with every ls batch hung for 60 s and a
    2 s device watchdog: WatchdogTimeout within 15 s."""
    from racon_tpu_torch.resilience import faults
    from racon_tpu_torch.resilience.watchdog import WatchdogTimeout

    faults.configure("poa.run.ls:hang=60")
    t0 = time.perf_counter()
    raised = None
    try:
        polish_with(racon_tpu_torch, d, "cuda", device_timeout_s=2.0)
    except WatchdogTimeout as e:
        raised = str(e)
    finally:
        faults.configure(None)
    took = time.perf_counter() - t0
    require(raised is not None, "the hung ls batch did not raise "
            "WatchdogTimeout")
    require(took < 15, f"WatchdogTimeout came after {took:.1f} s, not "
            "within 15 s")
    emit({"phase": "watchdog", "mbp": PARITY_MBP, "deadline_s": 2.0,
          "hang_s": 60, "raised_after_s": took, "error": raised})


def serve_phase(torch, racon_tpu_torch, d, d_par, main_run, plain_s, tmp):
    """The daemon on the card (module note): a daemon killed at a journal
    record, then a second one on its state directory that resumes its
    job beside two main-cell jobs from two clients at once and a
    parity-set job over its window budget, ended by SIGTERM."""
    import threading

    from racon_tpu_torch.obs import __main__ as reader
    from racon_tpu_torch.serve import ServeClient, loadtest

    def fasta(records):
        return "".join(f">{n}\n{s}\n" for n, s in records)

    def read(path):
        with open(path) as f:
            return f.read()

    main_fasta, main_launches = fasta(main_run[0]), main_run[2]
    host = racon_tpu_torch.create_polisher(d_par["reads"], d_par["overlaps"],
                                           d_par["draft"], backend="host",
                                           **MAIN)
    host.initialize()
    host_fasta = fasta(host.polish(True))
    par_fasta = fasta(polish(racon_tpu_torch, d_par, "cuda")[0])
    args = dict(MAIN)
    deadline = 900.0
    # the daemon is a second process on the card: this one's cached
    # blocks go back first
    torch.cuda.empty_cache()

    def spawn(state, env=None):
        t0 = time.perf_counter()
        proc = loadtest.spawn_daemon(state, "cuda", env=env, timeout=300)
        return proc, time.perf_counter() - t0

    def stop(proc):
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    # preemption first: a daemon killed at its job's third journal
    # record; the daemon restarted on its state directory then recovers
    # that job and serves the main-cell jobs beside it
    state = os.path.join(tmp, "serve")
    env = {**os.environ, "RACON_TORCH_FAULT":
           "journal.append:batch=3:kill=1"}
    proc, _ = spawn(state, env)
    try:
        with ServeClient.from_state_dir(state, timeout=60) as c:
            jid = c.submit(d_par["reads"], d_par["overlaps"], d_par["draft"],
                           args=args, job_id="prem")
        rc = proc.wait(timeout=300)
    finally:
        stop(proc)
    require(rc == -signal.SIGKILL, f"the faulted daemon exited {rc}, not by "
            "SIGKILL")
    proc, ready_s = spawn(state)
    done = {}
    try:
        def client(name, data, **kw):
            try:
                with ServeClient.from_state_dir(state, timeout=deadline) as c:
                    t0 = time.perf_counter()
                    job = (kw.pop("job_id") if "job_id" in kw else
                           c.submit(data["reads"], data["overlaps"],
                                    data["draft"], args=args,
                                    submitter=name, **kw))
                    done[name] = (c.wait(job, timeout=deadline),
                                  time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - reported below
                done[name] = (None, repr(e))

        threads = [threading.Thread(target=client, args=a, kwargs=k)
                   for a, k in ((("resumed", d_par), {"job_id": jid}),
                                (("main_a", d), {}), (("main_b", d), {}),
                                (("budget", d_par), {"window_budget": 1}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(deadline)
        with ServeClient.from_state_dir(state, timeout=60) as c:
            stats = c.stats()
            stats.pop("ok", None)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        term_s = time.perf_counter() - t0
    finally:
        stop(proc)
    require(rc == 0, f"the daemon exited {rc} on SIGTERM")
    for name in ("resumed", "main_a", "main_b", "budget"):
        require(done.get(name, (None,))[0] is not None,
                f"serve job {name} failed: {done.get(name)}")
    resp = done.pop("resumed")[0]
    res = resp["result"]
    require(resp["state"] == "done" and resp["lane"] == "device",
            f"the recovered job: {resp}")
    require(res["journal_replayed"] >= 1, "the recovered job replayed no "
            "journal record")
    require(read(res["output"]) == par_fasta, "the recovered job's FASTA "
            "differs from the card's polish of the parity set")
    emit({"phase": "serve_resume", "mbp": PARITY_MBP, "killed_rc": -9,
          "restart_ready_s": ready_s, "journal_replayed":
          res["journal_replayed"], "cold": res["cold"],
          "wall_s": res["wall_s"], "kernel_builds": res["kernel_builds"],
          "sigterm_exit_s": term_s, "identical": True})
    jobs = []
    for name, (resp, latency) in sorted(done.items()):
        res = resp["result"]
        require(resp["state"] == "done", f"serve job {name}: {resp}")
        require(res["kernel_builds"] == 0, f"serve job {name} built or "
                f"loaded {res['kernel_builds']} kernels after the warm-up")
        line = {"job": name, "lane": resp["lane"], "cold": res["cold"],
                "wall_s": res["wall_s"], "queued_s": resp["queued_s"],
                "running_s": resp["running_s"], "latency_s": latency,
                "kernel_builds": res["kernel_builds"],
                "batches": res.get("batches"), "rss_mb": res.get("rss_mb"),
                "demotions": resp["demotions"]}
        if name == "budget":
            require(resp["lane"] == "host" and res["backend"] == "host" and
                    "window budget" in resp["demotions"][0]["cause"],
                    f"the budget job did not run on the host lane: {resp}")
            require(read(res["output"]) == host_fasta, "the budget job's "
                    "FASTA differs from the host backend's")
        else:
            require(resp["lane"] == "device" and not resp["demotions"],
                    f"serve job {name} left the device lane: {resp}")
            require(read(res["output"]) == main_fasta, f"serve job {name}'s "
                    "FASTA differs from main's")
            doc, errors = reader.load_trace(res["trace"])
            require(not errors, f"serve job {name}'s trace: {errors[:5]}")
            track = reader.device_track(doc)
            for k in ("poa_consensus", "hirschberg_edge", "hirschberg_base"):
                n = track["kernels"].get(k, {}).get("launches", 0)
                require(n == main_launches[k] == res["launches"].get(k, 0),
                        f"serve job {name} launched {k} {n} times "
                        f"(its counts {res['launches'].get(k, 0)}), main "
                        f"{main_launches[k]}")
            line.update(launches=res["launches"],
                        device_busy_share=track["busy_share"],
                        device_busy_ms=track["busy_us"] / 1e3)
        jobs.append(line)
    adm = stats["admission"]
    require(stats["jobs"] == {"done": 4}, f"serve jobs: {stats['jobs']}")
    require(adm.get("demoted_budget") == 1, f"budget demotions: {adm}")
    mains = sorted((j for j in jobs if j["lane"] == "device"),
                   key=lambda j: j["latency_s"])
    emit({"phase": "serve", "ready_s": ready_s,
          "warm_wall_s": stats["session"]["warm_wall_s"],
          "warmed": stats["session"]["warmed"],
          "jobs": jobs, "first_main_wall_s": mains[0]["wall_s"],
          "second_main_wall_s": mains[1]["wall_s"],
          "plain_main_wall_s": plain_s, "main_wall_s": main_run[4],
          "identical": True})
    emit({"phase": "serve_stats", **stats})


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of racon_tpu_torch "
                                 "on one CUDA card")
    ap.add_argument("--keep", metavar="DIR", default=None,
                    help="copy the trace phase's trace and report into DIR")
    keep = ap.parse_args().keep
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import racon_tpu_torch
    from racon_tpu_torch import native
    from racon_tpu_torch.ops import align_cuda as ac
    from racon_tpu_torch.ops import (band, cuda_lib, poa_cuda, poa_driver,
                                     poa_v2_cuda)
    from racon_tpu_torch.tools import dp_cost_probe as probe
    from racon_tpu_torch.tools import simulate
    from racon_tpu_torch.tools.batches import plain_poa_pool
    from racon_tpu_torch.tools.kernel_bench import nvidia_smi

    smi = nvidia_smi()
    t0 = time.perf_counter()
    native.ensure_built()
    native_s = time.perf_counter() - t0
    kernels_s = cuda_lib.build_all()
    emit({"phase": "build", "native_s": native_s, "cuda_kernels_s": kernels_s,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    with tempfile.TemporaryDirectory(prefix="racon_smoke_") as tmp, \
            ProcessPoolExecutor(6, mp_context=multiprocessing.get_context(
                "spawn")) as cpu_pool, \
            plain_poa_pool(PLAIN_PROCS) as plain_ex:
        # the parity set's three CPU polishes (plain versions: flat, and
        # banded with each POA kernel) and the three wide sets' run in
        # their own processes through the phases below
        d_par = simulate.generate(os.path.join(tmp, "parity"),
                                  mbp=PARITY_MBP, seed=11)
        d_wide = simulate.generate(os.path.join(tmp, "wide"), mbp=WIDE_MBP,
                                   seed=11)
        d_wide3 = simulate.generate(os.path.join(tmp, "wide3"),
                                    mbp=WIDE3_MBP, seed=11)
        d_wide11 = simulate.generate(os.path.join(tmp, "wide11"),
                                     mbp=WIDE11_MBP,
                                     coverage=WIDE11_COVERAGE, seed=11)
        cpu_runs = {"flat": cpu_pool.submit(cpu_polish, d_par),
                    "band": cpu_pool.submit(cpu_polish, d_par, PARITY_SLACK),
                    "ls_band": cpu_pool.submit(cpu_polish, d_par,
                                               PARITY_SLACK, "ls"),
                    "wide": cpu_pool.submit(cpu_polish, d_wide, None, "ls",
                                            WIDE_WINDOW),
                    "wide3": cpu_pool.submit(cpu_polish, d_wide3, None, "ls",
                                             WIDE3_WINDOW),
                    "wide11": cpu_pool.submit(cpu_polish, d_wide11, None,
                                              "ls", WIDE11_WINDOW)}
        # the plain version on the int32 builds' check batch, queued
        # behind those
        wide_id_plain = {k: cpu_pool.submit(plain_wide_id, k)
                         for k in (None, "ls", "v2")}

        # main: 1.0 Mbp, 30x ONT-like reads, PAF overlaps, with the
        # default POA kernel; then the same polish with the other POA
        # kernel (phase main_<kernel>), which must give the same bytes
        t0 = time.perf_counter()
        d = simulate.generate(os.path.join(tmp, "main"), mbp=1.0,
                              coverage=30, seed=11)
        gen_s = time.perf_counter() - t0
        mods = (torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d,
                gen_s)
        first = poa_driver.DEFAULT_POA_KERNEL
        second = "ls" if first == "v2" else "v2"
        runs = {first: run_main(*mods, first, "main"),
                second: run_main(*mods, second, f"main_{second}")}
        emit({"phase": "main_aligner_by_band",
              "aligner_by_band": runs[first][1].per_band()})
        require(runs[second][0] == runs[first][0], f"the {second} POA "
                f"kernel's FASTA differs from the {first} kernel's")
        emit({"phase": f"main_{second}_vs_main", "identical": True})
        # journal and resume, the traced polish and the watchdog, on the
        # main cell (the watchdog on the parity set)
        plain_s = journal_phase(racon_tpu_torch, cuda_lib, d, runs[first],
                                tmp)
        trace_wall, trace_path, cells, trace_stats = trace_phase(
            torch, racon_tpu_torch, cuda_lib, d, runs[first], plain_s, tmp,
            keep)
        costmodel_phase(trace_path, cells, trace_stats)
        kernel_bench_phase(torch)
        check_n_bases(torch, plain_ex)
        watchdog_phase(racon_tpu_torch, d_par)
        # serve: the resident daemon on the main cell
        serve_phase(torch, racon_tpu_torch, d, d_par, runs[first], plain_s,
                    tmp)
        # main_band: the main cell on the banded path
        band_run = run_main(*mods, "v2", "main_band",
                            band=band.DEFAULT_SLACK,
                            band_names=("poa_consensus_v2_band",
                                        "hirschberg_edge_k128",
                                        "hirschberg_edge", "hirschberg_base"))
        emit(band_vs_flat("main_band", band_run, runs[first]))
        # main_ls_band: the same with the ls POA kernel's banded build
        ls_band_run = run_main(*mods, "ls", "main_ls_band",
                               band=band.DEFAULT_SLACK,
                               band_names=("poa_consensus_band",
                                           "hirschberg_edge_k128",
                                           "hirschberg_edge",
                                           "hirschberg_base"))
        emit(band_vs_flat("main_ls_band", ls_band_run, runs[first]))

        # lowerr: a PacBio-HiFi-like set (about 1% error), flat and banded
        t0 = time.perf_counter()
        d_low = simulate.generate(os.path.join(tmp, "lowerr"), **LOWERR)
        gen_low = time.perf_counter() - t0
        mods_low = mods[:-2] + (d_low, gen_low)
        low = run_main(*mods_low, "v2", "lowerr", mbp=LOWERR["mbp"])
        low_band = run_main(*mods_low, "v2", "lowerr_band",
                            band=band.DEFAULT_SLACK,
                            band_names=("poa_consensus_v2_band",
                                        "hirschberg_edge_k128",
                                        "hirschberg_base_k128"),
                            mbp=LOWERR["mbp"])
        line = band_vs_flat("lowerr_band", low_band, low)
        line["aligner_by_band"] = {"flat": low[1].per_band(),
                                   "band": low_band[1].per_band()}
        emit(line)

        # chunked: the main cell's scale in four contigs, sequential and
        # chunked, while the CPU polishes run in their six processes (as
        # the main cell's polishes do): the smoke's serial tail is its
        # longest stretch of idle cores
        t0 = time.perf_counter()
        d_chunked = simulate.generate(os.path.join(tmp, "chunked"),
                                      **CHUNKED)
        chunked_seq, chunked_wall = chunked_phase(
            racon_tpu_torch, native, cuda_lib, d_chunked,
            time.perf_counter() - t0)

        # kept launches: the POA checks take the ls run's (one plain pass
        # serves both POA kernels) and the banded runs' banded launches,
        # the aligner checks the main run's and, at K = 128, the lowerr
        # banded run's; the rest are dropped
        rec, rec_ls = runs[first][1], runs["ls"][1]
        rec_band, rec_low = band_run[1], low_band[1]
        rec_ls_band = ls_band_run[1]
        keep = {}   # recorder -> the kernels whose launches it keeps
        for r, names in ((rec_ls, ("poa_consensus",)),
                         (rec, ("hirschberg_edge", "hirschberg_base")),
                         (rec_band, ("poa_consensus_v2_band",)),
                         (rec_ls_band, ("poa_consensus_band",)),
                         (rec_low, ("hirschberg_edge_k128",
                                    "hirschberg_base_k128"))):
            keep[id(r)] = keep.get(id(r), ()) + names
        for r in (runs["ls"][1], runs["v2"][1], rec_band, rec_ls_band, low[1],
                  rec_low):
            for key in list(r.largest):
                if key[0] not in keep.get(id(r), ()):
                    del r.largest[key]

        # the POA kernels' resources at the main path's geometries
        for cfg in sorted({c for _, (c, _) in
                           rec_ls.inputs("poa_consensus")},
                          key=lambda c: c.depth):
            occ = {"poa_consensus": poa_cuda.occupancy(cfg),
                   "poa_consensus_band": poa_cuda.occupancy(cfg, band=True),
                   "poa_consensus_v2": poa_v2_cuda.occupancy(cfg),
                   "poa_consensus_v2_band": poa_v2_cuda.occupancy(
                       cfg, band=True)}
            emit({"phase": "occupancy", "depth": cfg.depth,
                  "max_nodes": cfg.max_nodes, "max_len": cfg.max_len,
                  "ls_plan": poa_cuda.plan(cfg),
                  "v2_plan": poa_v2_cuda.plan(cfg),
                  "v2_band_plan": poa_v2_cuda.plan(cfg, band=True), **occ})

        # each kernel on its path's largest launches, against its plain
        # version (the POA checks' plain passes on one pool of host
        # processes, plain_ex)
        procs = max(1, min(8, os.cpu_count() or 1))
        (poa_row, ls_ms), poa_plain = check_poa(torch, poa_cuda, rec_ls,
                                                PLAIN_PROCS, plain_ex)
        v2_row, v2_ms = check_poa_v2(torch, poa_v2_cuda, poa_plain)
        checked = {"poa_consensus": poa_row, "poa_consensus_v2": v2_row,
                   "poa_consensus_v2_band": check_poa_band(
                       torch, poa_v2_cuda.poa_consensus_v2, "v2", rec_band,
                       PLAIN_PROCS, "main_band", ex=plain_ex),
                   "poa_consensus_band": check_poa_band(
                       torch, poa_cuda.poa_consensus, "ls", rec_ls_band,
                       PLAIN_PROCS, "main_ls_band", ex=plain_ex),
                   "hirschberg_edge": check_edge(torch, ac, rec),
                   "hirschberg_base": check_base(torch, ac, rec),
                   "hirschberg_edge_k128": check_edge(
                       torch, ac, rec_low, "hirschberg_edge_k128",
                       "lowerr_band"),
                   "hirschberg_base_k128": check_base(
                       torch, ac, rec_low, "hirschberg_base_k128",
                       "lowerr_band")}
        for r in (rec, rec_ls, rec_band, rec_ls_band, rec_low):
            r.largest.clear()
        del poa_plain
        emit(poa_decision(first, ls_ms, v2_ms))

        # wide: -w 1500 through both POA kernels' wide builds
        wide_phase(torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib,
                   d_wide, cpu_runs["wide"])
        # wide_3000: -w 3000 through both POA kernels' global builds
        global_rows, global_paths = wide3_phase(
            torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib, d_wide3,
            cpu_runs["wide3"], PLAIN_PROCS, plain_ex)
        checked.update(global_rows)
        # wide_11008: -w 11008 through both POA kernels' int32 global builds
        global32_rows, global32_paths = wide11_phase(
            torch, racon_tpu_torch, native, ac, poa_driver, cuda_lib,
            d_wide11, cpu_runs["wide11"], wide_id_plain)
        checked.update(global32_rows)
        # parity: the card, with each POA kernel and on the banded path,
        # and the CPU give the same bytes (last in the pool: its banded
        # CPU polishes are the smoke's longest path)
        gpu, gstats, g_s = polish(racon_tpu_torch, d_par, "cuda", first)
        gpu_2, _, g2_s = polish(racon_tpu_torch, d_par, "cuda", second)
        gpu_b, bstats, gb_s = polish(racon_tpu_torch, d_par, "cuda", "v2",
                                     PARITY_SLACK)
        gpu_lb, lbstats, glb_s = polish(racon_tpu_torch, d_par, "cuda", "ls",
                                        PARITY_SLACK)
        t0 = time.perf_counter()
        cpu, cstats, c_s = cpu_runs["flat"].result()
        cpu_b, cbstats, cb_s = cpu_runs["band"].result()
        cpu_lb, clbstats, clb_s = cpu_runs["ls_band"].result()
        wait_s = time.perf_counter() - t0
        require(gpu == cpu, "card and CPU polish the parity set differently")
        require(gpu_2 == cpu, f"the card's {second} kernel and the CPU "
                "polish the parity set differently")
        emit({"phase": "parity", "mbp": PARITY_MBP, "identical": True,
              f"cuda_{first}_s": g_s, f"cuda_{second}_s": g2_s,
              "cpu_s": c_s, "align_device": gstats["align"]["device"],
              "windows_device": gstats["consensus"]["device"]})
        require(gpu_b == cpu_b, "card and CPU polish the parity set "
                "differently on the banded path")
        require(bstats["align"]["band"] == cbstats["align"]["band"] and
                bstats["consensus"]["band"] ==
                cbstats["consensus"]["band"],
                "the banded path's counts differ between card and CPU")
        emit({"phase": "parity_band", "mbp": PARITY_MBP,
              "band_slack": PARITY_SLACK, "identical": True,
              "equals_flat": gpu_b == gpu, "cuda_s": gb_s, "cpu_s": cb_s,
              "cpu_wait_s": wait_s,
              "band": {"align": bstats["align"]["band"],
                       "consensus": bstats["consensus"]["band"]},
              "align_device": bstats["align"]["device"],
              "windows_device": bstats["consensus"]["device"]})
        require(gpu_lb == cpu_lb, "card and CPU polish the parity set "
                "differently on the ls banded path")
        require(lbstats["align"]["band"] == clbstats["align"]["band"] and
                lbstats["consensus"]["band"] ==
                clbstats["consensus"]["band"],
                "the ls banded path's counts differ between card and CPU")
        emit({"phase": "parity_ls_band", "mbp": PARITY_MBP,
              "band_slack": PARITY_SLACK, "identical": True,
              "equals_flat": gpu_lb == gpu, "cuda_s": glb_s, "cpu_s": clb_s,
              "band": {"align": lbstats["align"]["band"],
                       "consensus": lbstats["consensus"]["band"]},
              "align_device": lbstats["align"]["device"],
              "windows_device": lbstats["consensus"]["device"]})
        # host: the host backend on the parity set
        host_phase(racon_tpu_torch, native, d_par, gpu, procs)
        # the fleet: the chunked cell through worker processes that share
        # the card, once every CPU polish of the pool has ended
        d_small, small_text = fleet_phases(
            torch, racon_tpu_torch, simulate, d_chunked, chunked_seq,
            chunked_wall, tmp)
        # the stripe, the sweep and the wrapper
        stripe_phase(torch, racon_tpu_torch, cuda_lib, d, runs[first],
                     trace_wall, tmp)
        multichip_phase(torch)
        wrapper_phase(d_small, tmp, small_text)


    # the DP-cost probe's path
    launches_probe, checked["dp_cost_probe"] = probe_phase(torch, probe,
                                                           cuda_lib)

    src = "racon_tpu_torch/csrc/"
    kernels = [
        dict(name="poa_consensus", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64"),
        dict(name="poa_consensus_v2", source=src + "poa_v2.cu",
             replaces="racon_tpu/ops/poa_pallas.py:73"),
        dict(name="poa_consensus_v2_band", source=src + "poa_v2.cu",
             replaces="racon_tpu/ops/poa_pallas.py:73 (band=True)"),
        dict(name="poa_consensus_band", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64 (band=True)"),
        dict(name="hirschberg_edge", source=src + "align.cu",
             replaces="racon_tpu/ops/align_pallas.py:112"),
        dict(name="hirschberg_edge_k128", source=src + "align.cu",
             replaces="racon_tpu/ops/align_pallas.py:112 (K=128)"),
        dict(name="hirschberg_base", source=src + "align_base.cu",
             replaces="racon_tpu/ops/align_pallas.py:299"),
        dict(name="hirschberg_base_k128", source=src + "align_base.cu",
             replaces="racon_tpu/ops/align_pallas.py:299 (K=128)"),
        dict(name="dp_cost_probe", source=src + "dp_cost_probe.cu",
             replaces="racon_tpu/tools/dp_cost_probe.py:89"),
        dict(name="poa_consensus_global", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64 (window classes "
             "above 2048)"),
        dict(name="poa_consensus_band_global", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64 (band=True, window "
             "classes above 2048)"),
        dict(name="poa_consensus_v2_global", source=src + "poa_v2.cu",
             replaces="racon_tpu/ops/poa_pallas.py:73 (window classes above "
             "2304)"),
        dict(name="poa_consensus_v2_band_global", source=src + "poa_v2.cu",
             replaces="racon_tpu/ops/poa_pallas.py:73 (band=True, window "
             "classes above 2048)"),
        dict(name="poa_consensus_global32", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64 (window classes "
             "above 10,880: int32 node ids)"),
        dict(name="poa_consensus_band_global32", source=src + "poa.cu",
             replaces="racon_tpu/ops/poa_pallas_ls.py:64 (band=True, window "
             "classes above 10,880: int32 node ids)"),
        dict(name="poa_consensus_v2_global32", source=src + "poa_v2.cu",
             replaces="racon_tpu/ops/poa_pallas.py:73 (window classes above "
             "10,880: int32 node ids)"),
        dict(name="poa_consensus_v2_band_global32", source=src + "poa_v2.cu",
             replaces="racon_tpu/ops/poa_pallas.py:73 (band=True, window "
             "classes above 10,880: int32 node ids)"),
    ]
    # launches and path sums: each POA kernel from its own polish, the
    # banded POA builds from main_band and main_ls_band, the K = 128
    # builds from lowerr_band, the other aligner kernels from the main
    # polish
    path_of = {POA_NAME[kn]: (r[2], r[3]) for kn, r in runs.items()}
    path_of["poa_consensus_v2_band"] = (band_run[2], band_run[3])
    path_of["poa_consensus_band"] = (ls_band_run[2], ls_band_run[3])
    for name in ("hirschberg_edge_k128", "hirschberg_base_k128"):
        path_of[name] = (low_band[2], low_band[3])
    path_of["dp_cost_probe"] = (launches_probe, None)
    path_of.update(global_paths)
    path_of.update(global32_paths)
    for k in kernels:
        k.update(checked[k["name"]])
        counts, summary = path_of.get(k["name"],
                                      (runs[first][2], runs[first][3]))
        k.update(route="cuda", launches=counts[k["name"]], library_ms=None)
        if summary is not None:
            m = summary[k["name"]]
            k.update(main_device_ms=m["device_ms"],
                     main_bound_ms=m["bound_ms"])
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
