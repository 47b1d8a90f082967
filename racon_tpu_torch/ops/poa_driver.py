"""Consensus-phase driver: packs windows into depth-bucketed batches, runs
a POA kernel, trims and installs the results, and re-polishes on the
host every window the kernel flags ``failed``.

A copy of the JAX package's driver (racon_tpu/ops/poa_driver.py) reduced
to one path: no sanitizer and no lattice. The kernel is an
argument, ``poa_kernel``: "ls" (ops/poa_cuda.py, the
default, as in the JAX package, and faster than v2 on every depth bucket
on the card) or "v2" (ops/poa_v2_cuda.py); both compute one function,
and neither steps down to the other. Both keep H in global memory and
plan their shared memory per launch (``plan``), with a wide build of 16
columns a thread where max_len + 1 > 2048 and a global build (the graph
in global memory, DP rows in tiles) where no shared-memory layout fits;
above 32,767 node slots (classes above 10,880) the global build takes
int32 node ids. A window's global scratch (H and the move records, about
5 bytes a DP cell, about 22.5 x class^2 bytes) grows with N x max_len:
about 95 MB at class 2048, 380 MB at 4096, 2.7 GB at 10,880, 6.0 GB at
16,384. Before any window runs, the phase checks that one window of
every bucket's geometry fits the card's free memory less a margin
(``check_memory``) and raises one ValueError, naming the largest window
length that fits, where one does not; no window is sent to the host for
its size. Each bucket's batches are capped by geometry (``batch_cap``):
as many windows as the card's free memory holds for every batch in
flight, less the margin (``MEMORY_MARGIN``), and at most
``batch_windows``. A process that shares the card (a fleet's worker)
sizes both from its share of the card instead, where that is smaller
(``device_memory_share``, ``sizing_bytes``).

Every batch is launched through a ``partitioner`` (parallel/partitioner.py;
by default one over `device` alone, whose stripe runs on the caller's
current stream). Over m > 1 devices a batch's windows are cut into m
slices, each device launches the kernel on its slice on a stream of its
own, and the host gathers the slices in order, waiting on every stripe's
event under the watchdog. Memory is sized per card: ``check_memory`` runs
once for each distinct card, stripes that share a card (a virtual
stripe) split its room between them, and a batch holds at most m times
the smallest stripe's cap.

The batches go through the shared feeder (ops/batch_exec.py) with up to
``pipeline_depth`` batches in flight (2, as the JAX package's
``RACON_TPU_PIPELINE_DEPTH``): the host exports and packs batch N+1, into
pinned buffers, while the card runs batch N; the bytes are the same at
every depth.

With ``band`` (the JAX package's ``RACON_TPU_BAND``) every batch runs the
chosen kernel's banded build: each window gets the half band of its worst
layer's length delta plus ``band_slack`` (ops/band.py), or 0 (flat) where
that band would not be much narrower than the DP row. A window whose
kernel run sets band_hit, or fails, under a band is re-run at twice the
band, at most ``band_max_widenings`` times and below ``max_len // 2``,
then at 0, through the same build; only a failure at 0 goes to the host.
The two banded builds differ where a band cuts the path off (an ls layer
with no end score above NEG fails, and adds nothing to the graph), but the
ladder re-runs every window that fails or hits, so both end in the flat
bytes.

With a journal (resilience/journal.py), windows a previous run journaled
are installed before the metadata pass and left out of the batches; each
window whose result is final is journaled as it is installed (a band hit
goes back to the ladder and a failed window to the host, and neither is
journaled there), with the host re-polish (tier "host") and the backbone
windows ("backbone"), all on this thread. The run point
``poa.run.<kernel>`` is checked for each batch where the host waits for
it, under the watchdog (``device_timeout_s``), so a ``hang=`` fault is a
card that does not answer; a ``raise`` there ends the polish.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .. import obs
from ..parallel.partitioner import get_partitioner
from ..resilience import faults
from ..resilience.journal import replay_windows
from . import band as _band
from . import poa, poa_cuda
from .batch_exec import DEFAULT_DEPTH, BatchExecutor
from .encoding import decode, encode
from .poa_cuda import poa_consensus
from .poa_v2_cuda import poa_consensus_v2

DEPTH_CAP = 200                    # layers per window, as the reference
DEPTH_BUCKETS = (8, 32, DEPTH_CAP)
NODE_FACTOR = 3                    # max_nodes = 3 x window length
POA_KERNELS = ("ls", "v2")
DEFAULT_POA_KERNEL = "ls"
#: What the consensus phase leaves of the card's free memory: 1 GiB and a
#: tenth of the rest, for the allocator's rounding, the phase's other
#: tensors and whatever else runs on the card (in a pipelined polish, the
#: alignment of the next chunk).
MEMORY_MARGIN = (1 << 30, 0.1)


def window_class(bb_len: int) -> int:
    """Kernel-geometry class for a backbone length: ceil to the 128 grid,
    so short windows run in their own class's geometry."""
    return max(128, (bb_len + 127) // 128 * 128)


def make_config(window_length: int, depth: int, match: int, mismatch: int,
                gap: int) -> poa.PoaConfig:
    def ceil128(x):
        return (x + 127) // 128 * 128

    return poa.PoaConfig(max_nodes=ceil128(NODE_FACTOR * window_length),
                         max_len=ceil128(window_length + window_length // 2),
                         max_backbone=ceil128(window_length), max_edges=12,
                         depth=depth, match=match, mismatch=mismatch,
                         gap=gap)


def tgs_trim(codes: np.ndarray, cov: np.ndarray, n_seqs: int):
    """Low-coverage end trim (reference: src/window.cpp:125-146)."""
    avg = (n_seqs - 1) // 2
    n = len(codes)
    begin = 0
    while begin < n and cov[begin] < avg:
        begin += 1
    end = n - 1
    while end >= 0 and cov[end] < avg:
        end -= 1
    if begin >= end:
        return codes  # chimeric suspicion: keep untrimmed
    return codes[begin:end + 1]


def kernel_for(poa_kernel: str):
    """The POA wrapper for a kernel name, looked up in this module when
    called (so a caller may wrap it here). Each wrapper runs its banded
    build when given ``wband=``."""
    if poa_kernel not in POA_KERNELS:
        raise ValueError(f"poa_kernel must be 'ls' or 'v2', got "
                         f"{poa_kernel!r}")
    return poa_consensus if poa_kernel == "ls" else poa_consensus_v2


def memory_room(free_bytes: int) -> int:
    """The bytes the consensus phase may take of `free_bytes`: all but
    MEMORY_MARGIN."""
    fixed, share = MEMORY_MARGIN
    return free_bytes - fixed - int(share * max(0, free_bytes - fixed))


def largest_window(room: int, depth: int) -> int:
    """The largest window length (-w, on the 128 grid of the window
    classes) one window of which, at `depth`, fits `room` bytes
    (``window_bytes``); 0 where none does."""
    def fits(k):
        return window_bytes(make_config(128 * k, depth, 0, 0, 0)) <= room

    lo, hi = 0, 1
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return 128 * lo


def check_memory(cfgs, free_bytes: int, poa_kernel: str,
                 stripes: int = 1) -> None:
    """Before any window runs on the card: both POA kernels take every
    geometry, flat or banded (above class 10,880 through their global
    build with int32 node ids), so the one limit is memory. Raises one
    ValueError where a single window of some geometry does not fit
    `free_bytes` less MEMORY_MARGIN, split between the `stripes` that
    share the card, naming the largest window length that fits."""
    room = memory_room(free_bytes) // max(1, stripes)
    for cfg in cfgs:
        need = window_bytes(cfg)
        if need > room:
            raise ValueError(
                f"the {poa_kernel} POA kernel does not take windows of "
                f"backbone class {cfg.max_backbone} on this card: one "
                f"window needs {need} bytes of device memory and "
                f"{max(0, room)} are free after the margin; the largest "
                f"window length that fits is -w "
                f"{largest_window(room, cfg.depth)}")


def window_bytes(cfg: poa.PoaConfig) -> int:
    """Device bytes one window of a batch at cfg's geometry takes: its
    global scratch (the global build's, the larger), its inputs, outputs
    and counts. A pure function of the geometry."""
    N, ML, MB, D = cfg.max_nodes, cfg.max_len, cfg.max_backbone, cfg.depth
    inputs = MB * 5 + 8 + D * ML * 5 + D * 12 + 4
    outputs = 2 * N * 4 + 4 + 1 + 4 + 1 + 8 * 8
    return 4 * poa_cuda.scratch_words(cfg, True) + inputs + outputs


def batch_cap(cfg: poa.PoaConfig, free_bytes: int, depth: int = 1,
              stripes: int = 1) -> int:
    """How many windows of cfg's geometry a batch (or one stripe of it)
    may hold on a card with `free_bytes` free while `depth` batches are in
    flight and `stripes` stripes share the card: the free bytes less
    MEMORY_MARGIN over stripes x depth x ``window_bytes``, at least 1."""
    return max(1, memory_room(free_bytes) //
               (max(1, stripes) * max(1, depth) * window_bytes(cfg)))


def free_device_bytes(device) -> int:
    """The card's free memory, counting what the caching allocator holds
    but does not use."""
    free, _ = torch.cuda.mem_get_info(device)
    return free + torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)


def shared_free_bytes(free_bytes: int, total_bytes: int, held_bytes: int,
                      share: float) -> int:
    """The free bytes a process that may hold `share` of a card sizes
    from: the smaller of `free_bytes` and that share of `total_bytes`
    less the `held_bytes` it already uses; `free_bytes` at a share of 1.
    Worker processes of one fleet each hold 1 / (its pool's ceiling),
    so that two of them sizing a batch at the same moment cannot each
    take nearly all of the card."""
    if share >= 1.0:
        return free_bytes
    return max(0, min(free_bytes, int(share * total_bytes) - held_bytes))


def sizing_bytes(device, share: float = 1.0) -> int:
    """``free_device_bytes`` capped at `share` of the card
    (``shared_free_bytes``): what ``check_memory`` and ``batch_cap``
    size from."""
    free = free_device_bytes(device)
    if share >= 1.0:
        return free
    _, total = torch.cuda.mem_get_info(device)
    return shared_free_bytes(free, total, torch.cuda.memory_allocated(device),
                             share)


def initial_poa_band(wx, keep, cfg: poa.PoaConfig, slack: int):
    """w0 (half band) for a window: the worst admitted layer's length less
    its span, plus the slack; None (flat) where the band would not be
    much narrower than the DP row."""
    if not keep:
        return None
    delta = max(abs(int(wx.lens[j]) - (int(wx.ends[j]) - int(wx.begins[j])))
                for j in keep)
    w0 = delta + max(0, slack)
    return w0 if 2 * w0 + 1 < cfg.max_len // 2 else None


def run_consensus_phase(pipeline, *, match: int, mismatch: int, gap: int,
                        trim: bool, device="cuda", batch_windows: int = 256,
                        poa_kernel: str = DEFAULT_POA_KERNEL,
                        band: bool = False,
                        band_slack: int = _band.DEFAULT_SLACK,
                        band_max_widenings: int = _band.DEFAULT_MAX_WIDENINGS,
                        pipeline_depth: int = DEFAULT_DEPTH,
                        budget=None, journal=None, report=None,
                        device_timeout_s: float = 0.0,
                        device_memory_share: float = 1.0,
                        partitioner=None) -> dict:
    """Kernel consensus for every window with at least two layers; the
    backbone for the rest; the host POA for windows the kernel fails.
    `poa_kernel` ("ls", the default, or "v2") picks the kernel; `band`
    runs its banded build with the widening ladder (module note). The
    batches go through ops/batch_exec.py with `pipeline_depth` of them in
    flight; `budget` (resilience/budget.py), when given, collapses that
    to 1 once its hard watermark latches.

    Returns {device, host_fallback, backbone, failed, layers_dropped,
    batches, host_seconds, band, pack_wall_s, kernel_wall_s,
    depth_collapsed}: windows served by the kernel, re-polished on the
    host, passed through as backbone, flagged failed by the kernel (at
    wband 0), layers dropped at admission, kernel batches run (re-runs
    included), the wall time of the host re-polish, the ladder's counts
    (ops/band.py; all 0 without `band`), the host's wall exporting and
    packing and blocked on the card, and whether the depth collapsed.

    `journal` replays and journals windows (module note); `report`, a
    PhaseReport("consensus", ...), gets the served counts by tier (the
    kernel, host, backbone, journal; they sum to the window count), the
    wall seconds and the extras: device_rejected, layers_dropped_maxlen,
    band, pack_wall_s, kernel_wall_s, depth_collapsed.
    `device_timeout_s` is the watchdog's deadline on each batch's wait (0:
    none). `device_memory_share` is the share of each card this process
    may hold (``sizing_bytes``; 1: all of it). `partitioner` stripes the
    batches over its devices (module note; default: `device` alone)."""
    device = torch.device(device)
    kernel_for(poa_kernel)
    n = pipeline.num_windows()
    stats = {"device": 0, "host_fallback": 0, "backbone": 0, "failed": 0,
             "layers_dropped": 0, "batches": 0, "band": _band.new_stats()}
    fallback: List[int] = []
    replayed = replay_windows(pipeline, journal, n, report)

    # Metadata pass: depth buckets, no layer bytes touched.
    jobs = []          # (window_idx, estimated depth, backbone len)
    with obs.span("poa.metadata", windows=n):
        for i in range(n):
            if i in replayed:
                continue
            n_seqs, bb_len, _rank, _is_tgs, _bytes, tid = \
                pipeline.window_info(i)
            k = n_seqs - 1
            if k < 2:
                # <3 sequences incl. backbone: backbone passthrough
                # (reference: src/window.cpp:68-71)
                wx = pipeline.export_window(i)
                pipeline.set_consensus(i, wx.backbone.tobytes(), False)
                if journal is not None:
                    journal.append_window(i, tid, wx.rank, "backbone",
                                          wx.backbone.tobytes(), False)
                stats["backbone"] += 1
                continue
            jobs.append((i, min(k, DEPTH_CAP), bb_len))

    buckets = {}
    for i, depth, bb in jobs:
        bucket = next(b for b in DEPTH_BUCKETS if depth <= b)
        buckets.setdefault((bucket, window_class(bb)), []).append(
            (i, depth, bb))
    cfgs = {key: make_config(key[1], key[0], match, mismatch, gap)
            for key in buckets}
    part = (get_partitioner([device]) if partitioner is None
            else partitioner)
    cards = part.cards()
    if device.type == "cuda":
        for card, k in cards.items():
            check_memory(cfgs.values(),
                         sizing_bytes(card, device_memory_share), poa_kernel,
                         stripes=k)
    ops = _ConsensusOps(pipeline, device, part, poa_kernel, trim, stats,
                        fallback, band, band_slack, band_max_widenings,
                        journal, device_timeout_s)
    executor = BatchExecutor(ops, depth=pipeline_depth, budget=budget)
    t_dev = time.perf_counter()
    for key, bucket_jobs in sorted(buckets.items()):
        cfg = cfgs[key]
        obs.count(f"poa.windows.d{key[0]}.c{key[1]}", len(bucket_jobs))
        # the cost model's cells (obs/costmodel.py): the admitted depth
        # times the class, summed over the bucket's windows (the rank
        # steps at graph growth 1; padding layers are not DP work)
        obs.count(f"poa.cells.d{key[0]}.c{key[1]}",
                  sum(d for _, d, _ in bucket_jobs) * key[1])
        # the bucket's span covers its submissions; with batches in
        # flight, a batch of one bucket may resolve in the next one's
        with obs.span("poa.bucket", depth=key[0], wl_class=key[1],
                      windows=len(bucket_jobs)):
            # depth- and length-homogeneous batches, as many as the card
            # holds
            bucket_jobs.sort(key=lambda job: (job[1], job[2]))
            per_batch = batch_windows
            if device.type == "cuda":
                per_batch = min(per_batch, part.n_devices * min(
                    batch_cap(cfg, sizing_bytes(card, device_memory_share),
                              executor.depth, k)
                    for card, k in cards.items()))
            for off in range(0, len(bucket_jobs), per_batch):
                executor.submit(cfg, [i for i, _, _ in
                                      bucket_jobs[off:off + per_batch]])
    executor.flush()
    executor.stamp_walls(stats)
    stats["depth_collapsed"] = executor.collapsed
    t_host = time.perf_counter()

    with obs.span("poa.host_fallback", windows=len(fallback)):
        for i in fallback:
            polished = pipeline.consensus_cpu_one(i)
            if journal is not None:
                _, _, rank, _, _, tid = pipeline.window_info(i)
                journal.append_window(i, tid, rank, "host",
                                      pipeline.get_consensus(i), polished)
            stats["host_fallback"] += 1
    stats["host_seconds"] = time.perf_counter() - t_host
    if report is not None:
        report.total += n
        report.record_served(poa_kernel, stats["device"])
        report.record_served("host", stats["host_fallback"])
        report.record_served("backbone", stats["backbone"])
        report.add_wall(poa_kernel, t_host - t_dev)
        report.add_wall("host", stats["host_seconds"])
        report.extra.update(
            device_rejected=stats["failed"],
            layers_dropped_maxlen=stats["layers_dropped"],
            band=dict(stats["band"]), pack_wall_s=stats["pack_wall_s"],
            kernel_wall_s=stats["kernel_wall_s"],
            depth_collapsed=stats["depth_collapsed"])
    return stats


class _ConsensusOps:
    """The consensus phase's hooks for the feeder (ops/batch_exec.py); the
    context of each batch is its bucket's geometry (a PoaConfig). Windows
    whose band hit (``band``) are kept by ``install`` and handed back by
    ``widen``, to be re-run at their widened band."""

    def __init__(self, pipeline, device, part, poa_kernel, trim, stats,
                 fallback, band, band_slack, band_max_widenings,
                 journal=None, timeout_s=0.0):
        self.pipeline, self.device, self.part = pipeline, device, part
        self.kernel = kernel_for(poa_kernel)
        self.kernel_name = poa_kernel
        self.journal, self.timeout_s = journal, timeout_s
        self.trim, self.stats, self.fallback = trim, stats, fallback
        self.band, self.band_slack = band, band_slack
        self.band_max_widenings = band_max_widenings
        self.states = {}   # window -> its BandState (ops/band.py)
        self._retry = []   # windows whose band hit in the last install

    def export(self, cfg, idxs):
        chunk = _export_chunk(self.pipeline, idxs, cfg, self.fallback,
                              self.stats)
        if self.band:
            for i, wx, keep in chunk:
                st = self.states[i] = _band.BandState(
                    initial_poa_band(wx, keep, cfg, self.band_slack))
                self.stats["band"]["jobs"] += bool(st.k)
                _count_banded_cells(st, keep)
        return chunk

    def pack(self, cfg, chunk):
        widths = ([self.states[i].k or 0 for i, _, _ in chunk]
                  if self.band else None)
        return _pack(chunk, cfg, widths, pin=self.device.type == "cuda")

    def dispatch(self, cfg, packed, chunk):
        """Launch the batch through the partitioner: on the card, the
        pinned inputs copied to each stripe's device without blocking,
        the kernel, its outputs copied into pinned host tensors without
        blocking and an event recorded; on the CPU the plain version.
        Returns (the StripeRun, window indices)."""
        self.stats["batches"] += 1
        kernel, band = self.kernel, self.band

        def launch(*ins):
            kw = {"wband": ins[9]} if band else {}
            outs = kernel(cfg, *ins[:9], **kw)
            return outs[:4] + outs[5:]

        arrays = packed[:10] if band else packed[:9]
        return self.part.stripe(launch, arrays), [i for i, _, _ in chunk]

    def unpack(self, cfg, handle):
        """Host numpy (cons_base, cons_cov, cons_len, failed, and
        band_hit from the banded build), waiting on the batch's events
        alone, under the watchdog, with the run point checked inside the
        wait."""
        run, idxs = handle
        point = f"poa.run.{self.kernel_name}"
        return self.part.gather(
            run, timeout_s=self.timeout_s,
            what=f"the {self.kernel_name} POA batch of {len(idxs)} windows",
            before=lambda: faults.check(point, idxs))

    def attempt(self, cfg, packed, chunk):
        return self.unpack(cfg, self.dispatch(cfg, packed, chunk))

    def install(self, cfg, chunk, results):
        forced = False
        if self.band and any(self.states[i].k for i, _, _ in chunk):
            # the widening-exhaustion drill: an injected band.hit makes
            # every banded window of the attempt a hit
            try:
                faults.check("band.hit", [i for i, _, _ in chunk])
            except faults.InjectedFault:
                forced = True
        self._retry += _install(self.pipeline, chunk, results, self.trim,
                                self.stats, self.fallback,
                                self.states if self.band else None,
                                cfg.max_len // 2, self.band_max_widenings,
                                journal=self.journal,
                                tier=self.kernel_name, force_hit=forced)

    def widen(self, cfg):
        retry, self._retry = self._retry, []
        return retry

    def done(self, cfg, chunk):
        for i, _, _ in chunk:
            self.states.pop(i, None)


def _count_banded_cells(st, keep) -> None:
    """``poa.cells.banded``: the cells of a banded window's next run, its
    layers times its band's 2k + 1 columns, counted where its band is set
    or widened (not where it runs flat), as the JAX driver counts them."""
    if st.k and obs.enabled():
        obs.count("poa.cells.banded", len(keep) * (2 * st.k + 1))


def _export_chunk(pipeline, idxs, cfg, fallback, stats):
    """Export window bases for one chunk; apply per-layer admission.

    Returns [(window_idx, export, kept layer indices)]; a window left with
    fewer than two admissible layers goes to the host."""
    chunk = []
    for i in idxs:
        wx = pipeline.export_window(i)
        k = len(wx.lens)
        keep = [j for j in range(k) if 0 < wx.lens[j] <= cfg.max_len]
        stats["layers_dropped"] += int(
            sum(1 for ln in wx.lens[:DEPTH_CAP] if ln > cfg.max_len))
        if len(keep) < len(wx.lens[:DEPTH_CAP]) and len(keep) < 2:
            fallback.append(i)
            continue
        chunk.append((i, wx, keep[:DEPTH_CAP]))
    return chunk


_TORCH_DTYPE = {np.uint8: torch.uint8, np.int32: torch.int32}


def _zeros(shape, dtype, pin: bool) -> np.ndarray:
    """A zeroed host array; with `pin`, a view of a pinned torch tensor
    (the card copies from it without blocking)."""
    if not pin:
        return np.zeros(shape, dtype=dtype)
    return torch.zeros(shape, dtype=_TORCH_DTYPE[dtype],
                       pin_memory=True).numpy()


def _pack(chunk, cfg, widths=None, pin: bool = False):
    """Numpy batch of the chunk's windows in the kernel's layout: the
    JAX package's 10-tuple, the trailing row each window's half band
    (`widths`, else 0). With `pin`, every array is a view of pinned host
    memory."""
    B = len(chunk)
    bb = _zeros((B, cfg.max_backbone), np.uint8, pin)
    bbw = _zeros((B, cfg.max_backbone), np.int32, pin)
    bb_len = _zeros(B, np.int32, pin)
    bb_len[:] = 1                        # padded windows: 1-base backbone
    n_layers = _zeros(B, np.int32, pin)
    seqs = _zeros((B, cfg.depth, cfg.max_len), np.uint8, pin)
    ws = _zeros((B, cfg.depth, cfg.max_len), np.int32, pin)
    lens = _zeros((B, cfg.depth), np.int32, pin)
    begins = _zeros((B, cfg.depth), np.int32, pin)
    ends = _zeros((B, cfg.depth), np.int32, pin)
    wband = _zeros(B, np.int32, pin)
    if widths is not None:
        wband[:] = widths

    for bi, (i, wx, keep) in enumerate(chunk):
        L = len(wx.backbone)
        bb[bi, :L] = encode(wx.backbone)
        bbw[bi, :L] = wx.backbone_weights
        bb_len[bi] = L
        K = len(keep)
        n_layers[bi] = K
        if K == 0:
            continue
        enc = encode(wx.bases)
        offsets = np.concatenate([[0], np.cumsum(wx.lens)]).astype(np.int64)
        kp = np.asarray(keep, dtype=np.int64)
        lens_k = wx.lens[kp].astype(np.int64)
        ML = cfg.max_len
        sflat = seqs[bi].reshape(-1)
        wflat = ws[bi].reshape(-1)
        for li in range(K):
            o = offsets[kp[li]]
            ll = lens_k[li]
            sflat[li * ML:li * ML + ll] = enc[o:o + ll]
            wflat[li * ML:li * ML + ll] = wx.weights[o:o + ll]
        lens[bi, :K] = lens_k
        begins[bi, :K] = wx.begins[kp]
        ends[bi, :K] = wx.ends[kp]
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends, wband)


def _install(pipeline, chunk, results, trim, stats, fallback, states=None,
             band_cap=0, max_widenings=_band.DEFAULT_MAX_WIDENINGS,
             journal=None, tier="device", force_hit=False):
    """Installs the chunk's consensus; a failed window goes to the host.
    With band `states`, a window run under a band that hit or failed
    (or every banded window, with `force_hit`) widens instead; returns
    those windows, to be re-run. Each installed window, and only those,
    is journaled under `tier`."""
    cons_base, cons_cov, cons_len, failed = results[:4]
    retry = []
    for bi, (i, wx, keep) in enumerate(chunk):
        st = states.get(i) if states else None
        if st is not None and st.k:
            if force_hit or results[4][bi] or failed[bi]:
                st.widen_width(band_cap, stats["band"], max_widenings)
                _count_banded_cells(st, keep)
                retry.append((i, wx, keep))
                continue
        if failed[bi]:
            fallback.append(i)
            stats["failed"] += 1
            continue
        cl = int(cons_len[bi])
        codes = cons_base[bi, :cl]
        if wx.is_tgs and trim:
            # threshold on the ADMITTED sequence count (backbone + packed
            # layers), as the reference accelerator counts only sequences
            # added to its batch (src/cuda/cudabatch.cpp:139-163,233)
            codes = tgs_trim(codes, cons_cov[bi, :cl], len(keep) + 1)
        payload = decode(codes)
        pipeline.set_consensus(i, payload, True)
        if journal is not None:
            journal.append_window(i, wx.target_id, wx.rank, tier, payload,
                                  True)
        stats["device"] += 1
    return retry
