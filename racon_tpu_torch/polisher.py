"""TorchPolisher: the accelerated polishing path on a CUDA card; CpuPolisher:
the native host pipeline.

TorchPolisher mirrors the JAX package's TpuPolisher (racon_tpu/polisher.py):
parse and filter natively, align CIGAR-less overlaps with the Hirschberg
kernels, build windows natively, run POA consensus with the CUDA kernel,
stitch natively. Per-item host paths are the algorithm's own: a job whose
band does not fit or whose path escapes the band is aligned on the host,
and a window the kernel flags failed is re-polished on the host. Both are
counted in ``stats``.

Its chunked modes split a multi-contig FASTA target into contiguous
chunks (``_split_fasta``) and polish each with a pipeline of its own; the
chunks' FASTA, concatenated in order, is the sequential run's, byte for
byte:

* **pipelined phases** (``pipeline_phases``): one worker thread parses,
  aligns and windows chunk N+1 while the calling thread runs consensus
  and stitches chunk N, through a FIFO queue of ``handoff_depth`` chunks.
  Each thread launches on a CUDA stream of its own;
* **streamed input** (``stream_input``, or any ``memory_budget_mb``):
  each chunk parses only its own byte ranges of the reads and overlaps
  files (streamio.py), so peak RSS grows with the chunk, not the genome;
* the **memory budget** (``memory_budget_mb``; resilience/budget.py): at
  the soft watermark a chunk's working set is parked on disk and the
  worker stops running ahead; the hard watermark latches and collapses
  the pipeline to sequential and the consensus feeder to depth 1.

Where a chunked mode cannot run, a NOTE on stderr says so and the phases
run sequentially: a target that is not FASTA, one contig, or MHAP
overlaps. MHAP names reads and targets by their ordinals in the input
files, which a chunk's own target file renumbers: the JAX package chunks
MHAP input all the same (streaming falls back to the whole inputs there)
and its chunked FASTA then differs from its sequential one, so the port
keeps MHAP input sequential. These choose a host-side schedule; no work
leaves the card.

TorchPolisher launches both phases' kernels through a Partitioner over
``devices`` (parallel/partitioner.py; the JAX package shards them over a
mesh of every device, racon_tpu/parallel): by default every visible
card. On one device each launch runs under that device on the caller's
current stream. With m > 1 devices each batch of the consensus phase and
each launch of the aligner's rounds is cut into m slices by rows, one
launch a device on a stream of its own, and gathered on the host in
order. A device may repeat (``devices=["cuda:0", "cuda:0"]``, a virtual
stripe: two streams on one card). The bytes do not depend on the stripe.

Both polishers take the JAX package's run-time surfaces as arguments
(racon_tpu/polisher.py):

* ``journal_path`` with ``resume_journal`` (resilience/journal.py): every
  served window and kernel CIGAR is journaled as it is installed, and a
  resumed run replays them and gives the same bytes. The journal needs
  run-global window indices, so a journaled run sets the chunked modes
  aside, with a NOTE, and runs sequentially (a memory budget still
  collapses the consensus feeder). ``journal_fsync`` fsyncs each record;
  ``self.journal`` is the run's Journal, or None;
* ``trace_path`` (obs/): phase spans ``phase.parse``, ``phase.align``,
  ``phase.window_assign``, ``phase.poa`` and ``phase.stitch`` around the
  sequential path and each chunk (``chunk=ci``), the drivers' spans and
  counters, and, on the card, a device track of every launch; written by
  polish();
* ``device_timeout_s`` (TorchPolisher; resilience/watchdog.py): the
  deadline on each wait for the card; 0 turns it off;
* ``self.report`` (resilience/report.py): served counts by tier for each
  phase, finalized by polish();
* ``sanitize`` with ``sanitize_parity`` (TorchPolisher and
  create_polisher; the JAX package's ``RACON_TPU_SANITIZE`` and
  ``RACON_TPU_SANITIZE_PARITY``): arms the runtime sanitizer
  (analysis/sanitize.py) for the run. It checks each gathered launch,
  each install seam, every N-th window against a host recompute, and the
  drivers' stats dicts against writes from other threads; its findings
  go to the report's ``sanitize`` section. The bytes are the unarmed
  run's, in the chunked modes too. Daemon and fleet jobs run unarmed.

Each constructor first resets the fault schedule (resilience/faults.py),
the obs state, the device track's launch sink and the sanitizer's arming
and findings. An injected fault at a
run point ends the polish with its error: nothing falls back to a plain
version or to the host.
"""

from __future__ import annotations

import inspect
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import List, Optional, Tuple

import torch

from . import obs
from .analysis import sanitize as _sanitize
from .ops import band as _band
from .ops.align_driver import run_alignment_phase
from .ops.batch_exec import DEFAULT_DEPTH
from .ops.poa_driver import (DEFAULT_POA_KERNEL, kernel_for,
                              run_consensus_phase)
from .parallel import get_partitioner, resolve_devices
from .pipeline import Pipeline
from .resilience import faults
from .resilience.budget import MemoryBudget, at_least, peak_rss_mb
from .resilience.journal import Journal, input_fingerprint, replay_windows
from .resilience.report import (ALIGN_TIERS, PhaseReport, RunReport,
                                consensus_tiers)

#: Handoff-queue sentinel: the alignment worker is done.
_DONE = object()
#: The phases of a chunk, in order, as stats["chunk_s"] times them.
CHUNK_PHASES = ("parse", "align", "windows", "consensus", "stitch")


class _WorkerFailure:
    """An exception raised on the alignment worker thread, re-raised on
    the consumer, so that a pipelined polish fails as a sequential one
    does (instead of waiting on the queue)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _split_fasta(target_path: str, n_chunks_hint: int, outdir: str):
    """Split a multi-contig FASTA into up to `n_chunks_hint` contiguous,
    roughly base-balanced chunk files (record text copied verbatim, so
    each chunk parses to byte-identical contigs). Returns the chunk
    paths, or None when the target is not splittable (one contig,
    non-FASTA content): the caller runs the phases sequentially. The
    chunks' polished output, concatenated in chunk order, is the
    unchunked run's."""
    import gzip

    opener = gzip.open if target_path.lower().endswith(".gz") else open
    records = []   # [bases, [raw lines]]
    cur = None
    try:
        with opener(target_path, "rt") as f:
            for line in f:
                if line.startswith(">"):
                    cur = [0, [line]]
                    records.append(cur)
                elif cur is None:
                    return None   # leading non-FASTA content
                else:
                    cur[0] += len(line.strip())
                    cur[1].append(line)
    except (OSError, UnicodeDecodeError):
        return None
    if len(records) < 2:
        return None
    k = min(len(records), max(2, n_chunks_hint))
    per_chunk = sum(r[0] for r in records) / k
    paths = []
    idx = 0
    for ci in range(k):
        must_leave = k - ci - 1   # later chunks each need >= 1 contig
        group = [records[idx]]
        acc = records[idx][0]
        idx += 1
        while (len(records) - idx > must_leave
               and (ci == k - 1 or acc + records[idx][0] <= per_chunk)):
            group.append(records[idx])
            acc += records[idx][0]
            idx += 1
        path = os.path.join(outdir, f"chunk{ci:03d}.fasta")
        with open(path, "w") as f:
            for _, lines in group:
                f.writelines(lines)
        paths.append(path)
    return paths


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "racon_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


def _note(msg: str) -> None:
    print(f"[racon_tpu_torch::polisher] {msg}", file=sys.stderr)


def _reset_run_state(trace_path: Optional[str], sanitize: bool = False,
                     sanitize_parity: int = _sanitize.DEFAULT_PARITY) -> None:
    """Per-run reset of the process-wide state, first in each polisher
    constructor: the fault schedule, the obs state, the device track's
    sink and the sanitizer's findings start afresh (a caller's
    cuda_lib.LAUNCH_EVENTS list is left as it is), then tracing is armed
    where a trace is asked for, and the sanitizer where `sanitize`."""
    faults.reset()
    obs.reset()
    obs.configure(trace_path=trace_path)
    _sanitize.arm(sanitize, sanitize_parity)


def _racon_params(racon_kwargs: dict) -> dict:
    """racon's parameters as the pipeline takes them: every one, with its
    default where it was not given, as its default's type. So the
    fingerprint is the same whether a caller passes a default or leaves
    it out (the CLI passes them all; 10 and 10.0 are one threshold)."""
    params = {}
    for name, arg in inspect.signature(Pipeline).parameters.items():
        if arg.kind is not arg.KEYWORD_ONLY:
            continue
        value = racon_kwargs.get(name, arg.default)
        params[name] = type(arg.default)(value)
    return params


def _open_journal(paths, backend: str, journal_path: Optional[str],
                  resume: bool, racon_kwargs: dict, fsync: bool):
    """The run's journal, or None. An explicit resume of a journal with
    another fingerprint raises JournalError; a missing file starts
    fresh."""
    if journal_path is None:
        return None
    fp = input_fingerprint(paths, _racon_params(racon_kwargs), backend)
    return Journal(journal_path, fp, resume=resume, fsync=fsync)


def _merge(total: Optional[PhaseReport], part: PhaseReport) -> PhaseReport:
    if total is None:
        return part
    total.merge(part)
    return total


def _add_counts(total: dict, part: dict) -> None:
    """Sum a chunk's phase stats into the run's: numbers added, flags
    or-ed, nested dicts (the ladder's counts) the same way."""
    for k, v in part.items():
        if isinstance(v, dict):
            _add_counts(total.setdefault(k, {}), v)
        elif isinstance(v, bool):
            total[k] = total.get(k, False) or v
        else:
            total[k] = total.get(k, 0) + v


def _overlap_s(a, b) -> float:
    """Seconds in which an interval of `a` and one of `b` ([(start,
    end)], each list disjoint) overlap."""
    return sum(max(0.0, min(e1, e2) - max(s1, s2))
               for s1, e1 in a for s2, e2 in b)


class TorchPolisher:
    """Polish `target` with `sequences` and their `overlaps`.

    ``device`` is where the kernels run ("cuda", the default, or "cpu"
    for the plain PyTorch versions); ``batch_windows`` is the POA batch
    in windows; ``poa_kernel`` picks the POA kernel ("ls", the default,
    as in the JAX package, or "v2"; both compute the same consensus).
    ``band`` runs the banded DP on both phases (the JAX package's
    ``RACON_TPU_BAND``; ops/band.py): each job and window starts on the
    band of its length delta plus ``band_slack`` and widens at most
    ``band_max_widenings`` times before it runs flat, through the chosen
    POA kernel's banded build; the output is the flat run's.
    ``pipeline_depth`` is the number of consensus batches in flight on
    the card (ops/batch_exec.py).

    The chunked modes (module note): ``pipeline_phases`` with
    ``handoff_depth`` chunks queued between the threads (the target is
    split into handoff_depth + 2 chunks), ``stream_input``, and
    ``memory_budget_mb`` (above 0 it arms streaming; its watermarks at
    80% and 95% of it, MemoryBudget's defaults) with its ``spill_dir``
    (the run's work directory by default). These are the JAX package's
    RACON_TPU_* knobs as arguments, with their defaults. The other
    keyword arguments are racon's (window_length, quality_threshold,
    error_threshold, trim, match, mismatch, gap, fragment_correction,
    num_threads).

    After polish(), ``stats`` holds each phase's wall seconds and served
    counts, with the ladder's counts in ``stats["align"]["band"]`` and
    ``stats["consensus"]["band"]`` and the consensus feeder's wall split
    in ``stats["consensus"]["pack_wall_s"]`` and ``["kernel_wall_s"]``.
    A chunked run sums the chunks' counts and seconds and adds "chunks",
    "chunk_s" (each chunk's phase seconds), "overlap_s" (the seconds in
    which one chunk's alignment and another's consensus ran at once),
    "prep_overlap_s" (the same for its parse, alignment and windows),
    "peak_rss_mb", "pressure_level", "quarantined" (chunks whose working
    set a torn input degraded) and "collapsed" (the hard watermark
    collapsed the pipeline).

    ``device_memory_share`` is the share of each card this polish may
    hold (1: all of it; a fleet's worker holds 1 / its pool's ceiling):
    the consensus phase sizes its batches from it
    (``poa_driver.sizing_bytes``).

    ``devices`` (the JAX package's ``RACON_TPU_SHARD`` and
    ``RACON_TPU_MESH_SHAPE``) is what the kernels' launches are striped
    over (module note; ``mesh.resolve_devices``): None, every visible
    device of ``device``'s type; a count, the first that many; or a list
    of devices, repeats allowed. Its first device then stands for
    ``device``.

    ``journal_path``, ``resume_journal``, ``journal_fsync``,
    ``trace_path``, ``device_timeout_s``, ``sanitize`` and
    ``sanitize_parity``: the module note."""

    def __init__(self, sequences: str, overlaps: str, target: str, *,
                 device="cuda", batch_windows: int = 256,
                 poa_kernel: str = DEFAULT_POA_KERNEL, band: bool = False,
                 band_slack: int = _band.DEFAULT_SLACK,
                 band_max_widenings: int = _band.DEFAULT_MAX_WIDENINGS,
                 pipeline_phases: bool = False, handoff_depth: int = 1,
                 stream_input: bool = False, memory_budget_mb: int = 0,
                 spill_dir: Optional[str] = None,
                 pipeline_depth: int = DEFAULT_DEPTH,
                 journal_path: Optional[str] = None,
                 resume_journal: bool = False, journal_fsync: bool = True,
                 trace_path: Optional[str] = None,
                 device_timeout_s: float = 0.0,
                 device_memory_share: float = 1.0, devices=None,
                 sanitize: bool = False,
                 sanitize_parity: int = _sanitize.DEFAULT_PARITY,
                 **racon_kwargs):
        _reset_run_state(trace_path, sanitize, sanitize_parity)
        self.device = _resolve_device(device)
        if not 0.0 < device_memory_share <= 1.0:
            raise ValueError(f"device_memory_share must be in (0, 1], got "
                             f"{device_memory_share}")
        self.device_memory_share = float(device_memory_share)
        self.devices = resolve_devices(devices, self.device)
        self.device = self.devices[0]
        self.partitioner = get_partitioner(self.devices)
        if self.device.type == "cuda":
            obs.arm_device_track(self.devices)
        kernel_for(poa_kernel)
        self.batch_windows = batch_windows
        self.poa_kernel = poa_kernel
        self.band = dict(band=band, band_slack=band_slack,
                         band_max_widenings=band_max_widenings)
        self.pipeline_depth = pipeline_depth
        self.handoff_depth = max(1, int(handoff_depth))
        self._kwargs = dict(racon_kwargs)
        self._paths = (sequences, overlaps, target)
        self.device_timeout_s = float(device_timeout_s)
        self.journal = _open_journal(self._paths, "torch", journal_path,
                                      resume_journal, racon_kwargs,
                                      journal_fsync)
        self.budget = MemoryBudget(memory_budget_mb, spill_dir=spill_dir)
        self._pipelined = bool(pipeline_phases)
        self._stream = bool(stream_input) or self.budget.enabled
        if self.journal is not None and (self._pipelined or self._stream):
            _note("NOTE: pipelined phases and streamed input set aside: the "
                  "journal needs run-global window indices; running the "
                  "phases sequentially")
            self._pipelined = self._stream = False
        # the chunked modes parse per chunk; the whole target's pipeline
        # is built only where the run ends up sequential
        self._pipeline = (None if (self._pipelined or self._stream) else
                          Pipeline(sequences, overlaps, target,
                                   **racon_kwargs))
        self._chunks = None
        self._tmpdir = None
        self._stream_index = None
        self._queue = None
        self._worker = None
        self._collapsed = False
        self._quarantined: List[int] = []
        # the memory report's writes: align-worker's (a quarantined chunk,
        # the collapse) and the main thread's once that worker is joined
        self._mem_lock = threading.Lock()
        self._align_spans: List[Tuple[float, float]] = []
        self._prep_spans: List[Tuple[float, float]] = []
        self.stats = {}
        self.report = RunReport()
        self._align_rep: Optional[PhaseReport] = None
        self._mem_rep = PhaseReport("memory", ())

    # -- the sequential path ----------------------------------------------
    def _sync(self) -> None:
        """Wait for this thread's work on the card (its current stream;
        the other thread of a pipelined run keeps going)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _timed(self, stats: dict, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self._sync()
        stats[f"{name}_s"] = time.perf_counter() - t0
        return out

    def _align(self, pl, stats: dict, chunk=None) -> PhaseReport:
        """Parse, align and window one pipeline, timing each phase into
        `stats`; returns its alignment report."""
        at = {} if chunk is None else {"chunk": chunk}
        rep = PhaseReport("alignment", ALIGN_TIERS)
        t_parse = time.perf_counter()
        with obs.span("phase.parse", **at):
            self._timed(stats, "parse", pl.prepare)
        t0 = time.perf_counter()
        with obs.span("phase.align", **at) as sp:
            stats["align"] = self._timed(
                stats, "align", run_alignment_phase, pl, device=self.device,
                journal=self.journal, report=rep,
                device_timeout_s=self.device_timeout_s,
                partitioner=self.partitioner, **self.band)
            sp.set(device=stats["align"]["device"],
                   host=stats["align"]["host"])
        self._align_spans.append((t0, time.perf_counter()))
        with obs.span("phase.window_assign", **at):
            self._timed(stats, "windows", pl.build_windows)
        self._prep_spans.append((t_parse, time.perf_counter()))
        return rep

    def _consensus(self, pl, stats: dict, drop_unpolished: bool,
                   chunk=None):
        """Consensus and stitching of one pipeline, timed into `stats`;
        returns (FASTA records, its consensus report)."""
        at = {} if chunk is None else {"chunk": chunk}
        kw = self._kwargs
        rep = PhaseReport("consensus", consensus_tiers(self.poa_kernel))
        with obs.span("phase.poa", **at):
            stats["consensus"] = self._timed(
                stats, "consensus", run_consensus_phase, pl,
                match=kw.get("match", 3), mismatch=kw.get("mismatch", -5),
                gap=kw.get("gap", -4), trim=kw.get("trim", True),
                device=self.device, batch_windows=self.batch_windows,
                poa_kernel=self.poa_kernel,
                pipeline_depth=self.pipeline_depth,
                budget=self.budget if self.budget.enabled else None,
                journal=self.journal, report=rep,
                device_timeout_s=self.device_timeout_s,
                device_memory_share=self.device_memory_share,
                partitioner=self.partitioner, **self.band)
        with obs.span("phase.stitch", **at):
            out = self._timed(stats, "stitch", pl.stitch, drop_unpolished)
        return out, rep

    def initialize(self) -> None:
        """Parse and filter, align, and build windows; in a chunked mode,
        split the target and (pipelined) start the alignment worker."""
        self.budget.start()
        if self._pipelined or self._stream:
            chunks = self._split_target()
            if chunks is not None:
                self._chunks = chunks
                if self._stream:
                    self._arm_streaming(chunks)
                if self._pipelined:
                    self._start_phase_pipeline(chunks)
                return
            self._pipelined = self._stream = False
        if self._pipeline is None:
            self._pipeline = Pipeline(*self._paths, **self._kwargs)
        self._align_rep = self._align(self._pipeline, self.stats)

    def polish(self, drop_unpolished: bool = True) -> List[Tuple[str, str]]:
        """Consensus and stitching; returns [(name, sequence)]. Then the
        report is finalized, the journal closed and the trace written."""
        try:
            if self._chunks is None:
                out, cons_rep = self._consensus(self._pipeline, self.stats,
                                                drop_unpolished)
                self.report.attach(self._align_rep)
                self.report.attach(cons_rep)
            else:
                out = self._polish_chunks(drop_unpolished)
        finally:
            self.budget.stop()
            if self._tmpdir is not None:
                shutil.rmtree(self._tmpdir, ignore_errors=True)
                self._tmpdir = None
            if self.journal is not None:
                self.journal.close()
        self.report.finalize()
        obs.write_trace()
        return out

    # -- the chunked modes ------------------------------------------------
    def _split_target(self):
        """Chunk the target FASTA; None (with a NOTE) where it cannot be
        split: the phases then run sequentially."""
        target = self._paths[2]
        if not target.lower().endswith((".fa", ".fasta", ".fa.gz",
                                        ".fasta.gz")):
            _note("NOTE: chunked polishing needs a FASTA target; running "
                  "the phases sequentially")
            return None
        if self._paths[1].lower().endswith((".mhap", ".mhap.gz")):
            _note("NOTE: MHAP overlaps name targets by ordinal, which "
                  "chunking the target would renumber; running the phases "
                  "sequentially")
            return None
        self._tmpdir = tempfile.mkdtemp(prefix="racon_tpu_torch_chunks.")
        chunks = _split_fasta(target, self.handoff_depth + 2, self._tmpdir)
        if chunks is None:
            shutil.rmtree(self._tmpdir, ignore_errors=True)
            self._tmpdir = None
            _note("NOTE: target has fewer than two contigs; running the "
                  "phases sequentially")
        return chunks

    def _arm_streaming(self, chunks) -> None:
        """Index each chunk's byte ranges of the inputs (one pass over
        each). MHAP and unreadable inputs fall back, with a NOTE, to chunk
        pipelines that parse the whole inputs; the native parser gives
        the verdict on them."""
        from .streamio import TORN_ERRORS, StreamIndex, StreamUnsupported

        try:
            self._stream_index = StreamIndex(
                self._paths[0], self._paths[1], chunks, self._tmpdir)
        except StreamUnsupported as e:
            _note(f"NOTE: streaming input disabled ({e}); chunk pipelines "
                  "parse the full inputs")
        except TORN_ERRORS as e:
            _note(f"NOTE: streaming index failed ({type(e).__name__}: {e}); "
                  "chunk pipelines parse the full inputs")

    def _chunk_inputs(self, ci: int):
        """(sequences, overlaps, subset paths) of chunk ci's pipeline: the
        streamed working set where streaming is armed, else the whole
        inputs. This is the per-chunk budget poll: under soft or worse
        pressure the working set goes through the spill file. A torn
        chunk is quarantined (recorded; the run goes on) and polishes
        from what the index recovered before the tear."""
        level = self.budget.poll()
        idx = self._stream_index
        if idx is None:
            return self._paths[0], self._paths[1], None
        torn = idx.torn(ci)
        try:
            ws = idx.materialize(ci)
            if at_least(level, "soft"):
                ws.park(self.budget.spill_dir_for(self._tmpdir))
            paths = ws.realize(self._tmpdir)
        except Exception as e:  # noqa: BLE001 - a degraded chunk, not a
            # failed run: it polishes from the whole inputs
            self._quarantine_chunk(ci, torn or e)
            return self._paths[0], self._paths[1], None
        if torn is not None:
            self._quarantine_chunk(ci, torn)
        return paths[0], paths[1], paths

    def _quarantine_chunk(self, ci: int, exc: BaseException) -> None:
        _note(f"WARNING: chunk {ci} working set degraded "
              f"({type(exc).__name__}: {exc}); quarantining the chunk")
        with self._mem_lock:
            self._quarantined.append(ci)
            self._mem_rep.record_quarantine(ci, exc)

    @staticmethod
    def _release_ws(ws_paths) -> None:
        """Delete a chunk's subset files (its pipeline has parsed them by
        the end of prepare())."""
        for p in ws_paths or ():
            try:
                os.unlink(p)
            except OSError:
                pass

    def _maybe_collapse(self) -> bool:
        """The hard watermark's latch on the pipelined path: once crossed,
        the worker no longer runs ahead of consensus."""
        if not self.budget.hard_latched():
            return False
        with self._mem_lock:
            if not self._collapsed:
                self._mem_rep.record_degrade("pipelined", "sequential")
            self._collapsed = True
        return True

    def _prepare_chunk(self, ci: int, chunk_path: str):
        """Chunk ci's pipeline, parsed, aligned and windowed, its stats
        and its alignment report."""
        st = {}
        seqs, ovls, ws_paths = self._chunk_inputs(ci)
        pl = Pipeline(seqs, ovls, chunk_path, **self._kwargs)
        try:
            rep = self._align(pl, st, ci)
        finally:
            self._release_ws(ws_paths)
        return pl, st, rep

    def _start_phase_pipeline(self, chunks) -> None:
        """Build the kernels, then start the one alignment worker and its
        FIFO queue of handoff_depth chunks: chunks reach consensus in
        target order, so the stitched output is the sequential run's."""
        import queue

        if self.device.type == "cuda":
            from .ops import cuda_lib

            cuda_lib.build_all()
        self._queue = q = queue.Queue(maxsize=self.handoff_depth)
        dev = self.device

        def worker():
            try:
                stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                          else None)
                with torch.cuda.stream(stream):
                    for ci, chunk_path in enumerate(chunks):
                        # backpressure: under soft or worse pressure (or
                        # once the hard watermark collapsed the pipeline)
                        # wait until consensus drains the queue
                        while ((self._maybe_collapse() or at_least(
                                self.budget.level(), "soft"))
                               and not q.empty()):
                            time.sleep(0.02)
                        q.put((ci, *self._prepare_chunk(ci, chunk_path)))
                q.put(_DONE)
            except BaseException as e:  # noqa: BLE001 - re-raised on the
                # consuming thread
                q.put(_WorkerFailure(e))

        self._worker = threading.Thread(target=worker, name="align-worker",
                                        daemon=True)
        self._worker.start()

    def _chunk_results(self):
        """(ci, pipeline, stats, alignment report) of each chunk in order:
        from the worker's queue when pipelined, else prepared here one at
        a time."""
        if not self._pipelined:
            for ci, chunk_path in enumerate(self._chunks):
                yield (ci, *self._prepare_chunk(ci, chunk_path))
            return
        while True:
            item = self._queue.get()
            if item is _DONE:
                break
            if isinstance(item, _WorkerFailure):
                raise item.exc
            yield item

    def _polish_chunks(self, drop_unpolished: bool):
        """Consensus and stitching of each chunk in order: pipelined, as
        the worker hands it over, on this thread's own stream; streamed
        without pipelining, one chunk at a time (working set, alignment,
        consensus, release), so peak RSS is O(chunk). The JAX package's
        _polish_pipelined and _polish_stream_sequential in one."""
        out: List[Tuple[str, str]] = []
        per_chunk, cons_spans = [], []
        align_rep = cons_rep = None
        stream = (torch.cuda.Stream(self.device)
                  if self._pipelined and self.device.type == "cuda"
                  else None)
        with torch.cuda.stream(stream):
            for ci, pl, st, arep in self._chunk_results():
                t0 = time.perf_counter()
                part, crep = self._consensus(pl, st, drop_unpolished, ci)
                out.extend(part)
                cons_spans.append((t0, t0 + st["consensus_s"]))
                per_chunk.append(st)
                align_rep = _merge(align_rep, arep)
                cons_rep = _merge(cons_rep, crep)
                del pl   # the chunk's native working set goes here
        if self._worker is not None:
            self._worker.join()
        total = {}
        for st in per_chunk:
            _add_counts(total, st)
        total.update(
            chunks=len(per_chunk),
            chunk_s=[{p: st[f"{p}_s"] for p in CHUNK_PHASES}
                     for st in per_chunk],
            overlap_s=_overlap_s(self._align_spans, cons_spans),
            prep_overlap_s=_overlap_s(self._prep_spans, cons_spans),
            peak_rss_mb=peak_rss_mb(),
            pressure_level=self.budget.level(),
            quarantined=sorted(self._quarantined),
            collapsed=self._collapsed,
            streamed=self._stream_index is not None)
        self.stats = total
        self.report.attach(align_rep)
        self.report.attach(cons_rep)
        with self._mem_lock:
            self._mem_rep.extra.update(
                peak_rss_mb=round(total["peak_rss_mb"], 1),
                budget_mb=self.budget.budget_mb, streamed=total["streamed"],
                pressure_level=total["pressure_level"])
        self.report.attach(self._mem_rep)
        return out


class CpuPolisher:
    """The native host pipeline (the JAX package's CpuPolisher, its
    oracle): parse, align on the host and build windows in one native
    call, host POA consensus for every window (``num_threads`` threads),
    stitch. ``stats`` holds the wall seconds of "initialize", "consensus"
    and "stitch". With a journal the consensus runs window by window, so
    that each result is journaled as it exists, as the JAX package's
    does; ``journal_path``, ``resume_journal``, ``journal_fsync`` and
    ``trace_path`` are TorchPolisher's (module note)."""

    def __init__(self, sequences: str, overlaps: str, target: str, *,
                 journal_path: Optional[str] = None,
                 resume_journal: bool = False, journal_fsync: bool = True,
                 trace_path: Optional[str] = None, **racon_kwargs):
        _reset_run_state(trace_path)
        self.journal = _open_journal((sequences, overlaps, target), "host",
                                      journal_path, resume_journal,
                                      racon_kwargs, journal_fsync)
        self._pipeline = Pipeline(sequences, overlaps, target,
                                  **racon_kwargs)
        self.stats = {}
        self.report = RunReport()

    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.stats[f"{name}_s"] = time.perf_counter() - t0
        return out

    def initialize(self) -> None:
        # one native call parses, aligns and builds the windows: one span
        with obs.span("phase.parse", fused="parse+align+window_assign"):
            self._timed("initialize", self._pipeline.initialize)

    def polish(self, drop_unpolished: bool = True) -> List[Tuple[str, str]]:
        with obs.span("phase.poa", tier="host"):
            self._timed("consensus", self._polish_consensus)
        with obs.span("phase.stitch"):
            out = self._timed("stitch", self._pipeline.stitch,
                              drop_unpolished)
        if self.journal is not None:
            self.journal.close()
        self.report.finalize()
        obs.write_trace()
        return out

    def _polish_consensus(self) -> None:
        pl, jr = self._pipeline, self.journal
        n = pl.num_windows()
        rep = PhaseReport("consensus", ("host",) if jr is None
                          else ("journal", "host"))
        rep.total = n
        t0 = time.perf_counter()
        if jr is None:
            pl.consensus_cpu_all()
            rep.record_served("host", n)
        else:
            replayed = replay_windows(pl, jr, n, rep)
            for i in range(n):
                if i in replayed:
                    continue
                polished = pl.consensus_cpu_one(i)
                _, _, rank, _, _, tid = pl.window_info(i)
                jr.append_window(i, tid, rank, "host", pl.get_consensus(i),
                                 polished)
            rep.record_served("host", n - len(replayed))
        rep.add_wall("host", time.perf_counter() - t0)
        self.report.attach(rep)


BACKENDS = ("cuda", "host")


def create_polisher(sequences: str, overlaps: str, target: str, *,
                    backend: str = "cuda", sanitize: bool = False,
                    sanitize_parity: int = _sanitize.DEFAULT_PARITY,
                    **kwargs):
    """Factory, as the JAX package's create_polisher: backend "cuda" (the
    default) returns TorchPolisher with `kwargs`; "host" returns
    CpuPolisher, the native host pipeline, with racon's keyword
    arguments. It is not named "cpu": ``device="cpu"`` already means the
    kernels' plain PyTorch versions. `sanitize` arms the sanitizer for
    "cuda" only (module note): the host backend passes none of its
    seams, so it refuses `sanitize` rather than report a clean run
    it never checked."""
    if backend == "cuda":
        return TorchPolisher(sequences, overlaps, target, sanitize=sanitize,
                             sanitize_parity=sanitize_parity, **kwargs)
    if backend == "host":
        if sanitize:
            raise ValueError("sanitize needs the cuda backend: the host "
                             "backend passes no seam the sanitizer checks")
        return CpuPolisher(sequences, overlaps, target, **kwargs)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
