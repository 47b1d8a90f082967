"""Alignment-phase driver: every CIGAR-less overlap whose band fits goes
to the Hirschberg kernels; the native host aligner finishes the rest
(band too wide, or a path that escapes the band), as the reference's
accelerated polisher does (racon src/cuda/cudapolisher.cpp).

With a journal (resilience/journal.py), CIGARs a previous run journaled
are installed first and left out of the kernels' jobs, and each CIGAR the
kernels install is journaled (``CigarTap``). Host-aligned CIGARs are not
journaled: the native pass recomputes them, as the JAX package's driver
(racon_tpu/ops/align_driver.py) does."""

from __future__ import annotations

import time

import numpy as np

from .. import obs
from ..obs import costmodel
from ..resilience.journal import CigarTap, replay_cigars
from . import align_cuda
from . import band as _band


def run_alignment_phase(pipeline, *, device="cuda", band: bool = False,
                        band_slack: int = _band.DEFAULT_SLACK,
                        band_max_widenings: int = _band.DEFAULT_MAX_WIDENINGS,
                        journal=None, report=None,
                        device_timeout_s: float = 0.0,
                        partitioner=None) -> dict:
    """Align every job; returns {device, host, host_seconds, band}: jobs
    whose CIGAR the kernels produced, jobs the host aligned, the host
    aligner's wall time, and the banded ladder's counts (ops/band.py;
    all 0 without `band`). SAM input has no jobs and returns zeros.

    `report`, a PhaseReport("alignment", ...), gets the served counts by
    tier (hirschberg, host, journal; they sum to the job count), the
    tiers' wall seconds and the ladder's counts under ``extra``.
    `device_timeout_s` is the watchdog's deadline on each wait for the
    card (0: none). `partitioner`, where given, stripes the kernels'
    launches over its devices (ops/align_cuda.py)."""
    n = pipeline.num_align_jobs()
    served = 0
    counts = _band.new_stats()
    replayed = replay_cigars(pipeline, journal, n, report)
    t0 = time.perf_counter()
    if n:
        lengths = pipeline.align_job_lengths()
        if obs.enabled() and len(lengths):
            # the cost model's need-band cells over ALL phase-1 jobs, the
            # host's share included: max(n, m) rows x the 10%-rule band
            L = np.asarray(lengths, dtype=np.int64)[:n]
            need = costmodel.band_need(L[:, 0], L[:, 1])
            obs.count("align.cells.total",
                      int((L.max(axis=1) * need).sum()))
        jobs = [i for i in range(n) if i not in replayed
                and align_cuda.band_for(int(lengths[i, 0]),
                                        int(lengths[i, 1])) > 0]
        if jobs:
            sink = (CigarTap(pipeline, journal, "hirschberg")
                    if journal is not None else pipeline)
            served = align_cuda.run_jobs(
                sink, jobs, lengths, device=device, band=band,
                band_slack=band_slack,
                band_max_widenings=band_max_widenings, stats=counts,
                timeout_s=device_timeout_s, partitioner=partitioner)
    t1 = time.perf_counter()
    host = n - served - len(replayed)
    with obs.span("align.host") as sp:
        pipeline.align_jobs_cpu()   # skips every job whose CIGAR is set
        sp.set(jobs=host)
    t2 = time.perf_counter()
    if report is not None:
        report.total += n
        report.record_served("hirschberg", served)
        report.record_served("host", host)
        report.add_wall("hirschberg", t1 - t0)
        report.add_wall("host", t2 - t1)
        report.extra["band"] = dict(counts)
    return {"device": served, "host": host, "host_seconds": t2 - t1,
            "band": counts}
