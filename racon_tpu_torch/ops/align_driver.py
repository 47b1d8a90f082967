"""Alignment-phase driver: every CIGAR-less overlap whose band fits goes
to the Hirschberg kernels; the native host aligner finishes the rest
(band too wide, or a path that escapes the band), as the reference's
accelerated polisher does (racon src/cuda/cudapolisher.cpp)."""

from __future__ import annotations

import time

from . import align_cuda


def run_alignment_phase(pipeline, *, device="cuda") -> dict:
    """Align every job; returns {device, host, host_seconds}: jobs whose
    CIGAR the kernels produced, jobs the host aligned, and the host
    aligner's wall time. SAM input has no jobs and returns zeros."""
    n = pipeline.num_align_jobs()
    served = 0
    if n:
        lengths = pipeline.align_job_lengths()
        jobs = [i for i in range(n)
                if align_cuda.band_for(int(lengths[i, 0]),
                                       int(lengths[i, 1])) > 0]
        if jobs:
            served = align_cuda.run_jobs(pipeline, jobs, lengths,
                                         device=device)
    t0 = time.perf_counter()
    pipeline.align_jobs_cpu()   # skips every job whose CIGAR is set
    return {"device": served, "host": n - served,
            "host_seconds": time.perf_counter() - t0}
