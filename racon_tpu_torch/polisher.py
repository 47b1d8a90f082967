"""TorchPolisher: the accelerated polishing path on a CUDA card.

Mirrors the JAX package's sequential TpuPolisher (racon_tpu/polisher.py):
parse and filter natively, align CIGAR-less overlaps with the Hirschberg
kernels, build windows natively, run POA consensus with the CUDA kernel,
stitch natively. Per-item host paths are the algorithm's own: a job whose
band does not fit or whose path escapes the band is aligned on the host,
and a window the kernel flags failed is re-polished on the host. Both are
counted in ``stats``.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import torch

from .ops import band as _band
from .ops.align_driver import run_alignment_phase
from .ops.poa_driver import (DEFAULT_POA_KERNEL, kernel_for,
                              run_consensus_phase)
from .pipeline import Pipeline


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "racon_tpu_torch runs on a CUDA card and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


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
    POA kernel's banded build; the output is the flat run's. The other keyword arguments are racon's (window_length,
    quality_threshold, error_threshold, trim, match, mismatch, gap,
    fragment_correction, num_threads).

    After polish(), ``stats`` holds each phase's wall seconds and served
    counts, with the ladder's counts in ``stats["align"]["band"]`` and
    ``stats["consensus"]["band"]``."""

    def __init__(self, sequences: str, overlaps: str, target: str, *,
                 device="cuda", batch_windows: int = 256,
                 poa_kernel: str = DEFAULT_POA_KERNEL, band: bool = False,
                 band_slack: int = _band.DEFAULT_SLACK,
                 band_max_widenings: int = _band.DEFAULT_MAX_WIDENINGS,
                 **racon_kwargs):
        self.device = _resolve_device(device)
        kernel_for(poa_kernel)
        self.batch_windows = batch_windows
        self.poa_kernel = poa_kernel
        self.band = dict(band=band, band_slack=band_slack,
                         band_max_widenings=band_max_widenings)
        self._kwargs = dict(racon_kwargs)
        self._pipeline = Pipeline(sequences, overlaps, target,
                                  **racon_kwargs)
        self.stats = {}

    def _timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats[f"{name}_s"] = time.perf_counter() - t0
        return out

    def initialize(self) -> None:
        """Parse and filter, align, and build windows."""
        pl = self._pipeline
        self._timed("parse", pl.prepare)
        self.stats["align"] = self._timed(
            "align", run_alignment_phase, pl, device=self.device,
            **self.band)
        self._timed("windows", pl.build_windows)

    def polish(self, drop_unpolished: bool = True) -> List[Tuple[str, str]]:
        """Consensus and stitching; returns [(name, sequence)]."""
        kw = self._kwargs
        self.stats["consensus"] = self._timed(
            "consensus", run_consensus_phase, self._pipeline,
            match=kw.get("match", 3), mismatch=kw.get("mismatch", -5),
            gap=kw.get("gap", -4), trim=kw.get("trim", True),
            device=self.device, batch_windows=self.batch_windows,
            poa_kernel=self.poa_kernel, **self.band)
        return self._timed("stitch", self._pipeline.stitch, drop_unpolished)


def create_polisher(sequences: str, overlaps: str, target: str, *,
                    device="cuda", poa_kernel: str = DEFAULT_POA_KERNEL,
                    **kwargs) -> TorchPolisher:
    """Factory, as the JAX package's create_polisher for its device
    backend."""
    return TorchPolisher(sequences, overlaps, target, device=device,
                         poa_kernel=poa_kernel, **kwargs)
