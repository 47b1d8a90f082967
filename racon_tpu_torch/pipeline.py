"""Python handle over the native polishing pipeline of racon_tpu_torch.

Wraps the C ABI in native/src/rt_capi.cpp. The pipeline object exposes the two
accelerator seams (overlap-alignment jobs and window-consensus jobs) as numpy
arrays ready for device batching; everything else (parsing, filtering,
windowing, stitching) runs natively.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from . import native


@dataclass
class WindowExport:
    """One window's POA problem in packed form (layers sorted by begin)."""

    index: int
    rank: int
    target_id: int
    is_tgs: bool
    backbone: np.ndarray       # uint8 ASCII bases [L]
    backbone_weights: np.ndarray  # uint8 (PHRED-33, dummy backbone = 0) [L]
    lens: np.ndarray           # uint32 [K]
    begins: np.ndarray         # uint32 [K]
    ends: np.ndarray           # uint32 [K] (inclusive backbone positions)
    bases: np.ndarray          # uint8 concatenated layer bases
    weights: np.ndarray        # uint8 concatenated layer weights


class Pipeline:
    """One polishing run (sequences + overlaps + targets -> polished FASTA)."""

    def __init__(self, sequences_path: str, overlaps_path: str,
                 target_path: str, *, fragment_correction: bool = False,
                 window_length: int = 500, quality_threshold: float = 10.0,
                 error_threshold: float = 0.3, trim: bool = True,
                 match: int = 3, mismatch: int = -5, gap: int = -4,
                 num_threads: int = 1):
        self._lib = native.load()
        self._h = self._lib.rt_pipeline_create(
            sequences_path.encode(), overlaps_path.encode(),
            target_path.encode(), 1 if fragment_correction else 0,
            window_length, quality_threshold, error_threshold,
            1 if trim else 0, match, mismatch, gap, num_threads)
        if not self._h:
            native.check_error(self._lib)
            raise native.NativeError("pipeline creation failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rt_pipeline_destroy(self._h)
            self._h = None

    # -- phase 1 ----------------------------------------------------------
    def prepare(self) -> None:
        self._lib.rt_pipeline_prepare(self._h)
        native.check_error(self._lib)

    def num_align_jobs(self) -> int:
        return self._lib.rt_pipeline_num_align_jobs(self._h)

    def align_job(self, job: int) -> Tuple[np.ndarray, np.ndarray]:
        """Query/target byte arrays for alignment job `job`."""
        q = ctypes.c_char_p()
        t = ctypes.c_char_p()
        ql = ctypes.c_uint32()
        tl = ctypes.c_uint32()
        self._lib.rt_pipeline_align_job(
            self._h, job, ctypes.byref(q), ctypes.byref(ql), ctypes.byref(t),
            ctypes.byref(tl))
        qa = np.frombuffer(ctypes.string_at(q, ql.value), dtype=np.uint8)
        ta = np.frombuffer(ctypes.string_at(t, tl.value), dtype=np.uint8)
        return qa, ta

    def align_job_lengths(self) -> np.ndarray:
        """(q_len, t_len) per job without copying the bytes — one bulk
        ABI crossing (the per-job loop survives as `_align_job_lengths_loop`,
        the parity oracle)."""
        n = self.num_align_jobs()
        out = np.zeros((n, 2), dtype=np.uint32)
        if n:
            self._lib.rt_pipeline_align_job_lengths(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
            native.check_error(self._lib)
        return out

    def _align_job_lengths_loop(self) -> np.ndarray:
        """Per-job ctypes loop — the pre-bulk implementation, kept as the
        differential-test oracle for rt_pipeline_align_job_lengths."""
        n = self.num_align_jobs()
        out = np.zeros((n, 2), dtype=np.uint32)
        q = ctypes.c_char_p()
        t = ctypes.c_char_p()
        ql = ctypes.c_uint32()
        tl = ctypes.c_uint32()
        for i in range(n):
            self._lib.rt_pipeline_align_job(
                self._h, i, ctypes.byref(q), ctypes.byref(ql),
                ctypes.byref(t), ctypes.byref(tl))
            out[i, 0] = ql.value
            out[i, 1] = tl.value
        return out

    def set_job_cigar(self, job: int, cigar: str) -> None:
        self._lib.rt_pipeline_set_job_cigar(self._h, job, cigar.encode())

    def align_jobs_cpu(self) -> None:
        self._lib.rt_pipeline_align_jobs_cpu(self._h)
        native.check_error(self._lib)

    def build_windows(self) -> None:
        self._lib.rt_pipeline_build_windows(self._h)
        native.check_error(self._lib)

    def initialize(self) -> None:
        self._lib.rt_pipeline_initialize(self._h)
        native.check_error(self._lib)

    # -- phase 2 ----------------------------------------------------------
    def num_windows(self) -> int:
        return self._lib.rt_pipeline_num_windows(self._h)

    def window_info(self, i: int) -> Tuple[int, int, int, bool, int, int]:
        out = (ctypes.c_uint64 * 6)()
        self._lib.rt_pipeline_window_info(self._h, i, out)
        return (int(out[0]), int(out[1]), int(out[2]), bool(out[3]),
                int(out[4]), int(out[5]))

    def export_window(self, i: int) -> WindowExport:
        (n_seqs, bb_len, rank, is_tgs, layer_bytes,
         target_id) = self.window_info(i)
        k = n_seqs - 1
        bb = np.zeros(bb_len, dtype=np.uint8)
        bbw = np.zeros(bb_len, dtype=np.uint8)
        lens = np.zeros(k, dtype=np.uint32)
        begins = np.zeros(k, dtype=np.uint32)
        ends = np.zeros(k, dtype=np.uint32)
        bases = np.zeros(layer_bytes, dtype=np.uint8)
        weights = np.zeros(layer_bytes, dtype=np.uint8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        self._lib.rt_pipeline_window_export(
            self._h, i,
            bb.ctypes.data_as(u8p), bbw.ctypes.data_as(u8p),
            lens.ctypes.data_as(u32p), begins.ctypes.data_as(u32p),
            ends.ctypes.data_as(u32p), bases.ctypes.data_as(u8p),
            weights.ctypes.data_as(u8p))
        return WindowExport(index=i, rank=rank, target_id=target_id,
                            is_tgs=is_tgs, backbone=bb, backbone_weights=bbw,
                            lens=lens, begins=begins, ends=ends, bases=bases,
                            weights=weights)

    def consensus_cpu_one(self, i: int) -> bool:
        r = self._lib.rt_pipeline_consensus_cpu_one(self._h, i)
        if r < 0:
            native.check_error(self._lib)
            raise native.NativeError(f"consensus failed for window {i}")
        return bool(r)

    def consensus_cpu_all(self) -> None:
        self._lib.rt_pipeline_consensus_cpu_all(self._h)
        native.check_error(self._lib)

    def get_consensus(self, i: int) -> bytes:
        """Window i's stored consensus (host- or device-produced)."""
        ln = ctypes.c_uint64()
        p = self._lib.rt_pipeline_get_consensus(self._h, i, ctypes.byref(ln))
        return ctypes.string_at(p, ln.value)

    def set_consensus(self, i: int, consensus: bytes, polished: bool) -> None:
        self._lib.rt_pipeline_set_consensus(
            self._h, i, consensus, len(consensus), 1 if polished else 0)

    def stitch(self, drop_unpolished: bool = True) -> List[Tuple[str, str]]:
        n = self._lib.rt_pipeline_stitch(
            self._h, 1 if drop_unpolished else 0)
        native.check_error(self._lib)
        out = []
        ln = ctypes.c_uint64()
        for i in range(n):
            p = self._lib.rt_pipeline_result_name(self._h, i, ctypes.byref(ln))
            name = ctypes.string_at(p, ln.value).decode()
            p = self._lib.rt_pipeline_result_data(self._h, i, ctypes.byref(ln))
            data = ctypes.string_at(p, ln.value).decode()
            out.append((name, data))
        return out
