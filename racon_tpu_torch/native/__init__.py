"""ctypes binding to the host runtime (libracon_host.so) of racon_tpu_torch.

The library implements the host side of polishing: parsers for
FASTA/FASTQ/MHAP/PAF/SAM (+gzip), the sequence/overlap/window data model,
overlap filtering, the banded global aligner and POA consensus oracle, the
thread pool, and the stitching pipeline. The sources under ``src/`` are
this package's own copy, so parsing, windowing, stitching and the host
fallbacks stay byte-identical to the JAX package's runtime without
importing it.

The library is built with ``make`` into ``build/`` at first use. A file
lock serialises that build, so several test workers or processes that
reach it at once build it once. The same lock builds the native CLI
binary, ``build/racon_tpu_torch`` (racon's flags and rampler's ``split``
and ``subsample``; ``ensure_cli_built``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_DIR, "build")
_LIB_PATH = os.path.join(_BUILD, "libracon_host.so")
#: The native CLI binary.
CLI_PATH = os.path.join(_BUILD, "racon_tpu_torch")
#: The source of the binary's main alone (the library does not link it).
_CLI_MAIN = "rt_main.cpp"

_lib: Optional[ctypes.CDLL] = None


def _stale(target: str) -> bool:
    """Whether `target` (the library or the binary) is missing or older
    than one of its sources or the Makefile."""
    src_dir = os.path.join(_DIR, "src")
    inputs = [os.path.join(src_dir, f) for f in os.listdir(src_dir)
              if f.endswith((".cpp", ".hpp"))
              and (f != _CLI_MAIN or target == CLI_PATH)]
    inputs.append(os.path.join(_DIR, "Makefile"))
    try:
        built = os.path.getmtime(target)
    except OSError:
        return True
    return any(os.path.getmtime(p) > built for p in inputs)


def _build(target: str) -> str:
    """``make`` `target` under the build lock if it is stale."""
    if not _stale(target):
        return target
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if _stale(target):  # another process may have built it
                proc = subprocess.run(
                    ["make", "-j", str(os.cpu_count() or 4),
                     os.path.relpath(target, _DIR)],
                    cwd=_DIR, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"native build failed (make exited "
                        f"{proc.returncode}):\n{proc.stdout}\n"
                        f"{proc.stderr}")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return target


def ensure_built() -> str:
    """Build libracon_host.so if missing or stale. Returns its path."""
    return _build(_LIB_PATH)


def ensure_cli_built() -> str:
    """Build the native CLI binary if missing or stale. Returns its
    path."""
    return _build(CLI_PATH)


def load() -> ctypes.CDLL:
    """Load (building if necessary) the native library, configured."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())

    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)

    lib.rt_last_error.restype = ctypes.c_char_p
    lib.rt_last_error.argtypes = []

    lib.rt_edit_distance.restype = ctypes.c_int64
    lib.rt_edit_distance.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32]

    lib.rt_align_cigar.restype = ctypes.c_void_p
    lib.rt_align_cigar.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_uint32]

    lib.rt_free.restype = None
    lib.rt_free.argtypes = [ctypes.c_void_p]

    lib.rt_window_consensus.restype = ctypes.c_void_p
    lib.rt_window_consensus.argtypes = [
        ctypes.c_char_p, ctypes.c_uint32, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_char_p, u32p, u32p, u32p, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int8, ctypes.c_int8,
        ctypes.c_int8, ctypes.POINTER(ctypes.c_int)]

    lib.rt_pipeline_create.restype = ctypes.c_void_p
    lib.rt_pipeline_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_double, ctypes.c_double, ctypes.c_int,
        ctypes.c_int8, ctypes.c_int8, ctypes.c_int8, ctypes.c_uint32]

    lib.rt_pipeline_destroy.restype = None
    lib.rt_pipeline_destroy.argtypes = [ctypes.c_void_p]

    for name in ("rt_pipeline_prepare", "rt_pipeline_align_jobs_cpu",
                 "rt_pipeline_build_windows", "rt_pipeline_initialize",
                 "rt_pipeline_consensus_cpu_all"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p]

    lib.rt_pipeline_num_align_jobs.restype = ctypes.c_uint64
    lib.rt_pipeline_num_align_jobs.argtypes = [ctypes.c_void_p]

    lib.rt_pipeline_align_job.restype = None
    lib.rt_pipeline_align_job.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char_p), u32p,
        ctypes.POINTER(ctypes.c_char_p), u32p]

    lib.rt_pipeline_align_job_lengths.restype = None
    lib.rt_pipeline_align_job_lengths.argtypes = [ctypes.c_void_p, u32p]

    lib.rt_pipeline_set_job_cigar.restype = None
    lib.rt_pipeline_set_job_cigar.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p]

    lib.rt_pipeline_num_windows.restype = ctypes.c_uint64
    lib.rt_pipeline_num_windows.argtypes = [ctypes.c_void_p]

    lib.rt_pipeline_window_info.restype = None
    lib.rt_pipeline_window_info.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p]

    lib.rt_pipeline_window_export.restype = None
    lib.rt_pipeline_window_export.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u8p, u8p, u32p, u32p, u32p, u8p, u8p]

    lib.rt_pipeline_consensus_cpu_one.restype = ctypes.c_int
    lib.rt_pipeline_consensus_cpu_one.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64]

    lib.rt_pipeline_set_consensus.restype = None
    lib.rt_pipeline_set_consensus.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_int]

    lib.rt_pipeline_stitch.restype = ctypes.c_uint64
    lib.rt_pipeline_stitch.argtypes = [ctypes.c_void_p, ctypes.c_int]

    lib.rt_pipeline_result_name.restype = ctypes.c_void_p
    lib.rt_pipeline_result_name.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p]

    lib.rt_pipeline_result_data.restype = ctypes.c_void_p
    lib.rt_pipeline_result_data.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p]

    lib.rt_pipeline_get_consensus.restype = ctypes.c_void_p
    lib.rt_pipeline_get_consensus.argtypes = [ctypes.c_void_p,
                                              ctypes.c_uint64, u64p]

    lib.rt_pipeline_window_type.restype = ctypes.c_int
    lib.rt_pipeline_window_type.argtypes = [ctypes.c_void_p]

    _lib = lib
    return lib


class NativeError(RuntimeError):
    """Raised when the native runtime reports an error (it never exits the
    process when used as a library; the CLI binary exits 1 instead)."""


def check_error(lib: ctypes.CDLL) -> None:
    msg = lib.rt_last_error()
    if msg:
        raise NativeError(msg.decode().strip())


def edit_distance(q: bytes, t: bytes) -> int:
    """Global (NW) edit distance — the accuracy metric of the test suite
    (reference analogue: test/racon_test.cpp:14-23)."""
    lib = load()
    return lib.rt_edit_distance(q, len(q), t, len(t))


def align_cigar(q: bytes, t: bytes) -> str:
    """Global alignment CIGAR (host banded NW)."""
    lib = load()
    ptr = lib.rt_align_cigar(q, len(q), t, len(t))
    if not ptr:
        check_error(lib)
        raise NativeError("alignment failed")
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.rt_free(ptr)


def window_consensus(backbone: bytes, layers, *, backbone_qual: bytes = None,
                     quals=None, begins=None, ends=None, tgs: bool = True,
                     trim: bool = True, match: int = 5, mismatch: int = -4,
                     gap: int = -8):
    """One-shot host POA window consensus (unit/differential test hook).

    layers: list of bytes. begins/ends: per-layer backbone positions
    (default: full span). quals: list of bytes or None.
    Returns (consensus: bytes, polished: bool).
    """
    lib = load()
    n = len(layers)
    bb_len = len(backbone)
    lens = (ctypes.c_uint32 * n)(*[len(s) for s in layers])
    begins_a = (ctypes.c_uint32 * n)(
        *(begins if begins is not None else [0] * n))
    ends_a = (ctypes.c_uint32 * n)(
        *(ends if ends is not None else [bb_len - 1] * n))
    bases = b"".join(layers)
    has_qual = quals is not None
    qual_cat = b"".join(quals) if has_qual else None
    polished = ctypes.c_int(0)
    ptr = lib.rt_window_consensus(
        backbone, bb_len, backbone_qual, bases, qual_cat, lens, begins_a,
        ends_a, n, 1 if has_qual else 0, 1 if tgs else 0, 1 if trim else 0,
        match, mismatch, gap, ctypes.byref(polished))
    if not ptr:
        check_error(lib)
        raise NativeError("window consensus failed")
    try:
        return ctypes.string_at(ptr), bool(polished.value)
    finally:
        lib.rt_free(ptr)
