"""Build, load and count the hand-written CUDA kernels of racon_tpu_torch.

Every source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into ``_build/lib<name>.so``, a shared library with a plain C interface
that the wrappers call through ``ctypes`` (pointers as ``c_void_p``, the
stream from ``torch.cuda.current_stream().cuda_stream``). The build runs
at first use, one ``nvcc`` per source, all started together, under a file
lock so that concurrent processes build once. ``--fmad=false`` and IEEE
division keep the POA kernel's float32 column keys bit-identical to the
plain version's.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where
it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("poa", "align")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"poa_consensus": 0, "hirschberg_edge": 0,
                            "hirschberg_base": 0}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return path


def lib_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    mtime = os.path.getmtime(out)
    deps = [os.path.join(CSRC, f) for f in os.listdir(CSRC)
            if f.startswith(name + ".") or f.endswith(".cuh")]
    return any(os.path.getmtime(d) > mtime for d in deps)


def build_all() -> float:
    """Compile every stale source in parallel; returns the seconds spent
    (0 when nothing was stale). Raises with nvcc's output on failure."""
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [n for n in SOURCES if _stale(n)]
            if todo:
                nvcc = _nvcc()
                procs = []
                for n in todo:
                    tmp = lib_path(n) + ".tmp"
                    log = open(os.path.join(BUILD, f"{n}.log"), "w")
                    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                           os.path.join(CSRC, f"{n}.cu")]
                    procs.append((n, tmp, log, subprocess.Popen(
                        cmd, stdout=log, stderr=subprocess.STDOUT)))
                errors = []
                for n, tmp, log, p in procs:
                    rc = p.wait()
                    log.close()
                    if rc != 0:
                        with open(log.name) as f:
                            errors.append(f"{n}.cu (nvcc exited {rc}):\n"
                                          f"{f.read()}")
                    else:
                        os.replace(tmp, lib_path(n))
                if errors:
                    raise RuntimeError("CUDA kernel build failed:\n"
                                       + "\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all sources first
    if any is missing or stale."""
    lib = _libs.get(name)
    if lib is None:
        if any(_stale(n) for n in SOURCES):
            build_all()
        lib = ctypes.CDLL(lib_path(name))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t, name: str, dtype, shape, device) -> None:
    """Wrapper argument check: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
