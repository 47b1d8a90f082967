"""Build, load and count the hand-written CUDA kernels of racon_tpu_torch.

Every source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into ``_build/lib<name>.so``, a shared library with a plain C interface
that the wrappers call through ``ctypes`` (pointers as ``c_void_p``, the
stream from ``torch.cuda.current_stream().cuda_stream``). The build runs
at first use, one ``nvcc`` per source, all started together, under a file
lock so that concurrent processes build once. ``--fmad=false`` and IEEE
division keep the POA kernels' float32 column keys bit-identical to the
plain version's.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where
it launches its kernel and nowhere else (``count_launch``). ``LAUNCH_EVENTS``,
when set to a list, collects two CUDA events around each polish-path
launch call (``launch_events``), so that a caller can time the kernels
alone; ``TRACE_EVENTS`` is a second such sink, the trace's device track
(obs/__init__.py), so that both see every launch, whose entries also
carry the launch's device (a striped polish launches on several cards,
and each card's events are timed against a reference event of that
card). The pipelined polish launches from two threads (alignment on one,
consensus on the other), so all are written under one lock, and each
launch goes to the current stream of its tensors' device: the calling
thread's, or the stripe's own stream, which the partitioner makes
current together with its device (parallel/partitioner.py).

Each ``nvcc`` build of a source and each first load of its library in
the process counts ``kernel.builds.<source>`` in obs (a no-op unless a
run has armed it): a serve job reports their sum as its
``kernel_builds``, 0 once the daemon's warm-up has loaded every library
(``serve.PolishSession.warm``).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
SOURCES = ("poa", "poa_v2", "align", "align_base", "dp_cost_probe")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {"poa_consensus": 0, "poa_consensus_band": 0,
                            "poa_consensus_v2": 0,
                            "poa_consensus_v2_band": 0,
                            "poa_consensus_global": 0,
                            "poa_consensus_band_global": 0,
                            "poa_consensus_v2_global": 0,
                            "poa_consensus_v2_band_global": 0,
                            "poa_consensus_global32": 0,
                            "poa_consensus_band_global32": 0,
                            "poa_consensus_v2_global32": 0,
                            "poa_consensus_v2_band_global32": 0,
                            "hirschberg_edge": 0, "hirschberg_edge_k128": 0,
                            "hirschberg_base": 0, "hirschberg_base_k128": 0,
                            "dp_cost_probe": 0}

# None, or a list to which the polish path's wrappers (edge, base case,
# both POA kernels) append (name, start, end) for each launch: CUDA events
# on the launch's stream just before and just after the launch call, so
# that they time the kernel and not the wrapper's checks and allocations.
LAUNCH_EVENTS: Optional[List[tuple]] = None
# The same for the trace's device track (obs.arm_device_track), apart
# from LAUNCH_EVENTS so that arming a trace never takes over a caller's
# list; its entries are (name, start, end, device).
TRACE_EVENTS: Optional[List[tuple]] = None

_libs: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def take_trace_events() -> List[tuple]:
    """The device track's launches recorded so far; the sink starts
    afresh (obs.write_trace)."""
    global TRACE_EVENTS
    with _COUNT_LOCK:
        events, TRACE_EVENTS = TRACE_EVENTS or [], []
    return events


def count_launch(name: str) -> None:
    """One launch of kernel `name`: what each wrapper calls where it
    launches its kernel."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


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
    from .. import obs

    os.makedirs(BUILD, exist_ok=True)
    t0 = time.perf_counter()
    with obs.span("kernel.build") as sp, \
            open(os.path.join(BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            todo = [n for n in SOURCES if _stale(n)]
            sp.set(sources=todo)
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
                        obs.count(f"kernel.builds.{n}")
                if errors:
                    raise RuntimeError("CUDA kernel build failed:\n"
                                       + "\n".join(errors))
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return time.perf_counter() - t0


_LOAD_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building all sources first
    if any is missing or stale."""
    with _LOAD_LOCK:
        lib = _libs.get(name)
        if lib is None:
            if any(_stale(n) for n in SOURCES):
                build_all()
            lib = ctypes.CDLL(lib_path(name))
            _libs[name] = lib
            from .. import obs

            obs.count(f"kernel.builds.{name}")
    return lib


#: cudaError_t codes after which the process's context launches nothing
#: more (every later call returns the same error): illegal address (700),
#: launch timeout (702), device-side assert (710), hardware stack error
#: (714), illegal instruction (715), misaligned address (716), invalid
#: address space (717), invalid PC (718), launch failure (719).
STICKY_CODES = frozenset({700, 702, 710, 714, 715, 716, 717, 718, 719})


class DeviceError(RuntimeError):
    """A launch function returned a non-zero cudaError_t (``code``)."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what}: CUDA launch failed with error {code}")
        self.code = code

    @property
    def sticky(self) -> bool:
        """Whether the error has poisoned the process's CUDA context."""
        return self.code in STICKY_CODES


def check(err: int, what: str) -> None:
    """Raise DeviceError on a non-zero cudaError_t returned by a launch
    function."""
    if err != 0:
        raise DeviceError(what, err)


# What the POA kernels' occupancy exports report, in order.
POA_OCCUPANCY = ("regs", "local_bytes", "shared_bytes", "blocks_per_sm")


def occupancy(fn, args, keys, what: str) -> Dict[str, int]:
    """A kernel's resources through its ``rt_*_occupancy`` export, which
    takes int ``args`` and fills one int per name in ``keys`` (registers
    and local (spill) bytes a thread, and what else the kernel reports)."""
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
    out = (ctypes.c_int * len(keys))()
    check(fn(*args, out), f"{what} occupancy query")
    return dict(zip(keys, out))


@contextlib.contextmanager
def launch_events(name: str, t):
    """Around a launch call on ``t``'s stream: records its two events into
    ``LAUNCH_EVENTS`` and (with ``t``'s device) ``TRACE_EVENTS``, each
    where it is a list, else does nothing."""
    launch, trace = LAUNCH_EVENTS, TRACE_EVENTS
    if launch is None and trace is None:
        yield
        return
    import torch

    stream = torch.cuda.current_stream(t.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record(stream)
    yield
    ev[1].record(stream)
    with _COUNT_LOCK:
        if launch is not None:
            launch.append((name, ev[0], ev[1]))
        if trace is not None:
            trace.append((name, ev[0], ev[1], t.device))


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
