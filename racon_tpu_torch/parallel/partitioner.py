"""The Partitioner: every kernel launch of the polish, striped over
devices.

A port of the JAX package's partitioner (racon_tpu/parallel/partitioner.py)
without JAX. There the batch dim is sharded over a ``jax.sharding.Mesh``:
one program, its rows placed by XLA, padded to equal shards. Here a
**stripe** is one launch a device:

* the batch's rows (its leading dim: windows for POA, tasks for the
  aligner) are cut into m = min(devices, rows) contiguous slices, whose
  sizes differ by one at most (the first ``rows % m`` one larger, as
  ``np.array_split`` cuts), slice i for device i; no row is padded or
  recomputed, and the slices are views of the caller's (pinned) buffers;
* for each slice, under ``torch.cuda.device(dev)`` and
  ``torch.cuda.stream(s)``, the inputs are copied to the device without
  blocking, the wrapper launches its kernel, the outputs are copied into
  pinned host tensors without blocking and an event is recorded. Both
  context managers are needed: the kernels' libraries read the card's
  shared-memory limit and set their attributes on the runtime's current
  device (csrc/poa_common.cuh ``plan``), and the wrappers launch on the
  current stream of the tensors' device (``cuda_lib.stream_of``). At m =
  1, ``s`` is the caller's current stream of that device, so that one
  device runs the launches, copies and event on the stream it always
  did; at m > 1 each entry has a stream of its own, one set a thread (the
  pipelined polish launches from two threads);
* ``gather`` waits on every stripe's event, under the watchdog
  (resilience/watchdog.py), and concatenates the outputs on the host in
  stripe order. With the runtime sanitizer armed (analysis/sanitize.py)
  it first checks each stripe's outputs, as numpy views of the host
  copies it waited for: float outputs finite, one row a row launched.
  Every launch of the polish passes here, so this is the port's
  counterpart of the JAX package's checking proxy around each built
  kernel (ops/kernel_cache.py), which the port does not have.

Every launch of the polish path goes through ``stripe``, one device or
many. A striped launch (m > 1) counts ``shard.chunks`` and each device
position's rows, ``shard.rows.d<i>``, from the slice it launched (the JAX
package's counter names); m = 1 counts nothing. On the CPU each slice
runs the kernel's plain version in turn. No collectives: windows and
alignment tasks are independent. A device may repeat in the list
(``("cuda:0", "cuda:0")``, a virtual stripe).

Divergences from the JAX partitioner, by design: no ``demote`` (a stripe
whose launch fails raises, as every launch of the port does: no tier
lattice); no model axis, mesh shape or logical-axis rules (no port kernel
splits a non-batch dim, so every launch splits its leading dim over
every device); no padding (``shard_map`` needs equal shards, one launch a
device does not). ``get_partitioner`` is memoized on the device tuple, in
place of the JAX package's topology-keyed kernel cache.
"""

from __future__ import annotations

import functools
import threading
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..analysis import sanitize
from ..resilience.watchdog import wait_events
from .mesh import device_mesh


class StripeRun:
    """One striped launch in flight: per stripe, its outputs (pinned host
    tensors being filled on the card, or CPU tensors) and its event (None
    on the CPU); ``rows``, the rows each stripe launched."""

    __slots__ = ("parts", "rows")

    def __init__(self, parts, rows):
        self.parts = parts
        self.rows = rows

    def events(self):
        return [ev for _, ev in self.parts if ev is not None]

    def outputs(self):
        """The outputs as numpy arrays, concatenated in stripe order (once
        every event has been reached)."""
        if len(self.parts) == 1:
            return tuple(h.numpy() for h in self.parts[0][0])
        return tuple(np.concatenate([p[0][k].numpy() for p in self.parts])
                     for k in range(len(self.parts[0][0])))


def split_rows(rows: int, m: int):
    """The (start, stop) row bounds of `m` contiguous slices of `rows`
    rows, the first ``rows % m`` one row larger (``np.array_split``)."""
    per, extra = divmod(rows, m)
    bounds, lo = [], 0
    for i in range(m):
        hi = lo + per + (i < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


class Partitioner:
    """Launches kernels over `devices` (a tuple of torch.device, repeats
    allowed), one slice of the batch's rows a device (module note)."""

    def __init__(self, devices: Sequence):
        self.devices = device_mesh(devices)
        if not self.devices:
            raise ValueError("a Partitioner needs at least one device")
        self._local = threading.local()   # each thread's stripe streams

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    def stripes(self, rows: int) -> int:
        """The slices a batch of `rows` rows is launched as: one a device,
        and no slice without a row."""
        return max(1, min(self.n_devices, rows))

    def cards(self) -> Dict[torch.device, int]:
        """{device: entries of the list on it}: the stripes that share
        each card's memory."""
        out: Dict[torch.device, int] = {}
        for d in self.devices:
            out[d] = out.get(d, 0) + 1
        return out

    def _streams(self):
        streams = getattr(self._local, "streams", None)
        if streams is None:
            streams = self._local.streams = [
                torch.cuda.Stream(device=d) if d.type == "cuda" else None
                for d in self.devices]
        return streams

    def stripe(self, fn, arrays) -> StripeRun:
        """Launch `fn` on the batch `arrays` (numpy, the leading dim its
        rows), one slice a device (module note). `fn` takes the slice's
        tensors on the device and returns a tuple of device tensors, each
        with one row a batch row. Returns the StripeRun that ``gather``
        resolves."""
        rows = int(np.asarray(arrays[0]).shape[0])
        m = self.stripes(rows)
        streams = None
        if m > 1:
            obs.count("shard.chunks")
            if any(d.type == "cuda" for d in self.devices[:m]):
                streams = self._streams()
        parts = []
        bounds = split_rows(rows, m)
        for i, (lo, hi) in enumerate(bounds):
            dev = self.devices[i]
            if m > 1:
                obs.count(f"shard.rows.d{i}", hi - lo)
            if dev.type == "cpu":
                outs = fn(*(torch.from_numpy(np.ascontiguousarray(a[lo:hi]))
                            for a in arrays))
                parts.append((tuple(outs), None))
                continue
            with torch.cuda.device(dev):
                s = (torch.cuda.current_stream(dev) if streams is None
                     else streams[i])
                with torch.cuda.stream(s):
                    ins = [torch.from_numpy(a[lo:hi]).to(dev,
                                                         non_blocking=True)
                           for a in arrays]
                    host = []
                    for t in fn(*ins):
                        h = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True)
                        h.copy_(t, non_blocking=True)
                        host.append(h)
                    ev = torch.cuda.Event()
                    ev.record(s)
            parts.append((tuple(host), ev))
        return StripeRun(parts, [hi - lo for lo, hi in bounds])

    @staticmethod
    def gather(*runs: StripeRun, timeout_s: float = 0.0,
               what: str = "a striped launch", before=None,
               name: str = "launch") -> Tuple:
        """Wait for every stripe of `runs` (under the watchdog's deadline
        `timeout_s`, with `before`, a run point's fault check, inside the
        wait), then the outputs of each run in turn as numpy arrays,
        concatenated in stripe order. With the sanitizer armed, each
        stripe's outputs are checked first, findings under `name`."""
        wait_events([ev for run in runs for ev in run.events()], timeout_s,
                    what, before=before)
        if sanitize.enabled():
            for run in runs:
                for (outs, _), rows in zip(run.parts, run.rows):
                    sanitize.check_kernel_outputs(
                        f"partitioner.gather[{name}]",
                        [h.numpy() for h in outs], rows)
        return tuple(a for run in runs for a in run.outputs())


@functools.lru_cache(maxsize=8)
def _build_partitioner(devices: Tuple[torch.device, ...]) -> Partitioner:
    return Partitioner(devices)


def get_partitioner(devices: Sequence) -> Partitioner:
    """The process's Partitioner for these devices: one instance a device
    tuple, so that every polish on the same devices shares its streams."""
    return _build_partitioner(device_mesh(devices))


def reset_partitioner() -> None:
    """Drop the memoized partitioners (and their streams)."""
    _build_partitioner.cache_clear()
