"""The port's device list: what the polish's launches are striped over.

The JAX package's mesh module (racon_tpu/parallel/mesh.py) builds a
``jax.sharding.Mesh`` and wraps kernels in ``jax.jit``/``shard_map``. The
port has neither: a stripe is one launch a device, each on that device's
own stream, and an ordered gather on the host (parallel/partitioner.py).
So its "mesh" is a tuple of ``torch.device``s, in stripe order, in which
a device may repeat: ``("cuda:0", "cuda:0")`` is a *virtual stripe*, two
launches on one card on two streams, the counterpart of the JAX tests'
forced virtual CPU mesh.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def visible_devices(device="cuda") -> Tuple[torch.device, ...]:
    """Every device of `device`'s type the process sees, as the JAX
    package's default mesh is every device of its backend: each visible
    card for "cuda", the one host for "cpu". A device with an index
    stands for itself alone."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return (torch.device("cpu"),)
    if dev.index is not None:
        return (dev,)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def device_mesh(devices: Sequence) -> Tuple[torch.device, ...]:
    """The stripe's devices, in stripe order, from names or
    ``torch.device``s (repeats allowed). A "cuda" without an index is
    cuda:0."""
    out = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        out.append(d)
    return tuple(out)


def resolve_devices(spec=None, device="cuda") -> Tuple[torch.device, ...]:
    """The stripe's devices from a ``--devices`` spelling: None, every
    visible device of `device`'s type (one card: no stripe); a count
    (``2``, ``"2"``), the first that many of them; or device names
    (``"cuda:0,cuda:1"``, a sequence), repeats allowed (``"cuda:0,cuda:0"``:
    a virtual stripe). Every device must be of `device`'s type and exist."""
    base = torch.device(device)
    every = visible_devices(base)
    if spec is None:
        return every
    if isinstance(spec, int) or (isinstance(spec, str)
                                 and spec.strip().isdigit()):
        n = int(spec)
        if not 1 <= n <= len(every):
            raise ValueError(f"--devices {spec!r}: {len(every)} {base.type} "
                             "device(s) visible")
        return every[:n]
    names = spec.split(",") if isinstance(spec, str) else list(spec)
    names = [n.strip() if isinstance(n, str) else n for n in names]
    try:
        devs = device_mesh([n for n in names if n != ""])
    except RuntimeError as e:   # torch.device's error for a bad name
        raise ValueError(f"--devices {spec!r}: {e}") from None
    if not devs:
        raise ValueError(f"no device in {spec!r}")
    for d in devs:
        if d.type != base.type:
            raise ValueError(f"device {d} in {spec!r}: the polish runs on "
                             f"{base.type}")
        if d.type == "cuda" and not d.index < torch.cuda.device_count():
            raise ValueError(f"device {d} in {spec!r}: "
                             f"{torch.cuda.device_count()} card(s) visible")
    return devs
