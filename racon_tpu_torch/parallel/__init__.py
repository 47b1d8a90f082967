"""Multi-card striping: each kernel launch of the polish is split by rows
over a list of devices, one launch a device on that device's own stream,
and gathered on the host in stripe order (the reference racon's CUDA
polisher stripes its POA and aligner batches over every GPU,
src/cuda/cudapolisher.cpp:96-114,165-180,228-240; the JAX package shards
them over a mesh, racon_tpu/parallel).

Layout: ``mesh`` holds the device list and the ``--devices`` parser,
``partitioner`` the Partitioner that launches a stripe and gathers it."""

from .mesh import device_mesh, resolve_devices, visible_devices  # noqa: F401
from .partitioner import (  # noqa: F401
    Partitioner, get_partitioner, reset_partitioner)
