"""racon_tpu_torch: consensus polishing of long reads on a CUDA card.

The PyTorch and CUDA port of the JAX package ``racon_tpu``: the same
native host runtime (parsing, filtering, windowing, stitching, host
fallbacks; ``native/``, its own copy), with the Hirschberg banded aligner
and the POA consensus as CUDA kernels written for Hopper (``csrc/``).

    from racon_tpu_torch import create_polisher
    p = create_polisher("reads.fastq", "overlaps.paf", "draft.fasta")
    p.initialize()
    contigs = p.polish()

``create_polisher(..., backend="host")`` runs the native host pipeline
alone (``CpuPolisher``).
"""

__version__ = "0.1.0"

from . import native  # noqa: F401
from .polisher import (CpuPolisher, TorchPolisher,  # noqa: F401
                       create_polisher)

__all__ = ["CpuPolisher", "TorchPolisher", "create_polisher", "native",
           "__version__"]
