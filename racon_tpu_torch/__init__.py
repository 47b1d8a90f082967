"""racon_tpu_torch: consensus polishing of long reads on a CUDA card.

The PyTorch and CUDA port of the JAX package ``racon_tpu``: the same
native host runtime (parsing, filtering, windowing, stitching, host
fallbacks; ``native/``, its own copy), with the Hirschberg banded aligner
and the POA consensus as CUDA kernels written for Hopper (``csrc/``).

    from racon_tpu_torch import create_polisher
    p = create_polisher("reads.fastq", "overlaps.paf", "draft.fasta")
    p.initialize()
    contigs = p.polish()
"""

from . import native  # noqa: F401
from .polisher import TorchPolisher, create_polisher  # noqa: F401

__all__ = ["TorchPolisher", "create_polisher", "native"]
