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

The polisher, and with it torch, is imported at the first use of one of
its names, so that the trace reader (``racon_tpu_torch.obs``) and its
cost model run without torch, as the JAX package's run without JAX.
"""

__version__ = "0.1.0"

from . import native  # noqa: F401

_POLISHER_NAMES = ("CpuPolisher", "TorchPolisher", "create_polisher")


def __getattr__(name):
    if name in _POLISHER_NAMES:
        from . import polisher
        return getattr(polisher, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CpuPolisher", "TorchPolisher", "create_polisher", "native",
           "__version__"]
