"""The journal's fingerprint: the identity of one polishing problem.

A copy of the JAX package's ``journal_fingerprint``
(racon_tpu/fingerprint.py), with its schema version and excluded
parameters. The kernel-cache and serve keys of that module wait for the
modules that use them.

The fingerprint hashes the input files' bytes, racon's parameters (the
polisher's ``racon_kwargs`` with the pipeline's defaults filled in, less
``num_threads``: polisher._racon_params) and a backend string:
``"torch"`` for TorchPolisher, ``"host"`` for CpuPolisher. What only
schedules the work is left out because it cannot change the bytes: the
thread count, and the card's own arguments (``device``, ``poa_kernel``,
``band``, ``band_slack``, ``band_max_widenings``, ``batch_windows``,
``pipeline_depth`` and the chunked modes), which TorchPolisher takes
apart from racon's. So a journal written on the card with the v2 kernel
resumes on the CPU with ls.
"""

from __future__ import annotations

import hashlib
from typing import Sequence

#: Journal header schema version (a journal written under another version
#: is not replayed).
JOURNAL_VERSION = 1

#: Polish parameters left out of the fingerprint: they cannot change the
#: output bytes (the thread count only schedules work).
EXCLUDED_PARAMS = ("num_threads",)


def journal_fingerprint(paths: Sequence[str], params: dict,
                        backend: str) -> str:
    """sha256 over the input bytes, the parameters and the backend,
    streamed (one read of the inputs)."""
    h = hashlib.sha256()
    h.update(f"racon-tpu-journal-v{JOURNAL_VERSION}".encode())
    h.update(f"\0backend={backend}".encode())
    for k in sorted(params):
        if k in EXCLUDED_PARAMS:
            continue
        h.update(f"\0{k}={params[k]!r}".encode())
    for p in paths:
        h.update(b"\0file\0")
        with open(p, "rb") as f:
            for blk in iter(lambda: f.read(1 << 20), b""):
                h.update(blk)
    return h.hexdigest()
