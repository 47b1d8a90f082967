"""The journal's fingerprint: the identity of one polishing problem, and
the serve daemon's paths of a job.

A copy of the JAX package's ``journal_fingerprint`` and
``serve_job_paths`` (racon_tpu/fingerprint.py), with its schema version
and excluded parameters. Its kernel-cache key has no use here: the CUDA
kernels are built once per source, not per geometry.

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
import os
from typing import Dict, Optional, Sequence

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


def serve_job_paths(workdir: str, job_id: str,
                    backend: Optional[str] = None) -> Dict[str, str]:
    """Every path the serve daemon derives from a job id: the job
    directory and, when `backend` is given, the artifact paths inside it.
    The journal's name is keyed by backend ("cuda", "host"), so a job
    demoted from the device lane to the host lane never replays device
    records into a host run (the two fingerprints differ too)."""
    jd = os.path.join(workdir, "jobs", job_id)
    out = {"dir": jd}
    if backend is not None:
        out.update(
            journal=os.path.join(jd, f"journal.{backend}.jsonl"),
            output=os.path.join(jd, "polished.fasta"),
            trace=os.path.join(jd, "trace.json"),
            report=os.path.join(jd, "report.json"),
        )
    return out
