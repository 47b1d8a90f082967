"""The journal's fingerprint: the identity of one polishing problem, and
the serve daemon's paths of a job; and the registry that the determinism
audit (``racon_tpu_torch/analysis/determinism``) holds them against.

A copy of the JAX package's ``journal_fingerprint`` and
``serve_job_paths`` (racon_tpu/fingerprint.py), with its schema version
and excluded parameters. Its kernel-cache key has no use here: the CUDA
kernels are built once per source, not per geometry.

The fingerprint hashes the input files' bytes, racon's parameters (the
polisher's ``racon_kwargs`` with the pipeline's defaults filled in, less
``num_threads``: polisher._racon_params) and a backend string:
``"torch"`` for TorchPolisher, ``"host"`` for CpuPolisher. What only
schedules the work is left out because it cannot change the bytes: the
thread count, the card's own arguments (every keyword of
``TorchPolisher.__init__`` but ``racon_kwargs``), which TorchPolisher
takes apart from racon's, and the fault spec. So a journal written on
the card with the v2 kernel resumes on the CPU with ls.

Three pure literals describe that contract, and the determinism audit
reads them from the AST (never by import):

* ``SOURCES``: every value the fingerprint leaves out, where it is read
  (a parameter at its function's entry, or an environment read) and
  whether it may change the output bytes. The audit proves each
  cost-only source's value reaches no install seam
  (``set_consensus``, ``set_job_cigar``): ``determinism-leak``;
* ``OUTPUT_SOURCES``: the inputs every complete composition must cover,
  with ``source:<name>`` of each source declared output-affecting
  (``fingerprint-gap``);
* ``SITES``: each fingerprint composition and what its components
  cover; a component keyed only on cost-only, taint-clean sources is a
  ``fingerprint-overkey`` warning.
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

#: The values the fingerprint leaves out, as (name, file, callable, where,
#: affects_output): `where` is the parameter whose value enters the
#: callable, or ``env:<NAME>`` for an environment read inside it. PURE
#: LITERAL: the determinism audit parses it from the AST.
SOURCES = (
    ("device", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "device", False),
    ("devices", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "devices", False),
    ("batch_windows", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "batch_windows", False),
    ("poa_kernel", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "poa_kernel", False),
    ("band", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "band", False),
    ("band_slack", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "band_slack", False),
    ("band_max_widenings", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "band_max_widenings", False),
    ("pipeline_phases", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "pipeline_phases", False),
    ("handoff_depth", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "handoff_depth", False),
    ("stream_input", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "stream_input", False),
    ("memory_budget_mb", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "memory_budget_mb", False),
    ("spill_dir", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "spill_dir", False),
    ("pipeline_depth", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "pipeline_depth", False),
    ("journal_fsync", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "journal_fsync", False),
    ("trace_path", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "trace_path", False),
    ("device_timeout_s", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "device_timeout_s", False),
    ("device_memory_share", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "device_memory_share", False),
    ("sanitize", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "sanitize", False),
    ("sanitize_parity", "racon_tpu_torch/polisher.py",
     "TorchPolisher.__init__", "sanitize_parity", False),
    ("num_threads", "racon_tpu_torch/pipeline.py",
     "Pipeline.__init__", "num_threads", False),
    ("RACON_TORCH_FAULT", "racon_tpu_torch/resilience/faults.py",
     "active_spec", "env:RACON_TORCH_FAULT", False),
)

#: The inputs every complete fingerprint composition must cover (the
#: audit adds ``source:<name>`` for each source declared
#: output-affecting). PURE LITERAL.
OUTPUT_SOURCES = (
    "input:sequences",
    "input:overlaps",
    "input:target",
    "input:params",
    "input:backend",
)

#: The fingerprint compositions. PURE LITERAL. Per site: ``helper`` names
#: the function below that builds the key; ``complete: True`` means the
#: key must cover every output-affecting source; ``components`` maps each
#: key component to the tokens it covers, and ``site:<name>`` nests
#: another site's coverage (a serve job's directory holds its journal).
SITES = {
    "journal": {
        "helper": "journal_fingerprint",
        "description": "resilience/journal.py header: may a resume "
                       "replay this journal's records?",
        "complete": True,
        "components": {
            "schema": ("const:journal-version",),
            "backend": ("input:backend",),
            "params": ("input:params",),
            "input_bytes": ("input:sequences", "input:overlaps",
                            "input:target"),
        },
    },
    "serve_job_dir": {
        "helper": "serve_job_paths",
        "description": "serve/scheduler.py per-job artifact namespace: "
                       "the job id and backend key the journal a re-run "
                       "resumes",
        "complete": True,
        "components": {
            "job_id": ("input:job_id",),
            "backend": ("input:backend",),
            "journal": ("site:journal",),
        },
    },
}


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
