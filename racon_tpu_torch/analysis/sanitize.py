"""Opt-in runtime sanitizer for the port's drivers (dynamic analysis).

A copy of the JAX package's sanitizer (racon_tpu/analysis/sanitize.py),
armed by arguments instead of its ``RACON_TPU_SANITIZE`` and
``RACON_TPU_SANITIZE_PARITY`` knobs: ``TorchPolisher(sanitize=True,
sanitize_parity=N)``, ``create_polisher(...)`` with the same, or the CLI's
``--sanitize`` and ``--sanitize-parity N``. Each polisher constructor
calls ``arm``, which also clears the findings, so that a run reports its
own. Three families of checks:

* **launch outputs**: when armed, the partitioner's ``gather``
  (parallel/partitioner.py) checks each stripe's outputs once they are on
  the host (``check_kernel_outputs``): float outputs are finite, and every
  output has one row a row the stripe launched. Every launch of both
  phases goes through it, so it stands where the JAX package wraps each
  built kernel in a checking proxy (ops/kernel_cache.py); the port has no
  kernel cache. It takes the numpy arrays the gather returns: nothing is
  copied back from the card and nothing waits beyond the gather's own
  wait;
* **driver seams**: the consensus install (``poa_driver._install``)
  checks in-range consensus codes and lengths before it installs a chunk,
  and on every N-th window the card served (``sanitize_parity``, default
  8; 0 turns it off) recomputes the window on the host and compares the
  bytes before the card's result is installed over the host's, so an
  armed run is byte-identical to an unarmed one. The aligner
  (``align_cuda.run_jobs``) checks that served rows' op codes stay in the
  M/I/D range before they become CIGARs;
* **shared-state guards**: the drivers' stats dicts are wrapped so that a
  write from any thread but the one that made the dict is recorded as a
  ``racy-stats`` finding.

A finding never raises and never changes the polish: findings are
recorded (capped, deduplicated by kind and place), reported under
``RunReport.as_dict()["sanitize"]`` and read by ``python -m
racon_tpu_torch.analysis --sanitize-report``. A parity mismatch is a
finding: the host bytes are never installed and the window is not sent
to the host.

Fault points (``RACON_TORCH_FAULT``; resilience/faults.py):
``sanitize.nan`` poisons the checker's copy of a chunk's consensus (the
installed consensus is untouched) and ``sanitize.stats`` makes one real
cross-thread write through a guard, on a thread named
``sanitize-stats-probe``; both show that the detectors fire without
changing the bytes.

This module imports neither torch nor JAX.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

#: The default parity stride: every 8th window the card served.
DEFAULT_PARITY = 8

#: Distinct (kind, where) findings kept; later hits only bump counters.
_MAX_FINDINGS = 100


@dataclass
class Finding:
    """One sanitizer violation class, aggregated across occurrences."""

    kind: str    # nonfinite | stripe-rows | cigar-op-range |
                 # consensus-range | parity | racy-stats
    where: str   # launch or driver seam that caught it
    detail: str  # first occurrence's specifics
    count: int = 1


_lock = threading.Lock()
_findings: Dict[Tuple[str, str], Finding] = {}
# the arming state, set by each polisher constructor (``arm``)
_armed = False
_parity = DEFAULT_PARITY


def arm(enabled: bool = False, parity: int = DEFAULT_PARITY) -> None:
    """Arm (or disarm) the sanitizer for the next run, with a parity
    stride of `parity` (0: no parity), and clear the findings."""
    global _armed, _parity
    if int(parity) < 0:
        raise ValueError(f"sanitize_parity must be >= 0, got {parity}")
    with _lock:
        _armed = bool(enabled)
        _parity = int(parity)
        _findings.clear()


def enabled() -> bool:
    """Whether the runtime sanitizer is armed."""
    return _armed


def reset() -> None:
    """Clear the collected findings (``arm`` does this for each run)."""
    with _lock:
        _findings.clear()


def record(kind: str, where: str, detail: str) -> None:
    """Record one violation (thread-safe; capped, never raises)."""
    with _lock:
        f = _findings.get((kind, where))
        if f is not None:
            f.count += 1
        elif len(_findings) < _MAX_FINDINGS:
            _findings[(kind, where)] = Finding(kind, where, detail)


def findings() -> List[Finding]:
    with _lock:
        return list(_findings.values())


def as_dicts() -> List[dict]:
    """JSON-ready findings (the RunReport / --sanitize-report schema)."""
    return [{"kind": f.kind, "where": f.where, "detail": f.detail,
             "count": f.count} for f in findings()]


# --------------------------------------------------------------------------
# launch outputs (called from the partitioner's gather)
# --------------------------------------------------------------------------

def check_kernel_outputs(name: str, outs, rows=None) -> None:
    """Invariants on one stripe's concrete outputs (numpy arrays): float
    outputs are finite and, where `rows` is given, each output has
    `rows` rows."""
    for k, a in enumerate(outs):
        arr = np.asarray(a)
        if rows is not None and (arr.ndim == 0 or arr.shape[0] != rows):
            record("stripe-rows", f"{name}[out {k}]",
                   f"output {k} has shape {arr.shape} for a stripe of "
                   f"{rows} rows")
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            record("nonfinite", f"{name}[out {k}]",
                   f"non-finite values in float output {k} "
                   f"(shape {arr.shape})")


# --------------------------------------------------------------------------
# driver-seam checks (called from ops/align_cuda.py and ops/poa_driver.py)
# --------------------------------------------------------------------------

def check_align_outputs(ops, cnt, ok, where: str) -> None:
    """Aligner outputs: op codes on a served (ok) row must stay in the
    M/I/D range 0..2; code 3 is the kernel's failure marker and is legal
    only on rows whose ok flag is already false."""
    ops = np.asarray(ops)
    cnt = np.asarray(cnt).reshape(-1)
    ok = np.asarray(ok).reshape(-1)
    for bi in range(ops.shape[0]):
        if bi >= len(ok) or not bool(ok[bi]):
            continue
        row = ops[bi, :int(cnt[bi])]
        if row.size and int(row.max()) > 2:
            record("cigar-op-range", where,
                   f"op code {int(row.max())} > 2 on served row {bi}")


def check_consensus_outputs(results, idxs, where: str) -> None:
    """Consensus chunk invariants at the install seam: cons_len within the
    padded capacity, base codes decodable (0..4) within each served
    length, failed flags boolean.

    The ``sanitize.nan`` fault poisons a float copy for the checker only:
    the arrays the driver installs are never touched, so a fault-injected
    run still polishes byte-identically."""
    cons_base, _cons_cov, cons_len, failed = (np.asarray(x)
                                              for x in results)
    cons_len = cons_len.reshape(-1)
    failed = failed.reshape(-1)

    check_view = cons_base.astype(np.float32, copy=True)
    from ..resilience import faults
    try:
        faults.check("sanitize.nan", idxs)
    except faults.InjectedFault:
        if check_view.size:
            check_view.reshape(-1)[0] = np.nan
    if not np.isfinite(check_view).all():
        record("nonfinite", where,
               f"non-finite consensus values (chunk windows {idxs[:4]}…)")

    cap = cons_base.shape[1] if cons_base.ndim >= 2 else cons_base.size
    for bi in range(len(cons_len)):
        if int(failed[bi]) not in (0, 1):
            record("consensus-range", where,
                   f"failed flag {failed[bi]!r} not boolean (row {bi})")
        if int(failed[bi]):
            continue
        cl = int(cons_len[bi])
        if cl < 0 or cl > cap:
            record("consensus-range", where,
                   f"cons_len {cl} outside [0, {cap}] (row {bi})")
            continue
        row = cons_base[bi, :cl] if cons_base.ndim >= 2 else cons_base[:cl]
        if row.size and (int(row.min()) < 0 or int(row.max()) > 4):
            record("consensus-range", where,
                   f"base code outside 0..4 (row {bi}, "
                   f"min {int(row.min())}, max {int(row.max())})")


# --------------------------------------------------------------------------
# sampled host <-> card parity
# --------------------------------------------------------------------------

def parity_due(n_installed: int) -> bool:
    """Whether the window installed after `n_installed` others is
    recomputed on the host: every Nth window the card served (N the armed
    parity stride; 0: parity off)."""
    s = _parity
    return _armed and s > 0 and n_installed % s == 0


def check_parity(device_payload, host_payload, window: int,
                 where: str) -> None:
    """Byte-compare a card's consensus with the host recompute of the same
    window (the caller recomputes before it installs the card's result,
    which is what the pipeline keeps either way)."""
    d = (device_payload.encode() if isinstance(device_payload, str)
         else bytes(device_payload))
    h = (host_payload.encode() if isinstance(host_payload, str)
         else bytes(host_payload))
    if d != h:
        record("parity", where,
               f"window {window}: device consensus ({len(d)}b) != "
               f"host recompute ({len(h)}b)")


# --------------------------------------------------------------------------
# shared-state guard (driver stats dicts)
# --------------------------------------------------------------------------

class GuardedStats(dict):
    """Dict guard recording a ``racy-stats`` finding when any thread but
    the one that created it (the driver's) writes a key. The write still
    happens: the guard observes, it does not serialize."""

    def __init__(self, initial: dict, where: str):
        super().__init__(initial)
        self._owner = threading.get_ident()
        self._where = where

    def __setitem__(self, key, value):
        tid = threading.get_ident()
        if tid != self._owner:
            record("racy-stats", self._where,
                   f"key {key!r} written from thread {tid} "
                   f"(owner {self._owner})")
        super().__setitem__(key, value)

    def __reduce__(self):
        # a copy (pickled to another process, deep-copied) is a plain
        # dict: the guard belongs to its thread
        return (dict, (dict(self),))


def guard_stats(stats: dict, where: str) -> dict:
    """Wrap a driver stats dict when the sanitizer is armed (the dict
    itself otherwise); the caller keeps the returned dict. The
    ``sanitize.stats`` fault makes one real cross-thread write through
    the guard, whose key is then removed."""
    if not enabled():
        return stats
    g = GuardedStats(stats, where)
    from ..resilience import faults
    try:
        faults.check("sanitize.stats")
    except faults.InjectedFault:
        t = threading.Thread(target=g.__setitem__,
                             args=("_sanitize_stats_probe", 1),
                             name="sanitize-stats-probe", daemon=True)
        t.start()
        t.join(timeout=10.0)
        g.pop("_sanitize_stats_probe", None)
    return g
