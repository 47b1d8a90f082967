"""Crash-safe, append-only journal of served windows and CIGARs.

A copy of the JAX package's journal (racon_tpu/resilience/journal.py),
with the same record format, so that one reader serves both. A polish
that is killed (a preemption) resumes with ``--resume-journal``: it
replays what was served and recomputes only the rest, to the same bytes.

Format (one JSON object per line, keys sorted)::

    {"fingerprint": "<sha256>", "kind": "header", "version": 1}
    {"contig": 0, "i": 17, "kind": "window", "payload": "ACGT...",
     "polished": true, "rank": 3, "sha": "<sha256(payload)[:16]>",
     "tier": "ls"}
    {"cigar": "120=1X...", "i": 4, "kind": "cigar", "tier": "hirschberg"}

* **Durability**: each record is flushed and, with ``fsync`` (the
  default, as ``RACON_TPU_JOURNAL_FSYNC``), fsynced, so a crash loses at
  most the record being written. A write failure disarms the journal
  with a warning and the polish carries on unjournaled.
* **Torn tail**: replay reads from the top and stops at the first
  incomplete, unparseable or hash-mismatched line; the file is truncated
  back to the last good byte before appending resumes.
* **Fingerprint** (fingerprint.py): records from other inputs or
  parameters are refused. An explicit resume raises JournalError; a
  missing or empty file starts fresh.

Only final results are journaled: a kernel-served CIGAR or window as it
is installed (a band hit that will be re-run is not), the host re-polish
of a window, and the backbone windows. Host-aligned CIGARs are not: the
native pass recomputes them on resume. The ``journal.append`` and
``journal.replay`` fault points make both seams testable, ``kill=1``
included.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Set

from .. import fingerprint, obs
from . import faults

VERSION = fingerprint.JOURNAL_VERSION


class JournalError(RuntimeError):
    """A journal cannot be used for this run (fingerprint mismatch)."""


def _warn(msg: str) -> None:
    print(f"[racon_tpu_torch::journal] WARNING: {msg}", file=sys.stderr)


def _sha16(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()[:16]


def input_fingerprint(paths: Sequence[str], params: dict,
                      backend: str) -> str:
    """Identity of one polishing problem (fingerprint.journal_fingerprint)."""
    return fingerprint.journal_fingerprint(paths, params, backend)


@dataclass
class WindowRecord:
    payload: bytes
    polished: bool
    tier: str


@dataclass
class CigarRecord:
    cigar: str
    tier: str


class Journal:
    """One run's append handle and what a previous run left behind."""

    def __init__(self, path: str, fingerprint: str, *, resume: bool = False,
                 fsync: bool = True):
        self.path = path
        self.fingerprint = fingerprint
        self.dead = False
        self.fsync_s = 0.0       # seconds spent in fsync
        self.windows: Dict[int, WindowRecord] = {}
        self.cigars: Dict[int, CigarRecord] = {}
        self._fsync = fsync
        self._f = None
        if resume and os.path.exists(path) and os.path.getsize(path) > 0:
            self._open_resume()
        else:
            self._open_fresh()

    # -- opening -----------------------------------------------------------
    def _open_fresh(self) -> None:
        self._f = open(self.path, "wb")
        header = {"fingerprint": self.fingerprint, "kind": "header",
                  "version": VERSION}
        self._f.write((json.dumps(header, sort_keys=True) + "\n").encode())
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())

    def _open_resume(self) -> None:
        good_end = 0
        header_ok = False
        with open(self.path, "rb") as f:
            for raw in f:
                if not raw.endswith(b"\n"):
                    break            # torn tail: crash mid-write
                try:
                    rec = json.loads(raw.decode("utf-8"))
                    if not isinstance(rec, dict):
                        break
                    if not header_ok:
                        if (rec.get("kind") != "header"
                                or rec.get("version") != VERSION):
                            break
                        if rec.get("fingerprint") != self.fingerprint:
                            raise JournalError(
                                f"journal {self.path} was written for "
                                f"different inputs/parameters "
                                f"(fingerprint "
                                f"{str(rec.get('fingerprint'))[:12]}… != "
                                f"{self.fingerprint[:12]}…); refusing to "
                                f"resume — rerun without --resume-journal "
                                f"to start fresh")
                        header_ok = True
                    elif rec.get("kind") == "window":
                        payload = str(rec["payload"]).encode("latin-1")
                        if _sha16(payload) != rec.get("sha"):
                            break    # corrupt record: stop trusting here
                        self.windows[int(rec["i"])] = WindowRecord(
                            payload, bool(rec.get("polished")),
                            str(rec.get("tier", "?")))
                    elif rec.get("kind") == "cigar":
                        self.cigars[int(rec["i"])] = CigarRecord(
                            str(rec["cigar"]), str(rec.get("tier", "?")))
                    # unknown kinds from a newer writer: skipped
                except JournalError:
                    raise
                except Exception:  # noqa: BLE001 - any undecodable line
                    # ends the trusted prefix (a torn or corrupt tail)
                    break
                good_end += len(raw)
        if not header_ok:
            # an empty or torn header: ours to restart
            self.windows.clear()
            self.cigars.clear()
            self._open_fresh()
            return
        size = os.path.getsize(self.path)
        if good_end < size:
            _warn(f"{self.path}: dropping {size - good_end} torn trailing "
                  f"byte(s) (crash mid-append)")
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
        self._f = open(self.path, "ab")

    # -- appending ---------------------------------------------------------
    def _append(self, rec: dict) -> None:
        if self.dead or self._f is None:
            return
        try:
            faults.check("journal.append")
            self._f.write(
                (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8"))
            self._f.flush()
            if self._fsync:
                t0 = time.perf_counter()
                os.fsync(self._f.fileno())
                self.fsync_s += time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - durability must never fail
            # the polish: a dead journal is a degraded run, not a failed one
            self.dead = True
            _warn(f"journal write failed ({type(e).__name__}: {e}); "
                  f"continuing without journaling")

    def append_window(self, i: int, contig: int, rank: int, tier: str,
                      consensus: bytes, polished: bool) -> None:
        self._append({"contig": int(contig), "i": int(i), "kind": "window",
                      "payload": consensus.decode("latin-1"),
                      "polished": bool(polished), "rank": int(rank),
                      "sha": _sha16(consensus), "tier": tier})

    def append_cigar(self, job: int, tier: str, cigar: str) -> None:
        self._append({"cigar": cigar, "i": int(job), "kind": "cigar",
                      "tier": tier})

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    def __del__(self):
        self.close()


# --------------------------------------------------------------------------
# replay, shared by the polishers and the drivers
# --------------------------------------------------------------------------

def replay_windows(pipeline, journal: Optional[Journal], n: int,
                   report=None) -> Set[int]:
    """Install journaled consensus payloads; returns the replayed window
    indices. A failed replay (the ``journal.replay`` fault point) warns
    and recomputes every window: the bytes never depend on the journal."""
    if journal is None or not journal.windows:
        return set()
    try:
        faults.check("journal.replay", sorted(journal.windows))
    except Exception as e:  # noqa: BLE001 - replay seam: recompute
        _warn(f"replay failed ({type(e).__name__}: {e}); recomputing all "
              f"windows")
        if report is not None:
            report.record_failure("journal", e)
        return set()
    done: Set[int] = set()
    with obs.span("journal.replay", kind="windows") as sp:
        for i in sorted(journal.windows):
            if not 0 <= i < n:
                continue
            rec = journal.windows[i]
            pipeline.set_consensus(i, rec.payload, rec.polished)
            done.add(i)
        if report is not None and done:
            report.record_served("journal", len(done))
        sp.set(replayed=len(done))
    return done


def replay_cigars(pipeline, journal: Optional[Journal], n: int,
                  report=None) -> Set[int]:
    """Install journaled kernel CIGARs; returns the replayed job indices
    (left out of the kernels' jobs; the host pass skips any job whose
    CIGAR is set)."""
    if journal is None or not journal.cigars:
        return set()
    try:
        faults.check("journal.replay", sorted(journal.cigars))
    except Exception as e:  # noqa: BLE001 - replay seam: realign
        _warn(f"cigar replay failed ({type(e).__name__}: {e}); realigning "
              f"all jobs")
        if report is not None:
            report.record_failure("journal", e)
        return set()
    done: Set[int] = set()
    with obs.span("journal.replay", kind="cigars") as sp:
        for job in sorted(journal.cigars):
            if not 0 <= job < n:
                continue
            pipeline.set_job_cigar(job, journal.cigars[job].cigar)
            done.add(job)
        if report is not None and done:
            report.record_served("journal", len(done))
        sp.set(replayed=len(done))
    return done


class CigarTap:
    """Pipeline proxy that journals each CIGAR as the kernels' driver
    installs it (``set_job_cigar``); everything else delegates."""

    def __init__(self, pipeline, journal: Journal, tier: str):
        self._pipeline = pipeline
        self._journal = journal
        self._tier = tier

    def __getattr__(self, name):
        return getattr(self._pipeline, name)

    def set_job_cigar(self, job: int, cigar: str) -> None:
        self._pipeline.set_job_cigar(job, cigar)
        self._journal.append_cigar(job, self._tier, cigar)
