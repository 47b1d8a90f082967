"""Banded DP: the Ukkonen band plan and the verify-and-widen ladder.

A copy of the JAX package's ops/band.py (racon_tpu/ops/band.py), with the
slack and the widening budget as arguments (the JAX side reads them from
``RACON_TPU_BAND_SLACK`` and ``RACON_TPU_BAND_MAX_WIDENINGS``; 32 and 2 by
default there and here) and the counters in a ``stats`` dict.

* **Band plan.** A job's first band is ``w0 = |m - n| + slack`` bucketed
  to ``BAND_BUCKETS``; a job whose first band would not be narrower than
  its flat bucket runs flat.
* **Exact verify (aligner).** With the band placed symmetrically around
  the main-diagonal corridor, a path that leaves the band costs at least
  ``|m - n| + 2 (min_pad + 1)`` edits, so a banded terminal distance of at
  most ``|m - n| + 2 min_pad`` proves that every optimal and co-optimal
  path lies strictly inside the band: the banded ops equal the flat
  ones (``ukkonen_ok``).
* **Hit signal (POA).** Sequence-to-graph scoring has no such bound, so
  the banded POA kernel flags ``band_hit`` where the traceback comes
  within one cell of the band edge, or where the terminal score falls
  further below the all-match score than ``poa_deficit_bound``.
* **Ladder.** A hit job is re-run at a wider band, at most
  ``max_widenings`` times; then it runs flat, through the flat kernel
  (aligner) or through the banded build at ``wband = 0`` (POA). The flat
  run is the oracle, so the ladder never changes output.

The counts, in the caller's ``stats`` dict: ``jobs`` (banded first
attempts), ``hits``, ``widenings`` and ``fallbacks`` (ladders that ended
flat).
"""

from __future__ import annotations

from typing import Optional

#: Band buckets of the banded aligner. 128 is the narrowest band the
#: kernels take; the wider rungs are the flat aligner's buckets, so the
#: ladder tops out where the flat kernel starts.
BAND_BUCKETS = (128, 256, 512, 1024, 2048)
DEFAULT_SLACK = 32
DEFAULT_MAX_WIDENINGS = 2
COUNTS = ("jobs", "hits", "widenings", "fallbacks")


def new_stats() -> dict:
    return dict.fromkeys(COUNTS, 0)


def initial_width(n: int, m: int, slack: int = DEFAULT_SLACK) -> int:
    """w0: the length delta plus the slack."""
    return abs(m - n) + max(0, slack)


def bucket_for(width: int) -> Optional[int]:
    """Smallest band bucket covering `width`; None where none does."""
    for b in BAND_BUCKETS:
        if width <= b:
            return b
    return None


def plan_align_band(n: int, m: int, flat_k: int, widenings: int = 0,
                    slack: int = DEFAULT_SLACK) -> Optional[int]:
    """Banded K for an aligner job after `widenings` doublings, or None
    where a band cannot beat the flat bucket `flat_k` (0: a host job)."""
    if flat_k <= 0 or flat_k <= BAND_BUCKETS[0]:
        return None
    k = bucket_for(initial_width(n, m, slack) << widenings)
    return k if k is not None and k < flat_k else None


def ukkonen_ok(n: int, m: int, k: int, gdmin: int, dist) -> bool:
    """Exact in-band certificate for the unit-cost aligner: the band covers
    the diagonals [gdmin, gdmin + k - 1], the optimal corridor
    [min(0, m - n), max(0, m - n)], and min_pad is the narrower margin
    between them."""
    if dist is None:
        return False
    pad_low = min(0, m - n) - gdmin
    pad_high = (gdmin + k - 1) - max(0, m - n)
    min_pad = min(pad_low, pad_high)
    if min_pad < 0:
        return False
    return dist <= abs(m - n) + 2 * min_pad


def poa_deficit_bound(gap: int, w: int) -> int:
    """The banded POA kernel's score-deficit bound at half-band `w`: a
    terminal score further than this below the all-match score sets
    band_hit."""
    return 2 * abs(gap) * max(1, w // 2)


class BandState:
    """One job's ladder: its current band `k` (None: flat, where a ladder
    that ends also ends) and the widenings taken."""

    __slots__ = ("k", "widenings")

    def __init__(self, k):
        self.k = k
        self.widenings = 0

    def _exhaust(self, stats) -> None:
        self.k = None
        stats["fallbacks"] += 1

    def widen(self, n: int, m: int, flat_k: int, stats: dict,
              max_widenings: int = DEFAULT_MAX_WIDENINGS,
              slack: int = DEFAULT_SLACK) -> None:
        """After an aligner hit: the next bucket of the doubled first band
        while the budget lasts and it beats the flat bucket, else flat."""
        stats["hits"] += 1
        if self.widenings < max(0, max_widenings):
            self.widenings += 1
            nxt = plan_align_band(n, m, flat_k, self.widenings, slack)
            if nxt is not None and nxt > self.k:
                self.k = nxt
                stats["widenings"] += 1
                return
        self._exhaust(stats)

    def widen_width(self, cap: int, stats: dict,
                    max_widenings: int = DEFAULT_MAX_WIDENINGS) -> None:
        """After a POA hit: `k` is a half-band width the kernel takes as
        data, so the ladder doubles it while the budget lasts and it stays
        below `cap`, then runs flat (wband = 0)."""
        stats["hits"] += 1
        if (self.widenings < max(0, max_widenings) and self.k
                and 2 * self.k < cap):
            self.widenings += 1
            self.k *= 2
            stats["widenings"] += 1
            return
        self._exhaust(stats)
