"""Host-side count of column-compressed POA stepping.

The v2 POA kernel (csrc/poa_v2.cu) runs its DP over the subgraph's nodes
in rank order, which is column-key order. Two facts make it sound to
retire two adjacent ranks in one serial iteration when they share a key:

* **Equal keys mean same column.** A node key is either a backbone
  ordinal or ``lo + (hi - lo) / (run + 1)`` strictly between its
  neighbours' keys; two nodes share a key only when the graph update
  placed them as alternative bases of the same alignment column.
* **No intra-column edges.** Every edge goes from a smaller key to a
  larger one, so nodes of one column never feed each other.

The kernel still runs the pair's two rows one after the other, in rank
order, so its result does not depend on the pairing. This module is the
count the plain version (ops/poa.py) and the tests hold the kernel's
measured iteration count against.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: Ranks retired per serial iteration when a same-column sibling is
#: adjacent: a column of m nodes takes ceil(m / 2) steps.
PACK = 2


def pair_schedule(keys) -> List[Tuple[int, int]]:
    """Greedy adjacent pairing of equal keys in rank order.

    `keys` are the column keys of the subgraph's nodes in rank order.
    Returns ``[(rank, take), ...]`` with ``take`` in {1, 2}: the
    iterations the kernel's column-compressed loop runs over ranks
    [0, len(keys)).
    """
    k = np.asarray(keys)
    out: List[Tuple[int, int]] = []
    r, n = 0, len(k)
    while r < n:
        take = 2 if (r + 1 < n and k[r + 1] == k[r]) else 1
        out.append((r, take))
        r += take
    return out


def n_column_steps(keys) -> int:
    """Serial DP iterations of the column-compressed loop."""
    return len(pair_schedule(keys))


def compression(keys) -> float:
    """Ranks per serial step: len(keys) / n_column_steps (1.0..2.0)."""
    n = len(np.asarray(keys))
    return n / n_column_steps(keys) if n else 1.0
