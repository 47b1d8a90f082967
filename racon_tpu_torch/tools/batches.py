"""Seeded synthetic kernel inputs: POA window batches and alignment pairs.

Used to hold each CUDA kernel against its plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py). Everything is drawn with
numpy from the given seed, so a batch is the same on every machine.
"""

from __future__ import annotations

import numpy as np

from ..ops.poa import PoaConfig


def mutate(rng: np.random.Generator, seq: np.ndarray, rate: float):
    """Codes 0..3 with substitutions, deletions and insertions, each at
    rate / 3 per base."""
    r = rng.random(len(seq))
    out = seq.copy()
    sub = r < rate / 3
    out[sub] = rng.integers(0, 4, int(sub.sum()))
    keep = ~((r >= rate / 3) & (r < 2 * rate / 3))
    ins = (r >= 2 * rate / 3) & (r < rate)
    reps = np.where(ins, 2, 1) * keep
    out = np.repeat(out, reps)
    # the second copy of each inserted base becomes a random base
    pos = np.cumsum(reps)[ins & keep] - 1
    out[pos] = rng.integers(0, 4, len(pos))
    return out.astype(np.uint8)


def poa_batch(cfg: PoaConfig, B: int, seed: int, window: int,
              rate: float = 0.1):
    """B windows of about `window` bases with 2..cfg.depth layers each
    (one partial-span layer where depth allows), per-base weights, and
    backbone weights: the nine numpy arrays ``poa.batch_to_tensors``
    takes, as a tuple with a trailing None."""
    rng = np.random.default_rng(seed)
    D, ML, MB = cfg.depth, cfg.max_len, cfg.max_backbone
    bb = np.zeros((B, MB), np.uint8)
    bbw = np.zeros((B, MB), np.int32)
    bb_len = np.ones(B, np.int32)
    n_layers = np.zeros(B, np.int32)
    seqs = np.zeros((B, D, ML), np.uint8)
    ws = np.zeros((B, D, ML), np.int32)
    lens = np.zeros((B, D), np.int32)
    begins = np.zeros((B, D), np.int32)
    ends = np.zeros((B, D), np.int32)
    for b in range(B):
        n = int(rng.integers(max(8, window * 4 // 5), window + 1))
        truth = rng.integers(0, 4, n).astype(np.uint8)
        backbone = mutate(rng, truth, rate)[:MB]
        L = len(backbone)
        bb[b, :L] = backbone
        bbw[b, :L] = rng.integers(0, 60, L)
        bb_len[b] = L
        nl = int(rng.integers(2, D + 1))
        n_layers[b] = nl
        for li in range(nl):
            lay = mutate(rng, truth, rate)
            beg, end = 0, L - 1
            if li == nl - 1 and nl >= 3:
                beg, end = L // 3, 2 * L // 3
                lay = lay[len(lay) // 3:2 * len(lay) // 3]
            lay = lay[:ML]
            seqs[b, li, :len(lay)] = lay
            ws[b, li, :len(lay)] = rng.integers(1, 60, len(lay))
            lens[b, li] = len(lay)
            begins[b, li], ends[b, li] = beg, end
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends, None)


def align_pairs(seed: int, count: int, lo: int, hi: int, rate=(0.02, 0.18)):
    """`count` (query, target) code pairs: a random query of lo..hi bases
    and a target mutated from it at a rate drawn from `rate`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        q = rng.integers(0, 4, int(rng.integers(lo, hi))).astype(np.uint8)
        out.append((q, mutate(rng, q, float(rng.uniform(*rate)))))
    return out
