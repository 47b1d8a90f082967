"""Seeded synthetic kernel inputs: POA window batches, alignment pairs and
edge-kernel tasks.

Used to hold each CUDA kernel against its plain version on the card
(chip_smoke.py, tests/test_torch_cuda.py). Everything is drawn with
numpy from the given seed, so a batch is the same on every machine.
``plain_poa_parallel`` and ``plain_poa_submit`` run the plain POA version
of large batches in several host processes for those checks.
"""

from __future__ import annotations

import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from ..ops import poa
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
              rate: float = 0.1, layers=None, shortest=None):
    """B windows of about `window` bases (from `shortest`, else 4/5 of
    it) with 2..cfg.depth layers each, or `layers` = (lo, hi) layers,
    lo..hi inclusive (one partial-span layer where there are three or
    more), per-base weights, and backbone weights: the nine numpy arrays
    ``poa.batch_to_tensors`` takes, as a tuple with a trailing None."""
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
        lo = window * 4 // 5 if shortest is None else shortest
        n = int(rng.integers(max(8, lo), window + 1))
        truth = rng.integers(0, 4, n).astype(np.uint8)
        backbone = mutate(rng, truth, rate)[:MB]
        L = len(backbone)
        bb[b, :L] = backbone
        bbw[b, :L] = rng.integers(0, 60, L)
        bb_len[b] = L
        lo, hi = (2, D) if layers is None else layers
        nl = int(rng.integers(lo, hi + 1))
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


#: wide_id_batch's backbone length and layer span.
WIDE_ID_BACKBONE, WIDE_ID_SPAN = 11000, 110


def wide_id_batch(cfg: PoaConfig, seed: int = 3):
    """Two windows at a geometry above the int16 node ids (class 11,008:
    max_nodes 33,024), the smallest launch of the POA kernels' int32
    global builds: window 0 has three short mutated layers on a random
    backbone; window 1 carries node ids past 32,767 with 199 short
    layers. Its backbone is 11,000 A's; 100 layers of 110 C's tile it, 99
    of 110 G's tile all but its last 110 bases, and every such base
    aligns to its column as a mismatch, so each makes a node: 32,890
    nodes. Needs cfg.depth >= 199 and cfg.max_backbone >= 11,000."""
    rng = np.random.default_rng(seed)
    D, ML, MB = cfg.depth, cfg.max_len, cfg.max_backbone
    L, span = WIDE_ID_BACKBONE, WIDE_ID_SPAN
    assert D >= 199 and MB >= L
    bb = np.zeros((2, MB), np.uint8)
    bbw = np.zeros((2, MB), np.int32)
    seqs = np.zeros((2, D, ML), np.uint8)
    ws = np.zeros((2, D, ML), np.int32)
    lens = np.zeros((2, D), np.int32)
    begins = np.zeros((2, D), np.int32)
    ends = np.zeros((2, D), np.int32)
    truth = rng.integers(0, 4, L).astype(np.uint8)
    bb[0, :L] = mutate(rng, truth, 0.1)[:L]
    bbw[:, :L] = rng.integers(1, 60, (2, L))
    n_layers = np.array([3, 0], np.int32)
    for li, beg in enumerate((100, 4000, 7500)):
        lay = mutate(rng, truth[beg:beg + 300], 0.1)
        seqs[0, li, :len(lay)] = lay
        ws[0, li, :len(lay)] = rng.integers(1, 60, len(lay))
        lens[0, li], begins[0, li], ends[0, li] = len(lay), beg, beg + 299
    for code, stop in ((1, L), (2, L - span)):
        for beg in range(0, stop, span):
            li = n_layers[1]
            seqs[1, li, :span] = code
            ws[1, li, :span] = rng.integers(1, 60, span)
            lens[1, li], begins[1, li], ends[1, li] = span, beg, beg + span - 1
            n_layers[1] += 1
    bb_len = np.full(2, L, np.int32)
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends, None)


def wide_column_batch(cfg: PoaConfig, seed: int = 5, span: int = 1000):
    """Two windows whose layers pass column 32,767 at class 22,016
    (max_len 33,024 above the int16 range, max_nodes 66,048): window 0 has
    three short mutated layers on a random backbone of cfg.max_backbone -
    16 bases; window 1's first layer is cfg.max_len - 124 bases (32,900
    at that class) over a `span`-base stretch of its backbone, the
    stretch's two halves around one long random insertion, so its graph
    also passes node id 32,767; its second layer, a mutated copy of the
    stretch, aligns through those inserted nodes. At a smaller class
    `span` shrinks to a quarter of the backbone."""
    rng = np.random.default_rng(seed)
    D, ML, MB = cfg.depth, cfg.max_len, cfg.max_backbone
    L = MB - 16
    span = min(span, L // 4)
    assert D >= 3 and ML - 124 > span
    bb = np.zeros((2, MB), np.uint8)
    bbw = np.zeros((2, MB), np.int32)
    seqs = np.zeros((2, D, ML), np.uint8)
    ws = np.zeros((2, D, ML), np.int32)
    lens = np.zeros((2, D), np.int32)
    begins = np.zeros((2, D), np.int32)
    ends = np.zeros((2, D), np.int32)
    bbw[:, :L] = rng.integers(1, 60, (2, L))

    def put(w, li, lay, beg, end):
        seqs[w, li, :len(lay)] = lay
        ws[w, li, :len(lay)] = rng.integers(1, 60, len(lay))
        lens[w, li], begins[w, li], ends[w, li] = len(lay), beg, end

    truth = rng.integers(0, 4, L).astype(np.uint8)
    bb[0, :L] = truth
    short = min(300, L // 4)
    for li, f in enumerate((0.01, 0.45, 0.9)):
        beg = int(f * (L - short))
        put(0, li, mutate(rng, truth[beg:beg + short], 0.1), beg,
            beg + short - 1)
    bb[1, :L] = rng.integers(0, 4, L)
    beg, half = L // 40, span // 2
    stretch = bb[1, beg:beg + span]
    insert = rng.integers(0, 4, ML - 124 - span).astype(np.uint8)
    put(1, 0, np.concatenate([stretch[:half], insert, stretch[half:]]), beg,
        beg + span - 1)
    put(1, 1, mutate(rng, stretch, 0.1), beg, beg + span - 1)
    n_layers = np.array([3, 2], np.int32)
    bb_len = np.full(2, L, np.int32)
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends, None)


#: (run length R, growing layers K, seed) of each equal_key_batch window.
EQUAL_KEY_WINDOWS = ((5, 11, 0), (7, 12, 0), (7, 11, 0), (12, 10, 1),
                     (9, 12, 3), (7, 10, 0))


def equal_key_batch(cfg: PoaConfig, windows=EQUAL_KEY_WINDOWS):
    """Windows whose float32 column keys run out of precision. On a random
    64-base backbone, layer k of K (full span) repeats the bases inserted
    so far between columns 40 and 41 and inserts R more, so the new
    columns' keys crowd towards 41 until some round to 41 itself: an edge
    then joins two nodes of equal key whose source has the larger id and
    ranks later. A last layer over columns 41..63 meets such nodes, some
    with every in-subgraph predecessor ranked after them. cfg needs
    depth >= 13, max_len >= 208 and max_backbone >= 64."""
    B, n, c = len(windows), 64, 40
    D, ML, MB = cfg.depth, cfg.max_len, cfg.max_backbone
    bb = np.zeros((B, MB), np.uint8)
    bbw = np.zeros((B, MB), np.int32)
    bb_len = np.full(B, n, np.int32)
    n_layers = np.zeros(B, np.int32)
    seqs = np.zeros((B, D, ML), np.uint8)
    ws = np.zeros((B, D, ML), np.int32)
    lens = np.zeros((B, D), np.int32)
    begins = np.zeros((B, D), np.int32)
    ends = np.full((B, D), n - 1, np.int32)
    for b, (R, K, seed) in enumerate(windows):
        rng = np.random.default_rng(seed)
        back = rng.integers(0, 4, n).astype(np.uint8)
        bb[b, :n], bbw[b, :n] = back, 10
        ins = np.zeros(0, np.uint8)
        lays = []
        for _ in range(K):
            ins = np.concatenate([ins, rng.integers(0, 4, R).astype(np.uint8)])
            lays.append(np.concatenate([back[:c + 1], ins, back[c + 1:]]))
        lays.append(back[c + 1:])
        begins[b, K] = c + 1
        n_layers[b] = len(lays)
        for li, lay in enumerate(lays):
            seqs[b, li, :len(lay)] = lay
            ws[b, li, :len(lay)] = 10
            lens[b, li] = len(lay)
    return (bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends, None)


#: (run length R, growing layers K, seed) of each pair_edge_batch window:
#: the first three fold in every layer, the last three fail.
PAIR_EDGE_WINDOWS = ((12, 12, 0), (9, 11, 2), (13, 12, 1), (12, 11, 2),
                     (12, 12, 2), (8, 12, 1))


def pair_edge_batch(cfg: PoaConfig, windows=PAIR_EDGE_WINDOWS):
    """Windows where a same-column pair of the colstep loop is joined by
    an edge. As in equal_key_batch, the keys of an insertion run crowd
    towards column 41 until two new nodes made one after the other round
    to the same float32 key: the edge between them then joins ranks r and
    r + 1 of one key, which the v2 kernel must run one after the other
    even though they share a column. Same cfg needs as equal_key_batch."""
    return equal_key_batch(cfg, windows)


def far_pred_batch(cfg: PoaConfig, B: int = 4, seed: int = 0,
                   insert: int = 100):
    """Windows whose graph holds in-subgraph edges far longer in rank than
    any ring of DP rows a kernel keeps. On a random 120-base backbone of
    codes 0..2 the first layer inserts a run of `insert` codes 3 after
    column 40; no base of the run can match a backbone node, so the run
    becomes one insertion and the backbone edge 40 -> 41 comes to span
    `insert` + 1 ranks. The other layers (full span, 5% mutated) follow
    the backbone across that edge, and every other one carries the run
    too. cfg needs max_len >= 120 + insert + 10 and max_backbone >= 120."""
    rng = np.random.default_rng(seed)
    n, c = 120, 40
    D, ML, MB = cfg.depth, cfg.max_len, cfg.max_backbone
    bb = np.zeros((B, MB), np.uint8)
    bbw = np.zeros((B, MB), np.int32)
    bb_len = np.full(B, n, np.int32)
    n_layers = np.full(B, D, np.int32)
    seqs = np.zeros((B, D, ML), np.uint8)
    ws = np.zeros((B, D, ML), np.int32)
    lens = np.zeros((B, D), np.int32)
    begins = np.zeros((B, D), np.int32)
    ends = np.full((B, D), n - 1, np.int32)
    for b in range(B):
        back = rng.integers(0, 3, n).astype(np.uint8)
        ins = np.full(insert, 3, np.uint8)
        bb[b, :n] = back
        bbw[b, :n] = rng.integers(1, 60, n)
        for li in range(D):
            lay = back if li % 2 else np.concatenate(
                [back[:c + 1], ins, back[c + 1:]])
            lay = mutate(rng, lay, 0.0 if li == 0 else 0.05)[:ML]
            seqs[b, li, :len(lay)] = lay
            ws[b, li, :len(lay)] = rng.integers(1, 60, len(lay))
            lens[b, li] = len(lay)
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


def _edge_arrays(K, shapes, rng, rcap):
    """Edge tasks (scal i32[B,4], q u8[B,rcap], t u8[B,rcap+K]) of the
    given (R, S, dmin) shapes; dmin None lays the task out as the
    aligner's orchestration does (the band centred on the drift). Codes
    0..4 (4 is N); the target is the query with 12% of its codes
    redrawn, padded with 255."""
    B = len(shapes)
    scal = np.zeros((B, 4), np.int32)
    q = rng.integers(0, 5, (B, rcap)).astype(np.uint8)
    t = np.full((B, rcap + K), 255, np.uint8)
    for b, (R, S, dmin) in enumerate(shapes):
        if dmin is None:
            drift = S - R
            dmin = min(0, drift) - (K - 1 - abs(drift)) // 2
        scal[b] = (R, S, dmin, 0)
        src = np.concatenate([q[b, :R], rng.integers(0, 5, rcap + K)])[:S]
        flip = rng.random(S) < 0.12
        src[flip] = rng.integers(0, 5, int(flip.sum()))
        t[b, :S] = src
    return scal, q, t


def edge_tasks(K: int, seed: int, rcap: int = 512):
    """Ten edge tasks at band K, R <= 300: near-diagonal ones, R = 1 with
    S = 0, R a multiple of neither 4 nor 32, dmin <= -K (the first rows
    wholly out of band, and column 0 entering at the last lane), dmin > 0
    with S < R (column S reaching lane 0 going backward), S = rcap + K,
    and codes 4 (N) in query and target."""
    shapes = [(1, 0, -((K - 1) // 2)), (299, 310, None), (257, 240, None),
              (100, 120, None), (300, 320, -K - 7), (200, 50, 5),
              (150, rcap + K, -3), (31, 33, 1 - K), (260, 275, None),
              (45, 40, -K - 20)]
    return _edge_arrays(K, shapes, np.random.default_rng(seed), rcap)


def edge_batch(K: int, B: int, seed: int, rcap: int = 512):
    """B random edge tasks at band K: R in 1..rcap, S within K/4 of R,
    dmin in -K/2..0."""
    rng = np.random.default_rng(seed)
    shapes = []
    for _ in range(B):
        R = int(rng.integers(1, rcap + 1))
        S = int(rng.integers(max(0, R - K // 4), min(rcap + K, R + K // 4)))
        shapes.append((R, S, -int(rng.integers(0, K // 2))))
    return _edge_arrays(K, shapes, rng, rcap)


def band_batch(cfg: PoaConfig, B: int, seed: int, roll: int = 0):
    """B windows of a random backbone of max_backbone / 2 bases and depth
    full-span layers, each the backbone with 3 substitutions; `roll`
    rotates each layer's bases after its 10th by that many places, so the
    layers drift off the backbone's diagonal (a narrow band hits there).
    The JAX package's banded POA fixture (tests/test_band.py _poa_batch),
    as ``poa_batch`` returns it (nine arrays and a trailing None)."""
    rng = np.random.default_rng(seed)
    L = cfg.max_backbone // 2
    bb = np.zeros((B, cfg.max_backbone), np.uint8)
    bbw = np.zeros((B, cfg.max_backbone), np.int32)
    bl = np.full(B, L, np.int32)
    nl = np.full(B, cfg.depth, np.int32)
    seqs = np.zeros((B, cfg.depth, cfg.max_len), np.uint8)
    ws = np.zeros((B, cfg.depth, cfg.max_len), np.int32)
    lens = np.full((B, cfg.depth), L, np.int32)
    bg = np.zeros((B, cfg.depth), np.int32)
    en = np.full((B, cfg.depth), L - 1, np.int32)
    for b in range(B):
        truth = rng.integers(0, 4, L).astype(np.uint8)
        bb[b, :L] = truth
        for li in range(cfg.depth):
            layer = truth.copy()
            pos = rng.integers(0, L, 3)
            layer[pos] = (layer[pos] + 1) % 4
            if roll:
                layer[10:] = np.roll(layer[10:], roll)
            seqs[b, li, :L] = layer
            ws[b, li, :L] = 1
    return bb, bbw, bl, nl, seqs, ws, lens, bg, en, None


def _plain_poa_part(cfg, arrays, wband=None, kernel="v2"):
    """One process's share of the plain POA run: numpy in, numpy out."""
    import torch

    torch.set_num_threads(1)
    stats = {"cells": 0, "steps": 0, "rows": 0}
    outs = poa.poa_batch_plain(
        cfg, *(torch.from_numpy(a) for a in arrays), stats=stats,
        colstep=True, wband=None if wband is None else torch.from_numpy(wband),
        kernel=kernel)
    return [o.numpy() for o in outs], stats


def plain_poa_pool(procs: int) -> ProcessPoolExecutor:
    """A pool of `procs` spawned processes for plain_poa_submit; one pool
    can serve every check of a run, so each starts no processes of its
    own."""
    return ProcessPoolExecutor(procs,
                               mp_context=multiprocessing.get_context("spawn"))


def plain_poa_submit(batches, procs: int, ex: ProcessPoolExecutor,
                     kernel: str = "v2"):
    """Queues the plain POA version on the host for [(cfg, tensors)] or
    [(cfg, tensors, wband)] (the banded build's half bands, i32[B], run
    with `kernel`'s banded semantics) on the pool `ex`, each batch's
    windows split over `procs` jobs (the plain version loops over windows
    in Python), and returns a function that waits for them and gives
    [(outputs, stats)]: the stats hold the DP cells, the DP rows and the
    colstep steps."""
    jobs, spans = [], []
    for cfg, dev_in, *wband in batches:
        host = [t.cpu().numpy() for t in dev_in]
        wb = wband[0].cpu().numpy() if wband else None
        cuts = np.linspace(0, host[0].shape[0], procs + 1).astype(int)
        spans.append((len(jobs), procs))
        jobs += [(cfg, [a[lo:hi] for a in host],
                  None if wb is None else wb[lo:hi], kernel)
                 for lo, hi in zip(cuts[:-1], cuts[1:])]
    futures = [ex.submit(_plain_poa_part, *job) for job in jobs]

    def gather():
        import torch

        parts = [f.result() for f in futures]
        res = []
        for first, n in spans:
            mine = parts[first:first + n]
            outs = [np.concatenate([p[0][k] for p in mine])
                    for k in range(len(mine[0][0]))]
            res.append(([torch.from_numpy(o) for o in outs],
                        {k: sum(p[1][k] for p in mine)
                         for k in ("cells", "steps", "rows")}))
        return res

    return gather


def plain_poa_parallel(batches, procs: int, kernel: str = "v2", ex=None):
    """plain_poa_submit's results, waited for: on the pool `ex`, or on a
    pool of `procs` processes of its own."""
    if ex is not None:
        return plain_poa_submit(batches, procs, ex, kernel)()
    with plain_poa_pool(procs) as own:
        return plain_poa_submit(batches, procs, own, kernel)()


class WindowSet:
    """A stand-in for ``pipeline.Pipeline`` in the consensus phase
    (``poa_driver.run_consensus_phase``): the windows of a ``poa_batch``,
    exported as the pipeline exports them, and the consensus each gets
    (``consensus``: window -> (bases, polished)). A window the kernel
    fails gets None from ``consensus_cpu_one``."""

    def __init__(self, packed):
        self.packed = packed
        self.consensus = {}

    def num_windows(self) -> int:
        return len(self.packed[2])

    def window_info(self, i: int):
        bb_len, n_layers = self.packed[2][i], self.packed[3][i]
        return (int(n_layers) + 1, int(bb_len), 0, True, 0, 0)

    def export_window(self, i: int):
        from ..ops.encoding import decode
        from ..pipeline import WindowExport

        bb, bbw, bb_len, n_layers, seqs, ws, lens, begins, ends = \
            self.packed[:9]
        L, K = int(bb_len[i]), int(n_layers[i])
        lk = lens[i, :K]
        ascii_of = np.frombuffer(decode(np.arange(4)), np.uint8)
        return WindowExport(
            index=i, rank=0, target_id=0, is_tgs=True,
            backbone=ascii_of[bb[i, :L]], backbone_weights=bbw[i, :L].astype(
                np.uint8), lens=lk.astype(np.uint32),
            begins=begins[i, :K].astype(np.uint32),
            ends=ends[i, :K].astype(np.uint32),
            bases=np.concatenate([ascii_of[seqs[i, k, :lk[k]]]
                                  for k in range(K)]),
            weights=np.concatenate([ws[i, k, :lk[k]] for k in range(K)]
                                   ).astype(np.uint8))

    def set_consensus(self, i: int, bases: bytes, polished: bool) -> None:
        self.consensus[i] = (bases, polished)

    def consensus_cpu_one(self, i: int) -> None:
        self.consensus[i] = None
