"""Hirschberg banded global aligner: CUDA edge-row and base-case kernels,
their plain PyTorch versions, and the host orchestration.

Replaces the JAX package's Pallas kernels ``_build_edge_kernel``
(racon_tpu/ops/align_pallas.py:112, pallas_call :264), whose CUDA version
is csrc/align.cu, and ``_build_base_kernel`` (:299, pallas_call :422),
whose CUDA version is csrc/align_base.cu:

* edge kernel: a banded unit-cost edit-distance DP over R rows that
  returns only the last K-lane band row, forward from ``F[0][j] = j`` or
  backward from ``B[R][j] = S - j``. Lane o holds column
  ``j = i + dmin + o``; cells out of band are INF.
* base kernel: subproblems of at most BASE_ROWS rows run the full banded
  DP keeping one move per cell (0=M, 1=I, 2=D), then trace back from
  (R, S) to (0, 0) and emit the op codes in reverse order, with the
  terminal distance and an ``ok`` flag (0 when the path leaves the band).

The orchestration splits every pair at its midpoint row until the pieces
fit the base case: a forward pass over the top half and a backward pass
over the bottom half give the crossing column (the first argmin of
F + B). Pairs that need no band wider than the largest bucket and whose
path stays in band are served here; the rest are left CIGAR-less for the
host aligner.

The banded path (``run_jobs(band=True)``, the JAX package's
``RACON_TPU_BAND``) starts a job on the narrower band of its Ukkonen plan
(ops/band.py), K = 128 included, where the same kernels run at that K;
the pair's exact certificate decides whether its ops stand, and a job
whose certificate fails climbs the ladder to the flat bucket.

What bounds the kernels on an H100: integer operations. One warp serves a
task and holds K/32 lanes per thread in registers, so a row costs no
shared memory and no block barrier, only warp shuffles for the one-lane
neighbour and the prefix/suffix min. Both keep the target and query codes
in registers (a window of target codes four to a word, slid one code a
row; the query's words one a lane), so a row loads nothing from global
memory. The edge kernel tests no bounds inside a row: it keeps each row
in a frame shifted by its lane and row index, where a cell is an add and
two mins, and sets the lanes out of band to INF once, at its output
(csrc/align.cu says why that leaves every output bit unchanged). The
base case writes its moves, two bits a cell, to a global scratch that one
thread reads back during the traceback.

Every launch goes through a ``partitioner`` (parallel/partitioner.py; by
default one over `device` alone, whose stripe runs on the caller's
current stream). Over m > 1 devices the task rows of each edge launch
and each base-case launch are cut into m slices, each device runs its
slice on a stream of its own, and the host waits on every stripe's event
under the watchdog before it gathers the rows in order.

Wrappers: a tensor on the CPU goes to the plain version, a tensor on the
card to the kernel (or an exception). Each launch adds one to
``cuda_lib.LAUNCHES`` (the K = 128 builds under their own names,
``launch_name``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import obs
from ..parallel.partitioner import get_partitioner
from ..resilience import faults
from ..resilience.watchdog import call_with_watchdog
from . import band as _band
from . import cuda_lib
from .align import ops_to_cigar
from .encoding import encode

INF = 1 << 28
BASE_ROWS = 256          # subproblems at or below this row count run the
                         # full traceback kernel
ROW_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 49152)
BANDS = (256, 512, 1024, 2048)   # the flat buckets (band_for)
KERNEL_BANDS = _band.BAND_BUCKETS  # what the kernels take: the flat
                                   # buckets and 128, a band override only
COHORT = 4096            # jobs aligned together, at most
SCRATCH_BUDGET = 512 << 20   # bytes of base-case moves scratch a launch


def band_for(n: int, m: int, band_hint: int = 0) -> int:
    """Band bucket: 10% of the larger side plus the diagonal drift; 0 when
    no bucket is wide enough (the host aligns the pair)."""
    need = max(band_hint, abs(m - n) + max(n, m) // 10 + 2)
    for b in BANDS:
        if need <= b:
            return b
    return 0


def _round_up(x, m):
    return (x + m - 1) // m * m


def base_ops_width(K: int) -> int:
    return _round_up(BASE_ROWS + K + 2, 128)


def base_scratch_bytes(K: int) -> int:
    """The base kernel's moves scratch a task: two bits a cell."""
    return BASE_ROWS * K // 4


def base_chunk(K: int) -> int:
    """Base tasks a launch at band K, so that its scratch stays within
    SCRATCH_BUDGET."""
    return max(1, SCRATCH_BUDGET // base_scratch_bytes(K))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def edge_rows_plain(scal, q, t, K: int, backward: bool) -> torch.Tensor:
    """Last band row of the forward (or backward) DP for each task.

    scal i32[B,4] = (R, S, dmin, 0); q u8[B,rcap] (natural order for both
    directions); t u8[B,rcap+K] padded with 255. Returns i32[B,K] on the
    inputs' device.
    """
    dev = scal.device
    scal, q, t = (x.long() for x in (scal, q, t))
    B, TCAP = t.shape
    R, S, dmin = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    lane = torch.arange(K, device=dev).unsqueeze(0)
    ar = torch.arange(B, device=dev)
    inf_col = torch.full((B, 1), INF, dtype=torch.long, device=dev)
    if not backward:
        j0 = dmin + lane
        row = torch.where((j0 >= 0) & (j0 <= S), j0, INF)
        for i in range(1, int(R.max()) + 1 if B else 1):
            jv = i + dmin + lane
            tc = t.gather(1, (jv - 1) % TCAP)
            sub = row + (tc != q[:, i - 1:i]).long()
            up = torch.cat([row[:, 1:], inf_col], 1) + 1
            V = torch.minimum(sub, up)
            V = torch.where(jv == 0, torch.full_like(V, i), V)
            oob = (jv < 0) | (jv > S)
            V = torch.where(oob, INF, V)
            nrow = torch.cummin(V - lane, 1).values + lane
            nrow = torch.where(oob, INF, torch.clamp(nrow, max=INF))
            row = torch.where(i <= R, nrow, row)
        return row.int()
    jR = R + dmin + lane
    row = torch.where((jR >= 0) & (jR <= S), S - jR, INF)
    gv = K - 1 - lane
    for k in range(int(R.max()) if B else 0):
        i = R - 1 - k                                    # per task
        jv = i + dmin + lane
        tc = t.gather(1, jv % TCAP)
        qc = q[ar, i[:, 0].clamp(min=0)].unsqueeze(1)
        sub = row + (tc != qc).long()
        down = torch.cat([inf_col, row[:, :-1]], 1) + 1
        V = torch.minimum(sub, down)
        V = torch.where(jv == S, R - i, V)
        oob = (jv < 0) | (jv > S)
        V = torch.where(oob, INF, V)
        x = (V - gv).flip(1)
        nrow = torch.cummin(x, 1).values.flip(1) + gv
        nrow = torch.where(oob, INF, torch.clamp(nrow, max=INF))
        row = torch.where(k < R, nrow, row)
    return row.int()


def base_plain(scal, q, t, K: int):
    """Base case: full banded DP with moves, traceback from (R, S).

    scal i32[B,4]; q u8[B,BASE_ROWS]; t u8[B,BASE_ROWS+K]. Returns (ops
    i32[B,OPS] in reverse order, cnt i32[B], ok i32[B], dist i32[B]) on
    the inputs' device; the traceback runs on the host.
    """
    dev = scal.device
    scal, q, t = (x.long() for x in (scal, q, t))
    B, TCAP = t.shape
    OPS = base_ops_width(K)
    R, S, dmin = scal[:, 0:1], scal[:, 1:2], scal[:, 2:3]
    lane = torch.arange(K, device=dev).unsqueeze(0)
    inf_col = torch.full((B, 1), INF, dtype=torch.long, device=dev)
    j0 = dmin + lane
    row = torch.where((j0 >= 0) & (j0 <= S), j0, INF)
    Rmax = int(R.max()) if B else 0
    moves = torch.zeros((B, max(Rmax, 1), K), dtype=torch.uint8, device=dev)
    fill = lane < K - 1     # the in-row scan's INF fill reaches every lane
                            # but the last
    for i in range(1, Rmax + 1):
        jv = i + dmin + lane
        tc = t.gather(1, (jv - 1) % TCAP)
        sub = row + (tc != q[:, i - 1:i]).long()
        up = torch.cat([row[:, 1:], inf_col], 1) + 1
        V = torch.minimum(sub, up)
        mv = torch.where(V == sub, 0, 1)
        V = torch.where(jv == 0, torch.full_like(V, i), V)
        mv = torch.where(jv == 0, 1, mv)
        oob = (jv < 0) | (jv > S)
        V = torch.where(oob, INF, V)
        c = torch.cummin(V - lane, 1).values
        c = torch.where(fill, torch.clamp(c, max=INF), c)
        nrow = c + lane
        mv = torch.where(nrow < V, 2, mv)
        nrow = torch.where(oob, INF, nrow)
        act = i <= R
        moves[:, i - 1] = torch.where(act, mv, 0).to(torch.uint8)
        row = torch.where(act, nrow, row)

    o_fin = S - R - dmin
    d_at = row.gather(1, o_fin.clamp(0, K - 1))
    dist = torch.where((o_fin >= 0) & (o_fin < K), d_at, INF)[:, 0]

    ops = np.zeros((B, OPS), dtype=np.int32)
    cnt = np.zeros(B, dtype=np.int32)
    okv = np.zeros(B, dtype=np.int32)
    mvn = moves.cpu().numpy()
    sc = scal.cpu().numpy()
    for b in range(B):
        i, j, dm = int(sc[b, 0]), int(sc[b, 1]), int(sc[b, 2])
        c, ok = 0, True
        while (i > 0 or j > 0) and c < OPS and ok:
            o = j - i - dm
            if i > 0:
                mv = int(mvn[b, i - 1, o]) if 0 <= o < K else 3
            else:
                mv = 2
            ok = mv != 3
            ops[b, c] = mv
            if mv != 2:
                i -= 1
            if mv != 1:
                j -= 1
            c += 1
        cnt[b] = c
        okv[b] = int(ok and i == 0 and j == 0)
    return (torch.from_numpy(ops).to(dev), torch.from_numpy(cnt).to(dev),
            torch.from_numpy(okv).to(dev), dist.int())


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LIB = None
_BASE_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = cuda_lib.load("align")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_edge_launch.restype = ci
        lib.rt_edge_launch.argtypes = [vp] * 5 + [ci] * 5 + [vp]
        _LIB = lib
    return _LIB


def _base_lib():
    global _BASE_LIB
    if _BASE_LIB is None:
        lib = cuda_lib.load("align_base")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rt_base_launch.restype = ci
        lib.rt_base_launch.argtypes = [vp] * 9 + [ci] * 4 + [vp]
        _BASE_LIB = lib
    return _BASE_LIB


def edge_occupancy(K: int, backward: bool) -> dict:
    """The edge kernel's registers and local (spill) bytes a thread and
    resident warps per SM at band K in one direction (needs the card)."""
    if K not in KERNEL_BANDS:
        raise ValueError(f"band {K} not in {KERNEL_BANDS}")
    return cuda_lib.occupancy(_lib().rt_edge_occupancy, (K, int(backward)),
                              ("regs", "local_bytes", "warps_per_sm"),
                              "edge kernel")


def base_occupancy(K: int) -> dict:
    """The base kernel's registers and local (spill) bytes a thread and
    resident warps per SM at band K (needs the card)."""
    if K not in KERNEL_BANDS:
        raise ValueError(f"band {K} not in {KERNEL_BANDS}")
    return cuda_lib.occupancy(_base_lib().rt_base_occupancy, (K,),
                              ("regs", "local_bytes", "warps_per_sm"),
                              "base kernel")


def launch_name(kernel: str, K: int) -> str:
    """The launch count a kernel adds to at band K: the K = 128 builds,
    which only the banded path runs, count apart."""
    return f"{kernel}_k128" if K == 128 else kernel


def _check_tasks(scal, q, t, rows: int, K: int):
    if K not in KERNEL_BANDS:
        raise ValueError(f"band {K} not in {KERNEL_BANDS}")
    B = scal.shape[0]
    dev = scal.device
    cuda_lib.require(scal, "scal", torch.int32, (B, 4), dev)
    cuda_lib.require(q, "q", torch.uint8, (B, rows), dev)
    cuda_lib.require(t, "t", torch.uint8, (B, rows + K), dev)
    return B


def edge_rows(scal, q, t, K: int, backward: bool,
              cycles=None) -> torch.Tensor:
    """Last band row per task: the kernel for tensors on the card, the
    plain version for tensors on the CPU.

    cycles: None, or an int64 tensor (B,) on the card that the kernel
    fills with each task's clock64() cycles in its row loop. The plain
    version counts none."""
    if scal.device.type == "cpu":
        if cycles is not None:
            raise ValueError("cycles: only the kernel counts them")
        return edge_rows_plain(scal, q, t, K, backward)
    rcap = q.shape[1]
    B = _check_tasks(scal, q, t, rcap, K)
    if q.data_ptr() % 4 or rcap % 4:
        raise ValueError("q: the kernel reads it as 32-bit words; its data "
                         "must be 4-byte aligned and its rows a multiple of "
                         f"4 bytes (rcap {rcap})")
    if cycles is not None:
        cuda_lib.require(cycles, "cycles", torch.int64, (B,), scal.device)
    out = torch.empty((B, K), dtype=torch.int32, device=scal.device)
    if B:
        lib = _lib()
        name = launch_name("hirschberg_edge", K)
        with cuda_lib.launch_events(name, scal):
            err = lib.rt_edge_launch(
                cuda_lib.ptr(scal), cuda_lib.ptr(q), cuda_lib.ptr(t),
                cuda_lib.ptr(out),
                None if cycles is None else cuda_lib.ptr(cycles), B, rcap,
                K, rcap + K, int(backward), cuda_lib.stream_of(scal))
        cuda_lib.check(err, "hirschberg edge kernel")
        cuda_lib.count_launch(name)
    return out


def base_case(scal, q, t, K: int, cycles=None):
    """(ops, cnt, ok, dist) per base task: the kernel for tensors on the
    card, the plain version for tensors on the CPU.

    cycles: None, or an int64 tensor (2, B) on the card that the kernel
    fills with each task's clock64() cycles in the DP rows (row 0) and in
    the traceback with the ops zero-fill (row 1). The plain version counts
    none."""
    if scal.device.type == "cpu":
        if cycles is not None:
            raise ValueError("cycles: only the kernel counts them")
        return base_plain(scal, q, t, K)
    B = _check_tasks(scal, q, t, BASE_ROWS, K)
    dev = scal.device
    if q.data_ptr() % 4:
        raise ValueError("q: the kernel reads it as 32-bit words; its data "
                         "must be 4-byte aligned")
    if cycles is not None:
        cuda_lib.require(cycles, "cycles", torch.int64, (2, B), dev)
    OPS = base_ops_width(K)
    ops = torch.empty((B, OPS), dtype=torch.int32, device=dev)
    cnt = torch.empty(B, dtype=torch.int32, device=dev)
    ok = torch.empty(B, dtype=torch.int32, device=dev)
    dist = torch.empty(B, dtype=torch.int32, device=dev)
    moves = torch.empty((B, base_scratch_bytes(K)), dtype=torch.uint8,
                        device=dev)
    if B:
        lib = _base_lib()
        name = launch_name("hirschberg_base", K)
        with cuda_lib.launch_events(name, scal):
            err = lib.rt_base_launch(
                cuda_lib.ptr(scal), cuda_lib.ptr(q), cuda_lib.ptr(t),
                cuda_lib.ptr(ops), cuda_lib.ptr(cnt), cuda_lib.ptr(ok),
                cuda_lib.ptr(dist), cuda_lib.ptr(moves),
                None if cycles is None else cuda_lib.ptr(cycles), B, K,
                BASE_ROWS + K, OPS, cuda_lib.stream_of(scal))
        cuda_lib.check(err, "hirschberg base kernel")
        cuda_lib.count_launch(name)
    return ops, cnt, ok, dist


def tasks_to_tensors(scal, q, t, device):
    """Unpacked numpy task arrays (int codes) -> the kernels' inputs on
    `device`: scal i32, q and t u8."""
    def conv(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    return conv(scal, np.int32), conv(q, np.uint8), conv(t, np.uint8)


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

class _Task:
    __slots__ = ("pair", "ia", "ib", "ja", "jb")

    def __init__(self, pair, ia, ib, ja, jb):
        self.pair, self.ia, self.ib, self.ja, self.jb = pair, ia, ib, ja, jb


def align_pairs(pairs, *, device="cuda", band_overrides=None, hits=None,
                timeout_s: float = 0.0, partitioner=None):
    """pairs: [(q_codes, t_codes)] int numpy arrays -> [ops | None].

    ops are forward-ordered codes (0=M, 1=I, 2=D); None leaves the pair to
    the host aligner (band escape or oversize).

    band_overrides: {pair index: K} runs those pairs under band K where K
    is narrower than their flat bucket (``band_for``), with the exact
    Ukkonen verify (ops/band.py): the pair's global distance must certify
    that every optimal and co-optimal path lies strictly inside the band,
    so that its ops equal the flat run's. A pair whose certificate fails
    is aborted at its first round, gets None, and its index is added to
    `hits` for the caller's verify-and-widen ladder.

    timeout_s: the watchdog's deadline on each wait for the card (0:
    none). partitioner: stripes the launches' task rows over its devices
    (module note; default: `device` alone)."""
    part = (get_partitioner([device]) if partitioner is None
            else partitioner)
    results: List[Optional[np.ndarray]] = [None] * len(pairs)
    segments: Dict[int, list] = {}
    bands = {}
    verify = {}     # pair index -> (n, m, K, gdmin) of a banded pair
    active = []
    for idx, (q, t) in enumerate(pairs):
        n, m = len(q), len(t)
        K = band_for(n, m)
        if K == 0 or n == 0 or m == 0 or (n + 1) // 2 > ROW_BUCKETS[-1]:
            continue
        kb = band_overrides.get(idx) if band_overrides else None
        banded = kb is not None and kb < K
        if banded:
            K = int(kb)
        gdmin = int(min(0, m - n) - (K - 1 - abs(m - n)) // 2)
        bands[idx] = (K, gdmin)
        if banded:
            verify[idx] = (n, m, K, gdmin)
        segments[idx] = []
        active.append(_Task(idx, 0, n, 0, m))

    failed = set()
    while True:
        big = [t for t in active if (t.ib - t.ia) > BASE_ROWS
               and t.pair not in failed]
        if not big:
            break
        active = [t for t in active if (t.ib - t.ia) <= BASE_ROWS]
        active.extend(_split_round(pairs, big, bands, failed, part,
                                   verify, timeout_s))

    base = [t for t in active if t.pair not in failed]
    _solve_base(pairs, base, bands, segments, failed, part, verify,
                timeout_s)

    for idx, segs in segments.items():
        if idx in failed:
            continue
        segs.sort(key=lambda s: s[0])
        results[idx] = np.concatenate([s[1] for s in segs]) if segs else \
            np.zeros(0, np.int32)
    if hits is not None:
        # a banded pair that fails is a hit: one whose certificate held
        # cannot fail later, since it covers every co-optimal path
        hits.update(idx for idx in failed if idx in verify)
    return results


def _root_certified(t, verify, dist) -> bool:
    """False where `t` is a banded pair's whole problem and its global
    distance does not certify the band (ops/band.ukkonen_ok)."""
    v = verify.get(t.pair)
    if v is None or not (t.ia == 0 and t.ib == v[0] and t.ja == 0
                         and t.jb == v[1]):
        return True
    return _band.ukkonen_ok(v[0], v[1], v[2], v[3], dist)


def _task_arrays(pairs, tasks, bands, rcap, K, backward):
    """Pack tasks into kernel arrays. The staged target window is clipped
    to the half's band-reachable columns (j <= ib + gdmin + K going
    forward, j >= ia + gdmin going backward) so it fits rcap + K."""
    B = len(tasks)
    TCAP = rcap + K
    scal = np.zeros((B, 4), np.int32)
    qs = np.zeros((B, rcap), np.uint8)
    ts = np.full((B, TCAP), 255, np.uint8)
    for bi, t in enumerate(tasks):
        q, tt = pairs[t.pair]
        _, gdmin = bands[t.pair]
        R = t.ib - t.ia
        if backward:
            j_lo = max(t.ja, t.ia + gdmin)
            j_hi = t.jb
        else:
            j_lo = t.ja
            j_hi = min(t.jb, t.ib + gdmin + K)
        S = j_hi - j_lo
        assert 0 <= S <= TCAP, (S, TCAP)
        scal[bi] = (R, S, gdmin + t.ia - j_lo, 0)
        qs[bi, :R] = q[t.ia:t.ib]
        ts[bi, :S] = tt[j_lo:j_hi]
    return scal, qs, ts


def _split_round(pairs, tasks, bands, failed, part, verify, timeout_s):
    """One Hirschberg round: split every oversized task at its midpoint.
    A banded pair's root task checks its certificate here: every path
    crosses the midpoint row, so the least F + B is the global distance."""
    out = []
    by_bucket = {}
    for t in tasks:
        K = bands[t.pair][0]
        half = (t.ib - t.ia + 1) // 2
        rcap = next(rb for rb in ROW_BUCKETS if half <= rb)
        by_bucket.setdefault((rcap, K), []).append(t)

    for (rcap, K), group in sorted(by_bucket.items()):
        # forward over [ia, imid], backward over [imid, ib]
        f_tasks, b_tasks = [], []
        for t in group:
            imid = (t.ia + t.ib) // 2
            f_tasks.append(_Task(t.pair, t.ia, imid, t.ja, t.jb))
            b_tasks.append(_Task(t.pair, imid, t.ib, t.ja, t.jb))
        fwd = part.stripe(
            lambda s, q, t, K=K: (edge_rows(s, q, t, K, False),),
            _task_arrays(pairs, f_tasks, bands, rcap, K, False))
        bwd = part.stripe(
            lambda s, q, t, K=K: (edge_rows(s, q, t, K, True),),
            _task_arrays(pairs, b_tasks, bands, rcap, K, True))
        F, Bv = part.gather(
            fwd, bwd, timeout_s=timeout_s,
            what=f"the edge kernel's round at K={K}, {len(group)} tasks")
        for gi, t in enumerate(group):
            imid = (t.ia + t.ib) // 2
            K_, gdmin = bands[t.pair]
            # Both midpoint rows map lane o to absolute column
            # j = imid + gdmin + o; overlay onto the task's column range
            # relative to ja.
            jmid = imid + gdmin - t.ja + np.arange(K_)
            span = t.jb - t.ja
            fv = np.full(span + 1, INF, np.int64)
            bv = np.full(span + 1, INF, np.int64)
            m = (jmid >= 0) & (jmid <= span)
            fv[jmid[m]] = F[gi][m]
            bv[jmid[m]] = Bv[gi][m]
            tot = fv + bv
            jstar = int(np.argmin(tot))      # first optimal crossing
            if tot[jstar] >= INF or not _root_certified(t, verify,
                                                        int(tot[jstar])):
                failed.add(t.pair)
                continue
            jabs = t.ja + jstar
            out.append(_Task(t.pair, t.ia, imid, t.ja, jabs))
            out.append(_Task(t.pair, imid, t.ib, jabs, t.jb))
    return out


def _solve_base(pairs, tasks, bands, segments, failed, partitioner, verify,
                timeout_s):
    """The base case of every task; a banded pair that is one base task
    checks its certificate on the kernel's terminal distance."""
    by_bucket = {}
    for t in tasks:
        by_bucket.setdefault(bands[t.pair][0], []).append(t)
    for K, group in sorted(by_bucket.items()):
        TCAP = BASE_ROWS + K
        step = base_chunk(K)
        for off in range(0, len(group), step):
            part = group[off:off + step]
            B = len(part)
            scal = np.zeros((B, 4), np.int32)
            qs = np.zeros((B, BASE_ROWS), np.uint8)
            ts = np.full((B, TCAP), 255, np.uint8)
            for bi, t in enumerate(part):
                q, tt = pairs[t.pair]
                _, gdmin = bands[t.pair]
                R, S = t.ib - t.ia, t.jb - t.ja
                scal[bi] = (R, S, gdmin + t.ia - t.ja, 0)
                qs[bi, :R] = q[t.ia:t.ib]
                ts[bi, :S] = tt[t.ja:t.jb]
            ops, cnt, ok, dist = partitioner.gather(
                partitioner.stripe(
                    lambda s, q, t, K=K: base_case(s, q, t, K),
                    (scal, qs, ts)),
                timeout_s=timeout_s, what=f"the base case at K={K}, {B} tasks")
            for bi, t in enumerate(part):
                if not ok[bi] or not _root_certified(t, verify,
                                                     int(dist[bi])):
                    failed.add(t.pair)
                    continue
                seg = ops[bi, :cnt[bi]][::-1].astype(np.int32)
                segments[t.pair].append((t.ia, seg))


def run_jobs(pipeline, jobs, lengths, *, device="cuda", band: bool = False,
             band_slack: int = _band.DEFAULT_SLACK,
             band_max_widenings: int = _band.DEFAULT_MAX_WIDENINGS,
             stats: Optional[dict] = None, timeout_s: float = 0.0,
             partitioner=None) -> int:
    """Align pipeline jobs with the Hirschberg engine and install their
    CIGARs. Jobs are grouped by (band, first-round row bucket) into
    cohorts of at most COHORT jobs, so each cohort launches
    geometry-homogeneous kernel batches. Returns how many jobs the engine
    served; band escapes stay CIGAR-less for the host aligner.

    With `band`, a job whose Ukkonen plan (ops/band.py, `band_slack`)
    beats its flat bucket starts on the narrower band, and its bucket key
    is that band. Each cohort then runs until its ladder drains: a job
    whose certificate fails widens (at most `band_max_widenings` times)
    and is re-run with the cohort's other hits; a job past its last rung
    is re-run flat, through the same kernels. `stats`, when given, gets
    the ladder's counts (``band.COUNTS``).

    Each ladder round of a cohort is an ``align.cohort`` span and checks
    the ``align.run`` fault point (under the watchdog, as the waits for
    the card are: `timeout_s`); a banded round checks ``band.hit``, whose
    injected fault makes every banded job of the round a hit.
    `partitioner` stripes the kernels' launches (module note)."""
    if stats is None:
        stats = _band.new_stats()
    states = {}          # job -> band.BandState of a banded job
    buckets = {}
    for job in jobs:
        n, m = int(lengths[job, 0]), int(lengths[job, 1])
        K = band_for(n, m)
        kb = (_band.plan_align_band(n, m, K, slack=band_slack)
              if band and K else None)
        if kb is not None:
            states[job] = _band.BandState(kb)
        half = (max(n, 1) + 1) // 2
        rcap = next((rb for rb in ROW_BUCKETS if half <= rb), 0)
        buckets.setdefault((kb or K, rcap), []).append(job)
    stats["jobs"] += len(states)

    served = 0
    for (K, _), items in sorted(buckets.items()):
        for off in range(0, len(items), COHORT):
            group = items[off:off + COHORT]
            pairs = {}
            for job in group:
                qa, ta = pipeline.align_job(job)
                pairs[job] = (encode(qa), encode(ta))
            todo = group
            rnd = 0
            while todo:
                overrides = {bi: states[job].k for bi, job in enumerate(todo)
                             if job in states and states[job].k is not None}
                hits = set()
                with obs.span("align.cohort", tier="hirschberg",
                              jobs=len(todo), band=K, rnd=rnd):
                    call_with_watchdog(
                        lambda: faults.check("align.run", todo), timeout_s,
                        f"align.run ({len(todo)} jobs)")
                    res = align_pairs([pairs[job] for job in todo],
                                      device=device,
                                      band_overrides=overrides, hits=hits,
                                      timeout_s=timeout_s,
                                      partitioner=partitioner)
                    if overrides:
                        try:
                            faults.check("band.hit", todo)
                        except faults.InjectedFault:
                            hits.update(overrides)
                rnd += 1
                retry = []
                for bi, (job, ops) in enumerate(zip(todo, res)):
                    if bi in hits:
                        n, m = int(lengths[job, 0]), int(lengths[job, 1])
                        states[job].widen(n, m, band_for(n, m), stats,
                                          band_max_widenings, band_slack)
                        retry.append(job)
                        continue
                    if ops is None:
                        continue
                    pipeline.set_job_cigar(job, ops_to_cigar(ops))
                    served += 1
                todo = retry
    return served
