"""Formal transition model of the fleet chunk lifecycle.

The port's copy of the JAX package's model (racon_tpu/analysis/protocol/
model.py): an untimed abstraction of the protocol implemented across
``fleet/leases.py``, ``fleet/plane.py``, ``fleet/pool.py`` and
``serve/scheduler.py``. A state is the cross product the checker
enumerates:

* **chunk lifecycle**: per chunk, pending/running/done, the accepted
  result count (the gather log), and the failure count (capped at
  ``retry + 1``, the point past which the chunk leaves the fleet);
* **lease ownership**: per chunk, the in-flight attempt set
  ``(worker, canonical, leased)``. A TTL expiry drops ``leased`` but
  keeps the attempt in flight (the holder may still be computing: the
  straggler and speculation machinery exists because of this);
* **journal ownership**: per chunk, ``jheld`` mirrors
  ``Chunk.journal_held`` (a possibly live writer owns the canonical
  journal) and ``jowners`` is the set of live canonical writers, the
  quantity the one-canonical-owner invariant bounds;
* **pool membership**: per worker slot, absent / live / draining /
  exited (clean drain) / dead / hung;
* **budget reservations**: the serve scheduler's window-budget ledger,
  abstract submitters racing the atomic check-and-reserve of
  ``Scheduler._admission_lane``;
* **gather log and outcomes**: which jobs have gathered and which have
  failed, plus the per-chunk accepted counts that make exactly-once
  checkable.

Two transitions follow the port where it differs from the JAX package:

* ``deliver_error`` (a worker survives a failed polish and reports its
  chunk, ``FleetPlane._chunk_error``) is perturbed through
  ``poa.run.ls``, the run point of the default POA kernel that every
  chunk a worker polishes with it passes, on the card and on the CPU;
  the JAX model's ``native.call`` is not a point of the port;
* retry exhaustion depends on where the jobs run, the ``card`` axis of
  ``Config``. Off the card the chunk takes ``local_floor`` (``cli
  --host`` polishes it, ``_run_local``), as in the JAX model, and the
  model explores exactly the JAX model's space. On the card (the
  port's default) the host's bytes are not the card's, so the chunk
  takes ``fail_job`` instead (``_to_local``): its job fails with the
  chunk's last error, its chunks are no longer dispatched, and late
  results for them are discarded as duplicates.

Time is abstracted away: lease expiry and heartbeats are modeled as
nondeterministic events (an expiry can always happen; heartbeats only
make it not mandatory), and injected faults draw from a finite fault
budget so the space stays bounded. Worker slots are recycled after a
clean exit or a reclaimed death, standing in for the real pool's
unbounded worker indices.

``TRANSITIONS`` and ``MUTATIONS`` are pure literals so that the
conformance pass (and the ``fault-model`` contract) can read them from
the AST without importing this module; ``successors()`` must implement
exactly the events ``TRANSITIONS`` declares, which a test and the
conformance pass keep in sync with the real code.
"""

from __future__ import annotations

from collections import namedtuple
from typing import Iterator, List, Optional, Tuple

#: Every protocol event the model implements, as
#: ``(name, code_site_file, code_site_callable, fault_point_or_None)``.
#: The code site is where the real transition lives; the fault point is
#: the ``faults.KNOWN_POINTS`` entry that can perturb it. PURE LITERAL:
#: the conformance pass reads it with ``ast.literal_eval``.
TRANSITIONS = (
    ("submit_reserve", "racon_tpu_torch/serve/scheduler.py",
     "_admission_lane", None),
    ("release_budget", "racon_tpu_torch/serve/scheduler.py", "_finish",
     None),
    ("scale_up", "racon_tpu_torch/fleet/pool.py", "scale_up",
     "pool.scale_up"),
    ("spawn_fail", "racon_tpu_torch/fleet/pool.py", "_spawn_one",
     "worker.spawn"),
    ("scale_down", "racon_tpu_torch/fleet/pool.py", "scale_down",
     "pool.scale_down"),
    ("drain_exit", "racon_tpu_torch/fleet/plane.py", "_fetch", None),
    ("dispatch", "racon_tpu_torch/fleet/plane.py", "_assign", None),
    ("steal", "racon_tpu_torch/fleet/plane.py", "_fetch", "pool.steal"),
    ("speculate", "racon_tpu_torch/fleet/plane.py", "_straggler", None),
    ("heartbeat_loss", "racon_tpu_torch/distrib/worker.py",
     "_heartbeat_loop", "worker.heartbeat"),
    ("ttl_expire", "racon_tpu_torch/fleet/plane.py", "_expire_leases",
     None),
    ("worker_die", "racon_tpu_torch/fleet/plane.py", "_worker_dead",
     "worker.result"),
    ("worker_hang", "racon_tpu_torch/distrib/worker.py", "run_worker",
     "worker.result"),
    ("lease_reclaim", "racon_tpu_torch/fleet/leases.py",
     "release_worker_leases", "lease.reclaim"),
    ("deliver_result", "racon_tpu_torch/fleet/plane.py", "_result",
     "worker.result"),
    ("deliver_error", "racon_tpu_torch/fleet/plane.py", "_chunk_error",
     "poa.run.ls"),
    ("local_floor", "racon_tpu_torch/fleet/plane.py", "_run_local", None),
    ("fail_job", "racon_tpu_torch/fleet/plane.py", "_to_local", None),
    ("controller_kill", "racon_tpu_torch/resilience/faults.py", "check",
     "pool.scale_up"),
    ("recover", "racon_tpu_torch/serve/scheduler.py", "recover", None),
    ("gather", "racon_tpu_torch/fleet/plane.py", "_gather", None),
)

#: Seeded transition-guard mutations for the self-test mode
#: (``--mutate``): name -> (flipped guard, invariant expected to catch
#: it, config overrides that make the violation reachable). PURE
#: LITERAL for the same reason as TRANSITIONS.
MUTATIONS = (
    ("expiry-releases-journal",
     "ttl_expire releases the canonical journal of a holder that may "
     "still be alive", "one-canonical-owner", {}),
    ("dispatch-double-canonical",
     "dispatch hands out a canonical journal even when a writer holds "
     "it", "one-canonical-owner", {}),
    ("reclaim-skips-requeue",
     "lease_reclaim forgets to re-queue the dead holder's chunk",
     "recovery-quiescence", {}),
    ("duplicate-accepted",
     "deliver_result accepts a result for an already-done chunk",
     "exactly-once-gather", {}),
    ("split-check-reserve",
     "submit's budget check and reserve are no longer one atomic step",
     "budget-capacity", {}),
    ("drain-exits-holding-lease",
     "a draining worker may exit while it still holds a lease",
     "no-orphan-lease-after-drain", {}),
    ("no-local-floor",
     "retry exhaustion neither demotes the chunk to the local floor nor "
     "fails its job", "recovery-quiescence", {"retry": 0}),
    ("recover-marks-done",
     "recovery marks unfinished chunks done instead of re-queueing "
     "them", "exactly-once-gather", {}),
    ("failed-job-gathers",
     "a job failed on the card still accepts its chunks' late results "
     "and gathers", "one-job-outcome", {}),
)

# -- state ------------------------------------------------------------------

#: One chunk: lifecycle state ("P"/"R"/"D"), accepted result count,
#: canonical-journal-held flag, live canonical writer set, in-flight
#: attempt set of (worker, canonical, leased), failure count.
Ch = namedtuple("Ch", "st acc jheld jowners att failures")

#: One model state. workers: per slot "A"bsent / "L"ive / "G"(draining)
#: / "X"(exited clean) / "D"ead / "H"ung. submits: per submitter "idle"
#: / "mid" (mutant only) / "res" / "set"(tled: released or shed; the
#: trace event keeps the distinction, the state does not). The window
#: reservation ledger is derived (`reserved()`): a submitter in "res"
#: holds exactly its estimate, which keeps the state minimal. failed:
#: the jobs failed on the card (always empty off the card, so that the
#: space is the JAX model's there).
S = namedtuple("S", "chunks workers affinity submits faults "
                    "controller gathered failed")


def reserved(cfg: "Config", s: "S") -> int:
    """The scheduler's window-budget ledger, derived from the
    admission states."""
    return sum(cfg.submit_ests[k] for k, st in enumerate(s.submits)
               if st == "res")


class Config:
    """One bounded configuration of the model. `card`: whether the jobs
    run on the card (the port's default), where retry exhaustion fails
    the job; off it, the local floor polishes the chunk."""

    def __init__(self, workers: int = 2, chunks: Tuple[str, ...] =
                 ("A", "A", "B"), retry: int = 1, faults: int = 1,
                 budget: int = 3, submit_ests: Tuple[int, ...] = (2, 2),
                 min_workers: int = 1, steal: bool = True,
                 speculate: bool = True, card: bool = True):
        self.workers = workers          # pool slots (== max pool size)
        self.chunks = tuple(chunks)     # job label per chunk
        self.jobs = tuple(sorted(set(chunks)))
        self.retry = retry              # per-chunk retry budget
        self.faults = faults            # injected-fault budget
        self.budget = budget            # window-budget capacity
        self.submit_ests = tuple(submit_ests)
        self.min_workers = min_workers
        self.steal = steal
        self.speculate = speculate
        self.card = card

    def replace(self, **kw) -> "Config":
        """A copy with the fields of `kw` changed."""
        cur = dict(workers=self.workers, chunks=self.chunks,
                   retry=self.retry, faults=self.faults,
                   budget=self.budget, submit_ests=self.submit_ests,
                   min_workers=self.min_workers, steal=self.steal,
                   speculate=self.speculate, card=self.card)
        cur.update(kw)
        return Config(**cur)

    def describe(self) -> str:
        where = "on the card" if self.card else "off the card"
        return (f"{self.workers} workers x {len(self.chunks)} chunks "
                f"({'+'.join(self.jobs)}) x {self.faults} fault(s), "
                f"retry={self.retry}, budget={self.budget}, "
                f"submits={list(self.submit_ests)}, {where}")


def initial(cfg: Config) -> S:
    chunks = tuple(Ch("P", 0, False, frozenset(), frozenset(), 0)
                   for _ in cfg.chunks)
    workers = tuple("L" if i < cfg.min_workers else "A"
                    for i in range(cfg.workers))
    return S(chunks=chunks, workers=workers,
             affinity=(None,) * cfg.workers,
             submits=("idle",) * len(cfg.submit_ests),
             faults=cfg.faults, controller="up", gathered=frozenset(),
             failed=frozenset())


def mutation_names() -> List[str]:
    return [m[0] for m in MUTATIONS]


def mutation_entry(which) -> Tuple[str, str, str, dict]:
    """Resolve a --mutate selector (index or name) to its entry."""
    if isinstance(which, str) and which.isdigit():
        which = int(which)
    if isinstance(which, int):
        if not 0 <= which < len(MUTATIONS):
            raise ValueError(f"mutation index {which} out of range "
                             f"(0..{len(MUTATIONS) - 1})")
        return MUTATIONS[which]
    for m in MUTATIONS:
        if m[0] == which:
            return m
    raise ValueError(f"unknown mutation {which!r} "
                     f"(valid: {', '.join(mutation_names())})")


# -- helpers ----------------------------------------------------------------

def _busy(s: S, w: int) -> bool:
    """A worker runs one chunk at a time: busy while any attempt of its
    is in flight anywhere."""
    return any(a[0] == w for c in s.chunks for a in c.att)


def _upd_chunk(s: S, i: int, c: Ch) -> S:
    chunks = s.chunks[:i] + (c,) + s.chunks[i + 1:]
    return s._replace(chunks=chunks)


def _upd_worker(s: S, w: int, st: str,
                affinity: Optional[str] = "<keep>") -> S:
    workers = s.workers[:w] + (st,) + s.workers[w + 1:]
    s = s._replace(workers=workers)
    if affinity != "<keep>":
        aff = s.affinity[:w] + (affinity,) + s.affinity[w + 1:]
        s = s._replace(affinity=aff)
    return s


def _running(cfg: Config, s: S, i: int) -> bool:
    """Chunk i's job has not failed (``job.state == "running"`` in the
    plane's guards; always true off the card)."""
    return cfg.chunks[i] not in s.failed


def _eligible(cfg: Config, s: S, i: int) -> bool:
    c = s.chunks[i]
    return c.st == "P" and c.failures <= cfg.retry and _running(cfg, s, i)


def _assign(cfg: Config, s: S, i: int, w: int, mutation: str) -> S:
    """The shared dispatch effect (plane._assign): lease + journal
    pick + affinity stamp."""
    c = s.chunks[i]
    canonical = (not c.jheld) or mutation == "dispatch-double-canonical"
    jowners = c.jowners | {w} if canonical else c.jowners
    c = c._replace(st="R", jheld=c.jheld or canonical, jowners=jowners,
                   att=c.att | {(w, canonical, True)})
    s = _upd_chunk(s, i, c)
    return _upd_worker(s, w, "L", affinity=cfg.chunks[i])


def _drop_lease(cfg: Config, s: S, i: int, w: int, mutation: str) -> S:
    """One lease of `w` on chunk i expires: leased -> False, the
    attempt stays in flight, _fail_chunk runs (failures += 1, re-queue
    when no lease remains) while the job runs. The canonical journal is
    NOT released, unless the expiry-releases-journal mutation flips
    that guard."""
    c = s.chunks[i]
    att = frozenset((aw, can, False) if aw == w else (aw, can, leased)
                    for aw, can, leased in c.att)
    jheld = c.jheld
    if mutation == "expiry-releases-journal":
        jheld = False
    if not _running(cfg, s, i):
        return _upd_chunk(s, i, c._replace(att=att, jheld=jheld))
    failures = min(c.failures + 1, cfg.retry + 1)
    st = c.st
    if not any(leased for _, _, leased in att) and st == "R":
        st = "P"
    return _upd_chunk(s, i, c._replace(st=st, att=att, jheld=jheld,
                                       failures=failures))


def _spawnable(s: S, w: int) -> bool:
    """Slot recycling: an absent slot, a cleanly exited slot, or a dead
    slot whose leases were reclaimed stands in for the real pool's
    fresh worker indices."""
    st = s.workers[w]
    if st == "A":
        return True
    if st in ("X", "D"):
        return not _busy(s, w) and not any(w in c.jowners
                                           for c in s.chunks)
    return False


def _live(s: S) -> int:
    return sum(1 for st in s.workers if st in ("L", "G", "H"))


def _active(s: S) -> int:
    return sum(1 for st in s.workers if st == "L")


# -- successor generation ---------------------------------------------------

Event = Tuple[str, Tuple]          # (transition name, args)


def successors(cfg: Config, s: S,
               mutation: Optional[str] = None) -> Iterator[
                   Tuple[Event, S]]:
    """Every enabled protocol event from state `s` (the real guards, or
    one flipped by `mutation`)."""
    mut = mutation or ""
    if s.controller == "down":
        # the daemon is gone: the only transition is the restart
        yield from _recover(cfg, s, mut)
        return

    # Partial-order reduction, exact for this model: admission
    # transitions touch only `submits` and fleet transitions never read
    # it, so the two components compose with no synchronization. Every
    # invariant is component-local (budget-capacity reads submits, the
    # rest read the fleet), hence exploring all admission interleavings
    # first, and only then the fleet, reaches the same verdicts as the
    # full product while shedding its multiplicative cost.
    settled = True
    for ev, ns in _admission(cfg, s, mut):
        settled = False
        yield ev, ns
    if not settled:
        return
    yield from _pool(cfg, s, mut)
    yield from _dispatching(cfg, s, mut)
    yield from _failures(cfg, s, mut)
    yield from _deliveries(cfg, s, mut)
    yield from _completion(cfg, s, mut)
    if s.faults > 0:
        yield (("controller_kill", ()),
               s._replace(controller="down", faults=s.faults - 1))


def _admission(cfg, s, mut):
    # scheduler.submit: atomic check-and-reserve under _cv, or, under
    # the split-check-reserve mutation, two separately interleavable
    # steps (the lost-update race the lock exists to prevent)
    ledger = reserved(cfg, s)
    for k, st in enumerate(s.submits):
        est = cfg.submit_ests[k]
        if st == "idle":
            if mut == "split-check-reserve":
                # the check passes, but the reserve is a later separate
                # step: a "mid" submitter holds nothing yet, so a
                # racing submitter's check also passes (lost update)
                if ledger + est <= cfg.budget:
                    yield (("submit_reserve", (k, "check")),
                           s._replace(submits=_t(s.submits, k, "mid")))
                else:
                    yield (("submit_reserve", (k, "shed")),
                           s._replace(submits=_t(s.submits, k, "set")))
            elif ledger + est <= cfg.budget:
                yield (("submit_reserve", (k,)),
                       s._replace(submits=_t(s.submits, k, "res")))
            else:
                yield (("submit_reserve", (k, "shed")),
                       s._replace(submits=_t(s.submits, k, "set")))
        elif st == "mid":
            yield (("submit_reserve", (k, "reserve")),
                   s._replace(submits=_t(s.submits, k, "res")))
        elif st == "res":
            yield (("release_budget", (k,)),
                   s._replace(submits=_t(s.submits, k, "set")))


def _pool(cfg, s, mut):
    if _live(s) < cfg.workers:
        spawn_slots = [w for w in range(cfg.workers) if _spawnable(s, w)]
        if spawn_slots:
            w = spawn_slots[0]          # lowest slot: symmetry reduction
            yield (("scale_up", (w,)), _upd_worker(s, w, "L", None))
            if s.faults > 0:
                # worker.spawn / pool.scale_up raise: growth skipped
                yield (("spawn_fail", (w,)),
                       s._replace(faults=s.faults - 1))
    if _active(s) > cfg.min_workers:
        drain_slots = [w for w in range(cfg.workers)
                       if s.workers[w] == "L"]
        for w in drain_slots:
            yield (("scale_down", (w,)), _upd_worker(s, w, "G"))
        if drain_slots and s.faults > 0:
            # pool.scale_down raise: the drain is skipped, counted
            yield (("scale_down", (drain_slots[0], "fault")),
                   s._replace(faults=s.faults - 1))
    for w in range(cfg.workers):
        if s.workers[w] == "G" and (not _busy(s, w)
                                    or mut == "drain-exits-holding-lease"):
            # the drain answer at the worker's next fetch; graceful by
            # construction: it holds no lease (unless mutated)
            yield (("drain_exit", (w,)), _upd_worker(s, w, "X", None))


def _dispatching(cfg, s, mut):
    idle = [w for w in range(cfg.workers)
            if s.workers[w] == "L" and not _busy(s, w)]
    for w in idle:
        aff = s.affinity[w]
        own = [i for i in range(len(cfg.chunks))
               if _eligible(cfg, s, i) and (aff is None
                                            or cfg.chunks[i] == aff)]
        other = [i for i in range(len(cfg.chunks))
                 if _eligible(cfg, s, i) and aff is not None
                 and cfg.chunks[i] != aff]
        for i in own:
            yield (("dispatch", (i, w)), _assign(cfg, s, i, w, mut))
        if not own and other and cfg.steal:
            for i in other:
                yield (("steal", (i, w)), _assign(cfg, s, i, w, mut))
            if s.faults > 0:
                # pool.steal raise: absorbed, the fetch waits
                yield (("steal", (other[0], w, "fault")),
                       s._replace(faults=s.faults - 1))
        if cfg.speculate:
            for i in range(len(cfg.chunks)):
                c = s.chunks[i]
                # the real guard counts *leases* (len(c.leases) >= 2
                # blocks; expired in-flight attempts don't count)
                leased = sum(1 for _, _, ls in c.att if ls)
                if (c.st == "R" and leased == 1 and _running(cfg, s, i)
                        and not any(a[0] == w for a in c.att)):
                    yield (("speculate", (i, w)),
                           _assign(cfg, s, i, w, mut))


def _failures(cfg, s, mut):
    for i, c in enumerate(s.chunks):
        for (w, can, leased) in sorted(c.att):
            if leased:
                yield (("ttl_expire", (i, w)),
                       _drop_lease(cfg, s, i, w, mut))
    for w in range(cfg.workers):
        if s.workers[w] not in ("L", "G", "H"):
            continue
        if s.faults > 0 and s.workers[w] != "H":
            # worker.heartbeat raise: renewals stop silently; every
            # lease the worker holds expires
            held = [i for i, c in enumerate(s.chunks)
                    if any(a[0] == w and a[2] for a in c.att)]
            if held:
                hs = s._replace(faults=s.faults - 1)
                for i in held:
                    hs = _drop_lease(cfg, hs, i, w, mut)
                yield (("heartbeat_loss", (w,)), hs)
            # worker.result hang: the worker wedges mid-chunk forever
            # (the straggler limit case: its attempts never deliver)
            if _busy(s, w) and s.workers[w] == "L":
                yield (("worker_hang", (w,)),
                       _upd_worker(s._replace(faults=s.faults - 1),
                                   w, "H"))
        if s.faults > 0:
            # worker.result kill / EOF: confirmed death
            ds = _upd_worker(s._replace(faults=s.faults - 1), w, "D",
                             None)
            # die step: the writer is gone from every live-writer set;
            # lease release is the separate lease_reclaim transition
            chunks = tuple(c._replace(jowners=c.jowners - {w})
                           for c in ds.chunks)
            yield (("worker_die", (w,)), ds._replace(chunks=chunks))
    for w in range(cfg.workers):
        if s.workers[w] == "D" and _busy(s, w):
            yield (("lease_reclaim", (w,)), _reclaim(cfg, s, w, mut))
            if s.faults > 0:
                # lease.reclaim raise: absorbed and counted, the
                # reclaim itself still proceeds
                rs = _reclaim(cfg, s, w, mut)
                yield (("lease_reclaim", (w, "fault")),
                       rs._replace(faults=rs.faults - 1))


def _reclaim(cfg, s, w, mut):
    """Confirmed death releases the holder's leases AND its canonical
    journal (the writer is known dead), then re-queues the chunk while
    its job runs: release_worker_leases + _fail_chunk."""
    for i, c in enumerate(s.chunks):
        mine = {a for a in c.att if a[0] == w}
        if not mine:
            continue
        att = c.att - mine
        jheld = c.jheld
        if any(can and leased for _, can, leased in mine):
            jheld = False               # leased canonical: released
        if mut == "reclaim-skips-requeue":
            c = c._replace(att=att, jheld=c.jheld)
        elif not _running(cfg, s, i):
            c = c._replace(att=att, jheld=jheld)
        else:
            failures = min(c.failures + 1, cfg.retry + 1)
            st = c.st
            if st == "R" and not any(ls for _, _, ls in att):
                st = "P"
            c = c._replace(st=st, att=att, jheld=jheld,
                           failures=failures)
        s = _upd_chunk(s, i, c)
    return s


def _deliveries(cfg, s, mut):
    late_ok = mut == "failed-job-gathers"
    for i, c in enumerate(s.chunks):
        running = _running(cfg, s, i)
        for (w, can, leased) in sorted(c.att):
            if s.workers[w] not in ("L", "G"):
                continue                # hung/dead workers never deliver
            att = c.att - {(w, can, leased)}
            if c.st == "D" or not (running or late_ok):
                # duplicate (or a failed job's late result): discarded
                # and counted, unless mutated
                acc = c.acc + 1 if (mut == "duplicate-accepted"
                                    and c.st == "D") else c.acc
                nc = c._replace(att=att, acc=min(acc, 2),
                                jowners=c.jowners - {w})
                yield (("deliver_result", (i, w, "dup")),
                       _upd_chunk(s, i, nc))
            else:
                # first result wins, even when the lease expired
                nc = c._replace(st="D", acc=min(c.acc + 1, 2), att=att,
                                jowners=c.jowners - {w})
                yield (("deliver_result", (i, w)), _upd_chunk(s, i, nc))
            if s.faults > 0 and c.st != "D":
                # the worker survives but the polish failed (an
                # injected run-point fault): _chunk_error releases the
                # canonical journal only when the lease is still held,
                # and fails the chunk only while its job runs
                jheld = c.jheld and not (can and leased)
                if running:
                    failures = min(c.failures + 1, cfg.retry + 1)
                    st = c.st
                    if st == "R" and not any(ls for _, _, ls in att):
                        st = "P"
                else:
                    failures, st = c.failures, c.st
                nc = c._replace(st=st, att=att, jheld=jheld,
                                jowners=c.jowners - {w},
                                failures=failures)
                yield (("deliver_error", (i, w)),
                       _upd_chunk(s, i, nc)._replace(
                           faults=s.faults - 1))


def _completion(cfg, s, mut):
    for i, c in enumerate(s.chunks):
        if (c.st == "P" and c.failures > cfg.retry
                and not any(ls for _, _, ls in c.att)
                and mut != "no-local-floor"):
            if not cfg.card:
                # retry budget exhausted off the card: the fleet ->
                # local floor (plane._run_local, the host's bytes)
                yield (("local_floor", (i,)),
                       _upd_chunk(s, i, c._replace(
                           st="D", acc=min(c.acc + 1, 2))))
            elif _running(cfg, s, i):
                # on the card the floor's host bytes are not the card's:
                # plane._to_local fails the job with the chunk's error
                yield (("fail_job", (i,)),
                       s._replace(failed=s.failed | {cfg.chunks[i]}))
    for j in cfg.jobs:
        if j in s.gathered or (j in s.failed
                               and mut != "failed-job-gathers"):
            continue
        idx = [i for i, cj in enumerate(cfg.chunks) if cj == j]
        if all(s.chunks[i].st == "D" for i in idx):
            yield (("gather", (j,)),
                   s._replace(gathered=s.gathered | {j}))


def _recover(cfg, s, mut):
    """Daemon restart: scheduler.recover re-queues every unfinished
    job from its spec (a failed or gathered job is finished); leases
    and the in-memory journal ownership died with the plane, the chunk
    journals on disk turn re-runs into resumes. Worker slots come back
    absent (the children died with the daemon)."""
    chunks = []
    for i, c in enumerate(s.chunks):
        if cfg.chunks[i] in s.gathered or cfg.chunks[i] in s.failed:
            chunks.append(c._replace(att=frozenset(),
                                     jowners=frozenset()))
        elif mut == "recover-marks-done":
            chunks.append(Ch("D", 0, False, frozenset(), frozenset(), 0))
        else:
            chunks.append(Ch("P", 0, False, frozenset(), frozenset(), 0))
    yield (("recover", ()),
           S(chunks=tuple(chunks), workers=("A",) * cfg.workers,
             affinity=(None,) * cfg.workers,
             submits=s.submits, faults=s.faults, controller="up",
             gathered=s.gathered, failed=s.failed))


def _t(tup: tuple, k: int, v) -> tuple:
    return tup[:k] + (v,) + tup[k + 1:]


# -- conformance anchors ----------------------------------------------------

def transition_names() -> List[str]:
    return [t[0] for t in TRANSITIONS]

