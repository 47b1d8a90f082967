"""Explicit-state exploration of the protocol model (the port's copy of
racon_tpu/analysis/protocol/checker.py).

BFS with state hashing is the default: states are interned to integer
ids, the frontier expands level by level, safety invariants run the
moment a state is discovered (so the first counterexample is a
*shortest* trace), and the forward edge list feeds the
recovery-quiescence check — a backward closure from the quiescent
states that every reachable state must fall inside.

The DFS fallback (``strategy="dfs"``) bounds depth instead of
exhausting the space: it exists for configurations too large to hold
in memory, trades minimal counterexamples for a bounded-depth sweep,
and reports ``exhausted=False`` whenever the bound clipped anything.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from . import invariants as inv
from .model import Config, Event, S, initial, mutation_entry, successors


@dataclass
class Violation:
    invariant: str
    detail: str
    trace: List[Event]          # minimal event path from the initial state

    def render(self) -> str:
        steps = " -> ".join(_fmt_event(e) for e in self.trace) or "<init>"
        return f"{self.invariant}: {self.detail}\n    trace: {steps}"


@dataclass
class Result:
    config: Config
    mutation: Optional[str]
    strategy: str
    states: int
    transitions: int
    elapsed_s: float
    exhausted: bool             # the bounded space was fully explored
    violations: List[Violation] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _fmt_event(ev: Event) -> str:
    name, args = ev
    return f"{name}({','.join(str(a) for a in args)})" if args else name


def check(cfg: Optional[Config] = None, mutation: Optional[str] = None,
          strategy: str = "bfs", max_states: int = 2_000_000,
          depth: int = 40, stop_on_first: bool = True) -> Result:
    """Explore the model; return the result with any counterexamples.

    mutation — a MUTATIONS name/index: its paired config overrides are
    applied on top of `cfg` (each mutation's violation is reachable
    under its documented bounded configuration).
    """
    mut_name = None
    if mutation is not None:
        name, _doc, _expected, overrides = mutation_entry(mutation)
        mut_name = name
        base = cfg or Config()
        cfg = base.replace(**overrides) if overrides else base
    cfg = cfg or Config()

    t0 = time.monotonic()
    if strategy == "dfs":
        res = _dfs(cfg, mut_name, max_states, depth, stop_on_first)
    else:
        res = _bfs(cfg, mut_name, max_states, stop_on_first)
    res.elapsed_s = time.monotonic() - t0
    return res


def _bfs(cfg: Config, mutation: Optional[str], max_states: int,
         stop_on_first: bool) -> Result:
    init = initial(cfg)
    ids: Dict[S, int] = {init: 0}
    states: List[S] = [init]
    parent: List[Tuple[int, Optional[Event]]] = [(-1, None)]
    edges: List[Tuple[int, int]] = []
    violations: List[Violation] = []

    v = _check_safety(cfg, init)
    if v is not None:
        violations.append(Violation(v[0], v[1], []))
        if stop_on_first:
            return Result(cfg, mutation, "bfs", 1, 0, 0.0, False,
                          violations)

    frontier = [0]
    exhausted = True
    while frontier and not (violations and stop_on_first):
        next_frontier: List[int] = []
        for sid in frontier:
            s = states[sid]
            for ev, ns in successors(cfg, s, mutation):
                nid = ids.get(ns)
                if nid is None:
                    if len(states) >= max_states:
                        exhausted = False
                        continue
                    nid = len(states)
                    ids[ns] = nid
                    states.append(ns)
                    parent.append((sid, ev))
                    next_frontier.append(nid)
                    v = _check_safety(cfg, ns)
                    if v is not None:
                        violations.append(Violation(
                            v[0], v[1], _trace(parent, nid)))
                        if stop_on_first:
                            return Result(cfg, mutation, "bfs",
                                          len(states), len(edges), 0.0,
                                          False, violations)
                edges.append((sid, nid))
        frontier = next_frontier

    if exhausted and not violations:
        violations.extend(_check_quiescence(cfg, states, edges, parent))
    return Result(cfg, mutation, "bfs", len(states), len(edges), 0.0,
                  exhausted, violations)


def _dfs(cfg: Config, mutation: Optional[str], max_states: int,
         depth: int, stop_on_first: bool) -> Result:
    """Depth-bounded DFS fallback: safety only (the quiescence check
    needs the exhausted graph), counterexamples not guaranteed
    minimal."""
    init = initial(cfg)
    ids: Dict[S, int] = {init: 0}
    states: List[S] = [init]
    parent: List[Tuple[int, Optional[Event]]] = [(-1, None)]
    violations: List[Violation] = []
    n_edges = 0
    exhausted = True

    v = _check_safety(cfg, init)
    if v is not None:
        violations.append(Violation(v[0], v[1], []))
        if stop_on_first:
            return Result(cfg, mutation, "dfs", 1, 0, 0.0, False,
                          violations)

    stack: List[Tuple[int, int]] = [(0, 0)]     # (state id, depth)
    while stack and not (violations and stop_on_first):
        sid, d = stack.pop()
        if d >= depth:
            exhausted = False
            continue
        for ev, ns in successors(cfg, states[sid], mutation):
            n_edges += 1
            nid = ids.get(ns)
            if nid is not None:
                continue
            if len(states) >= max_states:
                exhausted = False
                continue
            nid = len(states)
            ids[ns] = nid
            states.append(ns)
            parent.append((sid, ev))
            v = _check_safety(cfg, ns)
            if v is not None:
                violations.append(Violation(v[0], v[1],
                                            _trace(parent, nid)))
                if stop_on_first:
                    return Result(cfg, mutation, "dfs", len(states),
                                  n_edges, 0.0, False, violations)
            stack.append((nid, d + 1))
    return Result(cfg, mutation, "dfs", len(states), n_edges, 0.0,
                  exhausted, violations)


def _check_safety(cfg: Config, s: S) -> Optional[Tuple[str, str]]:
    for name, fn in inv.SAFETY.items():
        detail = fn(cfg, s)
        if detail is not None:
            return name, detail
    return None


def _check_quiescence(cfg: Config, states: List[S],
                      edges: List[Tuple[int, int]],
                      parent) -> List[Violation]:
    """Backward closure from the quiescent states; anything reachable
    but outside it is a stuck state — recovery cannot reach
    quiescence from there."""
    preds: List[List[int]] = [[] for _ in states]
    for src, dst in edges:
        preds[dst].append(src)
    good = [False] * len(states)
    work = [i for i, s in enumerate(states) if inv.quiescent(cfg, s)]
    for i in work:
        good[i] = True
    while work:
        dst = work.pop()
        for src in preds[dst]:
            if not good[src]:
                good[src] = True
                work.append(src)
    bad = [i for i, g in enumerate(good) if not g]
    if not bad:
        return []
    # ids are in BFS discovery order: the first bad id has the
    # shortest trace from the initial state
    sid = bad[0]
    s = states[sid]
    stuck = [f"chunk {i}={c.st}/f{c.failures}"
             for i, c in enumerate(s.chunks) if c.st != "D"]
    return [Violation(
        inv.QUIESCENCE,
        f"{len(bad)} reachable state(s) cannot reach quiescence "
        f"(first: {', '.join(stuck) or 'admission/controller stuck'})",
        _trace(parent, sid))]


def _trace(parent, sid: int) -> List[Event]:
    out: List[Event] = []
    while sid > 0:
        sid, ev = parent[sid]
        if ev is not None:
            out.append(ev)
    out.reverse()
    return out
