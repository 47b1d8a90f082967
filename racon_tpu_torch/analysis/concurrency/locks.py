"""Lock-discipline findings over the repo model.

A copy of the JAX package's rules (racon_tpu/analysis/concurrency/
locks.py).

Two rules:

* ``unguarded-mutation`` — a shared location (attribute of a shared
  class, or a module global) is mutated by two or more thread roles
  without one lock held at **every** mutation site.  Fix by guarding
  every site with the same lock, switching to a sanctioned lock-free
  type, or waiving the site with ``# concurrency: <reason>``.
* ``lock-order-cycle`` — the repo-wide lock-acquisition-order digraph
  (edge ``A -> B`` whenever B is acquired while A is held) contains a
  cycle: two paths can acquire the same locks in opposite orders, the
  classic deadlock.  Self-edges are ignored (Condition wraps an RLock).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..lint import Violation
from .model import Model, _cls_base

UNGUARDED = "unguarded-mutation"
LOCK_ORDER = "lock-order-cycle"


def audit(repo_root: str, model: Model = None) -> List[Violation]:
    m = model or Model.build(repo_root)
    out = _unguarded_mutations(m)
    out.extend(_lock_order_cycles(m))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def _location_name(owner: Tuple) -> str:
    if owner[0] == "attr":
        return f"{_cls_base(owner[1])}.{owner[2]}"
    return f"{os.path.basename(owner[1])} global {owner[2]}"


def _short_fn(qname: str) -> str:
    return qname.split("::", 1)[-1]


def _unguarded_mutations(m: Model) -> List[Violation]:
    by_loc: Dict[Tuple, List] = {}
    for mut in m.mutations:
        if mut.owner[0] == "attr" and mut.owner[1] not in m.shared_classes:
            continue  # instance never crosses threads
        by_loc.setdefault(mut.owner, []).append(mut)

    out: List[Violation] = []
    for owner, muts in sorted(by_loc.items(),
                              key=lambda kv: str(kv[0])):
        live = [x for x in muts if not x.waived]
        if not live:
            continue
        if all(x.const_flag for x in live):
            continue  # atomic flag: only constant rebinds
        roles = set()
        for x in live:
            roles |= m.roles_of(x.func)
        roles.discard("")
        if len(roles) < 2:
            continue
        guard = m.effective_held(live[0])
        for x in live[1:]:
            guard &= m.effective_held(x)
        if guard:
            continue
        live.sort(key=lambda x: (x.relpath, x.line))
        fns = sorted({_short_fn(x.func) for x in live})
        anchor = live[0]
        out.append(Violation(
            UNGUARDED, anchor.relpath, anchor.line,
            f"{_location_name(owner)} is mutated from roles "
            f"{{{', '.join(sorted(roles))}}} with no lock held at every "
            f"site (mutators: {', '.join(fns)}); guard every site with "
            f"one lock, use a sanctioned lock-free type, or waive with "
            f"'# concurrency: <reason>'"))
    return out


def _lock_order_cycles(m: Model) -> List[Violation]:
    edges: Dict[str, Dict[str, Tuple[str, int]]] = {}
    for acq in m.acquires:
        fn = m.functions.get(acq.func)
        entry = fn.entry_locks if fn and fn.entry_locks else frozenset()
        for held in acq.held_before | entry:
            if held == acq.lock:
                continue  # reentrant re-acquire (RLock/Condition)
            edges.setdefault(held, {}).setdefault(
                acq.lock, (acq.relpath, acq.line))

    # Tarjan SCC over the lock digraph
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    stack: List[str] = []
    on_stack = set()
    sccs: List[List[str]] = []
    counter = [0]
    nodes = sorted(set(edges) | {t for d in edges.values() for t in d})

    def strongconnect(v: str) -> None:
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        for w in sorted(edges.get(v, ())):
            if w not in index:
                strongconnect(w)
                low[v] = min(low[v], low[w])
            elif w in on_stack:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stack.pop()
                on_stack.discard(w)
                comp.append(w)
                if w == v:
                    break
            sccs.append(comp)

    for v in nodes:
        if v not in index:
            strongconnect(v)

    out: List[Violation] = []
    for comp in sccs:
        if len(comp) < 2:
            continue
        comp = sorted(comp)
        # witness: the first edge inside the component
        witness = None
        for a in comp:
            for b, site in sorted(edges.get(a, {}).items()):
                if b in comp:
                    witness = site
                    break
            if witness:
                break
        rel, line = witness if witness else ("", 0)
        out.append(Violation(
            LOCK_ORDER, rel, line,
            f"lock-order cycle between {{{', '.join(comp)}}}: these "
            f"locks are acquired while holding each other in opposite "
            f"orders (deadlock potential); pick one global acquisition "
            f"order"))
    return out
