"""Interprocedural explicit-flow taint analysis for Engine 5.

The port's copy of racon_tpu/analysis/determinism/taint.py. Sources are
the values ``racon_tpu_torch/fingerprint.py`` SOURCES declares (a
parameter at its function's entry, an environment read at its call);
sinks are the byte-install seams every polished byte passes through:
``pipeline.set_consensus(i, payload, ...)`` (poa_driver's host fallback
and ``_install``, journal replay) and ``pipeline.set_job_cigar(job,
cigar)`` (align_cuda.run_jobs, journal replay and CigarTap). A source
whose *value* can reach a sink payload is output-affecting; a source
that cannot is cost-only under the model below.

Modeling rules (deliberate, documented, and what makes the byte-identity
contract statically checkable at all), as in the JAX engine:

* **explicit flows only**: a source choosing a branch, a kernel or a
  device is control flow, and the repo contract is precisely that all
  such paths produce identical bytes; only *data* flow into a payload
  is a leak. Concretely: ``if`` / ``while`` tests and the test of a
  conditional expression never propagate taint.
* **index barrier**: ``seq[i]`` / ``seq[a:b]`` never taints the loaded
  value with the *index* taint (the container's own taint propagates):
  batch and chunk settings decide which windows are grouped together,
  never what any window's bytes are.
* **callee barrier**: calling a tainted *callable* contributes only the
  argument taints to the result. Settings select which built kernel
  runs; the contract says every kernel computes the same bytes.
* **shape barrier**: array allocators (``zeros``/``empty``/...) do not
  propagate taint from their shape arguments into the array values.
* **capacity barrier** (the port's addition): a queue's bound
  (``queue.Queue(maxsize=...)``) does not taint its items; what is
  ``put`` into a queue taints it, as an in-place mutator taints its
  receiver.
* everything else is conservative: unknown calls union their argument
  (and receiver) taints, containers carry element taint, attributes are
  tracked per ``(class, attr)`` plus object-level for dataclasses.

Waiver: a ``# determinism: <reason>`` comment on the flagged line (or on
a comment line directly above it) waives a source or a sink: intentional
flows like journal replay, which installs previously journaled bytes
that the journal's fingerprint already proves belong to this exact run.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..concurrency.model import _MUTATORS, Model
from . import knobs as knobs_mod
from .knobs import SourceDecl

#: Sink methods: name -> 0-based payload argument index.
SINKS = {
    "set_consensus": 1,    # pipeline.set_consensus(i, payload, polished)
    "set_job_cigar": 1,    # pipeline.set_job_cigar(job, cigar)
}

#: Calls whose result carries no taint (counts/sizes/allocations).
BARRIERS = frozenset({
    "len", "range", "id", "zeros", "ones", "empty", "full",
    "zeros_like", "ones_like", "empty_like", "full_like", "arange",
    "eye", "iota",
    # the capacity barrier: a bounded queue's items are what is put in
    "Queue", "LifoQueue", "PriorityQueue", "SimpleQueue",
})

#: In-place mutators that taint their receiver: the concurrency model's,
#: and a queue's puts.
_TAINTING = _MUTATORS | {"put", "put_nowait"}

_WAIVER_RE = re.compile(r"#\s*determinism:\s*(\S[^#]*)")


def waiver_reason(model: Model, rel: str, line: int) -> Optional[str]:
    """The ``# determinism:`` waiver covering this line: on the line
    itself, or on a run of pure comment lines directly above it."""
    lines = model.lines.get(rel, [])
    if not 1 <= line <= len(lines):
        return None
    m = _WAIVER_RE.search(lines[line - 1])
    if m:
        return m.group(1).strip()
    i = line - 2
    while i >= 0 and lines[i].lstrip().startswith("#"):
        m = _WAIVER_RE.search(lines[i])
        if m:
            return m.group(1).strip()
        i -= 1
    return None


@dataclass(frozen=True)
class SinkHit:
    """One source reaching one install seam."""

    source: str
    relpath: str
    line: int
    seam: str                  # sink method name
    func: str                  # enclosing function qname
    waived: Optional[str]      # waiver reason, if any


class State:
    """The monotone interprocedural facts of one fixpoint run."""

    def __init__(self) -> None:
        self.param: Dict[Tuple[str, str], Set[str]] = {}
        self.ret: Dict[str, Set[str]] = {}
        self.attr: Dict[Tuple[str, str], Set[str]] = {}
        self.glob: Dict[Tuple[str, str], Set[str]] = {}
        self.hits: Dict[Tuple[str, str, int], SinkHit] = {}
        self.reads: Dict[Tuple[str, str, int], knobs_mod.SourceRead] = {}
        self.changed = False
        self.iterations = 0
        self.globals_of: Dict[str, Set[str]] = {}

    def add(self, table: Dict, key, taints: Set[str]) -> None:
        if not taints:
            return
        cur = table.setdefault(key, set())
        if not taints <= cur:
            cur |= taints
            self.changed = True


def analyze(model: Model, decls: Dict[str, SourceDecl]) -> State:
    """Run the taint fixpoint over every function in the model, seeded
    by the registry's sources `decls`."""
    state = State()
    params = knobs_mod.param_sources(decls)
    envs = knobs_mod.env_sources(decls)
    by_rel: Dict[str, List[str]] = {}
    for q, fn in model.functions.items():
        by_rel.setdefault(fn.relpath, []).append(q)
    for i in range(25):
        state.changed = False
        state.iterations = i + 1
        for rel, tree in sorted(model.trees.items()):
            w = _TaintWalker(model, state, rel, params, envs)
            w.walk_module_level(tree)
            for q in by_rel.get(rel, ()):
                fn = model.functions[q]
                if fn.name == "<module>":
                    continue
                node = model.def_node(q)
                if node is not None:
                    w.walk_function(q, node, fn.cls)
        if not state.changed:
            break
    return state


class _TaintWalker:
    """Walks one file's functions, evaluating expression taint."""

    def __init__(self, model: Model, state: State, rel: str,
                 params: Dict[Tuple[str, str], str],
                 envs: Dict[str, str]):
        self.m = model
        self.s = state
        self.rel = rel
        self.params = params
        self.envs = envs
        self.consts = knobs_mod.module_constants(model.trees[rel])
        self.q = f"{rel}::<module>"
        self.cls: Optional[str] = None
        self.env: Dict[str, Set[str]] = {}
        self.types: Dict[str, Tuple] = {}
        self.globals_decl: Set[str] = set()
        self.module_level = False

    # -- walking -----------------------------------------------------------

    def walk_module_level(self, tree: ast.Module) -> None:
        self.q = f"{self.rel}::<module>"
        self.cls = None
        self.env = {}
        self.types = {}
        self.globals_decl = set()
        self.module_level = True
        body = [n for n in tree.body
                if not isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef))]
        for _ in range(2):
            for stmt in body:
                self._stmt(stmt)

    def walk_function(self, q: str, node, cls: Optional[str]) -> None:
        self.q = q
        self.cls = cls
        self.module_level = False
        if q not in self.s.globals_of:     # one walk a function a run
            self.s.globals_of[q] = {
                name for sub in ast.walk(node)
                if isinstance(sub, ast.Global) for name in sub.names}
        self.globals_decl = set(self.s.globals_of[q])
        self.env = {}
        self.types = {}
        args = list(getattr(node.args, "posonlyargs", [])) \
            + list(node.args.args) + list(node.args.kwonlyargs)
        for a in args:
            self.env[a.arg] = set(self.s.param.get((q, a.arg), ()))
            if a.arg == "self" and cls:
                self.types["self"] = ("class", cls)
            elif a.annotation is not None:
                tag = self._annotation_tag(a.annotation)
                if tag:
                    self.types[a.arg] = tag
            name = self.params.get((q, a.arg))
            if name is not None:
                self.env[a.arg] |= self._read(name, node.lineno)
        for _ in range(3):
            before = {k: set(v) for k, v in self.env.items()}
            for stmt in node.body:
                self._stmt(stmt)
            if self.env == before:
                break

    # -- statements --------------------------------------------------------

    def _stmt(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                       # walked as their own functions
        if isinstance(node, ast.Assign):
            t = self._eval(node.value)
            tag = self._type_of(node.value)
            for tgt in node.targets:
                self._assign(tgt, t, tag)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._assign(node.target, self._eval(node.value),
                             self._type_of(node.value))
        elif isinstance(node, ast.AugAssign):
            t = self._eval(node.value) | self._eval(
                _as_load(node.target))
            self._assign(node.target, t, None)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                self.s.add(self.s.ret, self.q, self._eval(node.value))
        elif isinstance(node, ast.For):
            t = self._eval(node.iter)
            self._assign(node.target, t, None)
            for sub in node.body + node.orelse:
                self._stmt(sub)
        elif isinstance(node, ast.While):
            self._eval(node.test)        # calls inside tests still count
            for sub in node.body + node.orelse:
                self._stmt(sub)
        elif isinstance(node, ast.If):
            self._eval(node.test)
            for sub in node.body + node.orelse:
                self._stmt(sub)
        elif isinstance(node, ast.With):
            for item in node.items:
                t = self._eval(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, t,
                                 self._type_of(item.context_expr))
            for sub in node.body:
                self._stmt(sub)
        elif isinstance(node, ast.Try):
            for sub in (node.body + node.orelse + node.finalbody):
                self._stmt(sub)
            for h in node.handlers:
                for sub in h.body:
                    self._stmt(sub)
        elif isinstance(node, ast.Expr):
            self._eval(node.value)
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    self._eval(sub)
        elif isinstance(node, ast.Global):
            self.globals_decl.update(node.names)

    def _assign(self, target, taints: Set[str],
                tag: Optional[Tuple]) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign(el, taints, None)
            return
        if isinstance(target, ast.Starred):
            self._assign(target.value, taints, None)
            return
        if isinstance(target, ast.Name):
            name = target.id
            if tag is not None:
                self.types[name] = tag
            if name in self.globals_decl or (
                    self.module_level
                    and self.m.is_module_global(self.rel, name)):
                self.s.add(self.s.glob, (self.rel, name), taints)
            cur = self.env.setdefault(name, set())
            cur |= taints
            return
        if isinstance(target, ast.Attribute):
            cls = self._class_of(target.value)
            if cls is not None:
                self.s.add(self.s.attr, (cls, target.attr), taints)
            if isinstance(target.value, ast.Name):
                # object-level: a tainted field taints the object
                self.env.setdefault(target.value.id, set()).update(taints)
            return
        if isinstance(target, ast.Subscript):
            # container store: taint the container, drop the index
            self._assign(target.value, taints, None)

    # -- expressions -------------------------------------------------------

    def _eval(self, node) -> Set[str]:
        if node is None or isinstance(node, ast.Constant):
            return set()
        if isinstance(node, ast.Name):
            out = set(self.env.get(node.id, ()))
            if node.id not in self.env \
                    and self.m.is_module_global(self.rel, node.id):
                out |= self.s.glob.get((self.rel, node.id), set())
            return out
        if isinstance(node, ast.Attribute):
            out = self._eval(node.value)
            cls = self._class_of(node.value)
            if cls is not None:
                out |= self.s.attr.get((cls, node.attr), set())
            return out
        if isinstance(node, ast.Subscript):
            env = knobs_mod.env_of_read(node, self.consts)
            if env in self.envs:
                return self._read(self.envs[env], node.lineno)
            self._eval(node.slice)       # still visit calls in the index
            return self._eval(node.value)
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        if isinstance(node, ast.IfExp):
            self._eval(node.test)        # control: test taint dropped
            return self._eval(node.body) | self._eval(node.orelse)
        if isinstance(node, (ast.Yield, ast.YieldFrom)):
            if node.value is not None:
                self.s.add(self.s.ret, self.q, self._eval(node.value))
            return set()
        if isinstance(node, ast.NamedExpr):
            t = self._eval(node.value)
            self._assign(node.target, t, self._type_of(node.value))
            return t
        if isinstance(node, ast.Lambda):
            return set()
        # everything else (BinOp, BoolOp, Compare, JoinedStr,
        # comprehensions, Tuple/List/Set/Dict, Starred, Slice, Await):
        # the union of every sub-expression
        out: Set[str] = set()
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.expr):
                out |= self._eval(sub)
            elif isinstance(sub, ast.comprehension):
                it = self._eval(sub.iter)
                self._assign(sub.target, it, None)
                out |= it
                for cond in sub.ifs:
                    self._eval(cond)
        return out

    def _read(self, name: str, line: int) -> Set[str]:
        """Record one read site of source `name`; its taint, or none
        where a waiver covers the site."""
        waived = waiver_reason(self.m, self.rel, line)
        key = (name, self.rel, line)
        if key not in self.s.reads:
            self.s.reads[key] = knobs_mod.SourceRead(
                name, self.rel, line, self.q, waived)
            self.s.changed = True
        return set() if waived else {name}

    def _eval_call(self, node: ast.Call) -> Set[str]:
        env = knobs_mod.env_of_read(node, self.consts)
        if env in self.envs:
            return self._read(self.envs[env], node.lineno)

        arg_taints = [self._eval(a.value if isinstance(a, ast.Starred)
                                 else a) for a in node.args]
        kw_taints = {kw.arg: self._eval(kw.value) for kw in node.keywords}
        all_args: Set[str] = set().union(*arg_taints) if arg_taints \
            else set()
        for t in kw_taints.values():
            all_args |= t

        func = node.func
        attr = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else "")

        # sink check: tainted payload into an install seam
        if attr in SINKS:
            idx = SINKS[attr]
            payload = arg_taints[idx] if idx < len(arg_taints) else set()
            for t in kw_taints.values():
                payload = payload | t
            if payload:
                waived = waiver_reason(self.m, self.rel, node.lineno)
                for k in sorted(payload):
                    key = (k, self.rel, node.lineno)
                    if key not in self.s.hits:
                        self.s.hits[key] = SinkHit(
                            k, self.rel, node.lineno, attr, self.q,
                            waived)
                        self.s.changed = True

        if attr in BARRIERS:
            return set()

        # in-place mutators taint their receiver container
        if isinstance(func, ast.Attribute) and attr in _TAINTING \
                and all_args:
            self._assign(func.value, all_args, None)

        self._forward(node, arg_taints, kw_taints)
        callee = self._resolve_callee(node)
        if callee is not None and callee[0] == "func":
            fq = callee[1]
            self._bind_args(fq, node, arg_taints, kw_taints,
                            callee[2])
            return set(self.s.ret.get(fq, ()))
        if callee is not None and callee[0] == "class":
            cq = callee[1]
            init_q = f"{cq}.__init__"
            if init_q in self.m.functions:
                self._bind_args(init_q, node, arg_taints, kw_taints,
                                None)
                return set(self.s.ret.get(init_q, ()))
            # dataclass-style: the object carries its field taints
            return all_args

        # unknown callee: union of args + receiver
        out = all_args
        if isinstance(func, ast.Attribute):
            out = out | self._eval(func.value)
        return out

    def _forward(self, node: ast.Call, arg_taints: List[Set[str]],
                 kw_taints: Dict[Optional[str], Set[str]]) -> None:
        """The forwarding rule (the port's addition): a function passed
        as a positional argument, as in ``self._timed(stats, "align",
        run_alignment_phase, pl, device=...)`` or ``ex.submit(fn, *a)``,
        is called by the callee with the positional arguments after it
        and the keyword arguments, so those bind to its parameters.
        Without it the drivers the polisher times would be unreachable
        from the sources."""
        for j, a in enumerate(node.args):
            if not isinstance(a, (ast.Name, ast.Attribute)):
                continue
            target = self._resolve_callee(
                ast.Call(func=a, args=[], keywords=[]))
            if target is not None and target[0] == "func":
                self._bind_args(target[1], node, arg_taints[j + 1:],
                                kw_taints, target[2])
                return

    def _bind_args(self, fq: str, node: ast.Call,
                   arg_taints: List[Set[str]],
                   kw_taints: Dict[Optional[str], Set[str]],
                   receiver) -> None:
        """Flow call-site taints into the callee's parameters."""
        def_node = self.m.def_node(fq)
        if def_node is None:
            return
        params = [a.arg for a in
                  list(getattr(def_node.args, "posonlyargs", []))
                  + list(def_node.args.args)]
        kwonly = {a.arg for a in def_node.args.kwonlyargs}
        if params and params[0] == "self":
            if receiver is not None:
                self.s.add(self.s.param, (fq, "self"),
                           self._eval(receiver))
            params = params[1:]
        for i, t in enumerate(arg_taints):
            if i < len(params):
                self.s.add(self.s.param, (fq, params[i]), t)
            elif def_node.args.vararg is not None:
                self.s.add(self.s.param,
                           (fq, def_node.args.vararg.arg), t)
        for name, t in kw_taints.items():
            if name is None:             # **kwargs expansion
                if def_node.args.kwarg is not None:
                    self.s.add(self.s.param,
                               (fq, def_node.args.kwarg.arg), t)
                continue
            if name in params or name in kwonly:
                self.s.add(self.s.param, (fq, name), t)
            elif def_node.args.kwarg is not None:
                self.s.add(self.s.param,
                           (fq, def_node.args.kwarg.arg), t)

    # -- resolution --------------------------------------------------------

    def _resolve_callee(self, node: ast.Call):
        """("func", qname, receiver_expr|None) / ("class", qname) /
        None.  Mirrors the concurrency model's resolution with this
        walker's local type environment for method receivers."""
        func = node.func
        if isinstance(func, ast.Name):
            scope: Optional[str] = self.q
            while scope is not None:
                found = self.m._funcs_by_parent.get(scope, {}).get(func.id)
                if found:
                    return ("func", found, None)
                if ".<locals>." in scope:
                    scope = scope.rsplit(".<locals>.", 1)[0]
                elif scope != self.rel:
                    scope = self.rel
                else:
                    scope = None
            sym = self.m.resolve_symbol(self.rel, func)
            if sym and sym[0] == "func":
                return ("func", sym[1], None)
            if sym and sym[0] == "class":
                return ("class", sym[1])
            return None
        if isinstance(func, ast.Attribute):
            base = self._class_of(func.value)
            if base is not None:
                q = f"{base}.{func.attr}"
                if q in self.m.functions:
                    return ("func", q, func.value)
                return None
            sym = self.m.resolve_symbol(self.rel, func)
            if sym and sym[0] == "func":
                return ("func", sym[1], None)
            if sym and sym[0] == "class":
                return ("class", sym[1])
        return None

    def _class_of(self, expr) -> Optional[str]:
        tag = self._type_of(expr)
        if tag and tag[0] == "class":
            return tag[1]
        return None

    def _type_of(self, expr) -> Optional[Tuple]:
        if isinstance(expr, ast.Name):
            tag = self.types.get(expr.id)
            if tag is not None:
                return tag
            sym = self.m.resolve_symbol(self.rel, expr)
            if sym and sym[0] == "class":
                return None              # the class object, not an instance
            return None
        if isinstance(expr, ast.Attribute):
            base = self._class_of(expr.value)
            if base is not None:
                info = self.m.classes.get(base)
                if info is not None:
                    tag = info.attr_tags.get(expr.attr)
                    if tag and tag[0] == "class":
                        return tag
            return None
        if isinstance(expr, ast.Call):
            sym = self.m.resolve_symbol(self.rel, expr.func) \
                if isinstance(expr.func, (ast.Name, ast.Attribute)) \
                else None
            if sym and sym[0] == "class":
                return ("class", sym[1])
            return None
        return None

    def _annotation_tag(self, ann) -> Optional[Tuple]:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):   # Optional[X] / List[X]
            return self._annotation_tag(ann.slice)
        sym = self.m.resolve_symbol(self.rel, ann) \
            if isinstance(ann, (ast.Name, ast.Attribute)) else None
        if sym and sym[0] == "class":
            return ("class", sym[1])
        return None


def _as_load(node):
    """AugAssign targets double as reads; ``_eval`` ignores ctx, so the
    Store-context node is usable as-is."""
    return node
