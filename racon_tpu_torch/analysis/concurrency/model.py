"""The repo model the concurrency auditor reasons over.

A copy of the JAX package's model (racon_tpu/analysis/concurrency/
model.py) over the files the port's lint walks (``lint.
iter_source_files``: ``racon_tpu_torch/`` less its build directories,
and ``chip_smoke.py``). One pass over those files builds:

* a function table (module functions, methods, nested defs, plus a
  ``<module>`` pseudo-function per file for module-level code);
* per-class attribute *tags* — which attrs hold locks, sanctioned
  lock-free types (queues/events/GuardedStats), or instances of other
  repo classes (from ``self.x = Expr`` with constructor-call and
  parameter-annotation typing);
* every shared-state **mutation** (attr rebind/augment, container
  store, mutating method call) with the lexically-held lock set;
* every lock **acquisition** (``with <lock>:``) with what was already
  held — the edges of the lock-order digraph;
* the intra-repo **call graph** with per-site held-lock sets;
* **thread entries**: ``threading.Thread(target=..., name=...)`` sites,
  the resolved target function and the patternized role name.

Then three fixpoints:

* *shared classes* — classes whose instances cross threads: seeds are
  classes owning a lock attr, classes stored into module globals, and
  classes whose bound methods are thread targets; the closure follows
  stores into shared attrs/containers and constructor-argument flow
  (``Job(spec=spec)`` shares JobSpec once Job is shared);
* *roles* — each thread entry seeds its role on the target function;
  module-level code and uncalled functions seed ``main``; roles flow
  caller -> callee to a fixpoint;
* *entry locks* — locks provably held on **every** path into a
  function (intersection over call sites of caller-entry + site-held),
  so ``_helper_locked``-style callees are credited with the guard.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .. import astcache
from ..lint import iter_source_files
from . import roles as roles_mod

#: Method names that mutate their receiver in place.
_MUTATORS = frozenset({
    "append", "extend", "insert", "remove", "pop", "popitem", "clear",
    "update", "add", "discard", "setdefault", "__setitem__",
})

_MAIN = "main"


@dataclass
class Mutation:
    owner: Tuple          # ("attr", cls_q, attr) | ("global", relpath, name)
    relpath: str
    line: int
    func: str             # qname of the enclosing function
    held: frozenset       # lexically-held locks at the site
    waived: bool
    const_flag: bool      # plain rebind to a constant (atomic flag write)


@dataclass
class Acquire:
    lock: str
    relpath: str
    line: int
    func: str
    held_before: frozenset


@dataclass
class CallSite:
    caller: str
    callee: str
    relpath: str
    line: int
    held: frozenset


@dataclass
class ThreadEntry:
    target: Optional[str]  # qname of the resolved target function
    role: str
    relpath: str
    line: int
    creator: str


@dataclass
class FunctionInfo:
    qname: str
    relpath: str
    name: str
    line: int
    cls: Optional[str]                     # owning class qname
    waived: bool = False                   # `# concurrency:` on def line
    roles: Set[str] = field(default_factory=set)
    entry_locks: Optional[frozenset] = None  # None = not yet known


@dataclass
class ClassInfo:
    qname: str
    relpath: str
    name: str
    line: int
    waived: bool = False                   # `# concurrency:` on class line
    attr_tags: Dict[str, Tuple] = field(default_factory=dict)


def _attr_chain(node) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def _module_dotted(relpath: str) -> str:
    rel = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = rel.split("/")
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _cls_base(cls_qname: str) -> str:
    return cls_qname.rsplit("::", 1)[-1]


class Model:
    def __init__(self, repo_root: str):
        self.repo_root = repo_root
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, ClassInfo] = {}
        self.mutations: List[Mutation] = []
        self.acquires: List[Acquire] = []
        self.calls: List[CallSite] = []
        self.thread_entries: List[ThreadEntry] = []
        self.shared_classes: Set[str] = set()
        self.lines: Dict[str, List[str]] = {}     # relpath -> source lines
        self.trees: Dict[str, ast.Module] = {}
        # sharedness flow edges, resolved during the closure
        self._global_stored: Set[str] = set()     # class qnames
        self._attr_flows: List[Tuple[str, str]] = []  # (owner_cls, stored)
        self._ctor_flows: List[Tuple[str, str]] = []  # (ctor_cls, arg_cls)
        # resolution tables
        self._mod_by_dotted: Dict[str, str] = {}  # dotted -> relpath
        self._ns: Dict[str, Dict[str, Tuple]] = {}  # relpath -> name -> sym
        self._funcs_by_parent: Dict[str, Dict[str, str]] = {}
        self._callers: Dict[str, List[CallSite]] = {}
        self._def_nodes: Dict[Tuple[str, int, str], ast.AST] = {}
        self._module_globals: Dict[str, Set[str]] = {}

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, repo_root: str,
              paths: Optional[List[str]] = None) -> "Model":
        m = cls(repo_root)
        rels = []
        for rel in (paths if paths is not None else
                    iter_source_files(repo_root)):
            parsed = astcache.load(repo_root, rel)
            if parsed.tree is None:
                continue  # run_lint already reports parse errors
            source, tree = parsed.source, parsed.tree
            m.lines[rel] = source.splitlines()
            m.trees[rel] = tree
            m._mod_by_dotted[_module_dotted(rel)] = rel
            rels.append(rel)
        for rel in rels:
            m._index_file(rel, m.trees[rel])
        for rel in rels:
            m._build_namespace(rel, m.trees[rel])
        for rel in rels:
            m._tag_classes(rel, m.trees[rel])
        for rel in rels:
            _FileWalker(m, rel).walk_module(m.trees[rel])
        m._resolve_shared_classes()
        m._resolve_roles()
        m._resolve_entry_locks()
        return m

    def waived_line(self, relpath: str, line: int) -> bool:
        lines = self.lines.get(relpath, [])
        if 1 <= line <= len(lines):
            return roles_mod.waiver_reason(lines[line - 1]) is not None
        return False

    def _index_file(self, rel: str, tree: ast.Module) -> None:
        """First pass: register every class/function qname in the file."""
        mod_fn = f"{rel}::<module>"
        self.functions[mod_fn] = FunctionInfo(mod_fn, rel, "<module>", 0,
                                              None)
        self._funcs_by_parent.setdefault(rel, {})
        self._module_globals[rel] = {
            t.id for stmt in tree.body
            if isinstance(stmt, (ast.Assign, ast.AnnAssign))
            for t in (stmt.targets if isinstance(stmt, ast.Assign)
                      else [stmt.target])
            if isinstance(t, ast.Name)}

        def visit(node, parent_q: str, cls_q: Optional[str]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    if cls_q and parent_q == cls_q:
                        q = f"{cls_q}.{child.name}"
                    elif parent_q == rel:
                        q = f"{rel}::{child.name}"
                    else:
                        q = f"{parent_q}.<locals>.{child.name}"
                    self.functions[q] = FunctionInfo(
                        q, rel, child.name, child.lineno, cls_q,
                        waived=self.waived_line(rel, child.lineno))
                    self._funcs_by_parent.setdefault(parent_q, {})[
                        child.name] = q
                    self._def_nodes[(rel, child.lineno, child.name)] = child
                    visit(child, q, cls_q)
                elif isinstance(child, ast.ClassDef):
                    cq = f"{rel}::{child.name}"
                    self.classes[cq] = ClassInfo(
                        cq, rel, child.name, child.lineno,
                        waived=self.waived_line(rel, child.lineno))
                    visit(child, cq, cq)

        visit(tree, rel, None)

    def _build_namespace(self, rel: str, tree: ast.Module) -> None:
        """Imports + module-level defs -> a per-file symbol table."""
        ns: Dict[str, Tuple] = {}
        pkg_parts = _module_dotted(rel).split(".")
        if not rel.endswith("/__init__.py") and rel != "__init__.py":
            pkg_parts = pkg_parts[:-1]
        for node in tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        ns[alias.asname] = ("mod", alias.name)
                    else:
                        head = alias.name.split(".")[0]
                        ns[head] = ("mod", head)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    keep = len(pkg_parts) - (node.level - 1)
                    base = pkg_parts[:keep] if keep > 0 else []
                    src = ".".join(base + ([node.module]
                                           if node.module else []))
                else:
                    src = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    ns[alias.asname or alias.name] = ("sym", src,
                                                      alias.name)
            elif isinstance(node, ast.ClassDef):
                ns[node.name] = ("class", f"{rel}::{node.name}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ns[node.name] = ("func", f"{rel}::{node.name}")
        self._ns[rel] = ns
        # module-level lock globals (`_lock = threading.Lock()`)
        for node in tree.body:
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                dotted = self._expand_dotted(ns, _raw_dotted(
                    node.value.func))
                if dotted and roles_mod.lock_call(dotted):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            ns[t.id] = ("lock", f"{rel}::{t.id}")

    def _tag_classes(self, rel: str, tree: ast.Module) -> None:
        """Attribute tags from ``self.x = ...`` in every method."""
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            cq = f"{rel}::{node.name}"
            info = self.classes.get(cq)
            if info is None:
                continue
            for stmt in ast.walk(node):
                tgt = val = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    tgt, val = stmt.targets[0], stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value:
                    tgt, val = stmt.target, stmt.value
                else:
                    continue
                chain = _attr_chain(tgt)
                if not chain or len(chain) != 2 or chain[0] != "self":
                    continue
                attr = chain[1]
                tag = self._value_tag(rel, cq, attr, val)
                if tag and (attr not in info.attr_tags
                            or info.attr_tags[attr][0] == "class"):
                    info.attr_tags[attr] = tag

    def _value_tag(self, rel: str, cq: str, attr: str,
                   val) -> Optional[Tuple]:
        if not isinstance(val, ast.Call):
            return None
        dotted = self.dotted_in_ns(rel, val.func)
        if dotted:
            if roles_mod.lock_call(dotted):
                return ("lock", f"{_cls_base(cq)}.{attr}")
            if roles_mod.sanctioned_call(dotted):
                return ("sanct",)
        sym = self.resolve_symbol(rel, val.func)
        if sym and sym[0] == "class":
            return ("class", sym[1])
        return None

    def _expand_dotted(self, ns: Dict[str, Tuple], dotted: str) -> str:
        """Expand the leading name of a dotted chain through imports."""
        if not dotted:
            return ""
        head, _, rest = dotted.partition(".")
        sym = ns.get(head)
        if sym and sym[0] == "mod":
            return sym[1] + ("." + rest if rest else "")
        if sym and sym[0] == "sym":
            full = (sym[1] + "." + sym[2]) if sym[1] else sym[2]
            return full + ("." + rest if rest else "")
        return dotted

    def dotted_in_ns(self, rel: str, node) -> str:
        """Import-resolved dotted name of a call target, '' if opaque."""
        return self._expand_dotted(self._ns.get(rel, {}),
                                   _raw_dotted(node))

    def resolve_symbol(self, rel: str, node) -> Optional[Tuple]:
        """Resolve a Name/Attribute to ("func", q) / ("class", q) /
        ("lock", id) across modules, following one import hop."""
        chain = _attr_chain(node)
        if not chain:
            return None
        ns = self._ns.get(rel, {})
        sym = ns.get(chain[0])
        if sym is None:
            return None
        if sym[0] in ("func", "class", "lock"):
            if len(chain) == 1:
                return sym
            if sym[0] == "class" and len(chain) == 2:
                q = f"{sym[1]}.{chain[1]}"
                return ("func", q) if q in self.functions else None
            return None
        if sym[0] == "sym":
            target_rel = self._mod_by_dotted.get(sym[1])
            if target_rel is not None:
                res = self._member(target_rel, sym[2], chain[1:])
                if res is not None:
                    return res
            # `from pkg import submodule` — sym names a module
            sub_rel = self._mod_by_dotted.get(
                (sym[1] + "." if sym[1] else "") + sym[2])
            if sub_rel is not None and len(chain) >= 2:
                return self._member(sub_rel, chain[1], chain[2:])
            return None
        if sym[0] == "mod":
            target_rel = self._mod_by_dotted.get(sym[1])
            if target_rel is not None and len(chain) >= 2:
                return self._member(target_rel, chain[1], chain[2:])
        return None

    def _member(self, target_rel: str, name: str, rest: List[str],
                _seen=None) -> Optional[Tuple]:
        seen = _seen or set()
        if (target_rel, name) in seen:
            return None  # re-export cycle (pkg __init__ loops)
        seen.add((target_rel, name))
        sym = self._ns.get(target_rel, {}).get(name)
        if sym is None:
            return None
        if sym[0] == "class" and rest:
            q = f"{sym[1]}.{rest[0]}"
            return ("func", q) if q in self.functions else None
        if sym[0] in ("func", "class", "lock") and not rest:
            return sym
        if sym[0] == "sym":  # re-export chain (one more hop)
            target2 = self._mod_by_dotted.get(sym[1])
            if target2 is not None:
                return self._member(target2, sym[2], rest, seen)
        return None

    def def_node(self, qname: str):
        fn = self.functions.get(qname)
        if fn is None:
            return None
        return self._def_nodes.get((fn.relpath, fn.line, fn.name))

    def is_module_global(self, rel: str, name: str) -> bool:
        return name in self._module_globals.get(rel, ())

    # -- fixpoints ---------------------------------------------------------

    def _resolve_shared_classes(self) -> None:
        shared = set(self._global_stored)
        for cq, info in self.classes.items():
            if any(t[0] == "lock" for t in info.attr_tags.values()):
                shared.add(cq)
        for te in self.thread_entries:
            if te.target and te.target in self.functions:
                cls = self.functions[te.target].cls
                if cls:
                    shared.add(cls)
        changed = True
        while changed:
            changed = False
            for owner, stored in self._attr_flows:
                if owner in shared and stored not in shared:
                    shared.add(stored)
                    changed = True
            for ctor, arg in self._ctor_flows:
                if ctor in shared and arg not in shared:
                    shared.add(arg)
                    changed = True
        self.shared_classes = shared

    def _resolve_roles(self) -> None:
        targets = {te.target for te in self.thread_entries if te.target}
        self._callers = {}
        for cs in self.calls:
            self._callers.setdefault(cs.callee, []).append(cs)
        for q, fn in self.functions.items():
            if fn.name == "<module>":
                fn.roles.add(_MAIN)
            elif q not in targets and q not in self._callers:
                fn.roles.add(_MAIN)
        for te in self.thread_entries:
            if te.target and te.target in self.functions:
                self.functions[te.target].roles.add(te.role)
        changed = True
        while changed:
            changed = False
            for cs in self.calls:
                src = self.functions.get(cs.caller)
                dst = self.functions.get(cs.callee)
                if src is None or dst is None:
                    continue
                if not src.roles <= dst.roles:
                    dst.roles |= src.roles
                    changed = True

    def _resolve_entry_locks(self) -> None:
        targets = {te.target for te in self.thread_entries if te.target}
        forced = set(targets)
        for q, fn in self.functions.items():
            if fn.name == "<module>" or q not in self._callers:
                forced.add(q)
        for _ in range(50):
            changed = False
            for q, fn in self.functions.items():
                contribs = [frozenset()] if q in forced else []
                for cs in self._callers.get(q, ()):
                    caller = self.functions.get(cs.caller)
                    if caller is None or caller.entry_locks is None:
                        continue  # unknown caller entry = universe; skip
                    contribs.append(caller.entry_locks | cs.held)
                if not contribs:
                    continue
                new = contribs[0]
                for c in contribs[1:]:
                    new = new & c
                if new != fn.entry_locks:
                    fn.entry_locks = new
                    changed = True
            if not changed:
                break
        for fn in self.functions.values():
            if fn.entry_locks is None:
                fn.entry_locks = frozenset()

    # -- queries -----------------------------------------------------------

    def effective_held(self, mut: Mutation) -> frozenset:
        fn = self.functions.get(mut.func)
        entry = fn.entry_locks if fn and fn.entry_locks else frozenset()
        return mut.held | entry

    def roles_of(self, qname: str) -> Set[str]:
        fn = self.functions.get(qname)
        return fn.roles if fn else set()


def _raw_dotted(node) -> str:
    chain = _attr_chain(node)
    return ".".join(chain) if chain else ""


def _local_names(node) -> Set[str]:
    """Names bound locally in a function body (not through nested defs)."""
    out: Set[str] = set()

    def visit(n):
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Name) and isinstance(
                    child.ctx, (ast.Store, ast.Del)):
                out.add(child.id)
            visit(child)

    if hasattr(node, "body"):
        for stmt in node.body:
            visit(stmt)
            if isinstance(stmt, ast.Name) and isinstance(
                    stmt.ctx, (ast.Store, ast.Del)):
                out.add(stmt.id)
    return out


class _FileWalker:
    """Walks one file's functions, recording mutations / acquires /
    calls / thread entries with the lexical held-lock stack."""

    def __init__(self, model: Model, rel: str):
        self.m = model
        self.rel = rel
        self.ns = model._ns.get(rel, {})
        self.q = f"{rel}::<module>"
        self.cls: Optional[str] = None
        self.env: Dict[str, Tuple] = {}
        self.held: List[str] = []
        self.globals_decl: Set[str] = set()
        self.locals: Set[str] = set()
        self.module_level = True
        self.is_init = False

    def walk_module(self, tree: ast.Module) -> None:
        self._walk_function(f"{self.rel}::<module>", tree, None, {},
                            module_level=True)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = self._qname_of_def(node)
                if q is None:
                    continue
                cls = self.m.functions[q].cls
                env = self._param_env(node, cls)
                self._walk_function(q, node, cls, env)

    def _qname_of_def(self, node) -> Optional[str]:
        for (rel, line, name), n in self.m._def_nodes.items():
            if n is node:
                fn = self.m.functions
                for q, info in fn.items():
                    if info.relpath == rel and info.line == line \
                            and info.name == name:
                        return q
        return None

    def _param_env(self, node, cls: Optional[str]) -> Dict[str, Tuple]:
        env: Dict[str, Tuple] = {}
        args = list(getattr(node.args, "posonlyargs", [])) \
            + list(node.args.args) + list(node.args.kwonlyargs)
        for a in args:
            if a.arg == "self" and cls:
                env["self"] = ("class", cls)
            elif a.annotation is not None:
                tag = self._annotation_tag(a.annotation)
                if tag:
                    env[a.arg] = tag
        return env

    def _annotation_tag(self, ann) -> Optional[Tuple]:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                ann = ast.parse(ann.value, mode="eval").body
            except SyntaxError:
                return None
        if isinstance(ann, ast.Subscript):  # Optional[X] / List[X]
            return self._annotation_tag(ann.slice)
        sym = self.m.resolve_symbol(self.rel, ann)
        if sym and sym[0] == "class":
            return ("class", sym[1])
        return None

    # -- per-function walk -------------------------------------------------

    def _walk_function(self, q: str, node, cls: Optional[str],
                       env: Dict[str, Tuple],
                       module_level: bool = False) -> None:
        self.q = q
        self.cls = cls
        self.env = dict(env)
        self.held = []
        self.globals_decl = set()
        self.locals = _local_names(node)
        self.module_level = module_level
        self.is_init = bool(cls) and q.endswith((".__init__",
                                                 ".__post_init__"))
        for stmt in getattr(node, "body", []):
            self._visit(stmt)

    def _visit(self, node) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # walked separately
        if isinstance(node, ast.Global):
            self.globals_decl.update(node.names)
            return
        if isinstance(node, ast.With):
            self._visit_with(node)
            return
        if isinstance(node, ast.Assign):
            self._record_assign(node.targets, node.value,
                                aug=False, line=node.lineno)
        elif isinstance(node, ast.AugAssign):
            self._record_assign([node.target], node.value,
                                aug=True, line=node.lineno)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            self._record_assign([node.target], node.value,
                                aug=False, line=node.lineno)
        if isinstance(node, ast.Call):
            self._visit_call(node)
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    def _visit_with(self, node: ast.With) -> None:
        pushed = 0
        for item in node.items:
            self._visit(item.context_expr)
            lock = self._lock_of(item.context_expr)
            if lock is not None:
                self.m.acquires.append(Acquire(
                    lock, self.rel, node.lineno, self.q,
                    frozenset(self.held)))
                self.held.append(lock)
                pushed += 1
        for stmt in node.body:
            self._visit(stmt)
        for _ in range(pushed):
            self.held.pop()

    def _lock_of(self, expr) -> Optional[str]:
        tag = self._type_of(expr)
        if tag and tag[0] == "lock":
            return tag[1]
        return None

    def _type_of(self, expr) -> Optional[Tuple]:
        if isinstance(expr, ast.Name):
            if expr.id in self.env:
                return self.env[expr.id]
            sym = self.ns.get(expr.id)
            if sym and sym[0] in ("lock", "class"):
                return sym
            return None
        if isinstance(expr, ast.Attribute):
            base = self._type_of(expr.value)
            if base and base[0] == "class":
                info = self.m.classes.get(base[1])
                if info:
                    return info.attr_tags.get(expr.attr)
            sym = self.m.resolve_symbol(self.rel, expr)
            if sym and sym[0] == "lock":
                return sym
            return None
        if isinstance(expr, ast.Call):
            dotted = self.m.dotted_in_ns(self.rel, expr.func)
            if dotted and roles_mod.lock_call(dotted):
                return ("lock", f"{self.rel}:{expr.lineno}")
            if dotted and roles_mod.sanctioned_call(dotted):
                return ("sanct",)
            sym = self.m.resolve_symbol(self.rel, expr.func)
            if sym and sym[0] == "class":
                return ("class", sym[1])
            if sym and sym[0] == "func":
                fn_node = self.m.def_node(sym[1])
                if fn_node is not None and fn_node.returns is not None:
                    other = _FileWalker(self.m,
                                        self.m.functions[sym[1]].relpath)
                    return other._annotation_tag(fn_node.returns)
            return None
        return None

    # -- mutations ---------------------------------------------------------

    def _global_owner(self, name: str) -> Optional[Tuple]:
        if name in self.globals_decl:
            return ("global", self.rel, name)
        if name not in self.locals and name not in self.env \
                and self.m.is_module_global(self.rel, name):
            return ("global", self.rel, name)
        return None

    def _owner_of(self, target) -> Optional[Tuple]:
        """Shared-state owner of a store target, None if local."""
        if isinstance(target, ast.Subscript):
            return self._owner_of_expr(target.value)
        if isinstance(target, ast.Name):
            if self.module_level:
                return None  # module-level assignment = initialization
            return ("global", self.rel, target.id) \
                if target.id in self.globals_decl else None
        if isinstance(target, ast.Attribute):
            base = self._type_of(target.value)
            if base and base[0] == "class":
                return ("attr", base[1], target.attr)
            return None
        return None

    def _owner_of_expr(self, expr) -> Optional[Tuple]:
        """Owner of a read expression mutated through
        (``self._queues[lane].append(x)`` -> (Scheduler, _queues))."""
        if isinstance(expr, ast.Subscript):
            return self._owner_of_expr(expr.value)
        if isinstance(expr, ast.Attribute):
            base = self._type_of(expr.value)
            if base and base[0] == "class":
                return ("attr", base[1], expr.attr)
            return None
        if isinstance(expr, ast.Name):
            return self._global_owner(expr.id)
        return None

    def _record_mutation(self, owner: Tuple, line: int,
                         const_flag: bool) -> None:
        if self.module_level:
            return  # module-level code is single-threaded initialization
        if owner[0] == "attr":
            if self.is_init and self.cls == owner[1]:
                return  # constructing your own instance
            info = self.m.classes.get(owner[1])
            if info is not None:
                tag = info.attr_tags.get(owner[2])
                if tag and tag[0] in ("lock", "sanct"):
                    return
                if info.waived:
                    return
        fn = self.m.functions.get(self.q)
        waived = self.m.waived_line(self.rel, line) \
            or bool(fn and fn.waived)
        self.m.mutations.append(Mutation(
            owner, self.rel, line, self.q, frozenset(self.held),
            waived, const_flag))

    def _record_assign(self, targets, value, aug: bool, line: int) -> None:
        vtag = self._type_of(value)
        const_flag = (not aug and isinstance(value, ast.Constant)
                      and value.value in (True, False, None))
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                for el in t.elts:
                    self._record_assign([el], value, aug, line)
                continue
            owner = self._owner_of(t)
            if owner is None and isinstance(t, ast.Name) \
                    and not self.module_level:
                owner = None if t.id in self.locals \
                    or not self.m.is_module_global(self.rel, t.id) \
                    else ("global", self.rel, t.id)
            if owner is None:
                if isinstance(t, ast.Name) and not aug:
                    if vtag is not None:
                        self.env[t.id] = vtag
                    else:
                        self.env.pop(t.id, None)
                continue
            self._record_mutation(owner, line, const_flag)
            self._record_flows(owner, value, vtag)
        if self.module_level:
            # still track sharedness: `_TRACKER = WedgeTracker()`
            for t in targets:
                if isinstance(t, ast.Name):
                    self._record_flows(("global", self.rel, t.id),
                                       value, vtag)

    def _record_flows(self, owner: Tuple, value, vtag) -> None:
        """Sharedness flow: storing a repo-class instance into a global
        or into another class's attr/container."""
        stored: Set[str] = set()
        if vtag and vtag[0] == "class":
            stored.add(vtag[1])
        for sub in ast.walk(value):
            if isinstance(sub, ast.Call):
                sym = self.m.resolve_symbol(self.rel, sub.func)
                if sym and sym[0] == "class":
                    stored.add(sym[1])
        for cq in stored:
            if owner[0] == "global":
                self.m._global_stored.add(cq)
            else:
                self.m._attr_flows.append((owner[1], cq))

    # -- calls -------------------------------------------------------------

    def _visit_call(self, node: ast.Call) -> None:
        dotted = self.m.dotted_in_ns(self.rel, node.func)
        if dotted == "threading.Thread":
            self._record_thread(node)
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            owner = self._owner_of_expr(node.func.value)
            if owner is not None:
                if not (owner[0] == "attr"
                        and self._tag_is_safe(owner)):
                    self._record_mutation(owner, node.lineno, False)
                for arg in node.args:
                    self._record_flows(owner, arg, self._type_of(arg))
        callee = self._resolve_callee(node)
        if callee is not None:
            if callee[0] == "func":
                self.m.calls.append(CallSite(
                    self.q, callee[1], self.rel, node.lineno,
                    frozenset(self.held)))
            elif callee[0] == "class":
                # constructor-argument flow: Job(spec=spec, ...)
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    t = self._type_of(arg)
                    if t and t[0] == "class":
                        self.m._ctor_flows.append((callee[1], t[1]))

    def _tag_is_safe(self, owner: Tuple) -> bool:
        info = self.m.classes.get(owner[1])
        tag = info.attr_tags.get(owner[2]) if info else None
        return bool(tag and tag[0] in ("lock", "sanct"))

    def _resolve_callee(self, node: ast.Call) -> Optional[Tuple]:
        func = node.func
        if isinstance(func, ast.Name):
            # lexical scope chain: nested defs, then enclosing, then
            # module functions, then imports
            scope: Optional[str] = self.q
            while scope is not None:
                found = self.m._funcs_by_parent.get(scope, {}).get(func.id)
                if found:
                    return ("func", found)
                if ".<locals>." in scope:
                    scope = scope.rsplit(".<locals>.", 1)[0]
                elif scope != self.rel:
                    scope = self.rel
                else:
                    scope = None
            sym = self.m.resolve_symbol(self.rel, func)
            return sym if sym and sym[0] in ("func", "class") else None
        if isinstance(func, ast.Attribute):
            base = self._type_of(func.value)
            if base and base[0] == "class":
                q = f"{base[1]}.{func.attr}"
                return ("func", q) if q in self.m.functions else None
            sym = self.m.resolve_symbol(self.rel, func)
            return sym if sym and sym[0] in ("func", "class") else None
        return None

    def _record_thread(self, node: ast.Call) -> None:
        target_q = None
        role = None
        for kw in node.keywords:
            if kw.arg == "target":
                texpr = kw.value
                if isinstance(texpr, ast.Call) and texpr.args:
                    texpr = texpr.args[0]  # functools.partial(f, ...)
                if isinstance(texpr, (ast.Name, ast.Attribute)):
                    callee = self._resolve_callee(
                        ast.Call(func=texpr, args=[], keywords=[]))
                    if callee and callee[0] == "func":
                        target_q = callee[1]
            elif kw.arg == "name":
                role = _patternized_name(kw.value)
        if role is None:
            role = f"unnamed@{self.rel}:{node.lineno}"
        self.m.thread_entries.append(ThreadEntry(
            target_q, role, self.rel, node.lineno, self.q))


def _patternized_name(expr) -> Optional[str]:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.JoinedStr):
        out = []
        for part in expr.values:
            if isinstance(part, ast.Constant):
                out.append(str(part.value))
            else:
                out.append("*")
        return "".join(out)
    return None
