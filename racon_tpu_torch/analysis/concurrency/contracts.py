"""Contract extraction and cross-checking (part B of the auditor).

The port's counterpart of the JAX package's contracts
(racon_tpu/analysis/concurrency/contracts.py). Three contracts, all
extracted statically from the analysed tree:

* **Degrade edges**: every literal ``record_degrade("a", "b")`` call
  site repo-wide (the port has no tier lattice, so the JAX extractor's
  other sources, ``CONSENSUS_TIERS``, ``ALIGN_TIERS``,
  ``record_band_fallback`` and ``record_shard_demotion``, have no
  counterpart). Every edge must have a test drill (a port test,
  ``tests/test_torch_*.py``, mentioning both tiers beside a degradation
  keyword) and a docs row (a ``|`` table row in README.md's port
  section mentioning both tiers). The rules keep the JAX ids,
  ``lattice-drill`` and ``lattice-docs``, and are anchored at the
  edge's first call site.
* **Fault points**: every name in ``resilience/faults.py``
  ``KNOWN_POINTS`` must appear in a port test and in a table row of
  README.md's port section. A JAX test or a row under ``docs/`` does
  not count: the two packages share point names, not drills. Every
  fleet-scoped point (``worker.*``, ``pool.*``, ``lease.*``) must also
  be claimed by a transition of the protocol model
  (``analysis/protocol/model.py`` ``TRANSITIONS``): ``fault-model``,
  skipped where the tree has no model.
* **Wire protocol**: producers and consumers in ``serve/server.py``,
  ``serve/client.py``, ``distrib/coordinator.py`` and
  ``distrib/worker.py`` are cross-checked field for field against the
  declared ``PROTOCOL`` / ``PAYLOADS`` literals in ``serve/protocol.py``.

Contracts degrade gracefully: a tree without ``faults.py`` (or without a
declared ``PROTOCOL``) simply skips that section, so fixture mini-trees
exercise one contract at a time.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .. import astcache
from ..lint import PACKAGE, Violation, iter_source_files
from ..rules.knobs import README_SECTION

LATTICE_DRILL = "lattice-drill"
LATTICE_DOCS = "lattice-docs"
FAULT_DRILL = "fault-drill"
FAULT_DOCS = "fault-docs"
FAULT_MODEL = "fault-model"
PROTOCOL_RULE = "protocol-mismatch"

_FAULTS_REL = f"{PACKAGE}/resilience/faults.py"
_PROTOCOL_REL = f"{PACKAGE}/serve/protocol.py"

#: The two wire surfaces: (surface, consumer file, producer file).
_SURFACES = (
    ("serve", f"{PACKAGE}/serve/server.py", f"{PACKAGE}/serve/client.py"),
    ("distrib", f"{PACKAGE}/distrib/coordinator.py",
     f"{PACKAGE}/distrib/worker.py"),
)

#: The files a drill may live in, and where the docs rows are read.
_TEST_PREFIX = "test_torch_"
_WHERE_TESTS = "no port test (tests/test_torch_*.py)"
_WHERE_ROWS = "no table row in README.md's port section"

#: A test file only counts as a degrade-edge drill when it also talks
#: about degradation, not merely mentions two tier names.
_DEGRADE_RE = re.compile(r"degrad|demot|fallback|lattice|bisect", re.I)


def audit(repo_root: str) -> List[Violation]:
    tests = _test_texts(repo_root)
    rows = _doc_rows(repo_root)
    out: List[Violation] = []
    out.extend(_degrade_checks(repo_root, tests, rows))
    out.extend(_fault_checks(repo_root, tests, rows))
    out.extend(_protocol_checks(repo_root))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule, v.message))


# -- shared helpers ---------------------------------------------------------

def _parse(repo_root: str, rel: str) -> Optional[ast.Module]:
    return astcache.load(repo_root, rel).tree


def _test_texts(repo_root: str) -> List[Tuple[str, str]]:
    """(relpath, text) of every port test, ``tests/test_torch_*.py``."""
    out = []
    tests_dir = os.path.join(repo_root, "tests")
    try:
        names = sorted(os.listdir(tests_dir))
    except OSError:
        return out
    for fn in names:
        if not (fn.startswith(_TEST_PREFIX) and fn.endswith(".py")):
            continue
        try:
            with open(os.path.join(tests_dir, fn)) as f:
                out.append((f"tests/{fn}", f.read()))
        except OSError:
            continue
    return out


def _doc_rows(repo_root: str) -> List[str]:
    """Every markdown table row (``|``-prefixed line) of README.md's port
    section (the section that ``knob-docs`` reads)."""
    try:
        with open(os.path.join(repo_root, "README.md")) as f:
            readme = f.read()
    except OSError:
        return []
    start = readme.find(README_SECTION)
    if start < 0:
        return []
    end = readme.find("\n## ", start + len(README_SECTION))
    section = readme[start:end if end >= 0 else len(readme)]
    return [line for line in section.splitlines()
            if line.lstrip().startswith("|")]


def _token_re(token: str) -> "re.Pattern":
    return re.compile(r"(?<![A-Za-z0-9_.])" + re.escape(token)
                      + r"(?![A-Za-z0-9_])")


def _has_tokens(text: str, tokens: Sequence[str]) -> bool:
    return all(_token_re(t).search(text) for t in tokens)


def _fmt_tokens(tokens: Sequence[str]) -> str:
    return " and ".join(f"'{t}'" for t in tokens)


# -- degrade edges ----------------------------------------------------------

def degrade_edges(repo_root: str
                  ) -> List[Tuple[Tuple[str, str], Tuple[str, int]]]:
    """The extracted edge set: [((from, to), (relpath, line))], each
    anchored at its first literal ``record_degrade`` call site."""
    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for rel in iter_source_files(repo_root):
        t = _parse(repo_root, rel)
        if t is None:
            continue
        sites = sorted(
            (node.lineno, node.args[0].value, node.args[1].value)
            for node in ast.walk(t)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "record_degrade"
            and len(node.args) >= 2
            and all(isinstance(a, ast.Constant) and isinstance(a.value, str)
                    for a in node.args[:2]))
        for line, a, b in sites:
            edges.setdefault((a, b), (rel, line))
    return sorted(edges.items())


def _degrade_checks(repo_root: str, tests, rows) -> List[Violation]:
    out: List[Violation] = []
    for tokens, (rel, line) in degrade_edges(repo_root):
        label = " -> ".join(tokens)
        if not any(_has_tokens(text, tokens) and _DEGRADE_RE.search(text)
                   for _rel, text in tests):
            out.append(Violation(
                LATTICE_DRILL, rel, line,
                f"degrade edge {label} has no test drill: {_WHERE_TESTS} "
                f"mentions {_fmt_tokens(tokens)} together with a "
                f"degradation keyword"))
        if not any(_has_tokens(row, tokens) for row in rows):
            out.append(Violation(
                LATTICE_DOCS, rel, line,
                f"degrade edge {label} has no docs row: {_WHERE_ROWS} "
                f"mentions {_fmt_tokens(tokens)}"))
    return out


# -- fault points -----------------------------------------------------------

def fault_points(repo_root: str) -> List[Tuple[str, int]]:
    tree = _parse(repo_root, _FAULTS_REL)
    if tree is None:
        return []
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "KNOWN_POINTS":
            val = node.value
            if isinstance(val, ast.Call) and val.args:
                val = val.args[0]
            if isinstance(val, ast.Set):
                return sorted(
                    (el.value, el.lineno) for el in val.elts
                    if isinstance(el, ast.Constant)
                    and isinstance(el.value, str))
    return []


def _fault_checks(repo_root: str, tests, rows) -> List[Violation]:
    out: List[Violation] = []
    for point, line in fault_points(repo_root):
        pat = _token_re(point)
        if not any(pat.search(text) for _rel, text in tests):
            out.append(Violation(
                FAULT_DRILL, _FAULTS_REL, line,
                f"fault point {point} has no test drill: {_WHERE_TESTS} "
                f"mentions it"))
        if not any(pat.search(row) for row in rows):
            out.append(Violation(
                FAULT_DOCS, _FAULTS_REL, line,
                f"fault point {point} has no docs row: {_WHERE_ROWS} "
                f"mentions it"))
    out.extend(_fault_model_checks(repo_root))
    return out


def _fault_model_checks(repo_root: str) -> List[Violation]:
    """Every fleet-scoped KNOWN_POINTS entry must be claimed by a
    protocol-model transition: a fault point the model does not know
    about is a failure mode no interleaving ever exercises. Skipped
    where the tree carries no protocol model (fixture mini-trees)."""
    from ..protocol import conformance      # local: avoids an import cycle
    entries, _ = conformance._transitions(repo_root)
    if entries is None:
        return []
    claimed = {e[3] for e in entries if e[3] is not None}
    out: List[Violation] = []
    for point, line in fault_points(repo_root):
        if (point.startswith(conformance.FLEET_PREFIXES)
                and point not in claimed):
            out.append(Violation(
                FAULT_MODEL, _FAULTS_REL, line,
                f"fleet fault point {point} is not claimed by any "
                f"protocol-model transition "
                f"(analysis/protocol/model.py TRANSITIONS)"))
    return out


# -- wire protocol ----------------------------------------------------------

def _declared_protocol(repo_root: str):
    tree = _parse(repo_root, _PROTOCOL_REL)
    if tree is None:
        return None
    spec = common = payloads = None
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            if name == "PROTOCOL":
                spec = value
            elif name == "COMMON_RESP":
                common = value
            elif name == "PAYLOADS":
                payloads = value
    if spec is None:
        return None
    return spec, tuple(common or ("ok", "error")), dict(payloads or {})


class _Reads:
    def __init__(self):
        self.strict: Set[str] = set()
        self.opt: Set[str] = set()
        self.allowed: Optional[Set[str]] = None  # from_dict universe


def _index_classes(tree: ast.Module) -> Dict[str, ast.ClassDef]:
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.ClassDef)}


def _index_functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _methods(cls: Optional[ast.ClassDef]) -> Dict[str, ast.FunctionDef]:
    if cls is None:
        return {}
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _param_names(func) -> List[str]:
    names = [a.arg for a in func.args.args]
    return names[1:] if names and names[0] in ("self", "cls") else names


def _collect_dict_reads(nodes, var: str, cls: Optional[ast.ClassDef],
                        all_classes: Dict[str, ast.ClassDef],
                        reads: _Reads, depth: int = 3) -> None:
    """Strict (``d["k"]``) and optional (``d.get("k")``) reads of dict
    ``var`` in ``nodes``, recursing through same-class helper methods
    and ``X.from_dict({k: v for k, v in d.items() if ...})``."""
    methods = _methods(cls)
    for top in nodes:
        for node in ast.walk(top):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == var \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                reads.strict.add(node.slice.value)
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == var and f.attr == "get" \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    reads.opt.add(node.args[0].value)
                elif depth > 0 and isinstance(f, ast.Attribute) \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "self" and f.attr in methods:
                    # self._helper(req): recurse with the matched param
                    for i, arg in enumerate(node.args):
                        if isinstance(arg, ast.Name) and arg.id == var:
                            params = _param_names(methods[f.attr])
                            if i < len(params):
                                _collect_dict_reads(
                                    methods[f.attr].body, params[i], cls,
                                    all_classes, reads, depth - 1)
                elif depth > 0 and isinstance(f, ast.Attribute) \
                        and f.attr == "from_dict" \
                        and isinstance(f.value, ast.Name) \
                        and node.args \
                        and _comprehension_over(node.args[0], var):
                    target = all_classes.get(f.value.id)
                    fd = _methods(target).get("from_dict")
                    if fd is not None:
                        params = _param_names(fd)
                        if params:
                            _collect_dict_reads(fd.body, params[0],
                                                target, all_classes,
                                                reads, depth - 1)
                            allowed = _from_dict_universe(fd, params[0])
                            if allowed is not None:
                                reads.allowed = allowed


def _comprehension_over(node, var: str) -> bool:
    """`{k: v for k, v in var.items() ...}`"""
    if not isinstance(node, ast.DictComp) or not node.generators:
        return False
    it = node.generators[0].iter
    return (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
            and it.func.attr == "items"
            and isinstance(it.func.value, ast.Name)
            and it.func.value.id == var)


def _from_dict_universe(func, param: str) -> Optional[Set[str]]:
    """The allowed-field set from a ``set(d) - {...}`` guard."""
    for node in ast.walk(func):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub) \
                and isinstance(node.left, ast.Call) \
                and isinstance(node.left.func, ast.Name) \
                and node.left.func.id == "set" \
                and node.left.args \
                and isinstance(node.left.args[0], ast.Name) \
                and node.left.args[0].id == param \
                and isinstance(node.right, ast.Set):
            vals = set()
            for el in node.right.elts:
                if isinstance(el, ast.Constant) \
                        and isinstance(el.value, str):
                    vals.add(el.value)
                else:
                    return None
            return vals
    return None


def _collect_returns(func, cls: Optional[ast.ClassDef],
                     depth: int = 3) -> List[ast.Dict]:
    """Response dict literals returned by ``func``, following
    ``return self._helper(...)`` one class-local hop at a time."""
    methods = _methods(cls)
    out: List[ast.Dict] = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        if isinstance(v, ast.Dict):
            out.append(v)
        elif depth > 0 and isinstance(v, ast.Call) \
                and isinstance(v.func, ast.Attribute) \
                and isinstance(v.func.value, ast.Name) \
                and v.func.value.id == "self" \
                and v.func.attr in methods:
            out.extend(_collect_returns(methods[v.func.attr], cls,
                                        depth - 1))
    return out


def _dict_fields(d: ast.Dict) -> Tuple[Set[str], bool]:
    """(literal string keys, has-spread)."""
    fields: Set[str] = set()
    open_dict = False
    for k in d.keys:
        if k is None:
            open_dict = True
        elif isinstance(k, ast.Constant) and isinstance(k.value, str):
            fields.add(k.value)
        else:
            open_dict = True
    return fields, open_dict


def _find_dispatch(tree: ast.Module):
    """(func, enclosing class, req param, op var) of the consumer's
    dispatch function: the one doing ``op = <req>.get("op")``."""
    for cls in [None] + [n for n in ast.walk(tree)
                         if isinstance(n, ast.ClassDef)]:
        body = tree.body if cls is None else cls.body
        for func in body:
            if not isinstance(func, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            params = set(_param_names(func))
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and isinstance(node.value, ast.Call) \
                        and isinstance(node.value.func, ast.Attribute) \
                        and node.value.func.attr == "get" \
                        and isinstance(node.value.func.value, ast.Name) \
                        and node.value.func.value.id in params \
                        and node.value.args \
                        and isinstance(node.value.args[0], ast.Constant) \
                        and node.value.args[0].value == "op":
                    return (func, cls, node.value.func.value.id,
                            node.targets[0].id)
    return None


def _branches(func, op_var: str) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.If) \
                and isinstance(node.test, ast.Compare) \
                and isinstance(node.test.left, ast.Name) \
                and node.test.left.id == op_var \
                and len(node.test.ops) == 1 \
                and isinstance(node.test.ops[0], ast.Eq) \
                and isinstance(node.test.comparators[0], ast.Constant) \
                and isinstance(node.test.comparators[0].value, str):
            out[node.test.comparators[0].value] = node.body
    return out


def _fmt(fields) -> str:
    return ", ".join(sorted(fields))


def _check_consumer(repo_root: str, surface: str, rel: str, spec: dict,
                    common: tuple, payloads: dict) -> List[Violation]:
    tree = _parse(repo_root, rel)
    if tree is None:
        return []
    found = _find_dispatch(tree)
    if found is None:
        return []
    func, cls, req_var, op_var = found
    all_classes = _index_classes(tree)
    # JobSpec.from_dict may live in a sibling module (serve/session.py)
    sdir = os.path.dirname(rel)
    for fn in sorted(os.listdir(os.path.join(repo_root, sdir))
                     if os.path.isdir(os.path.join(repo_root, sdir))
                     else []):
        if fn.endswith(".py"):
            t = _parse(repo_root, f"{sdir}/{fn}")
            if t is not None:
                for name, node in _index_classes(t).items():
                    all_classes.setdefault(name, node)
    branches = _branches(func, op_var)
    out: List[Violation] = []
    for op in sorted(set(branches) - set(spec)):
        out.append(Violation(
            PROTOCOL_RULE, rel, func.lineno,
            f"{surface}: consumer handles op '{op}' that the declared "
            f"PROTOCOL does not define"))
    for op in sorted(set(spec) - set(branches)):
        out.append(Violation(
            PROTOCOL_RULE, rel, func.lineno,
            f"{surface}: declared op '{op}' has no consumer branch"))
    for op, body in sorted(branches.items()):
        decl = spec.get(op)
        if decl is None:
            continue
        req = set(decl.get("req", ()))
        opt = set(decl.get("opt", ()))
        reads = _Reads()
        _collect_dict_reads(body, req_var, cls, all_classes, reads)
        reads.strict.discard("op")
        reads.opt.discard("op")
        bad_strict = reads.strict - req
        if bad_strict:
            out.append(Violation(
                PROTOCOL_RULE, rel, body[0].lineno,
                f"{surface}: op '{op}' consumer strictly reads "
                f"field(s) {_fmt(bad_strict)} not declared required "
                f"(KeyError on a spec-conforming request)"))
        bad_opt = reads.opt - req - opt
        if bad_opt:
            out.append(Violation(
                PROTOCOL_RULE, rel, body[0].lineno,
                f"{surface}: op '{op}' consumer reads undeclared "
                f"field(s) {_fmt(bad_opt)}"))
        if reads.allowed is not None and reads.allowed != req | opt:
            out.append(Violation(
                PROTOCOL_RULE, rel, body[0].lineno,
                f"{surface}: op '{op}' consumer accepts field universe "
                f"{{{_fmt(reads.allowed)}}} but the spec declares "
                f"{{{_fmt(req | opt)}}}"))
        # response side of each branch
        resp_ok = set(decl.get("resp", ())) | set(common)
        shell = ast.Module(body=body, type_ignores=[])
        shell_fn = ast.FunctionDef(
            name=f"_branch_{op}", args=func.args, body=body,
            decorator_list=[], returns=None)
        for d in _collect_returns(shell_fn, cls):
            fields, _open = _dict_fields(d)
            extra = fields - resp_ok
            if extra:
                out.append(Violation(
                    PROTOCOL_RULE, rel, d.lineno,
                    f"{surface}: op '{op}' response carries undeclared "
                    f"field(s) {_fmt(extra)}"))
            for k, v in zip(d.keys, d.values):
                if k is None or not isinstance(k, ast.Constant):
                    continue
                pkey = f"{surface}.{op}.{k.value}"
                if pkey in payloads and isinstance(v, ast.Dict):
                    want = set(payloads[pkey])
                    got, popen = _dict_fields(v)
                    if not popen and got != want:
                        out.append(Violation(
                            PROTOCOL_RULE, rel, v.lineno,
                            f"{surface}: payload '{pkey}' produced with "
                            f"fields {{{_fmt(got)}}} but PAYLOADS "
                            f"declares {{{_fmt(want)}}}"))
        del shell
    return out


def _rpc_call_fields(node: ast.Call):
    """(op, fields, open) of a producer rpc call, else None.

    Two producer shapes: ``self.rpc(op="x", k=v, ...)`` (serve client)
    and ``rpc(f, {"op": "x", "k": v, ...})`` (distrib worker)."""
    f = node.func
    is_rpc = (isinstance(f, ast.Attribute) and f.attr == "rpc") or \
        (isinstance(f, ast.Name) and f.id == "rpc")
    if not is_rpc:
        return None
    op = None
    fields: Set[str] = set()
    open_call = False
    for kw in node.keywords:
        if kw.arg is None:
            open_call = True
        elif kw.arg == "op":
            if isinstance(kw.value, ast.Constant):
                op = kw.value.value
        else:
            fields.add(kw.arg)
    if op is None:
        for arg in node.args:
            if isinstance(arg, ast.Dict):
                dfields, dopen = _dict_fields(arg)
                if "op" in dfields:
                    for k, v in zip(arg.keys, arg.values):
                        if isinstance(k, ast.Constant) \
                                and k.value == "op" \
                                and isinstance(v, ast.Constant):
                            op = v.value
                    fields = dfields - {"op"}
                    open_call = open_call or dopen
                    break
    if op is None:
        return None
    return op, fields, open_call


def _check_producer(repo_root: str, surface: str, rel: str, spec: dict,
                    common: tuple, payloads: dict) -> List[Violation]:
    tree = _parse(repo_root, rel)
    if tree is None:
        return []
    out: List[Violation] = []
    module_fns = _index_functions(tree)
    resp_fields = {op: set(decl.get("resp", ())) | set(common)
                   for op, decl in spec.items()}

    for func in ast.walk(tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        rpc_vars: Dict[str, str] = {}       # var -> op
        payload_vars: Dict[str, str] = {}   # var -> payload key
        for node in ast.walk(func):
            if not isinstance(node, (ast.Assign, ast.Expr, ast.Return)):
                continue
            value = node.value
            if not isinstance(value, ast.Call):
                continue
            sent = _rpc_call_fields(value)
            if sent is None:
                continue
            op, fields, open_call = sent
            decl = spec.get(op)
            if decl is None:
                out.append(Violation(
                    PROTOCOL_RULE, rel, value.lineno,
                    f"{surface}: producer sends op '{op}' that the "
                    f"declared PROTOCOL does not define"))
                continue
            req = set(decl.get("req", ()))
            opt = set(decl.get("opt", ()))
            if not open_call:
                missing = req - fields
                if missing:
                    out.append(Violation(
                        PROTOCOL_RULE, rel, value.lineno,
                        f"{surface}: op '{op}' producer omits required "
                        f"field(s) {_fmt(missing)}"))
                extra = fields - req - opt
                if extra:
                    out.append(Violation(
                        PROTOCOL_RULE, rel, value.lineno,
                        f"{surface}: op '{op}' producer sends "
                        f"undeclared field(s) {_fmt(extra)}"))
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                rpc_vars[node.targets[0].id] = op

        # response reads on tracked rpc-result vars
        for node in ast.walk(func):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Subscript) \
                    and isinstance(node.value.value, ast.Name) \
                    and node.value.value.id in rpc_vars \
                    and isinstance(node.value.slice, ast.Constant) \
                    and isinstance(node.value.slice.value, str):
                op = rpc_vars[node.value.value.id]
                pkey = f"{surface}.{op}.{node.value.slice.value}"
                if pkey in payloads:
                    payload_vars[node.targets[0].id] = pkey
            field = line = None
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.value, ast.Name) \
                    and isinstance(node.slice, ast.Constant) \
                    and isinstance(node.slice.value, str):
                var, field, line = (node.value.id, node.slice.value,
                                    node.lineno)
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "get" \
                    and isinstance(node.func.value, ast.Name) \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                var, field, line = (node.func.value.id,
                                    node.args[0].value, node.lineno)
            if field is None:
                continue
            if var in rpc_vars:
                op = rpc_vars[var]
                if field not in resp_fields.get(op, set()):
                    out.append(Violation(
                        PROTOCOL_RULE, rel, line,
                        f"{surface}: op '{op}' client reads undeclared "
                        f"response field '{field}'"))
            elif var in payload_vars:
                pkey = payload_vars[var]
                if field not in payloads[pkey]:
                    out.append(Violation(
                        PROTOCOL_RULE, rel, line,
                        f"{surface}: payload '{pkey}' consumer reads "
                        f"undeclared field '{field}'"))

        # payload vars handed whole to module helpers: recurse one hop
        for node in ast.walk(func):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Name) \
                    and node.func.id in module_fns:
                for i, arg in enumerate(node.args):
                    if isinstance(arg, ast.Name) \
                            and arg.id in payload_vars:
                        helper = module_fns[node.func.id]
                        params = _param_names(helper)
                        if i >= len(params):
                            continue
                        pkey = payload_vars[arg.id]
                        reads = _Reads()
                        _collect_dict_reads(helper.body, params[i],
                                            None, {}, reads)
                        bad = (reads.strict | reads.opt) \
                            - set(payloads[pkey])
                        if bad:
                            out.append(Violation(
                                PROTOCOL_RULE, rel, helper.lineno,
                                f"{surface}: payload '{pkey}' consumer "
                                f"({node.func.id}) reads undeclared "
                                f"field(s) {_fmt(bad)}"))
    return out


def _protocol_checks(repo_root: str) -> List[Violation]:
    declared = _declared_protocol(repo_root)
    if declared is None:
        return []
    protocol, common, payloads = declared
    out: List[Violation] = []
    for surface, consumer_rel, producer_rel in _SURFACES:
        spec = protocol.get(surface)
        if not spec:
            continue
        out.extend(_check_consumer(repo_root, surface, consumer_rel,
                                   spec, common, payloads))
        out.extend(_check_producer(repo_root, surface, producer_rel,
                                   spec, common, payloads))
    return out
