"""The build audit: the port's counterpart of the JAX package's jaxpr
audit (racon_tpu/analysis/jaxpr_audit.py), which traces the kernels over
the bucket grid and rejects host callbacks, float64 and recompile blow-ups.
The port traces nothing: its kernels are CUDA sources, built once each and
laid out per launch by a plan. So the audit has two parts.

**The CUDA-source audit** (on the CPU, no torch): every
``racon_tpu_torch/csrc/*.cu`` and ``*.cuh``, with comments and string
literals blanked first (so "double buffer" in a comment and
``static_assert`` are not flagged):

* ``cuda-float64``: no ``double`` and no floating literal without an
  ``f`` suffix (which C++ makes a double): the counterpart of
  ``jaxpr-float64``. The sources are device code but for their
  ``extern "C"`` launchers, which have no use for float64 either, so the
  whole file is scanned;
* ``cuda-host-callback``: no ``printf``, ``assert`` or ``__trap`` (nor
  ``__brkpt``, ``fprintf``, ``puts``) in them: the counterpart of
  ``jaxpr-forbidden-primitive``'s host callbacks;
* ``cuda-export``: every ``rt_*`` symbol a ctypes wrapper (``WRAPPERS``)
  binds is an ``extern "C"`` export of a source that the wrapper loads
  through ``cuda_lib.load``, each loaded source is one that
  ``cuda_lib.SOURCES`` builds, and every export of every source is bound
  by a wrapper that loads it.

**The launch-plan audit** (on the card; ``run_plan_audit``), in place of
the recompile budget. Its grid is every window class from 128 upward in
steps of 128, up to the largest one window of which fits the card's free
memory less the margin (``poa_driver.check_memory``; near -w 55,000 on 80
GB), at each of ``poa_driver.DEPTH_BUCKETS``. For both POA kernels, flat
and banded, ``plan`` must return a plan; keep its ``shared_bytes`` within
the card's opt-in limit a block; take the global build exactly where no
shared-memory layout fits (the smallest, a ring of 2 rows with the in-edge
sources in the global scratch, is over the limit, or the row is wider than
the wide build's 4,096 columns, or the node ids pass int16); ask for the
bytes of the layout it names; and take int32 node ids exactly above class
10,880 (``poa_cuda.wide_ids``). ``check_memory`` must admit the grid's
last class and refuse the next, and wherever ``check_memory`` admits the
class, the card's room must hold at least one window before
``batch_cap`` clamps its quotient to 1. The distinct (build,
plan) variants across the grid may number at most
``poa_driver.POA_BUILD_VARIANTS``. ``occupancy()`` runs once for each
distinct build the grid reaches and gates nothing.

``build_counts`` reads the ``kernel.builds.<source>`` counters of a
polish's metrics: after a polish in a process whose libraries are built,
each is at most 1 (its first load), and a second polish adds none.
"""

from __future__ import annotations

import ast
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from . import astcache
from .lint import PACKAGE, Violation, repo_root_for

CSRC = f"{PACKAGE}/csrc"
#: The ctypes wrappers whose bindings the export audit reads.
WRAPPERS = (f"{PACKAGE}/ops/poa_cuda.py", f"{PACKAGE}/ops/poa_v2_cuda.py",
            f"{PACKAGE}/ops/align_cuda.py",
            f"{PACKAGE}/tools/dp_cost_probe.py", f"{PACKAGE}/ops/cuda_lib.py")
CUDA_LIB = f"{PACKAGE}/ops/cuda_lib.py"

SOURCE_RULES = (
    ("cuda-float64", "no double and no unsuffixed floating literal in the "
                     "CUDA sources"),
    ("cuda-host-callback", "no printf, assert or __trap in the CUDA "
                           "sources"),
    ("cuda-export", "every rt_* symbol a ctypes wrapper binds is an "
                    "extern \"C\" export of a source it loads, and the "
                    "reverse"),
)
PLAN_RULES = (
    ("plan-audit", "over the driver's window classes and depth buckets, "
                   "both POA kernels' plans, flat and banded, fit the card "
                   "(--plans, on the card)"),
    ("plan-variants", "the distinct (build, plan) variants across the grid "
                      "stay within poa_driver.POA_BUILD_VARIANTS"),
)

_DOUBLE_RE = re.compile(r"(?<![\w])double(?![\w])")
_FLOAT_LIT_RE = re.compile(
    r"(?<![\w.])((?:\d+\.\d*|\.\d+)(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+)"
    r"([fFlL]?)(?![\w.])")
_CALLBACK_RE = re.compile(
    r"(?<![\w])(printf|fprintf|puts|assert|__trap|__brkpt)\s*\(")
_EXTERN_RE = re.compile(r'extern\s*"C"\s*')
_RT_RE = re.compile(r"^rt_\w+$")


# --------------------------------------------------------------------------
# the CUDA-source audit
# --------------------------------------------------------------------------

def strip_cuda(text: str, keep_strings: bool = False) -> str:
    """`text` with its comments blanked and, unless `keep_strings`, the
    contents of its string and character literals (the quotes stay, so
    ``extern "C"`` reads ``extern " "``); newlines are kept, so every
    offset keeps its line."""
    out = list(text)
    i, n = 0, len(text)

    def blank(a, b):
        for k in range(a, b):
            if out[k] != "\n":
                out[k] = " "

    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            blank(i, j)
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            blank(i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            if not keep_strings:
                blank(i + 1, min(j, n))
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


def _extern_exports(text: str) -> Dict[str, int]:
    """{symbol: line} of the functions a source defines or declares in
    its ``extern "C"`` blocks, or by a single ``extern "C"`` declaration:
    each identifier that opens a parameter list outside any body."""
    named = strip_cuda(text, keep_strings=True)
    code = strip_cuda(text)
    out = {}
    for m in _EXTERN_RE.finditer(named):
        i = m.end()
        block = code.startswith("{", i)
        depth, paren = (1, 0) if block else (0, 0)
        j = i + 1 if block else i
        while j < len(code):
            c = code[j]
            if c == "{":
                if not block and paren == 0 and depth == 0:
                    break                 # the declaration's body
                depth += 1
            elif c == "}":
                depth -= 1
                if block and depth == 0:
                    break                 # the end of the block
            elif c == "(":
                if paren == 0 and depth == (1 if block else 0):
                    name = re.search(r"([A-Za-z_]\w*)\s*$", code[i:j])
                    if name:
                        out.setdefault(name.group(1), _line_of(code, j))
                paren += 1
            elif c == ")":
                paren -= 1
            elif c == ";" and not block and paren == 0:
                break
            if c in ";{}" and paren == 0:
                i = j + 1                 # the next declaration starts
            j += 1
    return out


def _scan_source(rel: str, text: str) -> List[Violation]:
    code = strip_cuda(text)
    out = []
    for m in _DOUBLE_RE.finditer(code):
        out.append(Violation("cuda-float64", rel, _line_of(code, m.start()),
                             "`double` in a CUDA source: the kernels "
                             "compute in int32 and float32"))
    for m in _FLOAT_LIT_RE.finditer(code):
        if m.group(2) not in ("f", "F"):
            out.append(Violation(
                "cuda-float64", rel, _line_of(code, m.start()),
                f"floating literal {m.group(0)} without an f suffix is a "
                f"double (write {m.group(1)}f)"))
    for m in _CALLBACK_RE.finditer(code):
        out.append(Violation("cuda-host-callback", rel,
                             _line_of(code, m.start()),
                             f"{m.group(1)}() in a CUDA source calls back "
                             f"to the host or stops the kernel; report "
                             f"through an output instead"))
    return out


def _module_tuple(tree: ast.AST, name: str) -> Tuple[str, ...]:
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            try:
                return tuple(ast.literal_eval(node.value))
            except ValueError:
                return ()
    return ()


def _bindings(tree: ast.AST):
    """(sources loaded {name: line}, symbols bound {name: line}) of a
    wrapper: the literal arguments of ``cuda_lib.load`` (``load`` in
    cuda_lib itself) and the ``rt_*`` attributes it reads."""
    loads, binds = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            base = getattr(getattr(f, "value", None), "id", "cuda_lib")
            if name == "load" and base == "cuda_lib":
                loads[node.args[0].value] = min(
                    loads.get(node.args[0].value, node.lineno), node.lineno)
        elif isinstance(node, ast.Attribute) and _RT_RE.match(node.attr):
            binds[node.attr] = min(binds.get(node.attr, node.lineno),
                                   node.lineno)
    return loads, binds


def run_source_audit(repo_root: Optional[str] = None,
                     csrc_dir: Optional[str] = None) -> List[Violation]:
    """The CUDA-source audit (module note) over `csrc_dir` (default the
    tree's ``racon_tpu_torch/csrc``), against the tree's wrappers."""
    root = repo_root or repo_root_for()
    csrc = csrc_dir or os.path.join(root, CSRC)
    under_root = os.path.abspath(csrc).startswith(
        os.path.abspath(root) + os.sep)

    def rel(fn):
        path = os.path.join(csrc, fn)
        return (os.path.relpath(path, root) if under_root
                else os.path.join(os.path.basename(csrc), fn)).replace(
                    os.sep, "/")

    violations: List[Violation] = []
    exports: Dict[str, Dict[str, int]] = {}   # source -> {symbol: line}
    for fn in sorted(os.listdir(csrc)):
        if not fn.endswith((".cu", ".cuh")):
            continue
        with open(os.path.join(csrc, fn)) as f:
            text = f.read()
        violations.extend(_scan_source(rel(fn), text))
        if fn.endswith(".cu"):
            exports[fn[:-3]] = _extern_exports(text)

    lib = astcache.load(root, CUDA_LIB)
    sources = _module_tuple(lib.tree, "SOURCES") if lib.tree else ()
    if not sources:
        violations.append(Violation("cuda-export", CUDA_LIB, 1,
                                    "no SOURCES tuple: cannot tell which "
                                    "sources cuda_lib builds"))
    for name in sources:
        if name not in exports:
            violations.append(Violation(
                "cuda-export", CUDA_LIB, 1,
                f"cuda_lib builds {name}.cu, which {rel('')} lacks"))
    bound: Dict[str, Set[str]] = {}           # source -> symbols bound
    for wrapper in WRAPPERS:
        parsed = astcache.load(root, wrapper)
        if parsed.tree is None:
            violations.append(Violation("cuda-export", wrapper,
                                        parsed.error_line,
                                        parsed.error or "unreadable"))
            continue
        loads, binds = _bindings(parsed.tree)
        for name, line in sorted(loads.items()):
            if name not in sources:
                violations.append(Violation(
                    "cuda-export", wrapper, line,
                    f"loads {name!r}, which cuda_lib.SOURCES does not "
                    f"build"))
        offered = {s for name in loads for s in exports.get(name, {})}
        for sym, line in sorted(binds.items()):
            if sym not in offered:
                violations.append(Violation(
                    "cuda-export", wrapper, line,
                    f"binds {sym}, which no source it loads "
                    f"({', '.join(sorted(loads)) or 'none'}) exports "
                    f"extern \"C\""))
            for name in loads:
                if sym in exports.get(name, {}):
                    bound.setdefault(name, set()).add(sym)
    for name in sources:
        for sym, line in sorted(exports.get(name, {}).items()):
            if sym not in bound.get(name, set()):
                violations.append(Violation(
                    "cuda-export", rel(f"{name}.cu"), line,
                    f"exports {sym}, which no ctypes wrapper that loads "
                    f"{name} binds"))
    return sorted(violations, key=lambda v: (v.path, v.line, v.rule))


# --------------------------------------------------------------------------
# the launch-plan audit (on the card)
# --------------------------------------------------------------------------

#: Columns of the wide build's DP row (csrc/poa_common.cuh NT * CHWIDE):
#: a row wider than this runs the global build.
WIDE_COLUMNS = 4096
#: Columns of the usual build's row (NT * CHMAX): wider rows run the wide
#: build (16 columns a thread).
NARROW_COLUMNS = 2048
#: The largest window class whose node ids fit int16 (max_nodes 32,640).
INT16_CLASS = 10880


@dataclass
class PlanAudit:
    """What ``run_plan_audit`` found, and the grid it covered."""

    violations: List[Violation] = field(default_factory=list)
    summary: dict = field(default_factory=dict)
    occupancy: List[dict] = field(default_factory=list)


def _kernels():
    from ..ops import poa_cuda, poa_v2_cuda
    return (("ls", "poa_consensus", poa_cuda.plan, poa_cuda.layout_bytes),
            ("v2", "poa_consensus_v2", poa_v2_cuda.plan,
             poa_v2_cuda.layout_bytes))


def _occupancy_fn(kernel: str):
    from ..ops import poa_cuda, poa_v2_cuda
    return poa_cuda.occupancy if kernel == "ls" else poa_v2_cuda.occupancy


def run_plan_audit(device="cuda") -> PlanAudit:
    """The launch-plan audit (module note) on `device`, a card, sized
    from its free memory (``poa_driver.sizing_bytes``): raises
    RuntimeError without one."""
    import torch

    from ..ops import poa_cuda, poa_driver
    from ..ops.cuda_lib import DeviceError

    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the plan audit reads the card's plans and "
                           "limits: it needs a CUDA card")
    t0 = time.perf_counter()
    where = f"{PACKAGE}/ops/poa_driver.py"
    audit = PlanAudit()
    bad = audit.violations

    def flag(rule, msg):
        bad.append(Violation(rule, where, 0, msg))

    with torch.cuda.device(dev):
        free = poa_driver.sizing_bytes(dev)
        room = poa_driver.memory_room(free)
        limit = poa_cuda.shared_limit()
        kernels = _kernels()
        plans: Dict[tuple, dict] = {}
        variants: Set[tuple] = set()
        builds: Dict[tuple, tuple] = {}     # build -> first (kernel, cfg)
        top_class, grid, max_shared = {}, 0, 0
        for depth in poa_driver.DEPTH_BUCKETS:
            top = poa_driver.largest_window(room, depth)
            top_class[depth] = top
            if top < 128:
                flag("plan-audit", f"no window class fits the card at "
                     f"depth {depth} ({free} bytes free)")
                continue
            cfg_of = lambda c: poa_driver.make_config(c, depth, 5, -4, -8)
            try:
                poa_driver.check_memory([cfg_of(top)], free, "ls")
            except ValueError as e:
                flag("plan-audit", f"check_memory refuses class {top}, the "
                     f"largest_window at depth {depth}: {e}")
            try:
                poa_driver.check_memory([cfg_of(top + 128)], free, "ls")
                flag("plan-audit", f"check_memory admits class {top + 128}, "
                     f"past the largest_window {top} at depth {depth}")
            except ValueError:
                pass
            for c in range(128, top + 1, 128):
                grid += 1
                cfg = cfg_of(c)
                quotient = room // poa_driver.window_bytes(cfg)
                if quotient < 1:
                    flag("plan-audit", f"class {c}, depth {depth}: "
                         f"check_memory admits it but a batch holds "
                         f"{quotient} windows")
                key = (cfg.max_nodes, cfg.max_len)
                if key in plans:
                    continue
                plans[key] = {}
                for kernel, name, plan_fn, layout_fn in kernels:
                    for band in (False, True):
                        got = _check_plan(flag, kernel, name, plan_fn,
                                          layout_fn, cfg, c, band, limit)
                        if got is None:
                            continue
                        plans[key][(kernel, band)] = got
                        max_shared = max(max_shared, got["shared_bytes"])
                        variants.add(got["variant"])
                        builds.setdefault(got["build"], (kernel, cfg, band))
        if len(variants) > poa_driver.POA_BUILD_VARIANTS:
            flag("plan-variants", f"{len(variants)} distinct (build, plan) "
                 f"variants across the grid, above POA_BUILD_VARIANTS = "
                 f"{poa_driver.POA_BUILD_VARIANTS}")
        for build, (kernel, cfg, band) in sorted(builds.items()):
            try:
                occ = _occupancy_fn(kernel)(cfg, band=band)
            except DeviceError as e:
                occ = {"error": str(e)}
            audit.occupancy.append({
                "build": build[0], "wide": build[1], "src_in_shared":
                build[2], "max_nodes": cfg.max_nodes, "max_len": cfg.max_len,
                **occ})
    audit.summary = {
        "device": torch.cuda.get_device_name(dev), "free_bytes": free,
        "depths": list(poa_driver.DEPTH_BUCKETS),
        "largest_class": top_class, "grid": grid,
        "geometries": len(plans), "plans": 4 * len(plans),
        "variants": len(variants),
        "variant_cap": poa_driver.POA_BUILD_VARIANTS,
        "builds": len(builds), "max_shared_bytes": max_shared,
        "shared_limit": limit, "violations": len(bad),
        "seconds": time.perf_counter() - t0}
    return audit


def _check_plan(flag, kernel, name, plan_fn, layout_fn, cfg, wclass, band,
                limit) -> Optional[dict]:
    """One kernel's plan at one geometry against the module note's rules;
    its variant and build, or None where there is no plan."""
    from ..ops import poa_cuda
    from ..ops.cuda_lib import DeviceError

    what = (f"{kernel}{' banded' if band else ''} plan at class {wclass} "
            f"(max_nodes {cfg.max_nodes}, max_len {cfg.max_len})")
    try:
        p = plan_fn(cfg, band)
    except (ValueError, DeviceError) as e:
        flag("plan-audit", f"{what}: no plan ({e})")
        return None
    sm, glob = p["shared_bytes"], p["global_build"]
    if sm > limit:
        flag("plan-audit", f"{what}: {sm} shared bytes over the card's "
             f"limit of {limit}")
    N, ML = cfg.max_nodes, cfg.max_len
    fits = (ML + 1 <= WIDE_COLUMNS and N <= poa_cuda.INT16_NODES and
            layout_fn(cfg, band, 2, True) <= limit)
    if glob == fits:
        flag("plan-audit", f"{what}: global build {glob}, but the smallest "
             f"shared layout {'fits' if fits else 'does not fit'}")
    if not glob:
        want = layout_fn(cfg, band, p["ring"], not p["src_in_shared"])
        if sm != want:
            flag("plan-audit", f"{what}: plans {sm} shared bytes for a "
                 f"layout of {want}")
    ids32 = poa_cuda.wide_ids(cfg, glob)
    if ids32 != (wclass > INT16_CLASS):
        flag("plan-audit", f"{what}: int32 node ids {ids32} at class "
             f"{wclass} (int32 exactly above {INT16_CLASS})")
    launch = poa_cuda.launch_name(name, band, glob, ids32)
    wide = ML + 1 > NARROW_COLUMNS and not glob
    return {"shared_bytes": sm,
            "variant": (launch, wide, p["ring"], p["src_in_shared"]),
            "build": (launch, wide, p["src_in_shared"])}


def build_counts(snapshot: Optional[dict]) -> Dict[str, int]:
    """{source: count} of the ``kernel.builds.<source>`` counters of a
    metrics snapshot (``obs.snapshot()``; {} when disarmed)."""
    counters = (snapshot or {}).get("counters", {})
    prefix = "kernel.builds."
    return {k[len(prefix):]: int(v) for k, v in counters.items()
            if k.startswith(prefix)}


def check_build_counts(first: Dict[str, int],
                       second: Dict[str, int]) -> List[Violation]:
    """Violations of the build counts of two polishes in one process whose
    libraries were built before the first: each source at most once in
    the first (its load), none in the second."""
    where = f"{PACKAGE}/ops/cuda_lib.py"
    out = [Violation("plan-audit", where, 0,
                     f"kernel.builds.{k} = {v} in one polish (at most 1)")
           for k, v in sorted(first.items()) if v > 1]
    out += [Violation("plan-audit", where, 0,
                      f"kernel.builds.{k} = {v} in a second polish (0)")
            for k, v in sorted(second.items()) if v]
    return out
