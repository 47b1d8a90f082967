"""AST lint engine: walks the port's Python sources, runs every rule in
`rules/`, honours inline suppressions and a violation baseline.

A copy of the JAX package's engine (racon_tpu/analysis/lint.py) over
``racon_tpu_torch/`` (its build directories and ``__pycache__`` left out)
and ``chip_smoke.py``. A rule sees one parsed file at a time
(`FileContext`) or the whole tree once (`check_project`, for
registry-against-docs checks). Violations are stable, fingerprintable
records, so that a baseline file can tell accepted debt from new
regressions.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from . import astcache

#: The package the lint covers.
PACKAGE = "racon_tpu_torch"

#: Inline suppression: `# lint: disable=rule-id[,rule-id]` on the
#: offending line silences those rules for that line only.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w,-]+)")


@dataclass(frozen=True)
class Violation:
    rule: str      # rule id (kebab-case)
    path: str      # repo-relative posix path
    line: int      # 1-based
    message: str

    def fingerprint(self) -> str:
        """Line-number-free identity: survives unrelated edits above the
        violation, so a baseline does not churn on every refactor."""
        return f"{self.rule}:{self.path}:{self.message}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class FileContext:
    """One parsed source file, as rules see it."""

    def __init__(self, repo_root: str, relpath: str, source: str,
                 tree: ast.AST):
        self.repo_root = repo_root
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        # parent links let rules walk ancestor chains (ast has none)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def in_package(self, *parts: str) -> bool:
        """Whether this file lives under racon_tpu_torch/<parts...>."""
        prefix = "/".join((PACKAGE,) + parts)
        return self.relpath == prefix or self.relpath.startswith(prefix + "/")


class ProjectContext:
    """Repo-level view for rules that check cross-file invariants."""

    def __init__(self, repo_root: str, files: Sequence[FileContext]):
        self.repo_root = repo_root
        self.files = files

    def read_text(self, relpath: str) -> Optional[str]:
        path = os.path.join(self.repo_root, relpath)
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None


#: Source files the lint covers: the package and the smoke script. Tests
#: are out of scope (they set environments and write violations on
#: purpose).
_EXTRA_FILES = ("chip_smoke.py",)
#: Build outputs (``_build/``, ``native/build/``) and bytecode caches.
_EXCLUDE_DIRS = {"__pycache__", "_build", "build"}


def repo_root_for(start: Optional[str] = None) -> str:
    """The repo root: the directory holding the racon_tpu_torch package."""
    here = start or os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # analysis/ -> racon_tpu_torch/ -> repo root
    return os.path.dirname(here) if os.path.basename(here) == PACKAGE \
        else here


def iter_source_files(repo_root: str) -> List[str]:
    """Repo-relative paths of every linted source file, sorted."""
    out = []
    pkg = os.path.join(repo_root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d not in _EXCLUDE_DIRS]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), repo_root)
                out.append(rel.replace(os.sep, "/"))
    for fn in _EXTRA_FILES:
        if os.path.exists(os.path.join(repo_root, fn)):
            out.append(fn)
    return sorted(out)


def _suppressed(lines: Sequence[str], line_no: int, rule_id: str) -> bool:
    if not 1 <= line_no <= len(lines):
        return False
    m = _SUPPRESS_RE.search(lines[line_no - 1])
    return bool(m) and rule_id in m.group(1).split(",")


def run_lint(repo_root: Optional[str] = None,
             paths: Optional[Sequence[str]] = None,
             rules=None) -> List[Violation]:
    """Run every (or the given) lint rule over the port's sources.

    paths: a repo-relative file list in place of `iter_source_files`
    (the tests point it at a single snippet). Returns the violations
    that no inline suppression silences, sorted by location; baseline
    filtering is the CLI's job (`__main__.py`).
    """
    from .rules import ALL_RULES

    root = repo_root or repo_root_for()
    active = list(rules) if rules is not None else list(ALL_RULES)
    contexts: List[FileContext] = []
    violations: List[Violation] = []
    for rel in (paths if paths is not None else iter_source_files(root)):
        parsed = astcache.load(root, rel)
        if parsed.tree is None:
            violations.append(Violation(
                "parse-error", rel, parsed.error_line, parsed.error or ""))
            continue
        contexts.append(FileContext(root, rel, parsed.source, parsed.tree))

    for ctx in contexts:
        for rule in active:
            for v in rule.check(ctx):
                if not _suppressed(ctx.lines, v.line, v.rule):
                    violations.append(v)
    project = ProjectContext(root, contexts)
    for rule in active:
        check_project = getattr(rule, "check_project", None)
        if check_project is not None:
            violations.extend(check_project(project))
    return sorted(violations, key=lambda v: (v.path, v.line, v.rule))


# --------------------------------------------------------------------------
# baseline: accepted pre-existing violations (fingerprint set)
# --------------------------------------------------------------------------

def load_baseline(path: str) -> set:
    """Fingerprints accepted by the suppression baseline file."""
    try:
        with open(path) as f:
            data = json.load(f)
    except OSError:
        return set()
    return set(data.get("accepted", []))


def write_baseline(path: str, violations: Iterable[Violation]) -> None:
    data = {
        "comment": "accepted pre-existing violations; regenerate with "
                   "python -m racon_tpu_torch.analysis --write-baseline",
        "accepted": sorted({v.fingerprint() for v in violations}),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")


def filter_baselined(violations: Sequence[Violation],
                     baseline: set) -> List[Violation]:
    """Violations NOT covered by the baseline (i.e. the new ones)."""
    return [v for v in violations if v.fingerprint() not in baseline]
