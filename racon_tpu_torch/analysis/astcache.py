"""Shared parsed-AST cache for the analysis engines.

A copy of the JAX package's cache (racon_tpu/analysis/astcache.py): the
first engine to ask for a file pays the ``ast.parse``, the rest get the
same tree back.

Entries are validated against ``(mtime_ns, size, ctime_ns, inode)`` on
every lookup, so a long-lived process (the test suite, a REPL) that
rewrites a file between runs never sees a stale tree; within one CLI
run the stat is the only cost. ctime changes on every write and cannot
be set from userspace, and the inode catches atomic replace-by-rename.
Failures are cached too: a file that does not parse returns the same
``error`` to every engine.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class Parsed:
    """One cached parse: `tree` is None iff `error` is set."""

    relpath: str
    source: str
    tree: Optional[ast.Module]
    error: Optional[str]            # OSError/SyntaxError text
    error_line: int = 0             # SyntaxError line (0 when unknown)


_cache: Dict[str, Tuple[Tuple[int, int, int, int], Parsed]] = {}
_stats = {"parses": 0, "hits": 0, "failures": 0}


def load(repo_root: str, relpath: str) -> Parsed:
    """The parsed form of ``repo_root/relpath``, cached process-wide."""
    full = os.path.join(repo_root, relpath)
    try:
        st = os.stat(full)
        key = (st.st_mtime_ns, st.st_size, st.st_ctime_ns, st.st_ino)
    except OSError as e:
        _stats["failures"] += 1
        return Parsed(relpath, "", None, str(e))
    hit = _cache.get(full)
    if hit is not None and hit[0] == key:
        _stats["hits"] += 1
        # the same file may be asked for under a different repo_root
        # spelling; the relpath in the entry is from the first caller
        return hit[1]
    try:
        with open(full) as f:
            source = f.read()
        tree = ast.parse(source, filename=relpath)
        entry = Parsed(relpath, source, tree, None)
    except OSError as e:
        _stats["failures"] += 1
        return Parsed(relpath, "", None, str(e))
    except SyntaxError as e:
        entry = Parsed(relpath, source, None, str(e),
                       getattr(e, "lineno", 0) or 0)
    _stats["parses"] += 1
    _cache[full] = (key, entry)
    return entry


def stats() -> Dict[str, int]:
    return dict(_stats)
