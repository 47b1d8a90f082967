"""Source-registry extraction and read-site discovery for Engine 5.

The port's counterpart of racon_tpu/analysis/determinism/knobs.py. The
JAX package's sources are the knobs of its ``config.py`` registry, read
through ``config.get_*``; the port has no knob registry (its settings
are arguments), so its sources are declared in the ``SOURCES`` literal
of ``racon_tpu_torch/fingerprint.py``: the values the journal's
fingerprint leaves out, each with where it is read.

The registry is parsed *literally* from the audited tree, so the engine
audits what the file declares, not what an imported module computed;
fixture mini-trees carry their own tiny fingerprint.py the same way the
protocol conformance pass carries its own TRANSITIONS.

A read site is where a source's value enters the code:

* a parameter source (``where`` names a parameter) at its function's
  entry: the parameter's value is the source;
* an environment source (``where`` is ``env:<NAME>``) at every
  ``os.environ.get(NAME, ...)`` / ``os.getenv(NAME)`` call or
  ``os.environ[NAME]`` load whose name resolves (a literal, or a
  module-level string constant of the same file) to ``NAME``, as the
  ``env-registry`` lint rule resolves it (rules/knobs.py); that rule
  forces every environment read of the port into this resolvable form,
  so the enumeration is complete by construction.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .. import astcache
from ..lint import PACKAGE
from ..rules import dotted_name
from ..rules.knobs import _ENVIRON, _READ_FUNCS, _resolve
from ..rules.knobs import _module_constants as module_constants  # noqa: F401

FINGERPRINT_REL = f"{PACKAGE}/fingerprint.py"

_ENV_PREFIX = "env:"


@dataclass
class SourceDecl:
    """One registered source, as declared (not imported) in SOURCES."""

    name: str
    relpath: str               # the file that reads it
    func: str                  # the callable there ("Class.method")
    where: str                 # a parameter, or env:<NAME>
    affects_output: bool = False
    line: int = 0              # the entry's line in fingerprint.py

    @property
    def env(self) -> Optional[str]:
        return (self.where[len(_ENV_PREFIX):]
                if self.where.startswith(_ENV_PREFIX) else None)

    @property
    def qname(self) -> str:
        """The function's qname in the concurrency model."""
        return f"{self.relpath}::{self.func}"


@dataclass(frozen=True)
class SourceRead:
    """One read site of a source."""

    source: str
    relpath: str
    line: int
    func: str                  # qname of the enclosing model function
    waived: Optional[str]      # `# determinism: <reason>` text, if any


def extract_registry(repo_root: str) -> Optional[Dict[str, SourceDecl]]:
    """The SOURCES entries of ``<root>/racon_tpu_torch/fingerprint.py``,
    or None when the tree declares none (the source rules are skipped)."""
    parsed = astcache.load(repo_root, FINGERPRINT_REL)
    if parsed.tree is None:
        return None
    for node in parsed.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "SOURCES"
                and isinstance(node.value, (ast.Tuple, ast.List))):
            break
    else:
        return None
    out: Dict[str, SourceDecl] = {}
    for elt in node.value.elts:
        try:
            name, rel, func, where, affects = ast.literal_eval(elt)
        except (ValueError, SyntaxError, TypeError):
            continue
        out[str(name)] = SourceDecl(str(name), str(rel), str(func),
                                    str(where), bool(affects), elt.lineno)
    return out


def param_sources(decls: Dict[str, SourceDecl]
                  ) -> Dict[Tuple[str, str], str]:
    """(function qname, parameter) -> source name."""
    return {(d.qname, d.where): d.name for d in decls.values()
            if d.env is None}


def env_sources(decls: Dict[str, SourceDecl]) -> Dict[str, str]:
    """environment name -> source name."""
    return {d.env: d.name for d in decls.values() if d.env is not None}


def env_of_read(node, consts: Dict[str, str]) -> Optional[str]:
    """The environment name an ``os.environ.get`` / ``os.getenv`` call or
    an ``os.environ[...]`` load reads, or None."""
    if (isinstance(node, ast.Call) and node.args
            and dotted_name(node.func) in _READ_FUNCS):
        return _resolve(node.args[0], consts)
    if (isinstance(node, ast.Subscript)
            and isinstance(node.ctx, ast.Load)
            and dotted_name(node.value) in _ENVIRON):
        return _resolve(node.slice, consts)
    return None
