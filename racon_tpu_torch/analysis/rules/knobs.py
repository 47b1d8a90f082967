"""env-registry / knob-docs: the port reads the environment only by the
names it declares, and documents each of them.

The port's counterpart of the JAX rules (racon_tpu/analysis/rules/
knobs.py), whose registry is ``racon_tpu/config.py``. The port has no
knob registry: its settings are arguments, and it reads no ``RACON_TPU_*``
name (the JAX package's ``config.unknown_env_knobs`` would flag any it
does not know). The environment names it may read are declared here, in
``ENV_READS``:

* **env-registry** (per file): an ``os.environ`` / ``os.getenv`` read
  (``get``, a subscript, ``in``) of a name outside ``ENV_READS`` is a
  violation, and so is a read whose name the rule cannot resolve (a
  literal, or a module-level string constant of the same file, is
  resolved). Writes and whole-environment copies (``dict(os.environ)``,
  the environment of a child process) are not reads;
* **knob-docs** (project): every name of ``ENV_READS`` appears in
  README.md's port section ("## PyTorch / CUDA port").
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional

from ...resilience.faults import ENV as _FAULT_ENV
from ..lint import FileContext, ProjectContext, Violation
from . import dotted_name, str_const

#: The environment names the port reads, and where.
ENV_READS = {
    _FAULT_ENV: "the fault spec (resilience/faults.py active_spec), read "
                "from the environment so that a child process receives it",
    "PYTHONPATH": "a child process's import path, extended with the repo "
                  "root (serve/scheduler.child_env, distrib/common.py, "
                  "tools/wrapper.py, chip_smoke.py)",
}

_READ_FUNCS = {"os.environ.get", "environ.get", "os.getenv", "getenv"}
_ENVIRON = ("os.environ", "environ")
README_SECTION = "## PyTorch / CUDA port"


def _module_constants(tree: ast.AST) -> Dict[str, str]:
    """NAME -> value of the module-level ``NAME = "literal"`` assignments."""
    out = {}
    for node in getattr(tree, "body", ()):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            value = str_const(node.value)
            if value is not None:
                out[node.targets[0].id] = value
    return out


def _resolve(node: ast.AST, consts: Dict[str, str]) -> Optional[str]:
    lit = str_const(node)
    if lit is not None:
        return lit
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    return None


class EnvRegistryRule:
    id = "env-registry"
    doc = ("environment reads name a variable declared in "
           "racon_tpu_torch/analysis/rules/knobs.py ENV_READS")

    def _judge(self, ctx, node, key_node, consts):
        key = _resolve(key_node, consts)
        if key is None:
            return Violation(
                self.id, ctx.relpath, node.lineno,
                "environment read of a name the lint cannot resolve; read "
                "it by a literal or a module-level constant")
        if key not in ENV_READS:
            return Violation(
                self.id, ctx.relpath, node.lineno,
                f"environment read of {key}, which is not declared in "
                f"analysis/rules/knobs.py ENV_READS (the port takes its "
                f"settings as arguments)")
        return None

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        consts = _module_constants(ctx.tree)
        for node in ast.walk(ctx.tree):
            key_node = None
            if isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load) and \
                    dotted_name(node.value) in _ENVIRON:
                key_node = node.slice
            elif isinstance(node, ast.Call) and node.args and \
                    dotted_name(node.func) in _READ_FUNCS:
                key_node = node.args[0]
            elif isinstance(node, ast.Compare) and \
                    len(node.ops) == 1 and \
                    isinstance(node.ops[0], (ast.In, ast.NotIn)) and \
                    dotted_name(node.comparators[0]) in _ENVIRON:
                key_node = node.left
            if key_node is None:
                continue
            v = self._judge(ctx, node, key_node, consts)
            if v is not None:
                yield v


class KnobDocsRule:
    id = "knob-docs"
    doc = ("every name of ENV_READS is documented in README.md's port "
           "section")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        return ()

    def check_project(self, project: ProjectContext) -> List[Violation]:
        where = "racon_tpu_torch/analysis/rules/knobs.py"
        readme = project.read_text("README.md")
        if readme is None:
            return [Violation(self.id, "README.md", 0,
                              "README.md not found; the port's environment "
                              "names are undocumented")]
        start = readme.find(README_SECTION)
        if start < 0:
            return [Violation(self.id, "README.md", 0,
                              f"README.md has no {README_SECTION!r} "
                              f"section")]
        end = readme.find("\n## ", start + len(README_SECTION))
        section = readme[start:end if end >= 0 else len(readme)]
        return [Violation(self.id, where, 0,
                          f"environment name {name} is not documented in "
                          f"README.md's port section")
                for name in ENV_READS if name not in section]
