"""device-except: no silent broad excepts around the port's device seams.

The port's copy of the JAX rule (racon_tpu/analysis/rules/excepts.py). A
bare ``except:`` (or an undocumented ``except Exception:``) around a
launch swallows the failure that must end the polish. The convention:
every deliberate broad catch carries a ``# noqa: BLE001`` marker with a
one-phrase reason on the same line, so that each is searchable and
reviewed.

* bare ``except:``: a violation anywhere in the port;
* ``except Exception`` / ``except BaseException`` in the device layers
  (``racon_tpu_torch/ops/``, ``resilience/``, ``parallel/``) without the
  ``noqa: BLE001`` marker: a violation;
* in ``ops/`` and ``parallel/``, the layers that launch kernels, a broad
  except must also re-raise in its body. The JAX package's marker
  documents a step down its degradation lattice; the port has no lattice
  (a launch that fails ends the polish), so a broad catch there that does
  not re-raise would hide a failed launch, and the marker alone does not
  satisfy the rule.
"""

from __future__ import annotations

import ast
from typing import Iterable

from ..lint import FileContext, Violation
from . import last_attr

_DEVICE_LAYERS = (("ops",), ("resilience",), ("parallel",))
_RERAISE_LAYERS = (("ops",), ("parallel",))
_MARKER = "noqa: BLE001"
_BROAD = ("Exception", "BaseException")


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Whether the handler's own body (not a function or class defined in
    it) holds a ``raise``."""
    todo = list(handler.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        todo.extend(ast.iter_child_nodes(node))
    return False


class DeviceExceptRule:
    id = "device-except"
    doc = ("no bare except; a broad except in ops/, resilience/ or "
           "parallel/ carries '# noqa: BLE001 — reason', and in ops/ and "
           "parallel/ re-raises")

    def check(self, ctx: FileContext) -> Iterable[Violation]:
        device_layer = any(ctx.in_package(*p) for p in _DEVICE_LAYERS)
        must_reraise = any(ctx.in_package(*p) for p in _RERAISE_LAYERS)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield Violation(
                    self.id, ctx.relpath, node.lineno,
                    "bare `except:` swallows the failure that must end "
                    "the polish; catch a type")
                continue
            if not device_layer:
                continue
            names = [last_attr(node.type)] if not isinstance(
                node.type, ast.Tuple) else [last_attr(e)
                                            for e in node.type.elts]
            if not any(n in _BROAD for n in names):
                continue
            line = ctx.lines[node.lineno - 1] \
                if node.lineno <= len(ctx.lines) else ""
            if _MARKER not in line:
                yield Violation(
                    self.id, ctx.relpath, node.lineno,
                    "broad except at a device seam without the "
                    "documented marker (# noqa: BLE001 — reason)")
            elif must_reraise and not _reraises(node):
                yield Violation(
                    self.id, ctx.relpath, node.lineno,
                    "broad except in a launching layer must re-raise: "
                    "the port has no lattice to step down")
