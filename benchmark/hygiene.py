"""Import hygiene: nothing the benchmark runs loads JAX, flax or the JAX
package, and the reference loads nothing of the program.  Top-level
module names are compared whole: ``shadow_gnn_torch`` is not
``shadow_gnn_tpu``."""
from __future__ import annotations

import ast
import os
import sys
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "shadow_gnn_tpu")
PROGRAM = "shadow_gnn_torch"
HERE = os.path.dirname(os.path.abspath(__file__))


def loaded_forbidden() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def imported_names(path: str) -> List[str]:
    """Top-level names of every module that the file imports."""
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.append(str(node.args[0].value).split(".")[0])
    return out


def scan(root: str = HERE) -> Dict[str, List[str]]:
    """{file: offending names} over the benchmark's sources: a forbidden
    name anywhere, or the program in ``reference/``."""
    bad = {}
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            names = set(imported_names(path))
            worse = names & set(FORBIDDEN)
            if os.sep + "reference" + os.sep in path + os.sep and PROGRAM in names:
                worse.add(PROGRAM)
            if worse:
                bad[os.path.relpath(path, root)] = sorted(worse)
    return bad
