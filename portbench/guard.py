"""The import guard: nothing of JAX and nothing of the JAX package.

A module is refused when its top-level name (the part before the first
dot), compared whole, is one of ``BANNED``; so ``item_alignment_torch``
passes while ``item_alignment_tpu`` does not.  ``problems`` looks at the
modules the process holds and at what the benchmark's own files import
(read from their source, so an import that did not run counts too), and
at the reference, which may import nothing of the program either.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

BANNED = ("jax", "jaxlib", "flax", "optax", "item_alignment_tpu")
PROGRAM = "item_alignment_torch"
PACKAGE = Path(__file__).resolve().parent


def refused(names: Iterable[str], banned=BANNED) -> List[str]:
    return sorted({n for n in names if n.split(".")[0] in banned})


def source_imports(path: Path) -> List[str]:
    """The modules a Python file imports, by name (relative imports
    left out)."""
    tree = ast.parse(path.read_text(), str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.append(node.module)
    return out


def problems(modules: Iterable[str] = None, root: Path = PACKAGE
             ) -> List[str]:
    modules = sys.modules if modules is None else modules
    out = [f"loaded: {m}" for m in refused(modules)]
    for path in sorted(root.rglob("*.py")):
        names = source_imports(path)
        in_reference = path.relative_to(root).parts[0] == "reference"
        banned = BANNED + ((PROGRAM,) if in_reference else ())
        out += [f"{path.relative_to(root.parent)} imports {m}"
                for m in refused(names, banned)]
    return out
