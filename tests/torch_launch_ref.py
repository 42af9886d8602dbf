"""Functions of the reference's ``repro/launch/*.py``, read without
importing those modules.

``repro.launch.dryrun`` and ``repro.launch.calibrate`` set ``XLA_FLAGS`` (512
forced host devices) when imported, which would reach every later JAX
backend of the test process.  So the port's tests compile the few
definitions they compare with from the reference's source, each in a
namespace of its own.
"""
import ast
import os
from typing import Dict, Optional

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro", "launch")


def ref_defs(module: str, names, **ns) -> Dict[str, object]:
    """``{name: object}`` for the top-level functions and assignments of
    ``repro/launch/<module>.py`` named in ``names``, run in a namespace of
    ``ns`` (the names their definitions read) and ``Optional``."""
    path = os.path.join(REF, module + ".py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    body = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in names)
            or (isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) in names for t in n.targets))]
    env = dict(ns, Optional=Optional)
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), env)
    missing = [n for n in names if n not in env]
    if missing:
        raise LookupError(f"{missing} not found in {path}")
    return {n: env[n] for n in names}
