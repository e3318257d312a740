"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference, with the losses that are part of it, imports nothing of the
port.

Top-level module names (the part before the first dot) are compared whole:
``st3d_torch`` begins with ``st3d`` and is not it.
"""

import ast
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BANNED = {"jax", "jaxlib", "flax", "st3d"}


def modules():
    for dirpath, _, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_and_no_port_in_the_reference(path):
    names = top_level_imports(path)
    assert not names & BANNED, f"{path} imports {sorted(names & BANNED)}"
    if any(os.sep + d + os.sep in path for d in ("reference", "losses")):
        assert "st3d_torch" not in names, f"{path} imports the port"


def test_the_names_are_compared_whole():
    from portbench import run

    sys.modules["st3d_torch_probe_x"] = sys.modules[__name__]
    try:
        assert run.banned_modules() == sorted(
            {m.split(".")[0] for m in sys.modules} & BANNED)
        assert "st3d_torch_probe_x" not in run.banned_modules()
    finally:
        del sys.modules["st3d_torch_probe_x"]
    sys.modules["st3d"] = sys.modules[__name__]
    try:
        assert run.banned_modules() == ["st3d"]
    finally:
        del sys.modules["st3d"]
