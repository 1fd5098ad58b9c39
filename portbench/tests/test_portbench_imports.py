"""The import guard, read from the sources: no module of the benchmark
imports JAX or the JAX package, and the reference imports nothing of the
program. Top-level names are compared whole, so ``typeagent_tpu_torch``
is not ``typeagent_tpu``."""

from __future__ import annotations

import ast
import json
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "typeagent_tpu"}
PROGRAM = "typeagent_tpu_torch"


def sources() -> list[str]:
    out = []
    for base, _dirs, files in os.walk(HERE):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_level_imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def relative_imports(path: str) -> set[str]:
    """Modules named by ``from . import a`` / ``from .a import b`` and by
    ``from portbench import a``: the harness's own modules a file loads."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.level and node.module:
                names.add(node.module.split(".")[0])
            elif node.level or node.module == "portbench":
                names |= {a.name for a in node.names}
            elif node.module and node.module.startswith("portbench."):
                names.add(node.module)
    return names


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & JAX


def reference_modules() -> list[str]:
    """``reference.py``, every ``reference*.py`` beside it, and every module
    a configuration names under ``"reference"``."""
    names = {f[:-3] for f in os.listdir(HERE) if f.startswith("reference") and f.endswith(".py")}
    for f in os.listdir(os.path.join(HERE, "configs")):
        with open(os.path.join(HERE, "configs", f)) as fh:
            names.add(json.load(fh).get("reference", "reference"))
    return sorted(os.path.join(HERE, f"{n}.py") for n in names)


def test_only_the_system_module_imports_the_program():
    """The harness reaches the program through ``system.py`` alone (the
    tests also patch it, to break the timed path underneath)."""
    importers = {os.path.relpath(p, HERE) for p in sources() if PROGRAM in top_level_imports(p)}
    assert {p for p in importers if not p.startswith("tests" + os.sep)} == {"system.py"}


@pytest.mark.parametrize("path", reference_modules(), ids=os.path.basename)
def test_a_reference_imports_nothing_of_the_program(path):
    """Neither the program nor the harness's ``system.py``, which loads it."""
    assert os.path.exists(path)
    names = top_level_imports(path) | relative_imports(path)
    assert PROGRAM not in names and "system" not in names and "portbench.system" not in names


def test_the_run_refuses_jax_modules_by_whole_top_level_name(monkeypatch):
    import sys

    from portbench import run

    monkeypatch.setitem(sys.modules, "typeagent_tpu_torch_lookalike", sys)
    assert "typeagent_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
