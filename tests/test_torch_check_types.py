"""The repo's annotation gate, run over the port.

``tools/check_types.py`` scans only the JAX package (its ``PACKAGE``); this
test loads its ``iter_defs``, ``missing_annotations`` and ``is_public`` by
path and holds ``typeagent_tpu_torch/`` to its tier 1: every public
function and method annotates every parameter and its return.
"""

import ast
import importlib.util
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "typeagent_tpu_torch"


def _gate():
    spec = importlib.util.spec_from_file_location("check_types", REPO / "tools" / "check_types.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GATE = _gate()
FILES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_public_defs_are_annotated(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    missing = [
        f"{path.name}:{fn.lineno} {dotted}: {', '.join(GATE.missing_annotations(fn))}"
        for fn, dotted, private_cls in GATE.iter_defs(tree)
        if GATE.missing_annotations(fn) and GATE.is_public(dotted, fn.name, private_cls)
    ]
    assert not missing, "\n".join(missing)


def test_gate_sees_the_conversation_layer():
    names = {str(p.relative_to(PKG)) for p in FILES}
    assert {"knowpro/conversation_base.py", "knowpro/fields.py", "storage/memory/provider.py"} <= names
