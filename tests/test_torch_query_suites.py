"""The JAX package's query-pipeline suites, run against the port.

Each suite's source is read, its ``typeagent_tpu`` imports are pointed at
``typeagent_tpu_torch`` and its ``tests.test_*`` imports at the mirrored
suites, and it is executed as a module of its own. Every test function,
test class and fixture of it is then put into this module under a name
that carries the suite's (``test_<suite>__<test>``, ``Test_<suite>__<Class>``),
so pytest collects each test as a case of this file, parametrized tests
expanded, with the suite's own fixtures and asserts.

One thing differs from the JAX run, in the names the suites see, not in
the tests: the port's devices default to the card, so
``TextEmbeddingIndexSettings``, ``ConversationSettings`` and
``DevicePostingsIndex`` are given ``device="cpu"``, and the suites'
settings-less ``FakeConversation`` carries ``settings.device`` = cpu for the
device query engine. Stage 3 runs on the port's default engine, the device
engine on CPU tensors, as the JAX suites run on theirs.

The tests the port cannot run are in :data:`EXCLUDED`, each with its reason;
:data:`REWRITE` names the source texts adapted, with why.
:func:`mirror` is shared with ``test_torch_engine_suites.py``.
"""

import functools
import inspect
import pathlib
import re
import sys
import types

import pytest
import torch
from _pytest import fixtures

from typeagent_tpu_torch.ops.postings import DevicePostingsIndex
from typeagent_tpu_torch.tools import eval_episode53
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings

TESTS = pathlib.Path(__file__).resolve().parent
# In load order: a suite that imports from another comes after it.
SUITES = (
    "test_query_pipeline.py",
    "test_conversation.py",
    "test_query_semantics.py",
    "test_searchlang_compile.py",
    "test_searchlib.py",
    "test_answers.py",
    "test_query_collections_edges.py",
    "test_streaming_matrix.py",
    "test_serialization_matrix.py",
    "test_canned_replay.py",
)
EXCLUDED = {
    ("test_serialization_matrix.py", "TestObjectSerialization.test_non_pydantic_raises_type_error"): (
        "asserts pydantic's error text ('Pydantic dataclass'); the port has no "
        "pydantic and raises the same TypeError with its own words ('camelCase "
        "dataclass'), which test_torch_structured.py checks"
    ),
}
# The Episode-53 conversation of the canned replay's integration half is
# built on the port's default device, the card: the mirror names the CPU.
# (Those tests need the reference corpus and skip without it, as in JAX.)
REWRITE = {
    "test_canned_replay.py": (
        ("ev.load_episode53_conversation()", 'ev.load_episode53_conversation(device="cpu")'),
    ),
}


def _source(suite: str, drop: tuple[str, ...] = (), rewrite: tuple[tuple[str, str], ...] = ()) -> str:
    src = (TESTS / suite).read_text()
    for line in drop:
        # An import of a module the port does not have; the tests that use
        # it stand in the caller's EXCLUDED.
        assert src.count(line + "\n") == 1, (suite, line)
        src = src.replace(line + "\n", "")
    for old, new in rewrite:
        # A text the caller adapts (an argument the port's entry point
        # needs), each occurrence.
        assert old in src, (suite, old)
        src = src.replace(old, new)
    # The suites name the reference repository's test data by an absolute
    # path; the port reads it only where $TYPEAGENT_REFERENCE_TESTDATA says.
    src = re.sub(r'"/[^"]*/reference/tests/testdata/([^"]*)"', r'_reference_file("\1")', src)
    assert "/reference/tests/testdata/" not in src, suite
    src = re.sub(r"\btypeagent_tpu\b", "typeagent_tpu_torch", src)
    src = re.sub(r"\bfrom tests\.(test_\w+) import", r"from port_mirror_\1 import", src)
    src = re.sub(r"ConversationSettings\(\s*model=", 'ConversationSettings(device="cpu", model=', src)
    return src


def _load(suite: str, drop: tuple[str, ...] = (), rewrite: tuple[tuple[str, str], ...] = ()) -> types.ModuleType:
    name = f"port_mirror_{pathlib.Path(suite).stem}"
    module = types.ModuleType(name)
    module.__file__ = str(TESTS / suite)
    sys.modules[name] = module
    module._reference_file = reference_file
    exec(compile(_source(suite, drop, rewrite), f"<{suite} against typeagent_tpu_torch>", "exec"), module.__dict__)
    # The suites build embedding settings and postings indexes with the
    # default device, and conversations without settings.
    module.TextEmbeddingIndexSettings = functools.partial(TextEmbeddingIndexSettings, device="cpu")
    if "DevicePostingsIndex" in vars(module):
        module.DevicePostingsIndex = functools.partial(DevicePostingsIndex, device="cpu")
    if "FakeConversation" in vars(module) and _own(module, module.FakeConversation):
        module.FakeConversation.settings = types.SimpleNamespace(device=torch.device("cpu"))
    return module


def reference_file(name: str) -> str:
    """A file of the reference repository's test data under
    ``$TYPEAGENT_REFERENCE_TESTDATA``. Unset, a path in this checkout that
    does not exist, so the suites that need the file skip and nothing
    outside the checkout is read."""
    return eval_episode53.reference_file(name) or str(TESTS / "reference-testdata-unset" / name)


def _is_fixture(obj) -> bool:
    definition = getattr(fixtures, "FixtureFunctionDefinition", ())
    return isinstance(obj, definition) or hasattr(obj, "_pytestfixturefunction")


def _own(module: types.ModuleType, obj) -> bool:
    fn = getattr(obj, "_get_wrapped_function", lambda: obj)()
    return getattr(fn, "__module__", None) == module.__name__ or (
        inspect.isclass(obj) and obj.__module__ == module.__name__
    )


def mirror(
    suites, excluded: dict, namespace: dict, drop: dict[str, tuple[str, ...]] | None = None,
    rewrite: dict[str, tuple[tuple[str, str], ...]] | None = None,
) -> dict[str, list[str]]:
    """Load each suite and put its tests, classes and fixtures into
    ``namespace`` (a test module's globals) under the suite's name; returns
    the tests mirrored per suite. ``drop`` names, per suite, whole source
    lines (module-level imports of what the port lacks) taken out before
    the suite runs; ``rewrite``, per suite, (old, new) texts replaced (the
    caller says why)."""
    mirrored: dict[str, list[str]] = {}
    owners: dict[str, str] = {}
    for suite in suites:
        module = _load(suite, (drop or {}).get(suite, ()), (rewrite or {}).get(suite, ()))
        stem = pathlib.Path(suite).stem
        mirrored[suite] = []
        for name, obj in list(vars(module).items()):
            if _is_fixture(obj) and _own(module, obj):
                assert name not in owners, f"fixture {name} of {suite} and {owners[name]}"
                owners[name] = suite
                namespace[name] = obj
            elif (suite, name) in excluded:
                continue
            elif name.startswith("test_") and inspect.isfunction(obj) and _own(module, obj):
                namespace[f"test_{stem[5:]}__{name}"] = obj
                mirrored[suite].append(name)
            elif name.startswith("Test") and inspect.isclass(obj) and _own(module, obj):
                for method in [m for m in vars(obj) if m.startswith("test_")]:
                    if (suite, f"{name}.{method}") in excluded:
                        delattr(obj, method)
                    else:
                        mirrored[suite].append(f"{name}.{method}")
                namespace[f"Test_{stem[5:]}__{name}"] = obj
    return mirrored


def suite_tests(suite: str) -> set[str]:
    """Every test the suite's source defines, by name (methods as Class.test)."""
    import ast

    tree = ast.parse((TESTS / suite).read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test_"):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out.update(
                f"{node.name}.{m.name}"
                for m in node.body
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and m.name.startswith("test_")
            )
    return out


def check_mirrored(suites, excluded: dict, mirrored: dict[str, list[str]]) -> None:
    """Each test of each suite is mirrored or stands in ``excluded`` with
    its reason; nothing else is left out."""
    for suite in suites:
        defined = suite_tests(suite)
        left_out = {name for s, name in excluded if s == suite}
        assert set(mirrored[suite]) == defined - left_out, suite
        assert left_out <= defined, suite
    assert all(reason for reason in excluded.values())


MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)


def test_every_suite_test_is_mirrored_or_excluded():
    """Each test of each suite is a case here or stands in EXCLUDED with
    its reason; nothing else is left out."""
    check_mirrored(SUITES, EXCLUDED, MIRRORED)
