"""The JAX package's memory-storage suites, run against the port.

``tests/test_memory_storage.py``, ``test_collections_matrix.py``,
``test_reltermsindex.py`` and ``test_semrefindex_terms.py`` test modules
that the port now has (``knowpro/collections.py``, ``semrefindex.py``,
``propindex.py``, ``storage/memory/``). Each suite's source is read and
run with its ``typeagent_tpu.`` imports pointed at ``typeagent_tpu_torch.``;
every test function of it is one case here, so the port is held to the
same asserts as the JAX package. One thing differs, in the names the
suite's functions see, not in the tests: ``TextEmbeddingIndexSettings`` and
``ConversationSettings`` are given ``device="cpu"`` (the port's stores
default to the card; a function that imports ``ConversationSettings``
itself gets it in its call). ``test_reltermsindex.py`` takes its compiled
search-term helpers from the port's ``knowpro/query.py``.
"""

import asyncio
import functools
import inspect
import pathlib
import re

import pytest

from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings

TESTS = pathlib.Path(__file__).resolve().parent
SUITES = (
    "test_memory_storage.py",
    "test_collections_matrix.py",
    "test_reltermsindex.py",
    "test_semrefindex_terms.py",
)


def _load(suite: str) -> dict:
    src = (TESTS / suite).read_text()
    src = re.sub(r"\btypeagent_tpu\.", "typeagent_tpu_torch.", src)
    # A function that imports the settings itself gets the device in its call.
    src = src.replace("ConversationSettings(model=", 'ConversationSettings(device="cpu", model=')
    ns = {"__name__": f"port_mirror_{pathlib.Path(suite).stem}"}
    exec(compile(src, f"<{suite} against typeagent_tpu_torch>", "exec"), ns)
    # The suites build settings with the store's default device.
    ns["TextEmbeddingIndexSettings"] = functools.partial(TextEmbeddingIndexSettings, device="cpu")
    return ns


def _tests(ns: dict) -> dict:
    """The suite's test functions and ``Test*`` class methods by name."""
    out = {}
    for name, obj in ns.items():
        if name.startswith("test_") and inspect.isfunction(obj):
            out[name] = obj
        elif name.startswith("Test") and inspect.isclass(obj):
            for meth in dir(obj):
                if meth.startswith("test_"):
                    out[f"{name}.{meth}"] = functools.partial(getattr(obj(), meth))
    return out


MIRRORS = {suite: _tests(_load(suite)) for suite in SUITES}
CASES = [(suite, name) for suite, tests in MIRRORS.items() for name in tests]


def test_every_suite_mirrored():
    counts = {suite: sum(s == suite for s, _ in CASES) for suite in SUITES}
    assert all(counts.values()), counts
    for suite, tests in MIRRORS.items():
        for name, fn in tests.items():
            fn = getattr(fn, "func", fn)
            assert not getattr(fn, "pytestmark", None), f"{suite}::{name} is parametrized"


@pytest.mark.parametrize("suite,name", CASES, ids=[f"{s[5:-3]}::{n}" for s, n in CASES])
def test_port_mirror(suite, name, tmp_path):
    fn = MIRRORS[suite][name]
    params = inspect.signature(fn).parameters
    kwargs = {"tmp_path": tmp_path} if "tmp_path" in params else {}
    assert set(params) <= {"tmp_path"}, f"{name} needs fixtures {set(params)}"
    out = fn(**kwargs)
    if inspect.iscoroutine(out):
        asyncio.run(out)
