"""The port's stage-3 route: the host VM, and nothing in its place.

The JAX package's default engine is its device executor, which the port
does not have yet (ROADMAP.md Queue 1 item 4). So the port's
``SearchOptions`` default to the host VM, and every way of asking for the
device engine (``use_device_executor=True``, ``"device"``, ``"auto"``, or
``TAT_ENGINE_ROUTE`` set to ``device`` or ``auto``) raises
``NotImplementedError`` naming item 4 when a search resolves its route,
never a host answer in its place. Importing the package never raises.
"""

import asyncio
import os
import pathlib
import subprocess
import sys

import pytest

from typeagent_tpu_torch.knowpro import search
from typeagent_tpu_torch.knowpro.interfaces import SearchTerm, SearchTermGroup, Term
from typeagent_tpu_torch.knowpro.search import (
    SearchOptions,
    search_conversation,
    search_conversation_knowledge,
    search_conversation_knowledge_batch,
)

from test_torch_conv_corpus import make_corpus, port_conversation

GROUP = SearchTermGroup(boolean_op="or", terms=[SearchTerm(Term("word1"))])


@pytest.fixture(scope="module")
def conv():
    return asyncio.run(port_conversation(make_corpus(31, 40)))[0]


def test_default_route_is_the_host_vm(monkeypatch, conv):
    monkeypatch.delenv("TAT_ENGINE_ROUTE", raising=False)
    assert SearchOptions().use_device_executor is False
    found = asyncio.run(search_conversation(conv, GROUP, options=SearchOptions(), raw_search_query="word1"))
    assert found is not None and found.knowledge_matches


@pytest.mark.parametrize("value", ["host", "vm", "0", "false", False, "HOST"])
def test_host_vocabulary_runs(value, conv):
    options = SearchOptions(use_device_executor=value)
    assert asyncio.run(search_conversation_knowledge(conv, GROUP, options=options))


@pytest.mark.parametrize("value", [True, "device", "auto", "1", "true"])
@pytest.mark.parametrize("entry", ["single", "batch", "search"])
def test_device_requests_raise_naming_item_4(value, entry, conv):
    options = SearchOptions(use_device_executor=value)
    calls = {
        "single": lambda: search_conversation_knowledge(conv, GROUP, options=options),
        "batch": lambda: search_conversation_knowledge_batch(conv, [(GROUP, None)], options),
        "search": lambda: search_conversation(conv, GROUP, options=options),
    }
    with pytest.raises(NotImplementedError, match="item 4"):
        asyncio.run(calls[entry]())


@pytest.mark.parametrize("env", ["device", "auto", "1"])
def test_engine_route_env_raises_at_the_search_not_at_import(monkeypatch, env, conv):
    monkeypatch.setenv("TAT_ENGINE_ROUTE", env)
    options = SearchOptions()  # the variable is read here, as the options are made
    with pytest.raises(NotImplementedError, match="item 4"):
        asyncio.run(search_conversation_knowledge(conv, GROUP, options=options))


def test_package_imports_with_device_route_env():
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, TAT_ENGINE_ROUTE="device", PYTHONPATH=str(root))
    code = "import typeagent_tpu_torch.knowpro.conversation_base, typeagent_tpu_torch.knowpro.search; print('ok')"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(root), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["_try_device_executor", "_execute_on_device"])
def test_device_engine_entry_points_raise(name, conv):
    fn = getattr(search, name)
    args = (conv, None, SearchOptions()) if name == "_try_device_executor" else (conv, [])
    with pytest.raises(NotImplementedError, match="item 4"):
        asyncio.run(fn(*args))


def test_no_host_answer_when_the_device_is_asked_for(conv):
    """A device request raises before any host work: the conversation's
    search is not run and no result comes back."""
    ran = []
    real = search.run_query

    async def spy(*args, **kwargs):
        ran.append(True)
        return await real(*args, **kwargs)

    search.run_query = spy
    try:
        with pytest.raises(NotImplementedError):
            asyncio.run(search_conversation(conv, GROUP, options=SearchOptions(use_device_executor=True)))
    finally:
        search.run_query = real
    assert not ran
