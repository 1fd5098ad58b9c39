"""The port's stage-3 routes, as the JAX package routes them.

``SearchOptions().use_device_executor`` defaults to the device engine
(``knowpro/device_executor.py``) unless ``TAT_ENGINE_ROUTE`` says host or
auto, read when the options are made; the host vocabulary runs the host VM;
``"auto"`` samples both engines. A query the engine cannot express
(``_Unsupported``) runs on the host VM and the conversation notes "host
(device fallback)". One deliberate departure from the JAX package: an
exception in the engine propagates and is never answered by the host VM.
A conversation with a data-parallel ``_device_mesh`` (a mesh of CPU
devices here) splits each COO call over its dp ranks and answers as one
device does. The engine's memory guard decides how queries
pack into calls, never their route: under budgets of one slot and one
posting a call, ``make_questions``' 16 questions, action scopes included,
stay on the engine and answer as at the reckoned budgets. Everything runs
on CPU tensors.
"""

import asyncio
import os
import pathlib
import subprocess
import sys

import pytest

from typeagent_tpu_torch.knowpro import device_executor, search
from typeagent_tpu_torch.knowpro.interfaces import SearchTerm, SearchTermGroup, Term
from typeagent_tpu_torch.knowpro.query import (
    GroupSearchResultsExpr,
    MatchSearchTermExpr,
    MatchTermsOrExpr,
)
from typeagent_tpu_torch.knowpro.search import (
    SearchOptions,
    search_conversation,
    search_conversation_knowledge,
    search_conversation_knowledge_batch,
)

from test_torch_conv_corpus import QUESTION_KINDS, make_corpus, make_questions, port_conversation

GROUP = SearchTermGroup(boolean_op="or", terms=[SearchTerm(Term("word1"))])
ENTRIES = ("single", "batch", "search")


@pytest.fixture(scope="module")
def conv():
    return asyncio.run(port_conversation(make_corpus(31, 40)))[0]


def _run(conv, entry: str, options: SearchOptions):
    """Stage-3 results of one search through ``entry``."""
    async def go():
        if entry == "single":
            return await search_conversation_knowledge(conv, GROUP, options=options)
        if entry == "batch":
            return (await search_conversation_knowledge_batch(conv, [(GROUP, None)], options))[0]
        return (await search_conversation(conv, GROUP, options=options, raw_search_query="word1")).knowledge_matches

    return asyncio.run(go())


def _scores(result) -> dict:
    return {
        (ktype, m.semantic_ref_ordinal): m.score
        for ktype, r in (result or {}).items()
        for m in r.semantic_ref_matches
    }


@pytest.fixture
def host_result(conv):
    return _scores(_run(conv, "single", SearchOptions(use_device_executor="host")))


def test_default_route_is_the_device_engine(monkeypatch, conv, host_result):
    monkeypatch.delenv("TAT_ENGINE_ROUTE", raising=False)
    assert SearchOptions().use_device_executor is True
    found = _run(conv, "search", SearchOptions())
    assert conv._last_engine_route == "device"
    assert found and _scores(found) == pytest.approx(host_result)


@pytest.mark.parametrize("value", ["host", "vm", "0", "false", False, "HOST"])
def test_host_vocabulary_runs(monkeypatch, value, conv, host_result):
    async def no_engine(*args, **kwargs):
        raise AssertionError("the device engine ran for a host request")

    monkeypatch.setattr(search, "_execute_on_device", no_engine)
    got = _run(conv, "single", SearchOptions(use_device_executor=value))
    assert conv._last_engine_route == "host"
    assert _scores(got) == pytest.approx(host_result)


@pytest.mark.parametrize("value", [True, "device", "1", "true"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_device_requests_run_the_engine(value, entry, conv, host_result):
    got = _run(conv, entry, SearchOptions(use_device_executor=value))
    assert conv._last_engine_route == "device"
    assert _scores(got) == pytest.approx(host_result, rel=1e-6)


@pytest.mark.parametrize("entry", ["single", "batch"])
def test_auto_probes_both_engines(entry, conv, host_result):
    conv._engine_router = None
    options = SearchOptions(use_device_executor="auto")
    routes = []
    for _ in range(2):
        got = _run(conv, entry, options)
        routes.append(conv._last_engine_route)
        assert _scores(got) == pytest.approx(host_result, rel=1e-6)
    assert routes == ["device", "host"]
    router = conv._engine_router
    assert router.ms["device"] is not None and router.ms["host"] is not None


@pytest.mark.parametrize(
    ("env", "value"),
    [("device", True), ("auto", "auto"), ("host", False), ("vm", False), ("1", True), ("", True)],
)
def test_engine_route_env_is_read_when_options_are_made(monkeypatch, env, value):
    monkeypatch.setenv("TAT_ENGINE_ROUTE", env)
    assert SearchOptions().use_device_executor == value
    monkeypatch.setenv("TAT_ENGINE_ROUTE", "host" if value is not False else "device")
    assert SearchOptions().use_device_executor != value


def test_package_imports_with_device_route_env():
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, TAT_ENGINE_ROUTE="device", PYTHONPATH=str(root))
    code = "import typeagent_tpu_torch.knowpro.conversation_base, typeagent_tpu_torch.knowpro.search; print('ok')"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          cwd=str(root), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("coalesce", ["1", "0"])
@pytest.mark.parametrize("entry", ENTRIES)
def test_no_host_answer_when_the_device_is_asked_for(monkeypatch, conv, entry, coalesce):
    """An exception in the engine reaches the caller (through the batcher
    as its RuntimeError) and the host VM is not asked in its place."""
    async def boom(self, queries, context):
        raise ValueError("engine down")

    ran = []
    real = search.run_query

    async def spy(conversation, options, query):
        ran.append(type(query).__name__)
        return await real(conversation, options, query)

    monkeypatch.setenv("TAT_ENGINE_COALESCE", coalesce)
    monkeypatch.setattr(device_executor.DeviceQueryExecutor, "execute_batch", boom)
    monkeypatch.setattr(search, "run_query", spy)
    conv._engine_batcher = None
    with pytest.raises((ValueError, RuntimeError), match="engine down"):
        _run(conv, entry, SearchOptions(use_device_executor=True))
    assert "GroupSearchResultsExpr" not in ran


@pytest.mark.parametrize("entry", ENTRIES)
def test_unsupported_tree_runs_the_host_vm_and_says_so(monkeypatch, conv, entry, host_result):
    def unsupported(self, expr):
        raise device_executor._Unsupported

    monkeypatch.setattr(device_executor.DeviceQueryExecutor, "_compile_tree", unsupported)
    got = _run(conv, entry, SearchOptions(use_device_executor=True))
    assert conv._last_engine_route == "host (device fallback)"
    assert _scores(got) == pytest.approx(host_result)


def test_custom_booster_is_unsupported(conv):
    """A real inexpressible shape: a term expression with its own score
    booster and no declared entity boost."""
    async def go():
        executor, context = await search._get_device_executor(conv)
        expr = MatchSearchTermExpr(SearchTerm(Term("word1")), lambda t, sr, scored: scored)
        return await executor.execute(GroupSearchResultsExpr(MatchTermsOrExpr([expr], None)), context)

    assert asyncio.run(go()) is None


def test_device_mesh_raises_naming_item_9(monkeypatch):
    """The engine's data-parallel mesh (ROADMAP.md Queue 1 item 9, ported):
    with ``_device_mesh`` a (dp=2, shard=1) mesh the 16 questions answer
    through split calls exactly as on one device, on every route's entry
    (the single, batch and searchlang entries go through the
    EngineBatcher)."""
    import torch

    from typeagent_tpu_torch.knowpro import answers, searchlang
    from typeagent_tpu_torch.models.canned import CannedChatModel
    from typeagent_tpu_torch.parallel import create_mesh

    raw = make_corpus(9, 200)
    questions = make_questions(raw, 4)

    async def ask(mesh):
        conv = (await port_conversation(raw))[0]
        conv._device_mesh = mesh
        model = CannedChatModel(questions)
        conv._query_translator = searchlang.create_search_query_translator(model)
        conv._answer_translator = answers.create_answer_translator(model)
        out = []
        for question in questions:
            debug = searchlang.LanguageSearchDebugContext()
            answer = await conv.query(question, debug_context=debug)
            results = [(m.message_ordinal, m.score) for r in debug.search_results for m in r.message_matches]
            out.append((answer, conv._last_engine_route, results))
        single = await search_conversation_knowledge(conv, GROUP)
        return out, _scores(single), conv._device_executor

    one, one_single, _ = asyncio.run(ask(None))
    mesh = create_mesh(n_shard=1, n_dp=2, devices=[torch.device("cpu")] * 2)
    dp, dp_single, executor = asyncio.run(ask(mesh))
    assert executor.mesh is mesh and executor._postings.dp_calls > 0
    assert [route for _, route, _ in dp] == ["device"] * len(QUESTION_KINDS)
    assert dp == one and dp_single == one_single


def test_engine_runs_on_the_conversations_device(conv):
    executor, _ = asyncio.run(search._get_device_executor(conv))
    assert executor.device == conv.settings.device
    assert executor._postings._offsets.device == conv.settings.device


def test_budget_pressure_never_leaves_the_device(monkeypatch):
    """Budgets of one slot and one posting a call: every plan and action-
    scope job runs in a device call of its own, each question's route is
    "device", no scope selector goes to the host, and the answers and
    stage-3 results equal those at the reckoned budgets."""
    from typeagent_tpu_torch.knowpro import answers, searchlang
    from typeagent_tpu_torch.models.canned import CannedChatModel

    raw = make_corpus(7, 300)
    questions = make_questions(raw, 8)

    async def ask():
        conv = (await port_conversation(raw))[0]
        model = CannedChatModel(questions)
        conv._query_translator = searchlang.create_search_query_translator(model)
        conv._answer_translator = answers.create_answer_translator(model)
        out = []
        for question in questions:
            debug = searchlang.LanguageSearchDebugContext()
            answer = await conv.query(question, debug_context=debug)
            results = [
                (m.message_ordinal, m.score) for r in debug.search_results for m in r.message_matches
            ]
            out.append((answer, conv._last_engine_route, results))
        return out, conv._device_executor.host_scope_selectors

    reckoned, reckoned_host = asyncio.run(ask())
    for knob in ("_MAX_DENSE_ENTRIES", "_MAX_SPARSE_ENTRIES", "_MAX_GATHER_ELEMENTS"):
        monkeypatch.setattr(device_executor, knob, 1)
    tiny, tiny_host = asyncio.run(ask())
    assert len(tiny) == len(QUESTION_KINDS)
    assert [route for _, route, _ in tiny] == ["device"] * len(QUESTION_KINDS)
    assert reckoned_host == tiny_host == 0
    assert tiny == reckoned
