"""Parity: ``ConversationBase.query()`` of the port against the JAX package's.

The same seed-made conversation (``test_torch_conv_corpus.py``'s corpus
and extractor, the fake embedding model at d = 16) is built in both
packages, and the 16 questions of ``make_questions`` go through
``query()`` in each with a canned chat model (``models/canned.py``: the
recorded stage-1 JSON, crafted answers) and a ``debug_context``. Each
package runs stage 3 twice, on its host VM (``use_device_executor="host"``)
and on its default device engine (the port's on CPU tensors). Compared,
question by question, the port's host run against the JAX package's:

* the stage-1 ``SearchQuery``, as serialized dicts: equal;
* the compiled ``SearchQueryExpr`` list (after the search resolved its
  related terms into it), as serialized dicts: equal, each term's related
  terms as a set (their order among equal scores is a tie order);
* the stage-3 results against the JAX host VM: term matches exactly;
  message and semref (per knowledge type) lists of the same length with
  the same ordinals, scores within 1e-6 rank by rank and ordinal by
  ordinal, so the order may differ only among tied scores (equal scores
  keep the order their related terms were looked up in, a top-k tie
  order neither package defines); against the JAX device engine the same
  at 1e-4 (it sums in f32 where the VM sums Python floats: NOTES.md
  "Device==VM holds to 4 decimals");
* every prompt the chat model is given, every section of it (stage 1 with
  its time-range section from ``convutils``, the ``[ANSWER CONTEXT]``
  prompts, the combine prompt), and the final answer, against the JAX
  host run: the same text, byte for byte.

And the port's device engine: its route per question the JAX engine's
(``_last_engine_route``), its stage 3 against the JAX device engine and the
JAX host VM at 1e-4, its answers the JAX host run's, and before any result
its state, the CSR postings built from the conversation: the interner's
term -> id map, ``offsets``, ``semrefs``, ``scores``, ``_term_has_dups``,
``_semref_ktype`` and the start and end keys equal to the JAX engine's.
"""

import asyncio

import numpy as np
import pytest

from typeagent_tpu.knowpro import answers as janswers
from typeagent_tpu.knowpro import fields as jfields
from typeagent_tpu.knowpro import kplib as jkplib
from typeagent_tpu.knowpro import searchlang as jsearchlang
from typeagent_tpu.knowpro.factory import create_conversation as jcreate
from typeagent_tpu.knowpro.universal_message import ConversationMessage as JMessage
from typeagent_tpu.knowpro.universal_message import ConversationMessageMeta as JMeta
from typeagent_tpu.models.canned import CannedChatModel as JCanned
from typeagent_tpu.models.result import Success as JSuccess

from typeagent_tpu_torch.knowpro import answers, fields, searchlang
from typeagent_tpu_torch.models.canned import CannedChatModel

from test_torch_conv_corpus import (
    QUESTION_KINDS,
    WordExtractor,
    ingest,
    make_corpus,
    make_questions,
    port_conversation,
)
from test_torch_conversation import jax_settings

N = 300
SEED = 41
TOL = 1e-6
TOL_DEVICE = 1e-4


class Recording:
    """A chat model that keeps every prompt it is given."""

    def __init__(self, inner):
        self.inner = inner
        self.prompts: list[list[tuple[str, str]]] = []

    async def complete(self, sections):
        self.prompts.append([(s["role"], s["content"]) for s in sections])
        return await self.inner.complete(sections)


def _results(debug_context, serialize) -> list[dict]:
    out = []
    for r in debug_context.search_results:
        out.append({
            "messages": [(m.message_ordinal, m.score) for m in r.message_matches],
            "knowledge": {
                ktype: {
                    "terms": sorted(k.term_matches),
                    "semrefs": [(s.semantic_ref_ordinal, s.score) for s in k.semantic_ref_matches],
                }
                for ktype, k in r.knowledge_matches.items()
            },
        })
    return out


async def _ask(conv, model, questions, lang, serialize, search_options=None):
    """Each question through ``query()``: its answer, prompts, stage-1
    query, compiled expressions and stage-3 results."""
    recording = Recording(model)
    conv._query_translator = lang.create_search_query_translator(recording)
    conv._answer_translator = (janswers if lang is jsearchlang else answers).create_answer_translator(recording)
    out = []
    for question in questions:
        before = len(recording.prompts)
        debug = lang.LanguageSearchDebugContext()
        answer = await conv.query(question, search_options=search_options, debug_context=debug)
        out.append({
            "answer": answer,
            "prompts": recording.prompts[before:],
            "query": serialize(debug.search_query),
            "exprs": [serialize(e) for e in debug.search_query_expr],
            "results": _results(debug, serialize),
            "route": getattr(conv, "_last_engine_route", "host"),  # the JAX package notes it
        })
    return out


def _host_options(lang=jsearchlang):
    """query()'s default options, with the host VM asked for."""
    return lang.LanguageSearchOptions(
        compile_options=jsearchlang.LanguageQueryCompileOptions(
            exact_scope=False, verb_scope=True, term_filter=None, apply_scope=True
        ),
        exact_match=False,
        max_message_matches=25,
        use_device_executor="host",
    )


@pytest.fixture(scope="module")
def runs():
    raw = make_corpus(SEED, N)
    questions = make_questions(raw, SEED + 1)

    async def go():
        port_conv, _ = await port_conversation(raw)
        settings = jax_settings()
        settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor(jkplib, JSuccess)
        jax_conv, _ = await ingest(jcreate, settings, JMessage, JMeta, raw, 1)
        port = await _ask(port_conv, CannedChatModel(questions), questions, searchlang,
                          fields.serialize_object, _host_options(searchlang))
        host = await _ask(jax_conv, JCanned(questions), questions, jsearchlang,
                          jfields.serialize_object, _host_options())
        device = await _ask(jax_conv, JCanned(questions), questions, jsearchlang,
                            jfields.serialize_object)
        port_device = await _ask(port_conv, CannedChatModel(questions), questions, searchlang,
                                 fields.serialize_object)
        engines = (port_conv._device_executor, jax_conv._device_executor)
        return port, host, device, port_device, engines

    return asyncio.run(go())


QUESTIONS = range(len(QUESTION_KINDS))
IDS = [f"{i}-{kind}" for i, kind in enumerate(QUESTION_KINDS)]


def test_questions_cover_the_kinds(runs):
    port, host, device, port_device, _ = runs
    assert {r["route"] for r in host} == {r["route"] for r in port} == {"host"}
    assert {r["route"] for r in device} == {r["route"] for r in port_device} == {"device"}
    answers_ = [r["answer"] for r in port]
    nothing = QUESTION_KINDS.index("nothing")
    assert answers_[nothing].startswith("No answer found")
    assert all(a and "Search failed" not in a for a in answers_)
    assert sum(not a.startswith("No answer found") for a in answers_) == len(answers_) - 1


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_stage1_query_equal(runs, i):
    port, host, device = runs[:3]
    assert port[i]["query"] == host[i]["query"] == device[i]["query"]


def _related_as_sets(value):
    """``value`` with every ``relatedTerms`` list sorted by text: a fuzzy
    lookup lists equal scores in its top-k's tie order, which neither
    package defines (two terms at exactly equal cosines were seen in either
    order between runs of the JAX package alone)."""
    if isinstance(value, dict):
        out = {k: _related_as_sets(v) for k, v in value.items()}
        if isinstance(out.get("relatedTerms"), list):
            out["relatedTerms"] = sorted(out["relatedTerms"], key=lambda t: (t["text"], t.get("weight")))
        return out
    if isinstance(value, list):
        return [_related_as_sets(v) for v in value]
    return value


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_compiled_exprs_equal(runs, i):
    port, host, _ = runs[:3]
    assert _related_as_sets(port[i]["exprs"]) == _related_as_sets(host[i]["exprs"])


def _close_up_to_ties(a: list, b: list, tol: float) -> None:
    """(ordinal, score) lists: the same length, scores in rank order within
    ``tol``, each ordinal's score within ``tol`` where both hold it, and the
    ordinals equal as sets apart from those tying, within ``tol``, with the
    last score (a cut at a tie may keep either)."""
    assert len(a) == len(b)
    if not a:
        return
    for (_, x), (_, y) in zip(a, b):
        assert abs(x - y) <= tol
    sa, sb = dict(a), dict(b)
    for o in sa.keys() & sb.keys():
        assert abs(sa[o] - sb[o]) <= tol
    last = min(a[-1][1], b[-1][1])
    clear = lambda d: {o for o, s in d.items() if s > last + tol}  # noqa: E731
    assert clear(sa) == clear(sb)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_stage3_equal_to_jax_host_vm(runs, i):
    port, host, _ = runs[:3]
    assert len(port[i]["results"]) == len(host[i]["results"])
    for p, h in zip(port[i]["results"], host[i]["results"]):
        _close_up_to_ties(p["messages"], h["messages"], TOL)
        assert p["knowledge"].keys() == h["knowledge"].keys()
        for ktype in p["knowledge"]:
            assert p["knowledge"][ktype]["terms"] == h["knowledge"][ktype]["terms"]
            _close_up_to_ties(p["knowledge"][ktype]["semrefs"], h["knowledge"][ktype]["semrefs"], TOL)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_stage3_close_to_jax_device_engine(runs, i):
    port, _, device = runs[:3]
    assert len(port[i]["results"]) == len(device[i]["results"])
    for p, d in zip(port[i]["results"], device[i]["results"]):
        _close_up_to_ties(p["messages"], d["messages"], TOL_DEVICE)
        assert p["knowledge"].keys() == d["knowledge"].keys()
        for ktype in p["knowledge"]:
            rank = lambda pairs: sorted(pairs, key=lambda x: (-x[1], x[0]))  # noqa: E731
            _close_up_to_ties(rank(p["knowledge"][ktype]["semrefs"]),
                              rank(d["knowledge"][ktype]["semrefs"]), TOL_DEVICE)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_prompts_byte_identical(runs, i):
    port, host, _ = runs[:3]
    assert port[i]["prompts"] == host[i]["prompts"]
    texts = [content for prompt in port[i]["prompts"] for _, content in prompt]
    assert any("[ANSWER CONTEXT]" in t for t in texts) or QUESTION_KINDS[i] == "nothing"
    # Stage 1 carries the conversation's time range (convutils) before the request.
    assert any("CONVERSATION TIME RANGE" in t for t in texts)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_answer_equal(runs, i):
    port, host, _ = runs[:3]
    assert port[i]["answer"] == host[i]["answer"]


def test_engine_state_equal_to_jax(runs):
    """The CSR postings both engines build from the conversation, before
    any result is compared."""
    port_engine, jax_engine = runs[4]
    pp, jp = port_engine._postings, jax_engine._postings
    assert len(pp) == len(jp) and pp._n_semrefs == jp._n_semrefs
    assert pp._semref_cap == jp._semref_cap
    n_terms = len(jp)
    offsets = np.asarray(jp._offsets_host)[: n_terms + 1]
    np.testing.assert_array_equal(pp._offsets_host, offsets)
    n = int(offsets[-1])
    np.testing.assert_array_equal(pp._semrefs_host, np.asarray(jp._semrefs_host)[:n])
    np.testing.assert_array_equal(pp._scores.cpu().numpy(), np.asarray(jp._scores)[:n])
    np.testing.assert_array_equal(pp._term_has_dups, jp._term_has_dups)
    for name in ("_semref_ktype", "_sem_start_key", "_sem_end_key"):
        np.testing.assert_array_equal(getattr(port_engine, name), getattr(jax_engine, name))
    # The term -> id map, over every term the engine interns: the semref
    # index's terms and the property index's keys.
    port_conv = port_engine.conversation
    index = asyncio.run(port_conv.semantic_ref_index.get_terms())
    props = asyncio.run(port_conv.secondary_indexes.property_to_semantic_ref_index.all_postings())
    terms = {t: jp.lookup(t) for t in list(index) + ["prop!" + key for key, _, _ in props]}
    assert sorted(set(terms.values())) == list(range(n_terms))
    for term, ident in terms.items():
        assert pp.lookup(term) == ident, term


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_route_equal_to_jax(runs, i):
    _, _, device, port_device, _ = runs
    assert port_device[i]["route"] == device[i]["route"] == "device"


def _stage3_close(a: dict, b: dict, tol: float) -> None:
    assert len(a["results"]) == len(b["results"])
    for p, d in zip(a["results"], b["results"]):
        _close_up_to_ties(p["messages"], d["messages"], tol)
        assert p["knowledge"].keys() == d["knowledge"].keys()
        for ktype in p["knowledge"]:
            assert p["knowledge"][ktype]["terms"] == d["knowledge"][ktype]["terms"]
            rank = lambda pairs: sorted(pairs, key=lambda x: (-x[1], x[0]))  # noqa: E731
            _close_up_to_ties(rank(p["knowledge"][ktype]["semrefs"]),
                              rank(d["knowledge"][ktype]["semrefs"]), tol)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_device_engine_close_to_jax_device_engine(runs, i):
    _, _, device, port_device, _ = runs
    _stage3_close(port_device[i], device[i], TOL_DEVICE)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_device_engine_close_to_jax_host_vm(runs, i):
    _, host, _, port_device, _ = runs
    _stage3_close(port_device[i], host[i], TOL_DEVICE)


@pytest.mark.parametrize("i", QUESTIONS, ids=IDS)
def test_device_engine_answer_equal(runs, i):
    _, host, _, port_device, _ = runs
    assert port_device[i]["answer"] == host[i]["answer"]
