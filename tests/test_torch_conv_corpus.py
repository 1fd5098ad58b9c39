"""Seed-made conversations for the port's conversation tests, and the
port's own ingest checks on the CPU.

This module imports no JAX, so the card's tests (``test_torch_cuda.py``)
and the CPU parity tests (``test_torch_conversation.py``) build their
conversations from the same helpers:

* :func:`make_corpus` — one-chunk messages from ``numpy.random
  .default_rng(seed)``: 8-20 words each from a fixed vocabulary, a speaker
  and 1-3 recipients, ascending ISO timestamps;
* :class:`WordExtractor` — a deterministic knowledge extractor: one entity
  (the first word, with a float facet) and two topics (the next two words);
* :func:`to_messages`, :func:`port_settings` and :func:`ingest`, which take
  either package's classes;
* :func:`make_questions` — 16 questions over a corpus, each with the
  stage-1 ``searchQueryExpr`` JSON a chat model would return for it, made
  from the seed out of the corpus's own speakers and words (for the
  canned chat model of ``models/canned.py``).
"""

import asyncio
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest
import torch

from typeagent_tpu_torch import create_conversation
from typeagent_tpu_torch.knowpro import kplib, serialization
from typeagent_tpu_torch.knowpro.conversation_base import ConversationBase
from typeagent_tpu_torch.knowpro.convfiles import FileSerializedConversation
from typeagent_tpu_torch.knowpro.convsettings import ConversationSettings
from typeagent_tpu_torch.knowpro.universal_message import (
    ConversationMessage,
    ConversationMessageMeta,
)
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.models.result import Success

T0 = datetime(2024, 1, 1, tzinfo=timezone.utc)


def make_corpus(seed: int, n: int, vocab: int = 200, speakers: int = 8) -> list[dict]:
    """``n`` raw messages: text, speaker, recipients, timestamp."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, 21, n)
    word_ids = rng.integers(0, vocab, int(lengths.sum()))
    n_recipients = rng.integers(1, 4, n)
    speaker_ids = rng.integers(0, speakers, n)
    recipient_ids = rng.integers(0, speakers, int(n_recipients.sum()))
    ends, r_ends = np.cumsum(lengths), np.cumsum(n_recipients)
    out = []
    for i in range(n):
        words = word_ids[ends[i] - lengths[i] : ends[i]]
        rec = recipient_ids[r_ends[i] - n_recipients[i] : r_ends[i]]
        stamp = (T0 + timedelta(seconds=60 * i)).isoformat().replace("+00:00", "Z")
        out.append({
            "text": " ".join(f"word{w}" for w in words),
            "speaker": f"speaker{speaker_ids[i]}",
            "recipients": [f"speaker{r}" for r in rec],
            "timestamp": stamp,
        })
    return out


def to_messages(raw: list[dict], message_cls: type, meta_cls: type) -> list:
    return [
        message_cls(
            text_chunks=[m["text"]],
            metadata=meta_cls(speaker=m["speaker"], recipients=list(m["recipients"])),
            tags=[],
            timestamp=m["timestamp"],
        )
        for m in raw
    ]


class WordExtractor:
    """One entity and two topics per message, taken from its words."""

    def __init__(self, kplib_mod=kplib, success=Success):
        self.kplib = kplib_mod
        self.success = success

    async def extract(self, message: str):
        words = message.split()
        k = self.kplib
        entity = k.ConcreteEntity(
            name=words[0], type=["word"], facets=[k.Facet(name="length", value=float(len(words)))]
        )
        return self.success(
            k.KnowledgeResponse(entities=[entity], actions=[], inverse_actions=[], topics=words[1:3])
        )


def port_settings(d: int, device: str | None = "cpu") -> ConversationSettings:
    kwargs = {} if device is None else {"device": device}
    settings = ConversationSettings(create_test_embedding_model(d), **kwargs)
    settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor()
    return settings


async def ingest(create, settings, message_cls, meta_cls, raw: list[dict], batches: int,
                 dbname: str | None = None):
    """``create_conversation(dbname, message_cls, settings=settings)`` (memory
    storage without a ``dbname``, SQLite with one), then
    ``add_messages_with_indexing`` over ``batches`` equal slices."""
    conv = await create(dbname, message_cls, settings=settings)
    results = []
    for part in np.array_split(np.arange(len(raw)), batches):
        chunk = [raw[i] for i in part]
        results.append(await conv.add_messages_with_indexing(to_messages(chunk, message_cls, meta_cls)))
    return conv, results


async def port_conversation(raw: list[dict], batches: int = 1, d: int = 16, device: str | None = "cpu",
                            dbname: str | None = None):
    return await ingest(
        create_conversation, port_settings(d, device), ConversationMessage,
        ConversationMessageMeta, raw, batches, dbname,
    )


class ChatConversation(FileSerializedConversation, ConversationBase[ConversationMessage]):
    """A conversation of ``ConversationMessage`` that reads snapshots."""

    message_type = ConversationMessage


async def write_snapshot(conv, prefix: str, mixin=FileSerializedConversation, ser=serialization) -> None:
    """Write a ``create_conversation`` conversation's ``_data.json`` and
    ``_embeddings.bin`` through the snapshot mixin's ``serialize``."""
    ser.write_conversation_data_to_file(await mixin.serialize(conv), prefix)


# The kinds of make_questions, in order: entity terms with search terms,
# search terms alone, an entity with a type, an entity with a facet, a
# `when` date range, a "say" action between a speaker and a recipient, an
# action whose verb no message has (the verb-scope fallback query runs),
# two search expressions, a pronoun entity, and one that matches nothing (a
# date range before the corpus).
QUESTION_KINDS = ("entity", "entity", "entity", "terms", "terms", "typed", "facet", "when", "when",
                  "say", "say", "verb_fallback", "verb_fallback", "two", "pronoun", "nothing")


def make_questions(raw: list[dict], seed: int) -> dict[str, dict]:
    """Question text -> its stage-1 ``searchQueryExpr`` JSON, one question
    of each of :data:`QUESTION_KINDS`."""
    rng = np.random.default_rng(seed)

    def message() -> dict:
        return raw[int(rng.integers(len(raw)))]

    def word() -> str:
        words = message()["text"].split()
        return words[int(rng.integers(len(words)))]

    def entity(name: str, pronoun: bool = False, **more) -> dict:
        return {"name": name, "isNamePronoun": pronoun, **more}

    def date_time(t: datetime) -> dict:
        return {"date": {"day": t.day, "month": t.month, "year": t.year},
                "time": {"hour": t.hour, "minute": t.minute, "seconds": t.second}}

    def action(m: dict, verb: str) -> dict:
        return {"actorEntities": [entity(m["speaker"])], "isInformational": False,
                "actionVerbs": {"words": [verb], "tense": "Past"},
                "targetEntities": [entity(m["recipients"][0])]}

    out = {}
    for i, kind in enumerate(QUESTION_KINDS):
        if kind == "entity":
            m, w = message(), word()
            text, filters = f"what did {m['speaker']} say about {w}", [
                {"entitySearchTerms": [entity(m["speaker"])], "searchTerms": [w]}]
        elif kind == "terms":
            w1, w2 = word(), word()
            text, filters = f"what was said about {w1} and {w2}", [{"searchTerms": [w1, w2]}]
        elif kind == "typed":
            name = message()["text"].split()[0]
            text, filters = f"tell me about the word {name}", [
                {"entitySearchTerms": [entity(name, type=["word"])]}]
        elif kind == "facet":
            name = message()["text"].split()[0]
            text, filters = f"how long were the messages about {name}", [
                {"entitySearchTerms": [entity(name, facets=[{"facetName": "length", "facetValue": "*"}])]}]
        elif kind == "when":
            at = int(rng.integers(len(raw)))
            start = T0 + timedelta(seconds=60 * at)
            start = start.replace(minute=0, second=0)
            w = word()
            text, filters = f"what was said about {w} after {start:%H:00 on %B %d}", [
                {"searchTerms": [w], "timeRange": {"startDate": date_time(start),
                                                   "stopDate": date_time(start + timedelta(hours=2))}}]
        elif kind in ("say", "verb_fallback"):
            m = message()
            verb = "say" if kind == "say" else "compose"
            text, filters = f"what did {m['speaker']} {verb} to {m['recipients'][0]}", [
                {"actionSearchTerm": action(m, verb), "searchTerms": [m["text"].split()[1]]}]
        elif kind == "two":
            w, m = word(), message()
            out[f"Question {i}: what about {w}, and what did {m['speaker']} say?"] = {
                "searchExpressions": [
                    {"rewrittenQuery": f"what about {w}", "filters": [{"searchTerms": [w]}]},
                    {"rewrittenQuery": f"what did {m['speaker']} say",
                     "filters": [{"entitySearchTerms": [entity(m["speaker"])]}]},
                ]}
            continue
        elif kind == "pronoun":
            w = word()
            text, filters = f"what did I say about {w}", [
                {"entitySearchTerms": [entity("I", pronoun=True)], "searchTerms": [w]}]
        else:  # nothing: a range before the corpus
            w = word()
            text, filters = f"what was said about {w} in 1990", [
                {"searchTerms": [w], "timeRange": {
                    "startDate": {"date": {"day": 1, "month": 1, "year": 1990}},
                    "stopDate": {"date": {"day": 31, "month": 12, "year": 1990}}}}]
        question = f"Question {i}: {text}?"
        out[question] = {"searchExpressions": [{"rewrittenQuery": text, "filters": filters}]}
    return out


def metadata_semrefs(raw: list[dict]) -> int:
    """Semrefs a message's metadata gives: speaker and recipient entities,
    one "say" action per recipient."""
    return sum(1 + 2 * len(m["recipients"]) for m in raw)


# ---------------------------------------------------------------------------
# The port alone, on the CPU
# ---------------------------------------------------------------------------


def test_corpus_is_seeded():
    a, b = make_corpus(3, 50), make_corpus(3, 50)
    assert a == b and a != make_corpus(4, 50)
    assert all(8 <= len(m["text"].split()) <= 20 and 1 <= len(m["recipients"]) <= 3 for m in a)
    assert [m["timestamp"] for m in a] == sorted(m["timestamp"] for m in a)


@pytest.mark.parametrize("batches", [1, 3])
async def test_ingest_counts(batches):
    raw = make_corpus(11, 60)
    conv, results = await port_conversation(raw, batches)
    assert sum(r.messages_added for r in results) == 60
    assert sum(r.chunks_added for r in results) == 60
    semrefs = metadata_semrefs(raw) + 3 * 60  # the extractor: one entity, two topics
    assert sum(r.semrefs_added for r in results) == semrefs
    assert await conv.semantic_refs.size() == semrefs
    assert await conv.secondary_indexes.message_index.size() == 60
    assert await conv.secondary_indexes.timestamp_index.size() == 60
    hits = await conv.secondary_indexes.message_index.lookup_messages(raw[7]["text"])
    assert hits[0].message_ordinal == 7 and hits[0].score == pytest.approx(1.0, abs=1e-6)


async def test_snapshot_roundtrip_answers_the_same(tmp_path):
    raw = make_corpus(12, 80)
    conv, _ = await port_conversation(raw, 2)
    prefix = str(tmp_path / "chat")
    await write_snapshot(conv, prefix)
    again = await ChatConversation.read_from_file(prefix, port_settings(16))
    assert await again.messages.size() == 80
    assert await again.semantic_refs.size() == await conv.semantic_refs.size()
    for i in (0, 33, 79):
        want = await conv.secondary_indexes.message_index.lookup_messages(raw[i]["text"])
        got = await again.secondary_indexes.message_index.lookup_messages(raw[i]["text"])
        assert [(m.message_ordinal, m.score) for m in got] == [(m.message_ordinal, m.score) for m in want]
    # A second write of the reloaded conversation is the same snapshot.
    await again.write_to_file(prefix + "2")
    first = serialization.read_conversation_data_from_file(prefix)
    second = serialization.read_conversation_data_from_file(prefix + "2")
    assert first["semanticRefs"] == second["semanticRefs"]
    assert first["semanticIndexData"] == second["semanticIndexData"]


async def test_query_and_streaming_name_their_item():
    """``query()`` and ``add_messages_streaming`` run; what they still need
    from the HTTP chat adapters (the default chat model behind the
    translators and the default extractor) raises naming item 14."""
    conv, _ = await port_conversation(make_corpus(13, 5))
    with pytest.raises(NotImplementedError, match="item 14"):
        await conv.query("who spoke?")

    async def stream():
        for m in to_messages(make_corpus(13, 3), ConversationMessage, ConversationMessageMeta):
            yield m

    result = await conv.add_messages_streaming(stream())
    assert result.messages_added == 3 and await conv.messages.size() == 8
    conv.settings.semantic_ref_index_settings.knowledge_extractor = None
    with pytest.raises(NotImplementedError, match="item 14"):
        await conv.add_messages_streaming(stream())


async def test_dbname_names_item_12(tmp_path):
    """A ``dbname`` gives SQLite storage (ROADMAP.md Queue 1 item 12, ported);
    without a message type it raises, as in JAX."""
    from typeagent_tpu_torch.storage.sqlite import SqliteStorageProvider
    from typeagent_tpu_torch.storage.utils import create_storage_provider

    db = str(tmp_path / "chat.db")
    conv = await create_conversation(db, ConversationMessage, settings=port_settings(16))
    assert isinstance(conv.settings.storage_provider, SqliteStorageProvider)
    await conv.settings.storage_provider.close()
    settings = port_settings(16)
    with pytest.raises(ValueError, match="Message type"):
        await create_storage_provider(
            settings.message_text_index_settings, settings.related_term_index_settings, db
        )


async def test_default_extractor_names_item_14():
    settings = port_settings(16)
    settings.semantic_ref_index_settings.knowledge_extractor = None
    conv = await create_conversation(None, ConversationMessage, settings=settings)
    msgs = to_messages(make_corpus(14, 2), ConversationMessage, ConversationMessageMeta)
    with pytest.raises(NotImplementedError, match="item 14"):
        await conv.add_messages_with_indexing(msgs)
    # With extraction off, the metadata knowledge alone is indexed.
    settings.semantic_ref_index_settings.auto_extract_knowledge = False
    conv = await create_conversation(None, ConversationMessage, settings=settings)
    result = await conv.add_messages_with_indexing(msgs)
    assert result.messages_added == 2 and result.semrefs_added > 0


def test_settings_without_a_model_name_item_14():
    with pytest.raises(NotImplementedError, match="item 14"):
        ConversationSettings()


def test_settings_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConversationSettings(create_test_embedding_model(8))
    settings = ConversationSettings(create_test_embedding_model(8), device="cpu")
    for s in (settings.message_text_index_settings.embedding_index_settings,
              settings.related_term_index_settings.embedding_index_settings,
              settings.thread_settings):
        assert s.device == torch.device("cpu")


def test_lazy_exports():
    import typeagent_tpu_torch as pkg

    assert pkg.ConversationMessage is ConversationMessage
    assert pkg.ConversationMessageMeta is ConversationMessageMeta
    assert pkg.ConversationSettings is ConversationSettings
    assert pkg.ConversationBase is ConversationBase
    with pytest.raises(AttributeError):
        pkg.no_such_name


def test_extract_is_deterministic():
    out = asyncio.run(WordExtractor().extract("alpha beta gamma delta"))
    k = out.value
    assert [e.name for e in k.entities] == ["alpha"] and k.topics == ["beta", "gamma"]


async def test_threads_snapshot_and_reload(tmp_path):
    """Threads (index 6) are written with their embeddings as JSON floats
    and read back into a store that answers the same thread lookup. (The
    JAX package writes numpy floats there, which ``json`` refuses.)"""
    from typeagent_tpu_torch.knowpro.interfaces import TextLocation, TextRange, Thread

    conv, _ = await port_conversation(make_corpus(15, 20))
    threads = conv.secondary_indexes.threads
    await threads.add_thread(Thread("word1 word2 music", [TextRange(TextLocation(0), TextLocation(5))]))
    await threads.add_thread(Thread("speaker3 talks", [TextRange(TextLocation(7))]))
    prefix = str(tmp_path / "threads")
    await write_snapshot(conv, prefix)
    again = await ChatConversation.read_from_file(prefix, port_settings(16))
    got = again.secondary_indexes.threads
    assert [t.serialize() for t in got.threads] == [t.serialize() for t in threads.threads]
    want = await threads.lookup_thread("word1 music", max_matches=2, threshold_score=0.0)
    assert await got.lookup_thread("word1 music", max_matches=2, threshold_score=0.0) == want
