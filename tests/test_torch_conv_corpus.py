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
  canned chat model of ``models/canned.py``);
* :func:`make_mailbox`, :func:`email_text` and :func:`mailbox_questions` —
  the same for a mailbox: seed-made emails with display names, Cc,
  replies and forwards, as RFC 5322 text, and 12 questions over them.
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
# A seed-made mailbox (the email domain's tests and chip_smoke.py phase 16)
# ---------------------------------------------------------------------------

_FIRST = ("Ada", "Ben", "Cleo", "Dev", "Eva", "Finn", "Gia", "Hugo", "Iris", "Jon",
          "Kai", "Lena", "Milo", "Nia", "Omar", "Pia", "Quinn", "Rosa", "Sam", "Tara")
_LAST = ("Abbott", "Brooks", "Chen")


def make_mailbox(seed: int, n: int, vocab: int = 200, correspondents: int = 60,
                 phrases: int = 400) -> list[dict]:
    """``n`` raw emails in date order: sender and 1-4 recipients (To, then
    Cc) among ``correspondents`` people with display names, a subject from
    ``phrases`` seed-made phrases, a body of 30-300 words of the corpus
    vocabulary; 30% replies to an earlier email (``In-Reply-To``, "Re:",
    the earlier body quoted under an "On ... wrote:" line) and 5% forwards
    ("Fwd:", the earlier email under a forwarded-message header)."""
    rng = np.random.default_rng(seed)
    people = [(f"{_FIRST[i % len(_FIRST)]} {_LAST[i // len(_FIRST) % len(_LAST)]}",
               f"{_FIRST[i % len(_FIRST)].lower()}.{_LAST[i // len(_FIRST) % len(_LAST)].lower()}{i}@example.com")
              for i in range(correspondents)]
    subjects = [" ".join(f"word{w}" for w in rng.integers(0, vocab, rng.integers(2, 6)))
                for _ in range(phrases)]
    out: list[dict] = []
    for i in range(n):
        who = rng.permutation(correspondents)[: 1 + int(rng.integers(1, 5))]
        n_to = int(rng.integers(1, len(who)))  # at least one To; the rest Cc
        body = " ".join(f"word{w}" for w in rng.integers(0, vocab, rng.integers(30, 301)))
        kind = rng.random()
        stamp = T0 + timedelta(seconds=int(i * 365 * 86400 / max(n, 1)) + int(rng.integers(0, 600)))
        m = {"id": f"<m{seed}.{i}@example.com>", "sender": people[who[0]],
             "to": [people[j] for j in who[1 : 1 + n_to]], "cc": [people[j] for j in who[1 + n_to :]],
             "subject": subjects[int(rng.integers(phrases))], "body": body, "date": stamp,
             "reply_to": None, "forward_of": None}
        if out and kind < 0.30:
            parent = out[int(rng.integers(len(out)))]
            m["reply_to"], m["subject"] = parent, "Re: " + parent["subject"].removeprefix("Re: ")
        elif out and kind < 0.35:
            parent = out[int(rng.integers(len(out)))]
            m["forward_of"], m["subject"] = parent, "Fwd: " + parent["subject"]
        out.append(m)
    return out


def _wrap(text: str, width: int = 76) -> str:
    lines, line = [], ""
    for word in text.split():
        if line and len(line) + 1 + len(word) > width:
            lines.append(line)
            line = word
        else:
            line = f"{line} {word}" if line else word
    return "\n".join(lines + [line])


def email_text(m: dict) -> str:
    """One raw email of :func:`make_mailbox` as RFC 5322 text."""
    from email.utils import format_datetime

    def addr(person):
        return f"{person[0]} <{person[1]}>"

    head = [f"From: {addr(m['sender'])}", f"To: {', '.join(map(addr, m['to']))}"]
    if m["cc"]:
        head.append(f"Cc: {', '.join(map(addr, m['cc']))}")
    head += [f"Subject: {m['subject']}", f"Date: {format_datetime(m['date'])}", f"Message-ID: {m['id']}"]
    body = _wrap(m["body"])
    if m["reply_to"] is not None:
        parent = m["reply_to"]
        head += [f"In-Reply-To: {parent['id']}", f"References: {parent['id']}"]
        quoted = "\n".join("> " + line for line in _wrap(parent["body"]).splitlines())
        body += f"\n\nOn {format_datetime(parent['date'])}, {addr(parent['sender'])} wrote:\n{quoted}"
    elif m["forward_of"] is not None:
        parent = m["forward_of"]
        body += ("\n\n---------- Forwarded message ---------\n"
                 f"From: {addr(parent['sender'])}\nSubject: {parent['subject']}\n\n{_wrap(parent['body'])}")
    head += ["MIME-Version: 1.0", 'Content-Type: text/plain; charset="us-ascii"',
             "Content-Transfer-Encoding: 7bit"]
    return "\n".join(head) + "\n\n" + body + "\n"


# The kinds of mailbox_questions, in order: a sender's display name with a
# subject word, a recipient (To or Cc) as an entity, a subject's words, a
# "sent" action from a sender to a recipient, a one-week date range with a
# word, two search expressions, and one that matches nothing.
MAILBOX_KINDS = ("sender", "sender", "recipient", "recipient", "subject", "subject",
                 "sent", "sent", "week", "week", "two", "nothing")


def mailbox_questions(raw: list[dict], seed: int) -> dict[str, dict]:
    """Question text -> its stage-1 ``searchQueryExpr`` JSON, one question
    of each of :data:`MAILBOX_KINDS`, from the mailbox's own people,
    subjects and dates."""
    rng = np.random.default_rng(seed)

    def email() -> dict:
        return raw[int(rng.integers(len(raw)))]

    def entity(name: str) -> dict:
        return {"name": name, "isNamePronoun": False}

    def day(t: datetime) -> dict:
        return {"date": {"day": t.day, "month": t.month, "year": t.year}}

    out = {}
    for i, kind in enumerate(MAILBOX_KINDS):
        m = email()
        words = m["subject"].removeprefix("Re: ").removeprefix("Fwd: ").split()
        if kind == "sender":
            text, filters = f"what did {m['sender'][0]} send about {words[0]}", [
                {"entitySearchTerms": [entity(m["sender"][0])], "searchTerms": [words[0]]}]
        elif kind == "recipient":
            person = (m["to"] + m["cc"])[-1][0]
            text, filters = f"what went to {person}", [{"entitySearchTerms": [entity(person)]}]
        elif kind == "subject":
            text, filters = f"what was written about {' '.join(words)}", [{"searchTerms": words}]
        elif kind == "sent":
            text, filters = f"what did {m['sender'][0]} send to {m['to'][0][0]}", [
                {"actionSearchTerm": {"actorEntities": [entity(m["sender"][0])], "isInformational": False,
                                      "actionVerbs": {"words": ["sent"], "tense": "Past"},
                                      "targetEntities": [entity(m["to"][0][0])]}}]
        elif kind == "week":
            start = m["date"].replace(hour=0, minute=0, second=0)
            text, filters = f"what was said about {words[0]} in the week of {start:%B %d}", [
                {"searchTerms": [words[0]], "timeRange": {"startDate": day(start),
                                                          "stopDate": day(start + timedelta(days=7))}}]
        elif kind == "two":
            other = email()
            out[f"Mail question {i}: what about {words[0]}, and what did {other['sender'][0]} send?"] = {
                "searchExpressions": [
                    {"rewrittenQuery": f"what about {words[0]}", "filters": [{"searchTerms": [words[0]]}]},
                    {"rewrittenQuery": f"what did {other['sender'][0]} send",
                     "filters": [{"entitySearchTerms": [entity(other["sender"][0])]}]},
                ]}
            continue
        else:  # nothing: a range before the mailbox
            text, filters = f"what was written about {words[0]} in 1990", [
                {"searchTerms": [words[0]], "timeRange": {
                    "startDate": {"date": {"day": 1, "month": 1, "year": 1990}},
                    "stopDate": {"date": {"day": 31, "month": 12, "year": 1990}}}}]
        out[f"Mail question {i}: {text}?"] = {"searchExpressions": [{"rewrittenQuery": text, "filters": filters}]}
    return out


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


async def test_query_and_streaming_name_their_item(monkeypatch):
    """``query()`` without translators and ``add_messages_streaming``
    without an extractor build the default HTTP chat model (ROADMAP.md
    Queue 1 item 14, ported) from the environment, as in JAX: here a
    loopback fake that answers stage 1, stage 4 and extraction."""
    from test_torch_fake_endpoint import FakeEndpoint, canned_responder, point_models_at

    conv, _ = await port_conversation(make_corpus(13, 5))
    first = (await conv.messages.get_item(0)).text_chunks[0].split()[0]
    stage1 = {"who spoke?": {"searchExpressions": [
        {"rewrittenQuery": "who spoke?", "filters": [{"searchTerms": [first]}]}]}}
    with FakeEndpoint(canned_responder(stage1)) as fake:
        point_models_at(fake, monkeypatch)
        answer = await conv.query("who spoke?")
        assert answer and "Search failed" not in answer and "No answer" not in answer

        async def stream():
            for m in to_messages(make_corpus(13, 3), ConversationMessage, ConversationMessageMeta):
                yield m

        result = await conv.add_messages_streaming(stream())
        assert result.messages_added == 3 and await conv.messages.size() == 8
        conv.settings.semantic_ref_index_settings.knowledge_extractor = None
        before = await conv.semantic_refs.size()
        result = await conv.add_messages_streaming(stream())
        assert result.messages_added == 3 and await conv.semantic_refs.size() - before == result.semrefs_added
        stats = fake.stats()
    assert stats["chat"] >= 2 + 3  # stage 1, stage 4, one extraction per message
    assert stats["embeddings"] == 0  # the settings' model is the test embedder


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


async def test_default_extractor_names_item_14(monkeypatch):
    """Without an extractor the default one runs over the default HTTP chat
    model (item 14, ported): the fake's extraction adds one entity and two
    topics a message, as ``WordExtractor`` does."""
    from test_torch_fake_endpoint import FakeEndpoint, canned_responder, point_models_at

    raw = make_corpus(14, 2)
    msgs = to_messages(raw, ConversationMessage, ConversationMessageMeta)
    settings = port_settings(16)
    settings.semantic_ref_index_settings.knowledge_extractor = None
    with FakeEndpoint(canned_responder()) as fake:
        point_models_at(fake, monkeypatch)
        conv = await create_conversation(None, ConversationMessage, settings=settings)
        result = await conv.add_messages_with_indexing(msgs)
    assert result.messages_added == 2 and result.semrefs_added == metadata_semrefs(raw) + 3 * 2
    assert fake.stats()["chat"] == 2
    # With extraction off, the metadata knowledge alone is indexed.
    settings = port_settings(16)
    settings.semantic_ref_index_settings.knowledge_extractor = None
    settings.semantic_ref_index_settings.auto_extract_knowledge = False
    conv = await create_conversation(None, ConversationMessage, settings=settings)
    result = await conv.add_messages_with_indexing(msgs)
    assert result.messages_added == 2 and result.semrefs_added == metadata_semrefs(raw)


async def test_settings_without_a_model_name_item_14(monkeypatch):
    """``ConversationSettings()`` builds the default HTTP embedding model
    from the environment (item 14, ported), as in JAX."""
    from test_torch_fake_endpoint import FakeEndpoint, hash_embedding, point_models_at

    from typeagent_tpu_torch.models.adapters import HttpEmbedder
    from typeagent_tpu_torch.models.embeddings import normalize

    with FakeEndpoint(dim=32) as fake:
        point_models_at(fake, monkeypatch)
        settings = ConversationSettings(device="cpu")
        model = settings.embedding_model
        assert isinstance(model._embedder, HttpEmbedder)
        assert model.model_name == "text-embedding-ada-002"
        assert settings.message_text_index_settings.embedding_index_settings.embedding_model is model
        got = await model.get_embedding("hello")
    np.testing.assert_allclose(got, normalize(hash_embedding("hello", 32)), rtol=0, atol=1e-6)


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
