"""Parity: a conversation built by the port's ingest half
(``typeagent_tpu_torch/knowpro``, ``storage/memory``) against the same
conversation built by the JAX package, on the same seed-made messages,
extractor output and fake embedding model (d = 16).

The port runs with ``device="cpu"``, so its stores take their kernels'
plain versions; the JAX stores run on the CPU as the JAX tests run them.
Compared: semrefs, the term, property and timestamp indexes and the
related-terms texts exactly; related-terms rows within 1e-6;
message-index lookups with ordinals equal apart from ties and scores
within 1e-6; the ``_data.json`` both packages write, as parsed JSON, and
their ``_embeddings.bin``, byte for byte; and snapshots loaded across.
"""

import json

import numpy as np
import pytest

from typeagent_tpu.knowpro import kplib as jkplib
from typeagent_tpu.knowpro import serialization as jser
from typeagent_tpu.knowpro.conversation_base import ConversationBase as JConversationBase
from typeagent_tpu.knowpro.convfiles import FileSerializedConversation as JFileSerialized
from typeagent_tpu.knowpro.convsettings import ConversationSettings as JSettings
from typeagent_tpu.knowpro.factory import create_conversation as jcreate
from typeagent_tpu.knowpro.universal_message import ConversationMessage as JMessage
from typeagent_tpu.knowpro.universal_message import ConversationMessageMeta as JMeta
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu.models.result import Success as JSuccess

from typeagent_tpu_torch.knowpro import serialization

from test_torch_conv_corpus import (
    ChatConversation,
    WordExtractor,
    ingest,
    make_corpus,
    port_conversation,
    port_settings,
    write_snapshot,
)

D = 16
N = 240
TOL = 1e-6


class JChatConversation(JFileSerialized, JConversationBase[JMessage]):
    message_type = JMessage


def jax_settings(d: int = D) -> JSettings:
    settings = JSettings(jax_model(d))
    settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor(jkplib, JSuccess)
    return settings


async def jax_conversation(raw, batches=1):
    return await ingest(jcreate, jax_settings(), JMessage, JMeta, raw, batches)


async def index_state(conv) -> dict:
    """Everything the ingest built, as plain data (the related-terms rows
    apart)."""
    si = conv.secondary_indexes
    props = si.property_to_semantic_ref_index
    fuzzy = si.term_to_related_terms_index.fuzzy_index.serialize()
    return {
        "messages": [m.serialize() for m in conv.messages.items],
        "semrefs": [r.serialize() for r in conv.semantic_refs.items],
        "terms": await conv.semantic_ref_index.serialize(),
        "props": await props.all_postings(),
        "timestamps": [(t.timestamp, t.range.serialize()) for t in si.timestamp_index._ranges],
        "related_texts": list(fuzzy["textItems"]),
        "aliases": await si.term_to_related_terms_index.aliases.serialize(),
        "message_rows": await si.message_index.size(),
        "indexed": await si.message_index.indexed_message_count(),
    }


def related_rows(conv) -> np.ndarray:
    return conv.secondary_indexes.term_to_related_terms_index.fuzzy_index.serialize()["embeddings"]


def assert_same_hits(got, want, what):
    """Message hits: scores within TOL; ordinals equal except where the
    reference's scores tie within TOL."""
    assert len(got) == len(want), what
    gs = np.array([h.score for h in got])
    ws = np.array([h.score for h in want])
    np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0, err_msg=what)
    for g, w in zip(got, want):
        if g.message_ordinal != w.message_ordinal:
            ties = [h.message_ordinal for h in want if abs(h.score - w.score) <= TOL]
            assert g.message_ordinal in ties, what


async def assert_same_lookups(port_conv, jax_conv, raw, what):
    pidx = port_conv.secondary_indexes.message_index
    jidx = jax_conv.secondary_indexes.message_index
    texts = [raw[i]["text"] for i in (0, 17, N // 2, N - 1)] + ["word3 word5 word8", "speaker2"]
    for text in texts:
        for kwargs in ({}, {"max_matches": 5, "threshold_score": 0.0}):
            got = await pidx.lookup_messages(text, **kwargs)
            want = await jidx.lookup_messages(text, **kwargs)
            assert_same_hits(got, want, f"{what}: {text!r} {kwargs}")
    # The related-terms fuzzy index at its default 50 matches.
    terms = ["word1", "word42", "speaker3", "say"]
    pt = await port_conv.secondary_indexes.term_to_related_terms_index.fuzzy_index.lookup_terms(terms)
    jt = await jax_conv.secondary_indexes.term_to_related_terms_index.fuzzy_index.lookup_terms(terms)
    for a, b in zip(pt, jt):
        assert len(a) == len(b)
        np.testing.assert_allclose([t.weight for t in a], [t.weight for t in b], atol=TOL, rtol=0)


@pytest.fixture(scope="module")
def raw():
    return make_corpus(20261016, N)


@pytest.mark.parametrize("batches", [1, 3])
async def test_ingest_builds_the_same_indexes(raw, batches):
    port_conv, port_results = await port_conversation(raw, batches, D)
    jax_conv, jax_results = await jax_conversation(raw, batches)
    assert [vars(r) for r in port_results] == [
        {k: getattr(r, k) for k in ("messages_added", "chunks_added", "semrefs_added", "messages_skipped")}
        for r in jax_results
    ]
    assert await index_state(port_conv) == await index_state(jax_conv)
    np.testing.assert_allclose(related_rows(port_conv), related_rows(jax_conv), atol=TOL, rtol=0)
    await assert_same_lookups(port_conv, jax_conv, raw, f"{batches} batch(es)")


async def test_one_batch_and_three_batches_index_the_same_messages(raw):
    """Batching reorders the semrefs (each batch's metadata knowledge comes
    before its extracted knowledge), not what they hold or what a lookup
    finds."""
    one, _ = await port_conversation(raw, 1, D)
    three, _ = await port_conversation(raw, 3, D)
    a, b = await index_state(one), await index_state(three)
    for key in ("messages", "timestamps", "message_rows", "indexed"):
        assert a[key] == b[key], key

    def content(state):
        return sorted(json.dumps({k: v for k, v in r.items() if k != "semanticRefOrdinal"}, sort_keys=True)
                      for r in state["semrefs"])

    assert content(a) == content(b)
    assert sorted(t["term"] for t in a["terms"]["items"]) == sorted(t["term"] for t in b["terms"]["items"])
    assert set(a["related_texts"]) == set(b["related_texts"])
    for i in (0, N // 3, N - 1):
        got = await three.secondary_indexes.message_index.lookup_messages(raw[i]["text"])
        want = await one.secondary_indexes.message_index.lookup_messages(raw[i]["text"])
        assert [(h.message_ordinal, h.score) for h in got] == [(h.message_ordinal, h.score) for h in want]


async def test_snapshot_files_are_the_same(raw, tmp_path):
    port_conv, _ = await port_conversation(raw, 3, D)
    jax_conv, _ = await jax_conversation(raw, 3)
    pp, jp = str(tmp_path / "port"), str(tmp_path / "jax")
    await write_snapshot(port_conv, pp)
    await write_snapshot(jax_conv, jp, JFileSerialized, jser)
    with open(pp + "_data.json") as f:
        port_json = json.load(f)
    with open(jp + "_data.json") as f:
        jax_json = json.load(f)
    assert port_json == jax_json
    with open(pp + "_embeddings.bin", "rb") as f:
        port_bin = f.read()
    with open(jp + "_embeddings.bin", "rb") as f:
        jax_bin = f.read()
    assert port_bin == jax_bin
    header = port_json["embeddingFileHeader"]
    assert len(port_bin) == 4 * D * (header["relatedCount"] + header["messageCount"])


@pytest.mark.parametrize("writer", ["port", "jax"])
async def test_snapshots_load_across_packages(raw, tmp_path, writer):
    port_conv, _ = await port_conversation(raw, 2, D)
    jax_conv, _ = await jax_conversation(raw, 2)
    prefix = str(tmp_path / writer)
    if writer == "port":
        await write_snapshot(port_conv, prefix)
    else:
        await write_snapshot(jax_conv, prefix, JFileSerialized, jser)
    port_loaded = await ChatConversation.read_from_file(prefix, port_settings(D))
    jax_loaded = await JChatConversation.read_from_file(prefix, jax_settings())
    assert await index_state(port_loaded) == await index_state(jax_loaded)
    assert await index_state(port_loaded) == await index_state(port_conv)
    await assert_same_lookups(port_loaded, jax_loaded, raw, f"{writer} snapshot")
    await assert_same_lookups(port_loaded, jax_conv, raw, f"{writer} snapshot vs JAX ingest")


def test_read_data_matches(raw, tmp_path):
    """The two readers give equal trees for one written pair."""
    import asyncio

    jax_conv, _ = asyncio.run(jax_conversation(raw[:40], 1))
    prefix = str(tmp_path / "j")
    asyncio.run(write_snapshot(jax_conv, prefix, JFileSerialized, jser))
    a = serialization.read_conversation_data_from_file(prefix)
    b = jser.read_conversation_data_from_file(prefix)
    for tree in (a, b):
        for keys in (("relatedTermsIndexData", "textEmbeddingData"), ("messageIndexData", "indexData")):
            node = tree
            for key in keys:
                node = node[key]
            node["embeddings"] = node["embeddings"].tobytes()
    assert a == b


async def test_port_thread_snapshot_loads_in_jax(raw, tmp_path):
    """A snapshot with threads, written by the port (the JAX package cannot
    write one: its thread embeddings are numpy floats), loads in the JAX
    package with the same threads and thread lookups."""
    from typeagent_tpu_torch.knowpro.interfaces import TextLocation, TextRange, Thread

    port_conv, _ = await port_conversation(raw[:30], 1, D)
    threads = port_conv.secondary_indexes.threads
    await threads.add_thread(Thread("word1 word2 music", [TextRange(TextLocation(0), TextLocation(5))]))
    await threads.add_thread(Thread("speaker3 talks", [TextRange(TextLocation(7))]))
    prefix = str(tmp_path / "threads")
    await write_snapshot(port_conv, prefix)
    jax_loaded = await JChatConversation.read_from_file(prefix, jax_settings())
    jt = jax_loaded.secondary_indexes.threads
    assert [t.serialize() for t in jt.threads] == [t.serialize() for t in threads.threads]
    want = await threads.lookup_thread("word1 music", max_matches=2, threshold_score=0.0)
    got = await jt.lookup_thread("word1 music", max_matches=2, threshold_score=0.0)
    assert [g.thread_ordinal for g in got] == [w.thread_ordinal for w in want]
    np.testing.assert_allclose([g.score for g in got], [w.score for w in want], atol=TOL, rtol=0)


async def test_commit_chunk_batch_matches(raw):
    """``_commit_chunk_batch`` (the commit step the streaming pipeline
    feeds precomputed knowledge and embeddings to) builds the same indexes
    in both packages, over two batches."""
    from dataclasses import dataclass

    from typeagent_tpu.knowpro.interfaces import TextLocation as JLoc
    from typeagent_tpu_torch import create_conversation
    from typeagent_tpu_torch.knowpro import kplib
    from typeagent_tpu_torch.knowpro.interfaces import TextLocation
    from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage, ConversationMessageMeta
    from typeagent_tpu_torch.models.adapters import create_test_embedding_model

    from test_torch_conv_corpus import to_messages

    @dataclass
    class Chunk:
        chunk_id: object
        chunk_count: int
        message: object
        extracted_knowledge: object
        chunk_embedding: np.ndarray
        related_terms: list
        related_term_embeddings: list

    model = create_test_embedding_model(D)
    part = raw[:60]
    chunk_rows = await model.get_embeddings_nocache([m["text"] for m in part])

    async def commit(create, settings, msg_cls, meta_cls, kp, success, loc_cls):
        conv = await create(None, msg_cls, settings=settings)
        storage = await settings.get_storage_provider()
        extractor = WordExtractor(kp, success)
        for lo, hi in ((0, 25), (25, 60)):
            messages = to_messages(part[lo:hi], msg_cls, meta_cls)
            chunks = []
            for pos, message in enumerate(messages):
                knowledge = (await extractor.extract(message.text_chunks[0])).value
                terms = [knowledge.entities[0].name.lower(), *knowledge.topics]
                chunks.append(Chunk(loc_cls(lo + pos, 0), 1, message, knowledge, chunk_rows[lo + pos],
                                    terms, list(await model.get_embeddings(terms))))
            await conv._commit_chunk_batch(storage, messages, chunks)
        return conv

    from typeagent_tpu_torch.models.result import Success

    port_conv = await commit(create_conversation, port_settings(D), ConversationMessage,
                             ConversationMessageMeta, kplib, Success, TextLocation)
    jax_conv = await commit(jcreate, jax_settings(), JMessage, JMeta, jkplib, JSuccess, JLoc)
    assert await index_state(port_conv) == await index_state(jax_conv)
    np.testing.assert_allclose(related_rows(port_conv), related_rows(jax_conv), atol=TOL, rtol=0)
    assert await port_conv.secondary_indexes.message_index.size() == 60
    for text in (part[0]["text"], part[59]["text"]):
        got = await port_conv.secondary_indexes.message_index.lookup_messages(text)
        want = await jax_conv.secondary_indexes.message_index.lookup_messages(text)
        assert_same_hits(got, want, text)
