"""Parity: the port's streaming ingest (``knowpro/add_messages.py`` behind
``add_messages_streaming``) against the JAX package's, and against the
port's own batch ingest.

The same seed-made messages (``test_torch_conv_corpus.py``) are streamed
into a conversation of each package (d = 16, ``device="cpu"`` for the
port) in batches of 50. Compared:

* port streaming vs JAX streaming: the ``_data.json`` each writes, as
  parsed JSON, and ``_embeddings.bin``, byte for byte;
* port streaming vs ``add_messages_with_indexing`` over the same 50-message
  batches: every key of ``_data.json`` except the related-terms index and
  its row count. The two ingest paths of the JAX package fill that index
  differently (streaming: each chunk's extracted terms, facet names and
  values among them; batch: the terms each batch added to the term
  index, speakers and verbs among them), and the port keeps
  both as they are (ROADMAP Queue 3): :func:`test_related_terms_differ_as_in_jax`
  holds the difference to the JAX package's.
"""

import asyncio
import json

import pytest

from typeagent_tpu.knowpro import serialization as jser
from typeagent_tpu.knowpro.factory import create_conversation as jcreate
from typeagent_tpu.knowpro.universal_message import ConversationMessage as JMessage
from typeagent_tpu.knowpro.universal_message import ConversationMessageMeta as JMeta

from typeagent_tpu_torch import create_conversation
from typeagent_tpu_torch.knowpro.universal_message import (
    ConversationMessage,
    ConversationMessageMeta,
)

from test_torch_conv_corpus import (
    ingest,
    make_corpus,
    port_settings,
    to_messages,
    write_snapshot,
)
from test_torch_conversation import JFileSerialized, jax_settings

N = 400
BATCH = 50
D = 16


async def _streamed(create, settings, message_cls, meta_cls, raw):
    conv = await create(None, message_cls, settings=settings)

    async def stream():
        for m in to_messages(raw, message_cls, meta_cls):
            yield m

    committed = []
    result = await conv.add_messages_streaming(
        stream(), batch_size=BATCH, on_batch_committed=committed.append
    )
    return conv, result, committed


async def _snapshot(conv, prefix, mixin=None, ser=None) -> tuple[dict, bytes]:
    if mixin is None:
        await write_snapshot(conv, prefix)
    else:
        await write_snapshot(conv, prefix, mixin, ser)
    with open(prefix + "_data.json") as f:
        data = json.load(f)
    with open(prefix + "_embeddings.bin", "rb") as f:
        return data, f.read()


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    raw = make_corpus(23, N)
    tmp = tmp_path_factory.mktemp("streaming")

    async def go():
        port, port_result, port_batches = await _streamed(
            create_conversation, port_settings(D), ConversationMessage, ConversationMessageMeta, raw
        )
        jax, jax_result, jax_batches = await _streamed(jcreate, jax_settings(D), JMessage, JMeta, raw)
        batched, _ = await ingest(create_conversation, port_settings(D), ConversationMessage,
                                  ConversationMessageMeta, raw, N // BATCH)
        jax_batched, _ = await ingest(jcreate, jax_settings(D), JMessage, JMeta, raw, N // BATCH)
        return {
            "results": (port_result, jax_result),
            "batches": ([r.messages_added for r in port_batches], [r.messages_added for r in jax_batches]),
            "port": await _snapshot(port, str(tmp / "port")),
            "jax": await _snapshot(jax, str(tmp / "jax"), JFileSerialized, jser),
            "port_batched": await _snapshot(batched, str(tmp / "port_batched")),
            "jax_batched": await _snapshot(jax_batched, str(tmp / "jax_batched"), JFileSerialized, jser),
        }

    return asyncio.run(go())


def test_streaming_counts_equal_jax(snapshots):
    port, jax = snapshots["results"]
    assert (port.messages_added, port.chunks_added, port.semrefs_added, port.messages_skipped) == (
        jax.messages_added, jax.chunks_added, jax.semrefs_added, jax.messages_skipped)
    assert port.messages_added == N
    assert snapshots["batches"][0] == snapshots["batches"][1] == [BATCH] * (N // BATCH)


@pytest.mark.parametrize("key", [
    "nameTag", "messages", "tags", "semanticRefs", "semanticIndexData",
    "relatedTermsIndexData", "threadData", "messageIndexData", "fileHeader", "embeddingFileHeader",
])
def test_streaming_data_json_equals_jax(snapshots, key):
    (port, _), (jax, _) = snapshots["port"], snapshots["jax"]
    assert port.keys() == jax.keys()
    assert port[key] == jax[key]


def test_streaming_embeddings_bin_equals_jax(snapshots):
    assert snapshots["port"][1] == snapshots["jax"][1]


def _without_related_terms(data: dict) -> dict:
    data = json.loads(json.dumps(data))
    data.pop("relatedTermsIndexData")
    data["embeddingFileHeader"].pop("relatedCount")
    return data


def test_streaming_equals_batch_ingest_but_related_terms(snapshots):
    streamed, _ = snapshots["port"]
    batched, _ = snapshots["port_batched"]
    assert _without_related_terms(streamed) == _without_related_terms(batched)


def test_related_terms_differ_as_in_jax(snapshots):
    """Both packages: the streamed related-terms index holds each chunk's
    extracted terms (facet names and values among them), the batch one the
    terms each batch added to the term index (speakers and verbs among
    them); the port's two lists are the JAX package's."""
    def texts(snapshot):
        return snapshot[0]["relatedTermsIndexData"]["textEmbeddingData"]["textItems"]

    port_s, port_b = texts(snapshots["port"]), texts(snapshots["port_batched"])
    jax_s, jax_b = texts(snapshots["jax"]), texts(snapshots["jax_batched"])
    assert port_s == jax_s and port_b == jax_b
    assert {"length", "word"} <= set(port_s) - set(port_b)
    assert {"say", "speaker0"} <= set(port_b) - set(port_s)
