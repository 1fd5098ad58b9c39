"""Parity: SQLite storage of the port (``typeagent_tpu_torch/storage/sqlite``)
against the JAX package's, on the same seed-made conversation
(``test_torch_conv_corpus.py``'s corpus and extractor, the fake embedding
model at d = 16, 2,000 messages in two ``add_messages_with_indexing``
calls), and the CLIs ``ingest_vtt`` and ``query --search`` of both
packages on ``tests/testdata/mini.vtt``.

The SQLite file is how state carries across: no conversion function is
needed, so the tests check that it carries.

* Every table of the two files is equal row by row, the embedding BLOBs
  byte for byte. Rows are compared in primary-key order: the
  related-terms fuzzy index adds a batch's new terms from a Python set, so
  the order it inserts them in follows the process's string hashing in
  either package (it reads them back ``ORDER BY term``). The metadata
  rows ``created_at`` and ``updated_at`` hold the wall clock of each run
  and are compared as keys only.
* A JAX-written file opened by the port answers message lookups as the
  JAX package answers them on the same file (ordinals equal apart from
  ties, scores within 1e-6), and the 16 questions of ``make_questions``
  through ``query()`` with the canned chat model, on each package's
  default route (its device engine), with the same answers; a
  port-written file the same way round.
* The port's SQLite conversation and its memory conversation give the
  same ``query()`` answers when the memory conversation's related-terms
  index holds each term once, as it does after one ingest call. After
  two calls it holds a term the second call meets again twice, in both
  packages (``storage/memory/reltermsindex.py`` keeps no set of added
  terms, the SQLite index does), so the k = 50 expansion reaches fewer
  distinct terms there and some answers differ: the same questions in the
  port as in the JAX package (ROADMAP.md Queue 3).
* ``ingest_vtt`` on ``mini.vtt`` gives equal files in both packages, and
  ``query --search`` prints the same lines on them.

The port runs on CPU tensors (``device="cpu"``; the CLIs ``--device cpu``).
"""

import asyncio
import contextlib
import io
import sqlite3
import sys

import numpy as np
import pytest

from typeagent_tpu.knowpro import answers as janswers
from typeagent_tpu.knowpro import searchlang as jsearchlang
from typeagent_tpu.knowpro.factory import create_conversation as jcreate
from typeagent_tpu.knowpro.universal_message import ConversationMessage as JMessage
from typeagent_tpu.knowpro.universal_message import ConversationMessageMeta as JMeta
from typeagent_tpu.models.canned import CannedChatModel as JCanned

from typeagent_tpu_torch import create_conversation
from typeagent_tpu_torch.knowpro import answers, searchlang
from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage, ConversationMessageMeta
from typeagent_tpu_torch.models.canned import CannedChatModel

from test_torch_conv_corpus import ingest, make_corpus, make_questions, port_settings
from test_torch_conversation import assert_same_hits, jax_settings

D = 16
N = 2000
SEED = 53
TOL = 1e-6
PROBES = (0, 1, 17, 999, 1500, 1999)
CLOCK_KEYS = ("created_at", "updated_at")
VTT = "tests/testdata/mini.vtt"


def tables(path: str) -> dict[str, list[tuple]]:
    """Every table's rows in primary-key order (all columns where the
    table has no declared key), the clock-valued metadata as keys alone."""
    db = sqlite3.connect(path)
    out = {}
    names = [r[0] for r in db.execute(
        "SELECT name FROM sqlite_master WHERE type = 'table' AND name NOT LIKE 'sqlite_%' ORDER BY name"
    )]
    for name in names:
        columns = db.execute(f"PRAGMA table_info({name})").fetchall()
        keys = [c[1] for c in sorted(columns, key=lambda c: c[5]) if c[5]] or [c[1] for c in columns]
        rows = db.execute(f"SELECT * FROM {name} ORDER BY {', '.join(keys)}").fetchall()
        if name == "ConversationMetadata":
            rows = [(k, None if k in CLOCK_KEYS else v) for k, v in rows]
        out[name] = rows
    db.close()
    return out


async def _close(conv) -> None:
    await conv.settings.storage_provider.close()


async def _port_open(path: str):
    return await create_conversation(path, ConversationMessage, settings=port_settings(D))


async def _jax_open(path: str):
    return await jcreate(path, JMessage, settings=jax_settings(D))


async def _answers(conv, model, questions, lang, answers_mod) -> list[str]:
    conv._query_translator = lang.create_search_query_translator(model)
    conv._answer_translator = answers_mod.create_answer_translator(model)
    return [await conv.query(q) for q in questions]


async def _lookups(conv, raw) -> list[list]:
    index = conv.secondary_indexes.message_index
    return [await index.lookup_messages(raw[i]["text"]) for i in PROBES]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both packages' files, each file opened by both packages: lookups,
    answers and the route of the last question, per (writer, reader)."""
    tmp = tmp_path_factory.mktemp("sqlite_parity")
    raw = make_corpus(SEED, N)
    questions = make_questions(raw, SEED + 1)
    files = {"port": str(tmp / "port.db"), "jax": str(tmp / "jax.db")}

    async def go():
        conv, _ = await ingest(create_conversation, port_settings(D), ConversationMessage,
                               ConversationMessageMeta, raw, 2, files["port"])
        await _close(conv)
        conv, _ = await ingest(jcreate, jax_settings(D), JMessage, JMeta, raw, 2, files["jax"])
        await _close(conv)
        memory = {}
        for batches in (1, 2):
            conv, _ = await ingest(create_conversation, port_settings(D), ConversationMessage,
                                   ConversationMessageMeta, raw, batches)
            memory["port", batches] = {
                "answers": await _answers(conv, CannedChatModel(questions), questions, searchlang, answers),
                "related": conv.secondary_indexes.term_to_related_terms_index.fuzzy_index.serialize()["textItems"],
            }
        conv, _ = await ingest(jcreate, jax_settings(D), JMessage, JMeta, raw, 2)
        memory["jax", 2] = {"answers": await _answers(conv, JCanned(questions), questions, jsearchlang, janswers)}
        conv, _ = await ingest(create_conversation, port_settings(D), ConversationMessage,
                               ConversationMessageMeta, raw, 1, str(tmp / "one_call.db"))
        memory["sqlite", 1] = {
            "answers": await _answers(conv, CannedChatModel(questions), questions, searchlang, answers)
        }
        await _close(conv)
        out = {}
        for writer, path in files.items():
            for reader, opener, canned, lang, ans in (
                ("port", _port_open, CannedChatModel, searchlang, answers),
                ("jax", _jax_open, JCanned, jsearchlang, janswers),
            ):
                conv = await opener(path)
                out[writer, reader] = {
                    "lookups": await _lookups(conv, raw),
                    "answers": await _answers(conv, canned(questions), questions, lang, ans),
                    "route": conv._last_engine_route,
                    "messages": await conv.messages.size(),
                }
                await _close(conv)
        return raw, files, out, memory

    return asyncio.run(go())


def test_tables_equal_row_by_row(built):
    _, files, _, _ = built
    port, jax = tables(files["port"]), tables(files["jax"])
    assert port.keys() == jax.keys()
    for name in port:
        assert port[name] == jax[name], name
    assert len(port["Messages"]) == N and len(port["MessageTextIndex"]) == N
    assert len(port["SemanticRefs"]) > N and len(port["RelatedTermsFuzzy"]) > 0
    # The BLOBs are f32 vectors of the model's width, bytes equal above.
    blob = port["MessageTextIndex"][0][2]
    assert isinstance(blob, bytes) and len(blob) == 4 * D


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_opens_in_the_other_package_with_the_same_lookups(built, writer):
    raw, _, out, _ = built
    got, want = out[writer, "port"], out[writer, "jax"]
    assert got["messages"] == want["messages"] == N
    for probe, g, w in zip(PROBES, got["lookups"], want["lookups"]):
        assert_same_hits(g, w, f"{writer}-written file, probe {probe}")
        assert g[0].message_ordinal == probe and g[0].score == pytest.approx(1.0, abs=TOL)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_file_answers_the_questions_as_the_jax_package(built, writer):
    _, _, out, _ = built
    got, want = out[writer, "port"], out[writer, "jax"]
    assert got["route"] == want["route"] == "device"
    assert got["answers"] == want["answers"]
    assert sum(not a.startswith("No answer found") for a in got["answers"]) == len(got["answers"]) - 1


def test_sqlite_and_memory_answer_the_same(built):
    _, _, _, memory = built
    one_call = memory["port", 1]
    assert len(one_call["related"]) == len(set(one_call["related"]))
    assert memory["sqlite", 1]["answers"] == one_call["answers"]
    assert sum(not a.startswith("No answer found") for a in one_call["answers"]) == len(one_call["answers"]) - 1


def test_memory_repeats_related_terms_as_the_jax_package(built):
    """After two ingest calls the memory related-terms index holds repeated
    terms and the SQLite one does not, in both packages alike: the answers
    that differ between the port's memory and SQLite conversations are the
    JAX package's, question by question (a fault of the memory index,
    ROADMAP.md Queue 3)."""
    _, files, out, memory = built
    related = memory["port", 2]["related"]
    db = sqlite3.connect(files["port"])
    stored = [r[0] for r in db.execute("SELECT term FROM RelatedTermsFuzzy")]
    db.close()
    assert len(stored) == len(set(stored)) == len(set(related)) < len(related)
    assert memory["port", 2]["answers"] == memory["jax", 2]["answers"]
    port_differ = [a != b for a, b in zip(memory["port", 2]["answers"], out["port", "port"]["answers"])]
    jax_differ = [a != b for a, b in zip(memory["jax", 2]["answers"], out["jax", "jax"]["answers"])]
    assert port_differ == jax_differ


def _run_cli(main, argv: list[str]) -> str:
    """A CLI's ``main()`` in this process with ``argv``; its stdout."""
    saved = sys.argv
    sys.argv = argv
    buffer = io.StringIO()
    try:
        with contextlib.redirect_stdout(buffer):
            main()
    finally:
        sys.argv = saved
    return buffer.getvalue()


def test_cli_ingest_vtt_and_search_match(tmp_path):
    from typeagent_tpu.tools import ingest_vtt as j_ingest, query as j_query
    from typeagent_tpu_torch.tools import ingest_vtt, query

    port_db, jax_db = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    port_out = _run_cli(ingest_vtt.main, ["ingest_vtt", VTT, "-d", port_db, "--embedding-model", "test",
                                          "--device", "cpu"])
    jax_out = _run_cli(j_ingest.main, ["ingest_vtt", VTT, "-d", jax_db, "--embedding-model", "test"])
    assert port_out == jax_out and "3 messages" in port_out
    assert tables(port_db) == tables(jax_db)

    search = ["--search", "baroque", "music", "--embedding-model", "test"]
    port_out = _run_cli(query.main, ["query", "-d", port_db, *search, "--device", "cpu"])
    jax_out = _run_cli(j_query.main, ["query", "-d", jax_db, *search])
    port_lines = port_out.replace(port_db, "<db>").splitlines()
    assert port_lines == jax_out.replace(jax_db, "<db>").splitlines()
    assert any(line.startswith("messages: ") and line != "messages: 0" for line in port_lines)


def test_blob_bytes_are_the_jax_bytes():
    from typeagent_tpu.storage.sqlite.schema import deserialize_embedding as jdeser
    from typeagent_tpu.storage.sqlite.schema import serialize_embedding as jser
    from typeagent_tpu_torch.storage.sqlite.schema import deserialize_embedding, serialize_embedding

    rng = np.random.default_rng(7)
    for v in (rng.standard_normal(384), rng.standard_normal(3).astype(np.float32), [0.5, -1.0]):
        assert serialize_embedding(v) == jser(v)
        np.testing.assert_array_equal(deserialize_embedding(jser(v)), jdeser(jser(v)))
    assert serialize_embedding(None) is None and deserialize_embedding(None) is None
