"""``ConversationCorpus`` of the port (``parallel/conversation_corpus.py``)
against the JAX package's.

The tests of ``tests/test_mesh_conversation.py`` run against the port
through ``test_torch_query_suites.mirror`` on a (dp=2, shard=4) mesh of
CPU devices (the JAX suite's 8 virtual CPU devices): conversations whose
embedding indexes ride the row-sharded store, held to the one-device
store, and the corpus on the mesh, its checkpoint and resume included.

Then each package builds a corpus over the same three conversations from
the same seed-made messages (``test_torch_conv_corpus.make_corpus``, the
test embedding model at d = 16): two in memory storage and one in SQLite,
so both branches of ``refresh()`` run, then more messages into one of them
and a ``refresh()``. ``search_embedding`` on the same numpy queries,
globally and scoped to each conversation and to two, must give the same
hits (conversation, message and chunk ordinals equal except among scores
tied within 1e-6; scores within 1e-6), and ``query_all`` with the canned
chat model the same per-conversation and combined answers.
"""

import asyncio

import numpy as np
import pytest
import torch

from test_torch_conv_corpus import WordExtractor, ingest, make_corpus, make_questions, port_settings, to_messages
from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu.knowpro import answers as janswers
from typeagent_tpu.knowpro import kplib as jkplib
from typeagent_tpu.knowpro import searchlang as jsearchlang
from typeagent_tpu.knowpro.convsettings import ConversationSettings as JSettings
from typeagent_tpu.knowpro.factory import create_conversation as jcreate
from typeagent_tpu.knowpro.universal_message import ConversationMessage as JMessage
from typeagent_tpu.knowpro.universal_message import ConversationMessageMeta as JMeta
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu.models.canned import CannedChatModel as JCanned
from typeagent_tpu.models.result import Success as JSuccess
from typeagent_tpu.parallel import ConversationCorpus as JCorpus
from typeagent_tpu_torch import create_conversation
from typeagent_tpu_torch.knowpro import answers, searchlang
from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage, ConversationMessageMeta
from typeagent_tpu_torch.models.canned import CannedChatModel
from typeagent_tpu_torch.knowpro.interfaces import TextLocation
from typeagent_tpu_torch.parallel import ConversationCorpus, create_mesh

SUITES = ("test_mesh_conversation.py",)
EXCLUDED: dict = {}
DROPPED = {"test_mesh_conversation.py": ("from typeagent_tpu.parallel import create_mesh",)}
REWRITE = {"test_mesh_conversation.py": (
    ("ConversationCorpus(dim=24, mesh=mesh)", 'ConversationCorpus(dim=24, mesh=mesh, device="cpu")'),
)}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), DROPPED, REWRITE)


@pytest.fixture(scope="module")
def mesh():
    """The suite's (dp=2, shard=4) mesh, on the CPU."""
    return create_mesh(n_shard=4, n_dp=2, devices=[torch.device("cpu")] * 8)


def test_every_corpus_test_is_mirrored_or_excluded():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


D = 16
TOL = 1e-6
SIZES = {"podcast": 60, "mailbox": 45, "notes": 30}


def jax_settings() -> JSettings:
    settings = JSettings(jax_model(D))
    settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor(jkplib, JSuccess)
    return settings


async def _build(pkg: str, tmp_path):
    """Three conversations (``notes`` in SQLite) and a corpus over them;
    then 10 more messages into ``podcast`` and a refresh."""
    if pkg == "jax":
        create, settings_of, msg, meta = jcreate, jax_settings, JMessage, JMeta
        corpus = JCorpus(dim=D)
    else:
        create, settings_of, msg, meta = create_conversation, lambda: port_settings(D), ConversationMessage, ConversationMessageMeta
        corpus = ConversationCorpus(dim=D, device="cpu")
    convs = {}
    for i, (name, n) in enumerate(SIZES.items()):
        db = str(tmp_path / f"{pkg}_{name}.db") if name == "notes" else None
        convs[name], _ = await ingest(create, settings_of(), msg, meta, make_corpus(100 + i, n), 2, db)
        await corpus.add_conversation(name, convs[name])
    more = to_messages(make_corpus(200, 10), msg, meta)
    await convs["podcast"].add_messages_with_indexing(more)
    appended = await corpus.refresh()
    return corpus, convs, appended


def _same_hits(got, want, what):
    assert len(got) == len(want), what
    np.testing.assert_allclose([h.score for h in got], [h.score for h in want], rtol=0, atol=TOL, err_msg=what)
    for g, w in zip(got, want):
        key = (g.conversation, g.message_ordinal, g.chunk_ordinal)
        if key != (w.conversation, w.message_ordinal, w.chunk_ordinal):
            ties = [(h.conversation, h.message_ordinal, h.chunk_ordinal) for h in want if abs(h.score - w.score) <= TOL]
            assert key in ties, what


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpus")

    async def both():
        return await _build("jax", tmp), await _build("port", tmp)

    return asyncio.run(both())


def test_corpora_mirror_the_same_rows(corpora):
    (jcorpus, _, jappended), (pcorpus, _, pappended) = corpora
    assert pappended == jappended == 10
    assert pcorpus.conversations == jcorpus.conversations == list(SIZES)
    assert len(pcorpus._store) == len(jcorpus._store) == sum(SIZES.values()) + 10
    assert pcorpus._synced_counts == jcorpus._synced_counts
    for name in SIZES:
        assert [(l.message_ordinal, l.chunk_ordinal) for l in pcorpus._locations[name]] == [
            (l.message_ordinal, l.chunk_ordinal) for l in jcorpus._locations[name]]


@pytest.mark.parametrize("scope", [None, ["podcast"], ["mailbox"], ["notes"], ["podcast", "notes"]])
def test_search_embedding_matches(corpora, scope):
    (jcorpus, _, _), (pcorpus, _, _) = corpora
    rng = np.random.default_rng(7)
    for q in rng.standard_normal((8, D)).astype(np.float32):
        for k in (1, 10, 40):
            got = pcorpus.search_embedding(q, k=k, conversations=scope)
            want = jcorpus.search_embedding(q, k=k, conversations=scope)
            _same_hits(got, want, f"{scope} k={k}")
            assert all(h.conversation in (scope or SIZES) for h in got)
    merged = pcorpus.merge_by_message(pcorpus.search_embedding(q, k=20, conversations=scope))
    jmerged = jcorpus.merge_by_message(jcorpus.search_embedding(q, k=20, conversations=scope))
    assert len(merged) == len(jmerged)
    np.testing.assert_allclose([m.score for _, m in merged], [m.score for _, m in jmerged], rtol=0, atol=TOL)
    for (c, m), (jc, jm) in zip(merged, jmerged):
        if (c, m.message_ordinal) != (jc, jm.message_ordinal):
            assert (c, m.message_ordinal) in [(x, y.message_ordinal) for x, y in jmerged
                                              if abs(y.score - jm.score) <= TOL]


def test_search_text_finds_a_message_in_both(corpora):
    (jcorpus, jconvs, _), (pcorpus, pconvs, _) = corpora
    text = make_corpus(101, SIZES["mailbox"])[7]["text"]

    async def run():
        return (await pcorpus.search_text(text, k=3, conversations=["mailbox"]),
                await jcorpus.search_text(text, k=3, conversations=["mailbox"]))

    got, want = asyncio.run(run())
    _same_hits(got, want, "search_text")
    assert (got[0].conversation, got[0].message_ordinal) == ("mailbox", 7)


def test_query_all_matches(corpora):
    (jcorpus, _, _), (pcorpus, _, _) = corpora
    questions = make_questions(make_corpus(100, SIZES["podcast"]), 9)
    for scope in (None, ["mailbox", "notes"]):
        for question in list(questions)[:6]:
            out = {}
            for name, corpus, canned, lang, ans in (
                ("jax", jcorpus, JCanned, jsearchlang, janswers),
                ("port", pcorpus, CannedChatModel, searchlang, answers),
            ):
                model = canned(questions)
                per_conv, combined = asyncio.run(corpus.query_all(
                    question, lang.create_search_query_translator(model),
                    ans.create_answer_translator(model), conversations=scope))
                out[name] = ({k: (v.type, v.answer, v.why_no_answer) for k, v in per_conv.items()},
                             (combined.type, combined.answer, combined.why_no_answer), dict(model.calls))
            assert out["port"] == out["jax"], question
            assert out["port"][2]["stage1"] == 1  # one translation shared by every conversation


def test_mesh_and_checkpoints_name_item_9(tmp_path):
    """The mesh and checkpoints that ROADMAP.md Queue 1 item 9 ported: a
    corpus on a (2, 2) mesh saves and loads onto one device and onto a
    (1, 4) mesh with the same hits; a non-mesh is refused."""
    with pytest.raises(TypeError, match="Mesh"):
        ConversationCorpus(dim=D, mesh=object(), device="cpu")
    corpus = ConversationCorpus(dim=D, mesh=create_mesh(n_shard=2, n_dp=2, devices=[torch.device("cpu")] * 4))
    rng = np.random.default_rng(3)
    corpus._store.append("a", rng.standard_normal((300, D)).astype(np.float32))
    corpus._locations["a"] = [TextLocation(i, 0) for i in range(300)]
    q = rng.standard_normal(D).astype(np.float32)
    want = corpus.search_embedding(q, k=5)
    corpus.save(tmp_path / "mirror")
    one = ConversationCorpus.load(tmp_path / "mirror", device="cpu")
    four = ConversationCorpus.load(
        tmp_path / "mirror", mesh=create_mesh(n_shard=4, devices=[torch.device("cpu")] * 4))
    assert one.search_embedding(q, k=5) == four.search_embedding(q, k=5) == want
    assert four._store._store.n_shard == 4 and one._store._store.n_shard == 1
