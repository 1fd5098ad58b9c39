"""Parity on a mesh: a conversation whose embedding indexes ride the
row-sharded store and whose stage-3 engine runs data parallel, in both
packages.

The same seed-made conversation (``test_torch_conv_corpus``'s corpus and
extractor, d = 16) is built in each package with ``ConversationSettings(
mesh=...)`` on a (dp=2, shard=4) mesh (the JAX package's 8 virtual CPU
devices, the port's ``[cpu] * 8``), given that mesh as ``_device_mesh``,
and asked ``make_questions``' 16 questions through ``query()`` with the
canned chat model on the default device engine. Every question stays on
the engine in both; stage 3 agrees to 1e-4 (f32 device sums) up to ties,
the answers are equal, and the port's answers equal those of its one-device
conversation.
"""

import asyncio

import jax
import pytest
import torch

from typeagent_tpu.knowpro import kplib as jkplib
from typeagent_tpu.knowpro import searchlang as jsearchlang
from typeagent_tpu.knowpro.factory import create_conversation as jcreate
from typeagent_tpu.knowpro.universal_message import ConversationMessage as JMessage
from typeagent_tpu.knowpro.universal_message import ConversationMessageMeta as JMeta
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu.models.canned import CannedChatModel as JCanned
from typeagent_tpu.models.result import Success as JSuccess
from typeagent_tpu.knowpro import fields as jfields
from typeagent_tpu.knowpro.convsettings import ConversationSettings as JSettings
from typeagent_tpu.parallel import create_mesh as jax_create_mesh

from typeagent_tpu_torch import create_conversation
from typeagent_tpu_torch.knowpro import fields, searchlang
from typeagent_tpu_torch.knowpro.convsettings import ConversationSettings
from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage, ConversationMessageMeta
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.models.canned import CannedChatModel
from typeagent_tpu_torch.parallel import create_mesh

from test_torch_conv_corpus import QUESTION_KINDS, WordExtractor, ingest, make_corpus, make_questions
from test_torch_query_parity import TOL_DEVICE, _ask, _stage3_close

N = 240
SEED = 17


@pytest.fixture(scope="module")
def runs():
    raw = make_corpus(SEED, N)
    questions = make_questions(raw, SEED + 1)
    port_mesh = create_mesh(n_shard=4, n_dp=2, devices=[torch.device("cpu")] * 8)
    jmesh = jax_create_mesh(n_shard=4, n_dp=2, devices=jax.devices()[:8])

    async def go():
        out = {}
        for name, mesh in (("port", port_mesh), ("one", None)):
            settings = ConversationSettings(create_test_embedding_model(16), mesh=mesh, device="cpu")
            settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor()
            conv, _ = await ingest(create_conversation, settings, ConversationMessage,
                                   ConversationMessageMeta, raw, 2)
            conv._device_mesh = mesh
            out[name] = (await _ask(conv, CannedChatModel(questions), questions, searchlang,
                                    fields.serialize_object), conv)
        settings = JSettings(jax_model(16), mesh=jmesh)
        settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor(jkplib, JSuccess)
        jconv, _ = await ingest(jcreate, settings, JMessage, JMeta, raw, 2)
        jconv._device_mesh = jmesh
        out["jax"] = (await _ask(jconv, JCanned(questions), questions, jsearchlang,
                                 jfields.serialize_object), jconv)
        return out

    return asyncio.run(go())


def test_mesh_conversation_indexes_are_sharded(runs):
    conv = runs["port"][1]
    store = conv.secondary_indexes.message_index.text_location_index._embedding_index._vector_base
    assert store._sharded is not None and store._sharded.mesh.devices.shape == (2, 4)
    assert conv._device_executor.mesh is not None and conv._device_executor._postings.dp_calls > 0


@pytest.mark.parametrize("i", range(len(QUESTION_KINDS)), ids=QUESTION_KINDS)
def test_mesh_engine_matches_jax_and_one_device(runs, i):
    port, jax_run, one = runs["port"][0][i], runs["jax"][0][i], runs["one"][0][i]
    assert port["route"] == jax_run["route"] == "device"
    _stage3_close(port, jax_run, TOL_DEVICE)
    assert port["answer"] == jax_run["answer"] == one["answer"]
    assert port["results"] == one["results"]
