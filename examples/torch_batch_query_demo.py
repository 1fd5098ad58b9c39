"""Batched device-engine queries + multi-conversation corpus search, on
the PyTorch port.

Runs fully offline (fake deterministic embeddings, no LLM): builds two
conversations, answers several structured queries in ONE fused device call
(`search_conversation_knowledge_batch`), and cross-searches both
conversations through a mesh-sharded `ConversationCorpus`. The port of
``batch_query_demo.py``.

Run: ``python examples/torch_batch_query_demo.py [--device cpu]`` (the
card by default; on the CPU the mesh is 8 CPU devices).
"""

import argparse
import asyncio
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from typeagent_tpu_torch import create_conversation
from typeagent_tpu_torch.knowpro.convsettings import ConversationSettings
from typeagent_tpu_torch.knowpro.interfaces import SearchTerm, SearchTermGroup, Term
from typeagent_tpu_torch.knowpro.search import (
    SearchOptions,
    search_conversation_knowledge_batch,
)
from typeagent_tpu_torch.knowpro.universal_message import (
    ConversationMessage,
    ConversationMessageMeta,
)
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.tools import add_device_argument


def msg(text, speaker, ts):
    return ConversationMessage(
        [text], ConversationMessageMeta(speaker, ["Listener"]), timestamp=ts
    )


async def build(name: str, lines: list[tuple[str, str]], device: str):
    settings = ConversationSettings(model=create_test_embedding_model(24), device=device)
    settings.semantic_ref_index_settings.auto_extract_knowledge = False
    conversation = await create_conversation(
        None, ConversationMessage, name, settings=settings
    )
    await conversation.add_messages_with_indexing(
        [
            msg(text, speaker, f"2024-05-{i + 1:02d}T10:00:00Z")
            for i, (speaker, text) in enumerate(lines)
        ]
    )
    return conversation


async def main(device: str) -> None:
    podcast = await build(
        "podcast",
        [
            ("Alice", "Bach composed the Goldberg Variations."),
            ("Bob", "Glenn Gould recorded them twice."),
            ("Alice", "The harpsichord original is my favorite."),
        ],
        device,
    )
    mailbox = await build(
        "mailbox",
        [
            ("Carol", "Budget review meeting moved to Thursday."),
            ("Dan", "Attaching the quarterly budget spreadsheet."),
        ],
        device,
    )

    # --- N structured queries, ONE fused device call -----------------------
    def term(text):
        return SearchTermGroup(boolean_op="or", terms=[SearchTerm(Term(text))])

    selects = [
        (term("Alice"), None),
        (term("Bob"), None),
        (term("Carol"), None),
    ]
    results = await search_conversation_knowledge_batch(
        podcast, selects, SearchOptions(exact_match=True)
    )
    for (group, _), matches in zip(selects, results):
        text = group.terms[0].term.text
        counts = {k: len(v.semantic_ref_matches) for k, v in (matches or {}).items()}
        print(f"batched knowledge query {text!r}: {counts}")

    # --- cross-conversation corpus search on a device mesh -----------------
    from typeagent_tpu_torch.parallel import ConversationCorpus, create_mesh

    # Every card on the shard axis; on the CPU, 8 CPU devices.
    mesh = create_mesh() if device == "cuda" else create_mesh(devices=[torch.device("cpu")] * 8)
    corpus = ConversationCorpus(dim=24, mesh=mesh)
    await corpus.add_conversation("podcast", podcast)
    await corpus.add_conversation("mailbox", mailbox)

    # (The fake embedder is hash-deterministic, so semantic similarity only
    # appears for exact text matches — use a real embedding model for fuzzy
    # cross-conversation search.)
    query = "Attaching the quarterly budget spreadsheet."
    hits = await corpus.search_text(query, k=2)
    print("corpus global:", [(h.conversation, h.message_ordinal, round(h.score, 3)) for h in hits])
    assert hits[0].conversation == "mailbox" and hits[0].message_ordinal == 1
    scoped = await corpus.search_text(query, k=2, conversations=["podcast"])
    print(
        "corpus scoped to podcast:",
        [(h.conversation, h.message_ordinal) for h in scoped],
    )
    assert all(h.conversation == "podcast" for h in scoped)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(parser)
    asyncio.run(main(parser.parse_args().device))
