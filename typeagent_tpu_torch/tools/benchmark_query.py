"""Scoped term-lookup benchmark over a synthetic conversation.

(Parity role: reference tools/benchmark_query.py — lookup_term with scope
filtering over a SQLite-backed synthetic transcript, deterministic embedder.)

The port of ``typeagent_tpu/tools/benchmark_query.py``; the settings'
embedding indexes live on ``--device`` (the card unless ``cpu`` is named).
Run: ``python -m typeagent_tpu_torch.tools.benchmark_query``.
"""

from __future__ import annotations

import argparse
import asyncio
import statistics
import time

from typing import TYPE_CHECKING

from ..knowpro import kplib
from ..knowpro.collections import TextRangeCollection, TextRangesInScope
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import TextLocation, TextRange
from ..knowpro.query import lookup_term
from ..knowpro.semrefindex import add_knowledge_batch_to_semantic_ref_index
from ..knowpro.interfaces import Term
from ..knowpro.universal_message import ConversationMessage, ConversationMessageMeta
from ..models.adapters import create_test_embedding_model
from ..storage.utils import create_storage_provider
from . import add_device_argument

if TYPE_CHECKING:
    from ..knowpro.conversation_base import ConversationBase

WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo lima "
    "mike november oscar papa quebec romeo sierra tango uniform victor whiskey"
).split()


async def build_conversation(
    n_messages: int, dbname: str | None, device: str = "cuda"
) -> "ConversationBase":
    settings = ConversationSettings(model=create_test_embedding_model(32), device=device)
    settings.semantic_ref_index_settings.auto_extract_knowledge = False
    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        dbname,
        ConversationMessage,
    )
    settings.storage_provider = provider

    from ..knowpro.conversation_base import ConversationBase

    conv = await ConversationBase.create(settings, name="bench")
    messages = [
        ConversationMessage(
            [f"message {i} about {WORDS[i % len(WORDS)]}"],
            ConversationMessageMeta(f"speaker{i % 5}", []),
            timestamp=f"2024-01-{(i % 28) + 1:02d}T10:00:00Z",
        )
        for i in range(n_messages)
    ]
    async with provider:
        await conv.messages.extend(messages, index_messages=False)
        items = [
            (
                i,
                0,
                kplib.KnowledgeResponse(
                    entities=[
                        kplib.ConcreteEntity(WORDS[i % len(WORDS)], ["codeword"])
                    ],
                    actions=[],
                    inverse_actions=[],
                    topics=[WORDS[(i + 7) % len(WORDS)]],
                ),
            )
            for i in range(n_messages)
        ]
        await add_knowledge_batch_to_semantic_ref_index(conv, items)
    return conv


async def amain() -> None:
    parser = argparse.ArgumentParser(description="Scoped lookup_term benchmark")
    parser.add_argument("--messages", type=int, default=2000)
    parser.add_argument("--iterations", type=int, default=200)
    parser.add_argument("--database", "-d", default=None)
    add_device_argument(parser)
    args = parser.parse_args()

    conv = await build_conversation(args.messages, args.database, args.device)
    scope = TextRangesInScope()
    scope.add_text_ranges(
        TextRangeCollection(
            [TextRange(TextLocation(0), TextLocation(args.messages // 2))]
        )
    )

    times = []
    for i in range(args.iterations):
        term = Term(WORDS[i % len(WORDS)])
        t0 = time.perf_counter()
        await lookup_term(
            conv.semantic_ref_index, term, conv.semantic_refs, scope
        )
        times.append((time.perf_counter() - t0) * 1e6)
    print(
        f"lookup_term (scoped) over {args.messages} messages: "
        f"min {min(times):.0f}µs mean {statistics.mean(times):.0f}µs "
        f"median {statistics.median(times):.0f}µs max {max(times):.0f}µs"
    )


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
