"""Stage-3 engine benchmark: fused device executor vs the host query VM.

Builds a synthetic conversation at a chosen knowledge scale (no LLM, no
network), compiles realistic query trees (or/or_max groups of search +
property terms with related terms and scopes), and times
``search_conversation_knowledge_batch`` through BOTH engines. Reports
ms/query and the device speedup. (The reference's VM evaluates queries
one at a time on the host — this quantifies what the compiled device
program buys at scale.)

The port of ``typeagent_tpu/tools/benchmark_engine.py``; the
conversation's indexes and the device engine run on ``--device`` (the
card unless ``cpu`` is named).
Run: ``python -m typeagent_tpu_torch.tools.benchmark_engine [--messages 2000]
[--queries 64] [--batch 16] [--device cpu]``
"""

from __future__ import annotations

import argparse
import asyncio
import random
import time

from typing import TYPE_CHECKING

from ..knowpro import kplib
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import (
    PropertySearchTerm,
    SearchTerm,
    SearchTermGroup,
    Term,
)
from ..knowpro.propindex import build_property_index
from ..knowpro.search import SearchOptions, search_conversation_knowledge_batch
from ..knowpro.semrefindex import add_knowledge_batch_to_semantic_ref_index
from ..knowpro.universal_message import ConversationMessage, ConversationMessageMeta
from ..models.adapters import create_test_embedding_model
from ..storage.utils import create_storage_provider
from . import add_device_argument

if TYPE_CHECKING:
    from ..knowpro.conversation_base import ConversationBase

VOCAB = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo "
    "lima mike november oscar papa quebec romeo sierra tango uniform victor "
    "whiskey xray yankee zulu amber birch cedar dahlia elm fern grove hazel"
).split()


async def build_conversation(
    n_messages: int, rng: random.Random, device: str = "cuda"
) -> "ConversationBase":
    settings = ConversationSettings(model=create_test_embedding_model(16), device=device)
    settings.semantic_ref_index_settings.auto_extract_knowledge = False
    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        None,
        ConversationMessage,
    )
    settings.storage_provider = provider
    from ..knowpro.conversation_base import ConversationBase

    conv = await ConversationBase.create(settings, name="bench")
    messages = [
        ConversationMessage(
            [f"message {i} about {rng.choice(VOCAB)} and {rng.choice(VOCAB)}"],
            ConversationMessageMeta(rng.choice(["Alice", "Bob", "Carol"])),
            timestamp=f"2024-01-{(i % 27) + 1:02d}T10:00:00Z",
        )
        for i in range(n_messages)
    ]
    await conv.messages.extend(messages)
    knowledge = []
    for i in range(n_messages):
        w1, w2, w3 = (rng.choice(VOCAB) for _ in range(3))
        knowledge.append(
            (
                i,
                0,
                kplib.KnowledgeResponse(
                    entities=[
                        kplib.ConcreteEntity(w1, ["thing", w2]),
                        kplib.ConcreteEntity(f"{w2} {w3}", ["pair"]),
                    ],
                    actions=[
                        kplib.Action(
                            verbs=[w3],
                            verb_tense="past",
                            subject_entity_name=w1,
                            object_entity_name=w2,
                        )
                    ],
                    inverse_actions=[],
                    topics=[w2, f"{w1} {w3}"],
                ),
            )
        )
    await add_knowledge_batch_to_semantic_ref_index(conv, knowledge)
    await build_property_index(conv)
    return conv


def make_queries(n: int, rng: random.Random) -> list[tuple[SearchTermGroup, None]]:
    selects = []
    for _ in range(n):
        w1, w2, w3 = (rng.choice(VOCAB) for _ in range(3))
        group = SearchTermGroup(
            boolean_op="or",
            terms=[
                SearchTermGroup(
                    boolean_op="or_max",
                    terms=[
                        PropertySearchTerm(
                            "name",
                            SearchTerm(
                                Term(w1, 100.0),
                                related_terms=[Term(w2, 0.9), Term(w3, 0.85)],
                            ),
                        ),
                        PropertySearchTerm(
                            "type", SearchTerm(Term(w2, 100.0), related_terms=[])
                        ),
                    ],
                ),
                SearchTerm(Term(w2, 10.0), related_terms=[Term(w1, 0.88)]),
                PropertySearchTerm(
                    "topic", SearchTerm(Term(w3, 10.0), related_terms=[])
                ),
            ],
        )
        selects.append((group, None))
    return selects


async def run_engine(
    conv: "ConversationBase", selects: list[tuple], batch: int, use_device: bool
) -> float:
    options = SearchOptions(exact_match=False)
    options.use_device_executor = use_device
    t0 = time.perf_counter()
    for start in range(0, len(selects), batch):
        await search_conversation_knowledge_batch(
            conv, selects[start : start + batch], options
        )
    return time.perf_counter() - t0


async def amain() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--messages", type=int, default=2000)
    parser.add_argument("--queries", type=int, default=64)
    parser.add_argument("--batch", type=int, default=16)
    add_device_argument(parser)
    args = parser.parse_args()

    rng = random.Random(11)
    conv = await build_conversation(args.messages, rng, args.device)
    n_semrefs = await conv.semantic_refs.size()
    print(f"{args.messages} messages, {n_semrefs} semrefs")
    selects = make_queries(args.queries, rng)

    # Warm both engines: device sync + ALL jit shape buckets compile on the
    # first full pass (the persistent compile cache keeps later processes
    # warm too); the second pass is the steady-state measurement.
    await run_engine(conv, selects, args.batch, True)
    await run_engine(conv, selects[:4], args.batch, False)

    t_dev = await run_engine(conv, selects, args.batch, True)
    t_host = await run_engine(conv, selects, args.batch, False)
    n = len(selects)
    print(
        f"device engine: {t_dev / n * 1000:.2f} ms/query "
        f"(batch {args.batch}: {t_dev / (n / args.batch) * 1000:.1f} ms/call)"
    )
    print(f"host VM:       {t_host / n * 1000:.2f} ms/query")
    print(f"speedup:       {t_host / t_dev:.2f}x")


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
