"""Retrieval-quality benchmark: hit rate / MRR over a min_score sweep.

(Parity role: reference tools/benchmark_embeddings.py +
repeat_embedding_benchmarks.py — the harness whose Episode-53 sweeps produced
the per-model default min_score table in `aitools/vectorbase.py:31-35`.)

Given a conversation (SQLite db or JSON snapshot), treats each message's own
text as the query that should retrieve it, sweeping min_score x max_hits and
reporting hit rate and MRR per cell.

The port of ``typeagent_tpu/tools/benchmark_embeddings.py``; the message
index lives on ``--device`` (the card unless ``cpu`` is named).
Run: ``python -m typeagent_tpu_torch.tools.benchmark_embeddings -d conv.db``.
"""

from __future__ import annotations

import argparse
import asyncio


from ..knowpro.convsettings import ConversationSettings
from ..knowpro.universal_message import ConversationMessage
from ..storage.utils import create_storage_provider
from ..utils.metrics import mrr as compute_mrr
from ..utils.misc import load_dotenv
from . import add_device_argument


async def evaluate(
    db: str | None,
    index_path: str | None,
    min_scores: list[float],
    max_hits_list: list[int],
    embedding_model_spec: str | None,
    limit: int | None,
    device: str = "cuda",
) -> None:
    if embedding_model_spec:
        from ..models.adapters import create_embedding_model

        settings = ConversationSettings(
            model=create_embedding_model(embedding_model_spec), device=device
        )
    else:
        settings = ConversationSettings(device=device)

    if index_path:
        from ..podcasts.podcast import Podcast

        conversation = await Podcast.read_from_file(index_path, settings)
        provider = settings.storage_provider
    else:
        provider = await create_storage_provider(
            settings.message_text_index_settings,
            settings.related_term_index_settings,
            db,
            ConversationMessage,
        )
        settings.storage_provider = provider

    message_index = provider.message_text_index
    messages = provider.messages
    n = await messages.size()
    if limit:
        n = min(n, limit)
    if n == 0:
        print("No messages to evaluate")
        return

    print(f"Evaluating self-retrieval over {n} messages")
    print(f"{'min_score':>10} {'max_hits':>9} {'hit_rate':>9} {'mrr':>7}")
    for min_score in min_scores:
        for max_hits in max_hits_list:
            hits = 0
            mrr_total = 0.0
            for ordinal in range(n):
                message = await messages.get_item(ordinal)
                if not message.text_chunks or not message.text_chunks[0].strip():
                    continue
                results = await message_index.lookup_messages(
                    message.text_chunks[0], max_hits, min_score
                )
                retrieved = [r.message_ordinal for r in results]
                if ordinal in retrieved:
                    hits += 1
                mrr_total += compute_mrr(retrieved, {ordinal})
            print(
                f"{min_score:>10.2f} {max_hits:>9} {hits / n:>9.3f} "
                f"{mrr_total / n:>7.3f}"
            )


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="Retrieval quality sweep")
    parser.add_argument("--database", "-d", help="SQLite database")
    parser.add_argument("--index-path", "-i", help="JSON snapshot prefix")
    parser.add_argument(
        "--min-scores", type=float, nargs="+", default=[0.0, 0.7, 0.74, 0.85, 0.93]
    )
    parser.add_argument("--max-hits", type=int, nargs="+", default=[1, 10])
    parser.add_argument("--embedding-model", help="provider:model spec")
    parser.add_argument("--limit", type=int, help="Max messages to evaluate")
    parser.add_argument(
        "--repeat",
        type=int,
        default=1,
        help="Run the sweep N times (parity: reference "
        "tools/repeat_embedding_benchmarks.py — stability across runs)",
    )
    add_device_argument(parser)
    args = parser.parse_args()

    async def runs():
        for i in range(args.repeat):
            if args.repeat > 1:
                print(f"=== run {i + 1}/{args.repeat} ===")
            await evaluate(
                args.database,
                args.index_path,
                args.min_scores,
                args.max_hits,
                args.embedding_model,
                args.limit,
                args.device,
            )

    asyncio.run(runs())


if __name__ == "__main__":
    main()
