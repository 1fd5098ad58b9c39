"""Podcast ingestion CLI (parity role: reference tools/ingest_podcast.py).

The port of ``typeagent_tpu/tools/ingest_podcast.py``.
Run: ``python -m typeagent_tpu_torch.tools.ingest_podcast talk.txt -d out.db
--embedding-model test --no-extract-knowledge``.
"""

from __future__ import annotations

import argparse
import asyncio
from datetime import datetime

from ..knowpro.convsettings import ConversationSettings
from ..podcasts.podcast_ingest import ingest_podcast
from ..utils.misc import load_dotenv
from . import add_device_argument


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="Ingest a podcast transcript")
    parser.add_argument("file", help="Transcript text file (SPEAKER: turns)")
    parser.add_argument("--database", "-d", help="SQLite database (default: memory)")
    parser.add_argument("--name", help="Podcast name (default: filename)")
    parser.add_argument("--start-date", help="Base date (ISO), default Unix epoch")
    parser.add_argument("--length-minutes", type=float, default=60.0)
    parser.add_argument("--batch-size", type=int, default=0)
    parser.add_argument("--start-message", type=int, default=0)
    parser.add_argument("--concurrency", type=int, default=0)
    parser.add_argument(
        "--no-extract-knowledge",
        action="store_true",
        help="Skip LLM knowledge extraction (no API keys needed)",
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument("--write-index", help="Write JSON index snapshot prefix")
    parser.add_argument(
        "--embedding-model",
        help="provider:model embedding spec (use 'test' for offline fake)",
    )
    add_device_argument(parser)
    args = parser.parse_args()

    async def run() -> None:
        if args.embedding_model:
            from ..models.adapters import create_embedding_model

            settings = ConversationSettings(
                model=create_embedding_model(args.embedding_model), device=args.device
            )
        else:
            settings = ConversationSettings(device=args.device)
        if args.no_extract_knowledge:
            settings.semantic_ref_index_settings.auto_extract_knowledge = False
        start_date = (
            datetime.fromisoformat(args.start_date) if args.start_date else None
        )
        pod = await ingest_podcast(
            args.file,
            settings,
            podcast_name=args.name,
            start_date=start_date,
            length_minutes=args.length_minutes,
            dbname=args.database,
            batch_size=args.batch_size,
            start_message=args.start_message,
            concurrency=args.concurrency,
            verbose=args.verbose,
        )
        print(
            f"Ingested {await pod.messages.size()} messages, "
            f"{await pod.semantic_refs.size()} semantic refs"
        )
        if args.write_index:
            await pod.write_to_file(args.write_index)
            print(f"Wrote snapshot to {args.write_index}_data.json")

    asyncio.run(run())


if __name__ == "__main__":
    main()
