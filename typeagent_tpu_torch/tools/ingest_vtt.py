"""WebVTT ingestion CLI (parity role: reference tools/ingest_vtt.py).

The port of ``typeagent_tpu/tools/ingest_vtt.py``.
Run: ``python -m typeagent_tpu_torch.tools.ingest_vtt file.vtt -d out.db
--embedding-model test`` (``--device cpu`` without a card).
"""

from __future__ import annotations

import argparse
import asyncio
from datetime import datetime

from ..knowpro.convsettings import ConversationSettings
from ..transcripts.transcript_ingest import (
    get_transcript_duration,
    get_transcript_speakers,
    ingest_vtt_transcript,
)
from ..utils.misc import load_dotenv, timelog
from . import add_device_argument


def settings_from_spec(
    embedding_model_spec: str | None, device: str = "cuda"
) -> ConversationSettings:
    """Build settings, honoring an explicit provider:model embedding spec
    ('test' runs fully offline with the deterministic fake embedder)."""
    if embedding_model_spec:
        from ..models.adapters import create_embedding_model

        return ConversationSettings(
            model=create_embedding_model(embedding_model_spec), device=device
        )
    return ConversationSettings(device=device)


async def ingest_vtt_files(
    files: list[str],
    dbname: str | None,
    start_date: datetime | None,
    auto_extract: bool,
    text_speakers: bool,
    verbose: bool,
    embedding_model_spec: str | None = None,
    device: str = "cuda",
) -> None:
    for path in files:
        settings = settings_from_spec(embedding_model_spec, device)
        settings.semantic_ref_index_settings.auto_extract_knowledge = auto_extract
        if verbose:
            speakers = get_transcript_speakers(path, text_speakers)
            duration = get_transcript_duration(path)
            print(f"{path}: {len(speakers)} speakers, {duration:.0f}s")
        with timelog(f"ingest {path}", verbose=verbose):
            transcript = await ingest_vtt_transcript(
                path,
                settings,
                start_date=start_date,
                use_text_based_speaker_detection=text_speakers,
                dbname=dbname,
            )
        print(
            f"{path}: {await transcript.messages.size()} messages, "
            f"{await transcript.semantic_refs.size()} semantic refs"
        )


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="Ingest WebVTT transcripts")
    parser.add_argument("files", nargs="+", help=".vtt files")
    parser.add_argument("--database", "-d", help="SQLite database (default: memory)")
    parser.add_argument("--start-date", help="Base date (ISO), default Unix epoch")
    parser.add_argument(
        "--extract-knowledge",
        action="store_true",
        help="LLM knowledge extraction (requires API keys)",
    )
    parser.add_argument(
        "--text-speakers",
        action="store_true",
        help="Also detect speakers from text patterns",
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument(
        "--embedding-model",
        help="provider:model embedding spec (use 'test' for offline fake)",
    )
    add_device_argument(parser)
    args = parser.parse_args()
    start_date = datetime.fromisoformat(args.start_date) if args.start_date else None
    asyncio.run(
        ingest_vtt_files(
            args.files,
            args.database,
            start_date,
            args.extract_knowledge,
            args.text_speakers,
            args.verbose,
            args.embedding_model,
            args.device,
        )
    )


if __name__ == "__main__":
    main()
