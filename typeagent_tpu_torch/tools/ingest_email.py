"""Email ingestion CLI (parity role: reference tools/ingest_email.py —
date filters, offset/limit, dedupe via are_sources_ingested).

The port of ``typeagent_tpu/tools/ingest_email.py``; ``--device`` (and
``device=``) names where the embedding indexes live, the card by default.
Run: ``python -m typeagent_tpu_torch.tools.ingest_email mail_dump/ -d
mail.db`` (the models come from the environment: ``OPENAI_BASE_URL``,
``OPENAI_API_KEY``, ``OPENAI_EMBEDDING_MODEL``, or ``AZURE_OPENAI_*``).
"""

from __future__ import annotations

import argparse
import asyncio
from pathlib import Path

from ..emails.email_import import email_matches_date_filter, import_email_from_file
from ..emails.email_memory import EmailMemory
from ..emails.email_message import EmailMessage
from ..knowpro.convsettings import ConversationSettings
from ..storage.utils import create_storage_provider
from ..utils.misc import load_dotenv
from . import add_device_argument


async def ingest_emails(
    dir_path: str,
    dbname: str | None = None,
    after: str | None = None,
    before: str | None = None,
    offset: int = 0,
    limit: int | None = None,
    batch_size: int = 20,
    auto_extract: bool = True,
    verbose: bool = False,
    device: str = "cuda",
) -> EmailMemory:
    """Ingest .eml files from a directory, skipping already-ingested sources."""
    settings = ConversationSettings(device=device)
    settings.semantic_ref_index_settings.auto_extract_knowledge = auto_extract
    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        dbname,
        EmailMessage,
    )
    settings.storage_provider = provider
    memory = await EmailMemory.create(settings, name=dir_path)
    if not auto_extract:
        settings.semantic_ref_index_settings.auto_extract_knowledge = False

    files = sorted(p for p in Path(dir_path).iterdir() if p.is_file())
    files = files[offset : offset + limit if limit else None]

    emails: list[EmailMessage] = []
    for path in files:
        try:
            email = import_email_from_file(str(path))
        except Exception as e:
            print(f"skipping {path}: {e}")
            continue
        if not email_matches_date_filter(email.timestamp, after, before):
            continue
        email.source_id = email.metadata.id or str(path)
        emails.append(email)

    # Dedupe against already-ingested sources.
    ingested = await provider.are_sources_ingested([e.source_id for e in emails])
    emails = [e for e in emails if e.source_id not in ingested]
    if verbose:
        print(f"{len(emails)} new emails to ingest ({len(ingested)} already done)")

    async def stream():
        for email in emails:
            yield email

    result = await memory.add_messages_streaming(stream(), batch_size=batch_size)
    print(
        f"Ingested {result.messages_added} emails "
        f"({result.semrefs_added} semantic refs, "
        f"{result.messages_skipped} skipped)"
    )
    return memory


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="Ingest .eml files from a directory")
    parser.add_argument("dir", help="Directory of .eml files")
    parser.add_argument("--database", "-d", help="SQLite database (default: memory)")
    parser.add_argument("--after", help="Only emails at/after this ISO date")
    parser.add_argument("--before", help="Only emails before this ISO date")
    parser.add_argument("--offset", type=int, default=0)
    parser.add_argument("--limit", type=int)
    parser.add_argument("--batch-size", type=int, default=20)
    parser.add_argument("--no-extract-knowledge", action="store_true")
    parser.add_argument("--verbose", "-v", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()
    asyncio.run(
        ingest_emails(
            args.dir,
            args.database,
            args.after,
            args.before,
            args.offset,
            args.limit,
            args.batch_size,
            not args.no_extract_knowledge,
            args.verbose,
            args.device,
        )
    )


if __name__ == "__main__":
    main()
