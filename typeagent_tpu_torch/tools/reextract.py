"""Retry knowledge extraction for chunks recorded in ChunkFailures.

(The reference defines the ChunkFailures table "so a future re-extract tool
can retry just the failed chunks" — this is that tool.) For each recorded
failure whose message exists in storage, re-run the extractor on that chunk;
on success, add the knowledge + secondary index entries and clear the record.
The port of ``typeagent_tpu/tools/reextract.py``.
Run: ``python -m typeagent_tpu_torch.tools.reextract -d conv.db``.
"""

from __future__ import annotations

import argparse
import asyncio

from ..knowpro import convknowledge
from ..knowpro.conversation_base import ConversationBase
from ..knowpro.interfaces import IKnowledgeExtractor
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import IndexingStartPoints
from ..knowpro.semrefindex import add_knowledge_batch_to_semantic_ref_index
from ..knowpro.propindex import add_to_property_index
from ..knowpro.universal_message import ConversationMessage
from ..models.result import Failure
from ..storage.utils import create_storage_provider
from ..utils.misc import load_dotenv
from . import add_device_argument


async def reextract_failed_chunks(
    conversation: ConversationBase,
    extractor: IKnowledgeExtractor | None = None,
    verbose: bool = False,
) -> tuple[int, int]:
    """Retry all recorded chunk failures. Returns (succeeded, still_failed)."""
    storage = conversation.storage_provider
    failures = await storage.get_chunk_failures()
    if not failures:
        return (0, 0)
    extractor = (
        extractor
        or conversation.settings.semantic_ref_index_settings.knowledge_extractor
        or convknowledge.KnowledgeExtractor()
    )
    message_count = await conversation.messages.size()
    succeeded = 0
    still_failed = 0
    for failure in failures:
        if failure.message_ordinal >= message_count:
            # The message itself was skipped at ingest (never stored); its
            # text is gone, so the chunk cannot be re-extracted here.
            still_failed += 1
            if verbose:
                print(
                    f"skip {failure.message_ordinal}.{failure.chunk_ordinal}: "
                    f"message not stored"
                )
            continue
        message = await conversation.messages.get_item(failure.message_ordinal)
        if failure.chunk_ordinal >= len(message.text_chunks):
            still_failed += 1
            continue
        text = message.text_chunks[failure.chunk_ordinal].strip()
        result = await extractor.extract(text)
        if isinstance(result, Failure):
            still_failed += 1
            if verbose:
                print(
                    f"retry failed {failure.message_ordinal}."
                    f"{failure.chunk_ordinal}: {result.message[:120]}"
                )
            continue
        async with storage:
            start = IndexingStartPoints(
                message_count=message_count,
                semref_count=await conversation.semantic_refs.size(),
            )
            await add_knowledge_batch_to_semantic_ref_index(
                conversation,
                [(failure.message_ordinal, failure.chunk_ordinal, result.value)],
            )
            await add_to_property_index(conversation, start.semref_count)
            await storage.clear_chunk_failure(
                failure.message_ordinal, failure.chunk_ordinal
            )
        succeeded += 1
        if verbose:
            print(f"re-extracted {failure.message_ordinal}.{failure.chunk_ordinal}")
    return (succeeded, still_failed)


async def amain() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="Retry failed chunk extractions")
    parser.add_argument("--database", "-d", required=True)
    parser.add_argument("--embedding-model", help="provider:model spec")
    parser.add_argument("--verbose", "-v", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args()

    if args.embedding_model:
        from ..models.adapters import create_embedding_model

        settings = ConversationSettings(
            model=create_embedding_model(args.embedding_model), device=args.device
        )
    else:
        settings = ConversationSettings(device=args.device)
    settings.storage_provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        args.database,
        ConversationMessage,
    )
    conversation = await ConversationBase.create(settings, name=args.database)
    succeeded, still_failed = await reextract_failed_chunks(
        conversation, verbose=args.verbose
    )
    print(f"re-extracted {succeeded} chunks; {still_failed} still failing")
    await settings.storage_provider.close()


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
