"""Storage provider factory (parity: reference storage/utils.py:14-45).

The port of ``typeagent_tpu/storage/utils.py``.
"""

from __future__ import annotations

from ..knowpro.convsettings import MessageTextIndexSettings, RelatedTermIndexSettings
from ..knowpro.interfaces import ConversationMetadata, IMessage, IStorageProvider


async def create_storage_provider[TMessage: IMessage](
    message_text_settings: MessageTextIndexSettings,
    related_terms_settings: RelatedTermIndexSettings,
    dbname: str | None = None,
    message_type: type[TMessage] | None = None,
    metadata: ConversationMetadata | None = None,
) -> IStorageProvider[TMessage]:
    """Memory provider when dbname is None, SQLite otherwise."""
    if dbname is None:
        from .memory import MemoryStorageProvider

        return MemoryStorageProvider(
            message_text_settings, related_terms_settings, metadata=metadata
        )
    from .sqlite import SqliteStorageProvider

    if message_type is None:
        raise ValueError("Message type must be specified for SQLite storage")
    return SqliteStorageProvider(
        db_path=dbname,
        message_type=message_type,
        message_text_index_settings=message_text_settings,
        related_term_index_settings=related_terms_settings,
        metadata=metadata,
    )
