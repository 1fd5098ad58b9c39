"""Factory for conversation objects (parity: reference knowpro/factory.py).

The port of ``typeagent_tpu/knowpro/factory.py``. With no settings given
it builds ``ConversationSettings()``: the default HTTP embedding model from
the environment, on the card.
"""

from __future__ import annotations

from ..storage.utils import create_storage_provider
from .conversation_base import ConversationBase
from .convsettings import ConversationSettings
from .interfaces import ConversationMetadata, IMessage, IStorageProvider
from .secindex import ConversationSecondaryIndexes


def _wire_storage[TMessage: IMessage](
    conversation: ConversationBase[TMessage],
    provider: IStorageProvider,
    settings: ConversationSettings,
) -> None:
    """Point the conversation's collections/indexes at the provider's."""
    conversation.storage_provider = provider
    conversation.messages = provider.messages
    conversation.semantic_refs = provider.semantic_refs
    conversation.semantic_ref_index = provider.semantic_ref_index
    conversation.secondary_indexes = ConversationSecondaryIndexes(
        provider, settings.related_term_index_settings
    )


async def create_conversation[TMessage: IMessage](
    dbname: str | None,
    message_type: type[TMessage],
    name: str = "",
    tags: list[str] | None = None,
    settings: ConversationSettings | None = None,
    extras: dict[str, str] | None = None,
) -> ConversationBase[TMessage]:
    """Create a fully initialized conversation (memory when dbname is None)."""
    if settings is None:
        settings = ConversationSettings()
        settings.semantic_ref_index_settings.auto_extract_knowledge = True

    provider = await create_storage_provider(
        message_text_settings=settings.message_text_index_settings,
        related_terms_settings=settings.related_term_index_settings,
        dbname=dbname,
        message_type=message_type,
        metadata=ConversationMetadata(
            name_tag=name or None, tags=tags, extra=extras
        ),
    )
    settings.storage_provider = provider

    conversation = ConversationBase(
        settings=settings, name=name, tags=list(tags or ())
    )
    _wire_storage(conversation, provider, settings)
    return conversation
