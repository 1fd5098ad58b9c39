"""Secondary-index wiring + full builds (parity: reference knowpro/secindex.py).

The port of ``typeagent_tpu/knowpro/secindex.py`` (plain Python, the same code).

The six indexes live on the storage provider; this module exposes them under
the IConversationSecondaryIndexes protocol and provides the bulk (re)build
entry points used after deserialization or batch ingest.
"""

from __future__ import annotations

from ..storage.memory.indexes import build_timestamp_index
from ..storage.memory.messageindex import build_message_index
from ..storage.memory.reltermsindex import build_related_terms_index
from .convsettings import ConversationSettings, RelatedTermIndexSettings
from .interfaces import (
    IConversation,
    IConversationSecondaryIndexes,
    IMessage,
    IStorageProvider,
    ITermToSemanticRefIndex,
)
from .propindex import build_property_index


class ConversationSecondaryIndexes(IConversationSecondaryIndexes):
    """Thin view: every secondary index is owned by the storage provider."""

    def __init__(
        self,
        storage_provider: IStorageProvider,
        settings: RelatedTermIndexSettings | None = None,
    ):
        self._storage_provider = storage_provider
        provider = storage_provider
        self.property_to_semantic_ref_index = provider.property_index
        self.timestamp_index = provider.timestamp_index
        self.term_to_related_terms_index = provider.related_terms_index
        self.threads = provider.conversation_threads
        self.message_index = provider.message_text_index


async def _ensure_wired(
    conversation: IConversation, settings: ConversationSettings
) -> IStorageProvider:
    provider = await settings.get_storage_provider()
    if conversation.secondary_indexes is None:
        conversation.secondary_indexes = ConversationSecondaryIndexes(
            provider, settings.related_term_index_settings
        )
    return provider


async def build_transient_secondary_indexes[
    TMessage: IMessage, TTermToSemanticRefIndex: ITermToSemanticRefIndex
](
    conversation: IConversation[TMessage, TTermToSemanticRefIndex],
    settings: ConversationSettings,
) -> None:
    """Property + timestamp indexes (derivable from semrefs/messages)."""
    await _ensure_wired(conversation, settings)
    await build_property_index(conversation)
    await build_timestamp_index(conversation)


async def build_secondary_indexes[
    TMessage: IMessage,
    TTermToSemanticRefIndex: ITermToSemanticRefIndex,
](
    conversation: IConversation[TMessage, TTermToSemanticRefIndex],
    conversation_settings: ConversationSettings,
) -> None:
    """Full build: transient indexes, then the embedding-backed ones."""
    provider = await _ensure_wired(conversation, conversation_settings)
    await build_transient_secondary_indexes(conversation, conversation_settings)
    await build_related_terms_index(
        conversation, conversation_settings.related_term_index_settings
    )
    await build_message_index(conversation, provider)
