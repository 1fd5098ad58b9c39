"""In-memory storage backend (the port of ``typeagent_tpu/storage/memory``)."""

from .collections import (
    MemoryCollection,
    MemoryMessageCollection,
    MemorySemanticRefCollection,
)
from .indexes import (
    ConversationThreads,
    PropertyIndex,
    TermToSemanticRefIndex,
    TimestampToTextRangeIndex,
)
from .messageindex import MessageTextIndex
from .provider import MemoryStorageProvider
from .reltermsindex import RelatedTermsIndex, TermEmbeddingIndex, TermToRelatedTermsMap

__all__ = [
    "ConversationThreads",
    "MemoryCollection",
    "MemoryMessageCollection",
    "MemorySemanticRefCollection",
    "MemoryStorageProvider",
    "MessageTextIndex",
    "PropertyIndex",
    "RelatedTermsIndex",
    "TermEmbeddingIndex",
    "TermToRelatedTermsMap",
    "TermToSemanticRefIndex",
    "TimestampToTextRangeIndex",
]
