"""List-backed append-only collections (parity: storage/memory/collections.py).

The port of ``typeagent_tpu/storage/memory/collections.py``.

Message appends auto-feed the message text index, so chunk embeddings land
on the device buffer as messages arrive rather than in a separate pass.
"""

from __future__ import annotations

from collections.abc import AsyncIterator
from typing import Iterable

import numpy as np

from ...knowpro import interfaces
from ...knowpro.interfaces import IMessage, IMessageTextIndex

type _SemRef = interfaces.SemanticRef
type _SemRefOrdinal = interfaces.SemanticRefOrdinal


class MemoryCollection[T, TOrdinal: int](interfaces.ICollection[T, TOrdinal]):
    """A generic in-memory (non-persistent) append-only collection.

    The async surface mirrors the SQLite-backed collections so callers never
    care which backend they hold; here every operation is just a list op.
    """

    is_persistent = False  # property on the protocol; a constant here

    def __init__(self, items: list[T] | None = None):
        self.items: list[T] = [] if items is None else items

    def __repr__(self) -> str:
        return f"{type(self).__name__}(n={len(self.items)})"

    def __aiter__(self) -> AsyncIterator[T]:
        async def gen():
            for item in self.items:
                yield item

        return gen()

    # writes -----------------------------------------------------------------

    async def append(self, item: T) -> None:
        self.items.append(item)

    async def extend(self, items: Iterable[T]) -> None:
        self.items.extend(items)

    # reads ------------------------------------------------------------------

    async def size(self) -> int:
        return len(self.items)

    async def get_item(self, arg: int) -> T:
        return self.items[arg]

    async def get_slice(self, start: int, stop: int) -> list[T]:
        return self.items[start:stop]

    async def get_multiple(self, arg: list[TOrdinal]) -> list[T]:
        if any(i < 0 or i >= len(self.items) for i in arg):
            raise IndexError("One or more indices are out of bounds")
        return [self.items[i] for i in arg]


class MemorySemanticRefCollection(MemoryCollection[_SemRef, _SemRefOrdinal]):
    def __init__(self, items: list[_SemRef] | None = None):
        super().__init__(items)
        # Semrefs are append-only and never mutated in place, so their
        # metadata projections are immutable — memoized here because this
        # is the hottest host call in the query VM (every scoped
        # lookup_term pays it; it was ~30% of concurrent-pipeline host
        # time when rebuilt per call).
        self._metadata_cache: list[interfaces.SemanticRefMetadata] = []

    async def get_metadata_multiple(
        self, ordinals: list[_SemRefOrdinal]
    ) -> list[interfaces.SemanticRefMetadata]:
        # Metadata-only reads keep hot query paths off the knowledge payloads
        # (mirrors the SQLite backend, where this skips the knowledge JSON).
        cache = self._metadata_cache
        for o in range(len(cache), len(self.items)):
            ref = self.items[o]
            cache.append(
                interfaces.SemanticRefMetadata(
                    ordinal=o,
                    range=ref.range,
                    knowledge_type=ref.knowledge.knowledge_type,
                )
            )
        return [cache[o] for o in ordinals]


class MemoryMessageCollection[TMessage: IMessage](
    MemoryCollection[TMessage, interfaces.MessageOrdinal]
):
    """Message list that writes through into the message text index."""

    def __init__(
        self,
        items: list[TMessage] | None = None,
        message_text_index: IMessageTextIndex[TMessage] | None = None,
    ):
        super().__init__(items)
        self.message_text_index = message_text_index

    async def append(self, item: TMessage) -> None:
        start = len(self.items)
        self.items.append(item)
        index = self.message_text_index
        if index is not None:
            await index.add_messages_starting_at(start, [item])

    async def extend(
        self,
        items: Iterable[TMessage],
        chunk_embeddings: list[np.ndarray] | None = None,
        index_messages: bool = True,
    ) -> None:
        batch = list(items)
        if not batch:
            return
        start = len(self.items)
        self.items.extend(batch)
        index = self.message_text_index if index_messages else None
        if index is None:
            return
        if chunk_embeddings is None:
            # Embeds through the model (cache-aware).
            await index.add_messages_starting_at(start, batch)
        else:
            # Pipeline path: chunk embeddings were computed upstream.
            await index.add_messages_starting_at_with_embeddings(
                start, batch, chunk_embeddings
            )
