"""In-memory message text index: chunk embeddings live in the device store.

Each message contributes one embedding row per text chunk; a query scores
every chunk and a message inherits its best chunk's score. The embedding
rows themselves sit in the ``TextToTextLocationIndex`` on the settings' device — this
layer only owns the message⇄chunk bookkeeping and the max-merge.

The port of ``typeagent_tpu/storage/memory/messageindex.py``. (Behavioral parity: reference storage/memory/messageindex.py — same
protocol surface and chunk→message max-merge semantics; the incremental
dedupe-by-max-ordinal mirrors what the SQLite backend derives from
MAX(msg_id), reference sqlite/messageindex.py:128-153.)
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import numpy as np

from ...knowpro.convsettings import MessageTextIndexSettings
from ...knowpro.interfaces import (
    IConversation,
    IMessage,
    IMessageTextIndex,
    IStorageProvider,
    ITermToSemanticRefIndex,
    MessageOrdinal,
    MessageTextIndexData,
    ScoredMessageOrdinal,
    TextLocation,
)
from ...knowpro.textlocindex import ScoredTextLocation, TextToTextLocationIndex


async def build_message_index[
    TMessage: IMessage,
    TTermToSemanticRefIndex: ITermToSemanticRefIndex,
](
    conversation: IConversation[TMessage, TTermToSemanticRefIndex],
    storage_provider: IStorageProvider[TMessage],
) -> None:
    """(Re)index every message of ``conversation`` into its text index.

    Wired into ``build_secondary_indexes`` (knowpro/secindex.py); idempotent
    because ``add_messages`` skips the already-indexed prefix.
    """
    indexes = conversation.secondary_indexes
    if indexes is None:
        return
    index = indexes.message_index or storage_provider.message_text_index
    indexes.message_index = index
    total = await conversation.messages.size()
    if total:
        await index.add_messages(await conversation.messages.get_slice(0, total))


class IMessageTextEmbeddingIndex(IMessageTextIndex):
    """Extension protocol: direct embedding-space entry points.

    The query VM's re-rank expression (knowpro/query.py RankMessagesBy-
    SimilarityExpr) narrows to this to skip re-embedding the query text.
    """

    async def generate_embedding(self, text: str) -> np.ndarray: ...

    def lookup_by_embedding(
        self,
        text_embedding: np.ndarray,
        max_matches: int | None = None,
        threshold_score: float | None = None,
        predicate: Callable[[MessageOrdinal], bool] | None = None,
    ) -> list[ScoredMessageOrdinal]: ...

    def lookup_in_subset_by_embedding(
        self,
        text_embedding: np.ndarray,
        ordinals_to_search: list[MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]: ...


def _chunk_plan[TMessage: IMessage](
    first_ordinal: int, messages: list[TMessage]
) -> tuple[list[str], list[TextLocation]]:
    """One pass over the batch: chunk texts + their (message, chunk) rows."""
    texts: list[str] = []
    rows: list[TextLocation] = []
    for ordinal, message in enumerate(messages, start=first_ordinal):
        for chunk_ordinal, chunk in enumerate(message.text_chunks):
            texts.append(chunk)
            rows.append(TextLocation(ordinal, chunk_ordinal))
    return texts, rows


class MessageTextIndex(IMessageTextEmbeddingIndex):
    def __init__(self, settings: MessageTextIndexSettings):
        self.settings = settings
        self.text_location_index = TextToTextLocationIndex(
            settings.embedding_index_settings
        )
        # Highest message ordinal with rows in the store; -1 when empty.
        # Lets add_messages() accept a full message list and index only the
        # suffix that collection extends didn't already push.
        self._max_message_ordinal = -1

    async def size(self) -> int:
        return await self.text_location_index.size()

    async def is_empty(self) -> bool:
        return await self.text_location_index.is_empty()

    async def indexed_message_count(self) -> int:
        """Number of MESSAGES indexed so far (size() counts chunks)."""
        return self._max_message_ordinal + 1

    async def add_messages[TMessage: IMessage](
        self, messages: Iterable[TMessage]
    ) -> None:
        batch = list(messages)
        done = self._max_message_ordinal + 1
        pending = batch[done:]
        if pending:
            await self.add_messages_starting_at(done, pending)

    async def add_messages_starting_at[TMessage: IMessage](
        self,
        start_message_ordinal: int,
        messages: list[TMessage],
    ) -> None:
        texts, rows = _chunk_plan(start_message_ordinal, messages)
        embeddings = await self.text_location_index.generate_embeddings(
            texts, cache=False
        )
        await self._ingest(rows, embeddings)

    async def add_messages_starting_at_with_embeddings[TMessage: IMessage](
        self,
        start_message_ordinal: int,
        messages: list[TMessage],
        chunk_embeddings: list[np.ndarray],
    ) -> None:
        _, rows = _chunk_plan(start_message_ordinal, messages)
        if len(rows) != len(chunk_embeddings):
            raise ValueError(
                "messages and chunk_embeddings produced different chunk counts: "
                f"{len(rows)} != {len(chunk_embeddings)}"
            )
        await self._ingest(rows, chunk_embeddings)

    async def _ingest(
        self, rows: list[TextLocation], embeddings: list[np.ndarray]
    ) -> None:
        await self.text_location_index.add_text_locations_with_embeddings(
            rows, embeddings
        )
        for row in rows:
            if row.message_ordinal > self._max_message_ordinal:
                self._max_message_ordinal = row.message_ordinal

    async def lookup_messages(
        self,
        message_text: str,
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        defaults = self.settings.embedding_index_settings
        return self._max_merge(
            await self.text_location_index.lookup_text(
                message_text,
                max_matches if max_matches is not None else defaults.max_matches,
                threshold_score if threshold_score is not None else defaults.min_score,
            )
        )

    async def lookup_messages_in_subset(
        self,
        message_text: str,
        ordinals_to_search: list[MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        return self._max_merge(
            await self.text_location_index.lookup_text_in_subset(
                message_text, ordinals_to_search, max_matches, threshold_score
            )
        )

    async def generate_embedding(self, text: str) -> np.ndarray:
        return await self.text_location_index.generate_embedding(text)

    def lookup_by_embedding(
        self,
        text_embedding: np.ndarray,
        max_matches: int | None = None,
        threshold_score: float | None = None,
        predicate: Callable[[MessageOrdinal], bool] | None = None,
    ) -> list[ScoredMessageOrdinal]:
        return self._max_merge(
            self.text_location_index.lookup_by_embedding(
                text_embedding, max_matches, threshold_score, predicate
            )
        )

    def lookup_in_subset_by_embedding(
        self,
        text_embedding: np.ndarray,
        ordinals_to_search: list[MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        return self._max_merge(
            self.text_location_index.lookup_in_subset_by_embedding(
                text_embedding, ordinals_to_search, max_matches, threshold_score
            )
        )

    async def lookup_in_subset_by_embedding_async(
        self,
        text_embedding: np.ndarray,
        ordinals_to_search: list[MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        """Async subset re-rank: the event loop stays live during the device
        fetch so concurrent queries overlap their re-rank round trips."""
        return self._max_merge(
            await self.text_location_index.lookup_in_subset_by_embedding_async(
                text_embedding, ordinals_to_search, max_matches, threshold_score
            )
        )

    # Back-compat alias: earlier rounds exposed the merge publicly.
    def to_scored_message_ordinals(
        self, scored_locations: list[ScoredTextLocation]
    ) -> list[ScoredMessageOrdinal]:
        return self._max_merge(scored_locations)

    @staticmethod
    def _max_merge(
        scored_locations: list[ScoredTextLocation],
    ) -> list[ScoredMessageOrdinal]:
        """Collapse chunk hits to messages: a message scores as its best chunk."""
        best: dict[MessageOrdinal, float] = {}
        for hit in scored_locations:
            key = hit.text_location.message_ordinal
            if best.get(key, -1.0) < hit.score:
                best[key] = hit.score
        return [
            ScoredMessageOrdinal(ordinal, score)
            for ordinal, score in sorted(best.items(), key=lambda kv: -kv[1])
        ]

    async def serialize(self) -> MessageTextIndexData:
        return MessageTextIndexData(indexData=self.text_location_index.serialize())

    async def deserialize(self, data: MessageTextIndexData) -> None:
        index_data = data.get("indexData")
        if index_data is None:
            return
        self.text_location_index.deserialize(index_data)
        self._max_message_ordinal = max(
            (
                loc.message_ordinal
                for loc in self.text_location_index._text_locations
            ),
            default=-1,
        )
