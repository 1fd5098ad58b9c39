"""In-memory index implementations: semref terms, properties, timestamps,
conversation threads.

(Parity: reference storage/memory/{semrefindex,propindex,timestampindex,
convthreads}.py index classes; the port of
``typeagent_tpu/storage/memory/indexes.py``. Terms/keys are lowercased; postings carry a
default score of 1.0; the timestamp index keeps a sorted list with bisect;
threads sit on the port's vector store.)
"""

from __future__ import annotations

import bisect
from collections.abc import AsyncIterable, Callable, Sequence
from typing import Any

from ...knowpro.interfaces import (
    ConversationThreadData,
    DateRange,
    Datetime,
    IConversation,
    IConversationThreads,
    IMessage,
    IPropertyToSemanticRefIndex,
    ITermToSemanticRefIndex,
    ITimestampToTextRangeIndex,
    MessageOrdinal,
    ScoredSemanticRefOrdinal,
    ScoredThreadOrdinal,
    SemanticRefOrdinal,
    TermToSemanticRefIndexData,
    TermToSemanticRefIndexItemData,
    Thread,
    ThreadDataItem,
    TimestampedTextRange,
)
from ...knowpro.messageutils import text_range_from_message_chunk
from ...knowpro.propindex import make_property_term_text, split_property_term_text
from ...vectorstore import TextEmbeddingIndexSettings, VectorStore


class TermToSemanticRefIndex(ITermToSemanticRefIndex):
    """Index 1: lowercased term -> scored semref posting list."""

    def __init__(self):
        self._map: dict[str, list[ScoredSemanticRefOrdinal]] = {}

    async def size(self) -> int:
        return len(self._map)

    async def get_terms(self) -> list[str]:
        return list(self._map)

    async def clear(self) -> None:
        self._map.clear()

    async def add_term(
        self,
        term: str,
        semantic_ref_ordinal: SemanticRefOrdinal | ScoredSemanticRefOrdinal,
    ) -> str:
        if not term:
            return term
        if not isinstance(semantic_ref_ordinal, ScoredSemanticRefOrdinal):
            semantic_ref_ordinal = ScoredSemanticRefOrdinal(semantic_ref_ordinal, 1.0)
        term = self._prepare_term(term)
        self._map.setdefault(term, []).append(semantic_ref_ordinal)
        return term

    async def add_terms_batch(
        self,
        terms: Sequence[tuple[str, SemanticRefOrdinal | ScoredSemanticRefOrdinal]],
    ) -> None:
        for term, ordinal in terms:
            await self.add_term(term, ordinal)

    async def lookup_term(self, term: str) -> list[ScoredSemanticRefOrdinal] | None:
        return self._map.get(self._prepare_term(term)) or []

    async def remove_term(
        self, term: str, semantic_ref_ordinal: SemanticRefOrdinal
    ) -> None:
        term = self._prepare_term(term)
        postings = self._map.get(term)
        if postings is not None:
            remaining = [
                p for p in postings if p.semantic_ref_ordinal != semantic_ref_ordinal
            ]
            if remaining:
                self._map[term] = remaining
            else:
                del self._map[term]

    async def serialize(self) -> TermToSemanticRefIndexData:
        return TermToSemanticRefIndexData(
            items=[
                TermToSemanticRefIndexItemData(
                    term=term,
                    semanticRefOrdinals=[s.serialize() for s in postings],
                )
                for term, postings in self._map.items()
            ]
        )

    async def deserialize(self, data: TermToSemanticRefIndexData) -> None:
        self._map.clear()
        for item in data["items"]:
            term = self._prepare_term(item["term"])
            self._map[term] = [
                ScoredSemanticRefOrdinal.deserialize(s)
                for s in item["semanticRefOrdinals"]
            ]

    def _prepare_term(self, term: str) -> str:
        return term.lower()


class PropertyIndex(IPropertyToSemanticRefIndex):
    """Index 2: 'prop.{name}@@{value}' (lowercased) -> posting list."""

    def __init__(self):
        self._map: dict[str, list[ScoredSemanticRefOrdinal]] = {}

    async def size(self) -> int:
        return len(self._map)

    async def get_values(self) -> list[str]:
        return [split_property_term_text(key)[1] for key in self._map]

    async def add_property(
        self,
        property_name: str,
        value: str,
        semantic_ref_ordinal: SemanticRefOrdinal | ScoredSemanticRefOrdinal,
    ) -> None:
        if isinstance(semantic_ref_ordinal, int):
            semantic_ref_ordinal = ScoredSemanticRefOrdinal(semantic_ref_ordinal, 1.0)
        key = self._prepare(make_property_term_text(property_name, value))
        self._map.setdefault(key, []).append(semantic_ref_ordinal)

    async def add_properties_batch(
        self,
        properties: Sequence[
            tuple[str, str, SemanticRefOrdinal | ScoredSemanticRefOrdinal]
        ],
    ) -> None:
        for name, value, ordinal in properties:
            await self.add_property(name, value, ordinal)

    async def clear(self) -> None:
        self._map = {}

    async def lookup_property(
        self, property_name: str, value: str
    ) -> list[ScoredSemanticRefOrdinal] | None:
        return self._map.get(self._prepare(make_property_term_text(property_name, value)))

    async def remove_property(self, prop_name: str, semref_id: int) -> None:
        to_remove = []
        for key, postings in self._map.items():
            name_part, _ = split_property_term_text(key)
            name_part = name_part.removeprefix("prop.")
            if name_part == prop_name:
                remaining = [
                    p for p in postings if p.semantic_ref_ordinal != semref_id
                ]
                if remaining:
                    self._map[key] = remaining
                else:
                    to_remove.append(key)
        for key in to_remove:
            del self._map[key]

    async def remove_all_for_semref(self, semref_id: int) -> None:
        to_remove = []
        for key, postings in self._map.items():
            remaining = [p for p in postings if p.semantic_ref_ordinal != semref_id]
            if remaining:
                self._map[key] = remaining
            else:
                to_remove.append(key)
        for key in to_remove:
            del self._map[key]

    def _prepare(self, term_text: str) -> str:
        return term_text.lower()

    async def all_postings(self) -> list[tuple[str, int, float]]:
        """Dump (prop key, semref, score) triples for device-engine builds."""
        return [
            (key, p.semantic_ref_ordinal, p.score)
            for key, postings in self._map.items()
            for p in postings
        ]


# ---------------------------------------------------------------------------
# Timestamp index
# ---------------------------------------------------------------------------


def get_in_range[T, S: Any](
    values: list[T],
    start_at: S,
    stop_at: S | None,
    key: Callable[[T], S],
) -> list[T]:
    """Sublist with key in [start_at, stop_at); stop None = point query."""
    istart = bisect.bisect_left(values, start_at, key=key)
    if istart == len(values):
        return []
    if stop_at is None:
        istop = bisect.bisect_right(values, start_at, istart, key=key)
        return values[istart:istop]
    istop = bisect.bisect_left(values, stop_at, istart, key=key)
    return values[istart:istop]


class TimestampToTextRangeIndex(ITimestampToTextRangeIndex):
    """Index 3: sorted (ISO timestamp, message point-range) pairs."""

    def __init__(self):
        self._ranges: list[TimestampedTextRange] = []

    async def size(self) -> int:
        return len(self._ranges)

    async def lookup_range(self, date_range: DateRange) -> list[TimestampedTextRange]:
        start_at = date_range.start.isoformat()
        stop_at = None if date_range.end is None else date_range.end.isoformat()
        return get_in_range(self._ranges, start_at, stop_at, key=lambda x: x.timestamp)

    async def add_timestamp(
        self, message_ordinal: MessageOrdinal, timestamp: str
    ) -> bool:
        return self._insert(message_ordinal, timestamp, in_order=True)

    async def add_timestamps(
        self, message_timestamps: list[tuple[MessageOrdinal, str]]
    ) -> None:
        for message_ordinal, timestamp in message_timestamps:
            self._insert(message_ordinal, timestamp, in_order=False)
        self._ranges.sort(key=lambda x: x.timestamp)

    def _insert(
        self, message_ordinal: MessageOrdinal, timestamp: str | None, in_order: bool
    ) -> bool:
        if not timestamp:
            return False
        entry = TimestampedTextRange(
            range=text_range_from_message_chunk(message_ordinal),
            # Canonical isoformat keeps lexicographic == chronological order.
            timestamp=Datetime.fromisoformat(timestamp).isoformat(),
        )
        if in_order:
            where = bisect.bisect_left(
                self._ranges, entry.timestamp, key=lambda x: x.timestamp
            )
            self._ranges.insert(where, entry)
        else:
            self._ranges.append(entry)
        return True


async def build_timestamp_index(conversation: IConversation) -> None:
    if conversation.messages is None or conversation.secondary_indexes is None:
        return
    if await conversation.messages.size() == 0:
        return
    # Persistent collections index timestamps implicitly (DB column index).
    if conversation.messages.is_persistent:
        return
    assert conversation.secondary_indexes.timestamp_index is not None
    await add_to_timestamp_index(
        conversation.secondary_indexes.timestamp_index, conversation.messages, 0
    )


async def add_to_timestamp_index(
    timestamp_index: ITimestampToTextRangeIndex,
    messages: AsyncIterable[IMessage],
    base_message_ordinal: int,
) -> None:
    message_timestamps: list[tuple[int, str]] = []
    i = 0
    async for message in messages:
        if message.timestamp:
            message_timestamps.append((base_message_ordinal + i, message.timestamp))
        i += 1
    await timestamp_index.add_timestamps(message_timestamps)


# ---------------------------------------------------------------------------
# Conversation threads (index 6)
# ---------------------------------------------------------------------------


class ConversationThreads(IConversationThreads):
    """Thread descriptions embedded on device for fuzzy scoping."""

    threads: list[Thread]
    vector_base: VectorStore

    def __init__(self, settings: TextEmbeddingIndexSettings):
        self.threads = []
        self.vector_base = VectorStore(settings)

    async def add_thread(self, thread: Thread) -> None:
        assert len(self.threads) == len(self.vector_base)
        await self.vector_base.add_key(thread.description, cache=False)
        self.threads.append(thread)

    async def lookup_thread(
        self,
        thread_description: str,
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredThreadOrdinal]:
        matches = await self.vector_base.fuzzy_lookup(
            thread_description, max_matches, threshold_score
        )
        return [ScoredThreadOrdinal(m.item, m.score) for m in matches]

    def clear(self) -> None:
        self.threads = []
        self.vector_base.clear()

    async def build_index(self) -> None:
        self.vector_base.clear()
        await self.vector_base.add_keys(
            [t.description for t in self.threads], cache=False
        )

    def serialize(self) -> ConversationThreadData[ThreadDataItem]:
        thread_data: list[ThreadDataItem] = []
        for i, thread in enumerate(self.threads):
            emb = self.vector_base.serialize_embedding_at(i)
            thread_data.append(
                ThreadDataItem(
                    thread=thread.serialize(),
                    embedding=emb.tolist() if emb is not None else None,
                )
            )
        return ConversationThreadData(threads=thread_data)

    def deserialize(self, data: ConversationThreadData[ThreadDataItem]) -> None:
        self.clear()
        thread_items = data.get("threads")
        if thread_items is None:
            return
        for item in thread_items:
            thread = Thread.deserialize(item["thread"])
            self.threads.append(thread)
            if item["embedding"] is not None:
                self.vector_base.add_embedding(
                    thread.description, item["embedding"]
                )
