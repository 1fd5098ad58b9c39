"""SQLite message text index: embedding BLOBs write-through, search state in
a store on the settings' device.

(Parity: reference storage/sqlite/messageindex.py — all embedding BLOBs load
into the vector store at provider init; add_messages dedupes via MAX(msg_id).)
The runtime search state is the VectorStore — SQLite is the checkpoint.
The port of ``typeagent_tpu/storage/sqlite/messageindex.py``: the store sits
on ``settings.device`` (the card by default), so a reopened index of
131,072 rows or more answers through the hybrid exact2 route (K2, K3).
"""

from __future__ import annotations

import sqlite3
import typing
from collections.abc import Callable

import numpy as np

from ...knowpro import interfaces
from ...knowpro.convsettings import MessageTextIndexSettings
from ...knowpro.interfaces import ScoredMessageOrdinal
from ...utils.trace import span
from ...vectorstore import VectorStore
from ..memory.messageindex import IMessageTextEmbeddingIndex
from .schema import deserialize_embedding, serialize_embedding


class SqliteMessageTextIndex(IMessageTextEmbeddingIndex):
    def __init__(
        self,
        db: sqlite3.Connection,
        settings: MessageTextIndexSettings,
        message_collection: interfaces.IMessageCollection | None = None,
    ):
        self.db = db
        self.settings = settings
        self._message_collection = message_collection
        self._vectorbase = VectorStore(settings.embedding_index_settings)
        # (msg_id, chunk_ordinal) per vector row, parallel to the store.
        self._locations: list[tuple[int, int]] = []
        self._load_from_db()

    def _load_from_db(self) -> None:
        """Every stored BLOB into the store, in index_position order (span
        ``sqlite.message_index.load``; the rows reach the device at the
        store's first lookup)."""
        with span("sqlite.message_index.load"):
            cursor = self.db.cursor()
            cursor.execute(
                "SELECT msg_id, chunk_ordinal, embedding FROM MessageTextIndex "
                "ORDER BY index_position"
            )
            rows = cursor.fetchall()
            if rows:
                embeddings = [deserialize_embedding(row[2]) for row in rows]
                self._locations = [(row[0], row[1]) for row in rows]
                self._vectorbase.add_embeddings(
                    None, np.stack(embeddings, axis=0).astype(np.float32, copy=False)
                )

    async def size(self) -> int:
        return self._size()

    def _size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(*) FROM MessageTextIndex")
        return cursor.fetchone()[0]

    async def is_empty(self) -> bool:
        return self._size() == 0

    async def indexed_message_count(self) -> int:
        """Number of MESSAGES indexed so far (_size() counts chunk rows)."""
        cursor = self.db.cursor()
        cursor.execute("SELECT MAX(msg_id) FROM MessageTextIndex")
        result = cursor.fetchone()[0]
        return 0 if result is None else result + 1

    async def add_messages(
        self, messages: typing.Iterable[interfaces.IMessage]
    ) -> None:
        message_list = list(messages)
        if not message_list:
            return
        start_ordinal = await self.indexed_message_count()
        if start_ordinal < len(message_list):
            await self.add_messages_starting_at(
                start_ordinal, message_list[start_ordinal:]
            )

    async def add_messages_starting_at(
        self,
        start_message_ordinal: int,
        messages: list[interfaces.IMessage],
    ) -> None:
        chunks = [
            chunk for message in messages for chunk in message.text_chunks
        ]
        if not chunks:
            return
        embeddings = await self._vectorbase.get_embeddings(chunks, cache=False)
        await self.add_messages_starting_at_with_embeddings(
            start_message_ordinal, messages, list(embeddings)
        )

    async def add_messages_starting_at_with_embeddings(
        self,
        start_message_ordinal: int,
        messages: list[interfaces.IMessage],
        chunk_embeddings: list[np.ndarray],
    ) -> None:
        locations: list[tuple[int, int]] = []
        for msg_ord, message in enumerate(messages, start_message_ordinal):
            for chunk_ord in range(len(message.text_chunks)):
                locations.append((msg_ord, chunk_ord))
        if len(locations) != len(chunk_embeddings):
            raise ValueError(
                "messages and chunk_embeddings produced different chunk counts: "
                f"{len(locations)} != {len(chunk_embeddings)}"
            )
        if not locations:
            return

        current_size = len(self._vectorbase)
        self._vectorbase.add_embeddings(
            None, np.stack(chunk_embeddings, axis=0).astype(np.float32, copy=False)
        )
        self._locations.extend(locations)

        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT INTO MessageTextIndex (msg_id, chunk_ordinal, embedding, "
            "index_position) VALUES (?, ?, ?, ?)",
            [
                (msg_ord, chunk_ord, serialize_embedding(emb), current_size + idx)
                for idx, ((msg_ord, chunk_ord), emb) in enumerate(
                    zip(locations, chunk_embeddings)
                )
            ],
        )

    async def lookup_messages(
        self,
        message_text: str,
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        max_matches = max_matches or self.settings.embedding_index_settings.max_matches
        threshold_score = (
            threshold_score or self.settings.embedding_index_settings.min_score
        )
        embedding = await self._vectorbase.get_embedding(message_text)
        return self.lookup_by_embedding(embedding, max_matches, threshold_score)

    async def lookup_messages_in_subset(
        self,
        message_text: str,
        ordinals_to_search: list[interfaces.MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        embedding = await self._vectorbase.get_embedding(message_text)
        return self.lookup_in_subset_by_embedding(
            embedding, ordinals_to_search, max_matches, threshold_score
        )

    async def generate_embedding(self, text: str) -> np.ndarray:
        return await self._vectorbase.get_embedding(text)

    def lookup_by_embedding(
        self,
        text_embedding: np.ndarray,
        max_matches: int | None = None,
        threshold_score: float | None = None,
        predicate: Callable[[interfaces.MessageOrdinal], bool] | None = None,
    ) -> list[ScoredMessageOrdinal]:
        if max_matches is None:
            max_matches = len(self._vectorbase) or 1
        row_predicate = None
        if predicate is not None:
            row_predicate = lambda row: predicate(self._locations[row][0])
        matches = self._vectorbase.fuzzy_lookup_embedding(
            text_embedding,
            max_hits=max_matches,
            min_score=threshold_score,
            predicate=row_predicate,
        )
        return self._to_scored_message_ordinals(matches)

    def lookup_in_subset_by_embedding(
        self,
        text_embedding: np.ndarray,
        ordinals_to_search: list[interfaces.MessageOrdinal],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredMessageOrdinal]:
        # Map message ordinals -> vector row ordinals.
        wanted = set(ordinals_to_search)
        rows = [i for i, (msg, _) in enumerate(self._locations) if msg in wanted]
        if not rows:
            return []
        if max_matches is None:
            max_matches = len(rows)
        matches = self._vectorbase.fuzzy_lookup_embedding_in_subset(
            text_embedding, rows, max_matches, threshold_score
        )
        return self._to_scored_message_ordinals(matches)

    def _to_scored_message_ordinals(self, matches) -> list[ScoredMessageOrdinal]:
        result: dict[int, ScoredMessageOrdinal] = {}
        for m in matches:
            msg_ord = self._locations[m.item][0]
            existing = result.get(msg_ord)
            if existing is None:
                result[msg_ord] = ScoredMessageOrdinal(msg_ord, m.score)
            else:
                existing.score = max(existing.score, m.score)
        return sorted(result.values(), key=lambda r: r.score, reverse=True)

    async def clear(self) -> None:
        self.db.cursor().execute("DELETE FROM MessageTextIndex")
        self._vectorbase.clear()
        self._locations.clear()

    async def serialize(self) -> interfaces.MessageTextIndexData:
        return interfaces.MessageTextIndexData(
            indexData=interfaces.TextToTextLocationIndexData(
                textLocations=[
                    interfaces.TextLocation(msg, chunk).serialize()
                    for msg, chunk in self._locations
                ],
                embeddings=self._vectorbase.serialize(),
            )
        )

    async def deserialize(self, data: interfaces.MessageTextIndexData) -> None:
        index_data = data.get("indexData")
        if index_data is None:
            return
        await self.clear()
        text_locations = index_data["textLocations"]
        embeddings = index_data["embeddings"]
        if embeddings is None:
            raise ValueError("No embeddings found")
        if len(text_locations) != len(embeddings):
            raise ValueError(
                f"MessageTextIndexData corrupt: {len(text_locations)} != {len(embeddings)}"
            )
        locations = [
            (loc["messageOrdinal"], loc.get("chunkOrdinal", 0))
            for loc in text_locations
        ]
        self._locations = locations
        self._vectorbase.add_embeddings(None, np.asarray(embeddings, np.float32))
        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT INTO MessageTextIndex (msg_id, chunk_ordinal, embedding, "
            "index_position) VALUES (?, ?, ?, ?)",
            [
                (msg, chunk, serialize_embedding(np.asarray(embeddings[i], np.float32)), i)
                for i, (msg, chunk) in enumerate(locations)
            ],
        )
