"""SQLite collections: messages shredded into columns, semrefs as JSON rows.

(Parity: reference storage/sqlite/collections.py — msg_id = size at insert
(0-based, no gaps), bulk executemany extends, message extends auto-feed the
message text index with optional precomputed embeddings.)
The port of ``typeagent_tpu/storage/sqlite/collections.py``; rows go through
``knowpro/fields.py``'s ``serialize_object`` / ``deserialize_object``.
"""

from __future__ import annotations

import json
import sqlite3
import typing

import numpy as np

from ...knowpro import interfaces
from ...knowpro.fields import deserialize_object, serialize_object
from .schema import ShreddedMessage, ShreddedSemanticRef

# Stay far under SQLITE_MAX_VARIABLE_NUMBER (999 on older SQLite builds) —
# the device executor syncs with ordinal lists spanning whole conversations.
_SQL_IN_CHUNK = 500


def _fetch_rows_by_id(
    db: sqlite3.Connection, select_sql: str, id_column: str, ids: list[int]
) -> dict[int, tuple]:
    """Fetch ``select_sql WHERE id_column …`` for ``ids``; first selected
    column must be the id. Contiguous id runs use one range scan; arbitrary
    sets chunk the IN-list to stay under the bind-variable limit."""
    cursor = db.cursor()
    rows: dict[int, tuple] = {}
    lo, hi = min(ids), max(ids)
    if hi - lo + 1 == len(set(ids)):  # contiguous (modulo duplicates)
        cursor.execute(
            f"{select_sql} WHERE {id_column} >= ? AND {id_column} <= ?", (lo, hi)
        )
        for row in cursor.fetchall():
            rows[row[0]] = row
        return rows
    unique = list(dict.fromkeys(ids))
    for start in range(0, len(unique), _SQL_IN_CHUNK):
        chunk = unique[start : start + _SQL_IN_CHUNK]
        placeholders = ",".join("?" * len(chunk))
        cursor.execute(
            f"{select_sql} WHERE {id_column} IN ({placeholders})", chunk
        )
        for row in cursor.fetchall():
            rows[row[0]] = row
    return rows


class SqliteMessageCollection[TMessage: interfaces.IMessage](
    interfaces.IMessageCollection[TMessage]
):
    def __init__(
        self,
        db: sqlite3.Connection,
        message_type: type[TMessage] | None = None,
        message_text_index: "interfaces.IMessageTextIndex[TMessage] | None" = None,
    ):
        self.db = db
        self.message_type = message_type
        self.message_text_index = message_text_index

    def set_message_text_index(
        self, message_text_index: "interfaces.IMessageTextIndex[TMessage]"
    ) -> None:
        self.message_text_index = message_text_index

    @property
    def is_persistent(self) -> bool:
        return True

    async def size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(*) FROM Messages")
        return cursor.fetchone()[0]

    def __aiter__(self) -> typing.AsyncGenerator[TMessage, None]:
        return self._async_iterator()

    async def _async_iterator(self) -> typing.AsyncGenerator[TMessage, None]:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT chunks, chunk_uri, start_timestamp, tags, metadata, extra "
            "FROM Messages ORDER BY msg_id"
        )
        for row in cursor:
            yield self._from_row(row)

    def _from_row(self, row: ShreddedMessage) -> TMessage:
        chunks_json, _chunk_uri, start_timestamp, tags_json, metadata_json, extra_json = row
        data = json.loads(extra_json) if extra_json else {}
        data["textChunks"] = json.loads(chunks_json) if chunks_json else []
        data["timestamp"] = start_timestamp
        data["tags"] = json.loads(tags_json) if tags_json else []
        data["metadata"] = json.loads(metadata_json) if metadata_json else {}
        if self.message_type is None:
            raise ValueError(
                "Deserialization requires message_type passed to SqliteMessageCollection"
            )
        return deserialize_object(self.message_type, data)

    def _to_row(self, message: TMessage) -> ShreddedMessage:
        data = serialize_object(message, exclude_none=False)
        chunks_json = json.dumps(data.pop("textChunks", []))
        start_timestamp = data.pop("timestamp", None)
        tags_json = json.dumps(data.pop("tags", []))
        metadata_json = json.dumps(data.pop("metadata", {}))
        data = {k: v for k, v in data.items() if v is not None}
        extra_json = json.dumps(data) if data else None
        return (chunks_json, None, start_timestamp, tags_json, metadata_json, extra_json)

    async def get_item(self, arg: int) -> TMessage:
        if not isinstance(arg, int):
            raise TypeError(f"Index must be an int, not {type(arg).__name__}")
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT chunks, chunk_uri, start_timestamp, tags, metadata, extra "
            "FROM Messages WHERE msg_id = ?",
            (arg,),
        )
        row = cursor.fetchone()
        if row:
            return self._from_row(row)
        raise IndexError("Message not found")

    async def get_slice(self, start: int, stop: int) -> list[TMessage]:
        if stop <= start:
            return []
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT chunks, chunk_uri, start_timestamp, tags, metadata, extra "
            "FROM Messages WHERE msg_id >= ? AND msg_id < ? ORDER BY msg_id",
            (start, stop),
        )
        return [self._from_row(row) for row in cursor.fetchall()]

    async def get_multiple(self, arg: list[int]) -> list[TMessage]:
        size = await self.size()
        if not all(0 <= i < size for i in arg):
            raise IndexError("One or more Message indices are out of bounds")
        if len(arg) < 2:
            return [await self.get_item(i) for i in arg]
        rowdict = _fetch_rows_by_id(
            self.db,
            "SELECT msg_id, chunks, chunk_uri, start_timestamp, tags, metadata, "
            "extra FROM Messages",
            "msg_id",
            arg,
        )
        assert set(rowdict) == set(arg)
        return [self._from_row(rowdict[i][1:]) for i in arg]

    async def append(self, item: TMessage) -> None:
        msg_id = await self.size()  # 0-based dense ids
        cursor = self.db.cursor()
        cursor.execute(
            "INSERT INTO Messages (msg_id, chunks, chunk_uri, start_timestamp, "
            "tags, metadata, extra) VALUES (?, ?, ?, ?, ?, ?, ?)",
            (msg_id, *self._to_row(item)),
        )
        if self.message_text_index is not None:
            await self.message_text_index.add_messages_starting_at(msg_id, [item])

    async def extend(
        self,
        items: typing.Iterable[TMessage],
        chunk_embeddings: list[np.ndarray] | None = None,
        index_messages: bool = True,
    ) -> None:
        items_list = list(items)
        if not items_list:
            return
        current_size = await self.size()
        rows = [
            (msg_id, *self._to_row(item))
            for msg_id, item in enumerate(items_list, current_size)
        ]
        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT INTO Messages (msg_id, chunks, chunk_uri, start_timestamp, "
            "tags, metadata, extra) VALUES (?, ?, ?, ?, ?, ?, ?)",
            rows,
        )
        if index_messages and self.message_text_index is not None:
            if chunk_embeddings is not None:
                await self.message_text_index.add_messages_starting_at_with_embeddings(
                    current_size, items_list, chunk_embeddings
                )
            else:
                await self.message_text_index.add_messages_starting_at(
                    current_size, items_list
                )


class SqliteSemanticRefCollection(interfaces.ISemanticRefCollection):
    def __init__(self, db: sqlite3.Connection):
        self.db = db

    @property
    def is_persistent(self) -> bool:
        return True

    def _from_row(self, row: ShreddedSemanticRef) -> interfaces.SemanticRef:
        semref_id, range_json, knowledge_type, knowledge_json = row
        return interfaces.SemanticRef.deserialize(
            interfaces.SemanticRefData(
                semanticRefOrdinal=semref_id,
                range=json.loads(range_json),
                knowledgeType=knowledge_type,  # type: ignore[typeddict-item]
                knowledge=json.loads(knowledge_json),
            )
        )

    def _to_row(self, semantic_ref: interfaces.SemanticRef) -> ShreddedSemanticRef:
        data = semantic_ref.serialize()
        return (
            data["semanticRefOrdinal"],
            json.dumps(data["range"]),
            data["knowledgeType"],
            json.dumps(data["knowledge"]),
        )

    async def size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(*) FROM SemanticRefs")
        return cursor.fetchone()[0]

    def __aiter__(self) -> typing.AsyncGenerator[interfaces.SemanticRef, None]:
        return self._async_iterator()

    async def _async_iterator(self):
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT semref_id, range_json, knowledge_type, knowledge_json "
            "FROM SemanticRefs ORDER BY semref_id"
        )
        for row in cursor:
            yield self._from_row(row)

    async def get_item(self, arg: int) -> interfaces.SemanticRef:
        if not isinstance(arg, int):
            raise TypeError(f"Index must be an int, not {type(arg).__name__}")
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT semref_id, range_json, knowledge_type, knowledge_json "
            "FROM SemanticRefs WHERE semref_id = ?",
            (arg,),
        )
        row = cursor.fetchone()
        if row:
            return self._from_row(row)
        raise IndexError("SemanticRef not found")

    async def get_slice(self, start: int, stop: int) -> list[interfaces.SemanticRef]:
        if stop <= start:
            return []
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT semref_id, range_json, knowledge_type, knowledge_json "
            "FROM SemanticRefs WHERE semref_id >= ? AND semref_id < ? ORDER BY semref_id",
            (start, stop),
        )
        return [self._from_row(row) for row in cursor.fetchall()]

    async def get_multiple(self, arg: list[int]) -> list[interfaces.SemanticRef]:
        size = await self.size()
        if not all(0 <= i < size for i in arg):
            raise IndexError("One or more SemanticRef indices are out of bounds")
        if len(arg) < 2:
            return [await self.get_item(i) for i in arg]
        rowdict = _fetch_rows_by_id(
            self.db,
            "SELECT semref_id, range_json, knowledge_type, knowledge_json "
            "FROM SemanticRefs",
            "semref_id",
            arg,
        )
        assert set(rowdict) == set(arg)
        return [self._from_row(rowdict[i]) for i in arg]

    async def get_metadata_multiple(
        self, ordinals: list[int]
    ) -> list[interfaces.SemanticRefMetadata]:
        """Lightweight metadata — avoids knowledge JSON deserialization."""
        if not ordinals:
            return []
        rowdict = _fetch_rows_by_id(
            self.db,
            "SELECT semref_id, range_json, knowledge_type FROM SemanticRefs",
            "semref_id",
            list(ordinals),
        )
        result = []
        for o in ordinals:
            row = rowdict[o]
            range_data = json.loads(row[1])
            start = range_data["start"]
            end_data = range_data.get("end")
            result.append(
                interfaces.SemanticRefMetadata(
                    ordinal=row[0],
                    range=interfaces.TextRange(
                        start=interfaces.TextLocation(
                            start["messageOrdinal"], start.get("chunkOrdinal", 0)
                        ),
                        end=(
                            interfaces.TextLocation(
                                end_data["messageOrdinal"],
                                end_data.get("chunkOrdinal", 0),
                            )
                            if end_data
                            else None
                        ),
                    ),
                    knowledge_type=row[2],
                )
            )
        return result

    async def append(self, item: interfaces.SemanticRef) -> None:
        cursor = self.db.cursor()
        cursor.execute(
            "INSERT INTO SemanticRefs (semref_id, range_json, knowledge_type, "
            "knowledge_json) VALUES (?, ?, ?, ?)",
            self._to_row(item),
        )

    async def extend(self, items: typing.Iterable[interfaces.SemanticRef]) -> None:
        rows = [self._to_row(item) for item in items]
        if not rows:
            return
        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT INTO SemanticRefs (semref_id, range_json, knowledge_type, "
            "knowledge_json) VALUES (?, ?, ?, ?)",
            rows,
        )
