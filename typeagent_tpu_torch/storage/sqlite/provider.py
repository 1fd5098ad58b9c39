"""SQLite storage provider: WAL + manual BEGIN IMMEDIATE transactions.

(Parity: reference storage/sqlite/provider.py — PRAGMAs, embedding-model
consistency checks against stored metadata, embedding-size cross-table check,
metadata key-value table, ingestion + chunk-failure tracking. Conversation
threads reuse the memory implementation, as in the reference.)
The port of ``typeagent_tpu/storage/sqlite/provider.py``. The connection
keeps sqlite3's ``check_same_thread``: every access runs on the thread that
opened it, as in JAX (the stores' worker threads touch tensors only).
"""

from __future__ import annotations

from types import TracebackType

import sqlite3
from datetime import datetime, timezone

from ...knowpro import interfaces
from ...knowpro.convsettings import MessageTextIndexSettings, RelatedTermIndexSettings
from ...knowpro.interfaces import (
    STATUS_INGESTED,
    ChunkFailure,
    ConversationMetadata,
)
from ...knowpro.universal_message import format_timestamp_utc
from ...vectorstore import TextEmbeddingIndexSettings
from ..memory.indexes import ConversationThreads
from .collections import SqliteMessageCollection, SqliteSemanticRefCollection
from .indexes import (
    SqlitePropertyIndex,
    SqliteTermToSemanticRefIndex,
    SqliteTimestampToTextRangeIndex,
)
from .messageindex import SqliteMessageTextIndex
from .reltermsindex import SqliteRelatedTermsIndex
from .schema import (
    CONVERSATION_SCHEMA_VERSION,
    deserialize_embedding,
    get_db_schema_version,
    init_db_schema,
    set_conversation_metadata,
)


class SqliteStorageProvider[TMessage: interfaces.IMessage](
    interfaces.IStorageProvider[TMessage]
):
    """SQLite-backed provider with consistency checks at open."""

    def __init__(
        self,
        db_path: str = ":memory:",
        message_type: type[TMessage] = None,  # type: ignore[assignment]
        semantic_ref_type: type[interfaces.SemanticRef] = None,  # type: ignore[assignment]
        message_text_index_settings: MessageTextIndexSettings | None = None,
        related_term_index_settings: RelatedTermIndexSettings | None = None,
        metadata: ConversationMetadata | None = None,
    ):
        self.db_path = db_path
        self.message_type = message_type
        self.semantic_ref_type = semantic_ref_type
        self._metadata = metadata

        # isolation_level=None => manual BEGIN/COMMIT control.
        self.db = sqlite3.connect(db_path, isolation_level=None)
        self.db.execute("PRAGMA foreign_keys = ON")
        self.db.execute("PRAGMA synchronous = NORMAL")
        self.db.execute("PRAGMA journal_mode = WAL")
        self.db.execute("PRAGMA cache_size = -64000")  # 64MB
        self.db.execute("PRAGMA temp_store = MEMORY")
        self.db.execute("PRAGMA mmap_size = 268435456")  # 256MB

        init_db_schema(self.db)

        self.message_text_index_settings, self.related_term_index_settings = (
            self._resolve_embedding_settings(
                message_text_index_settings, related_term_index_settings
            )
        )
        self._check_embedding_consistency()

        self._msgs = SqliteMessageCollection(self.db, self.message_type)
        self._semrefs = SqliteSemanticRefCollection(self.db)
        self._term_index = SqliteTermToSemanticRefIndex(self.db)
        self._props = SqlitePropertyIndex(self.db)
        self._times = SqliteTimestampToTextRangeIndex(self.db)
        self._msg_text = SqliteMessageTextIndex(
            self.db, self.message_text_index_settings, self._msgs
        )
        self._rel_terms = SqliteRelatedTermsIndex(
            self.db, self.related_term_index_settings.embedding_index_settings
        )
        self._threads = ConversationThreads(
            self.message_text_index_settings.embedding_index_settings
        )
        self._msgs.set_message_text_index(self._msg_text)

    # -- settings/consistency checks -----------------------------------------

    def _metadata_value(self, key: str) -> str | None:
        cursor = self.db.cursor()
        cursor.execute("SELECT value FROM ConversationMetadata WHERE key = ?", (key,))
        rows = cursor.fetchall()
        return rows[0][0] if rows else None

    def _metadata_exists(self) -> bool:
        cursor = self.db.cursor()
        cursor.execute("SELECT 1 FROM ConversationMetadata LIMIT 1")
        return cursor.fetchone() is not None

    def _resolve_embedding_settings(
        self,
        given_msg_settings: MessageTextIndexSettings | None,
        given_rel_settings: RelatedTermIndexSettings | None,
    ) -> tuple[MessageTextIndexSettings, RelatedTermIndexSettings]:
        """The stored embedding_name metadata must match the configured model."""
        have_metadata = self._metadata_exists()
        persisted_model = self._metadata_value("embedding_name")

        if given_msg_settings is None:
            if persisted_model is not None:
                from ...models.adapters import create_embedding_model

                spec = persisted_model
                if spec and ":" not in spec:
                    spec = f"openai:{spec}"
                base = TextEmbeddingIndexSettings(
                    embedding_model=create_embedding_model(spec)
                )
            else:
                base = TextEmbeddingIndexSettings()
            msg_settings = MessageTextIndexSettings(base)
        else:
            msg_settings = given_msg_settings
            base = msg_settings.embedding_index_settings
            configured_model = base.embedding_model.model_name
            if persisted_model is not None and persisted_model != configured_model:
                raise ValueError(
                    f"Conversation metadata embedding_model ({persisted_model}) does "
                    f"not match provided embedding model ({configured_model})."
                )

        if given_rel_settings is None:
            rel_settings = RelatedTermIndexSettings(base)
        else:
            rel_settings = given_rel_settings
            related_name = (
                rel_settings.embedding_index_settings.embedding_model.model_name
            )
            if related_name != base.embedding_model.model_name:
                raise ValueError(
                    "Related term index embedding_model does not match message "
                    "text index embedding_model"
                )

        live_model_name = base.embedding_model.model_name
        if self._metadata is not None:
            if self._metadata.embedding_model is None:
                self._metadata.embedding_model = live_model_name
            elif self._metadata.embedding_model != live_model_name:
                raise ValueError(
                    "Conversation metadata embedding_model does not match provider settings"
                )

        if have_metadata and persisted_model is None:
            set_conversation_metadata(self.db, embedding_name=live_model_name)

        return msg_settings, rel_settings

    def _check_embedding_consistency(self) -> None:
        """Stored embedding sizes must agree across tables."""
        cursor = self.db.cursor()
        msg_dim: int | None = None
        cursor.execute("SELECT embedding FROM MessageTextIndex LIMIT 1")
        row = cursor.fetchone()
        if row and row[0]:
            msg_dim = len(deserialize_embedding(row[0]))
        rel_dim: int | None = None
        cursor.execute("SELECT term_embedding FROM RelatedTermsFuzzy LIMIT 1")
        row = cursor.fetchone()
        if row and row[0]:
            rel_dim = len(deserialize_embedding(row[0]))
        if (
            msg_dim is not None
            and rel_dim is not None
            and msg_dim != rel_dim
        ):
            raise ValueError(
                f"Embedding size mismatch: message text index has size "
                f"{msg_dim}, but related terms index has size "
                f"{rel_dim}. The database may be corrupted."
            )

    def _init_conversation_metadata_if_needed(self) -> None:
        """First write transaction seeds the metadata table (no own commit)."""
        cursor = self.db.cursor()
        cursor.execute("SELECT 1 FROM ConversationMetadata LIMIT 1")
        if cursor.fetchone() is not None:
            return
        now = datetime.now(timezone.utc)
        if self._metadata:
            name_tag = self._metadata.name_tag or "conversation"
            tags = self._metadata.tags
            extras = self._metadata.extra or {}
        else:
            name_tag = "conversation"
            tags = None
            extras = {}
        live_model_name = (
            self.message_text_index_settings.embedding_index_settings.embedding_model.model_name
        )
        embedding_name = (
            self._metadata.embedding_model
            if self._metadata and self._metadata.embedding_model is not None
            else live_model_name
        )
        extras = {
            k: v
            for k, v in extras.items()
            if k not in {"embedding_size", "embedding_name"}
        }
        set_conversation_metadata(
            self.db,
            name_tag=name_tag,
            schema_version=str(get_db_schema_version(self.db)),
            created_at=format_timestamp_utc(now),
            updated_at=format_timestamp_utc(now),
            tag=tags,
            embedding_name=embedding_name,
            **extras,
        )

    # -- transactions -----------------------------------------------------------

    async def __aenter__(self) -> "SqliteStorageProvider[TMessage]":
        if self.db.in_transaction:
            raise RuntimeError(
                "Cannot start a new transaction: a transaction is already in "
                "progress (nested 'async with storage:', an uncommitted prior "
                "transaction, or an inconsistent database state)."
            )
        self.db.execute("BEGIN IMMEDIATE")
        self._init_conversation_metadata_if_needed()
        return self

    async def __aexit__(
        self,
        exc_type: type[BaseException] | None,
        exc_val: BaseException | None,
        exc_tb: TracebackType | None,
    ) -> None:
        if exc_type is None:
            self.db.commit()
        else:
            self.db.rollback()

    async def close(self) -> None:
        """Close (COMMITS first)."""
        if hasattr(self, "db"):
            self.db.commit()
            self.db.close()
            del self.db

    def __del__(self) -> None:
        """GC close (ROLLS BACK)."""
        if hasattr(self, "db"):
            self.db.rollback()
            self.db.close()
            del self.db

    # -- collections + indexes ----------------------------------------------------

    @property
    def messages(self) -> SqliteMessageCollection[TMessage]:
        return self._msgs

    @property
    def semantic_refs(self) -> SqliteSemanticRefCollection:
        return self._semrefs

    @property
    def semantic_ref_index(self) -> SqliteTermToSemanticRefIndex:
        return self._term_index

    @property
    def property_index(self) -> SqlitePropertyIndex:
        return self._props

    @property
    def timestamp_index(self) -> SqliteTimestampToTextRangeIndex:
        return self._times

    @property
    def message_text_index(self) -> SqliteMessageTextIndex:
        return self._msg_text

    @property
    def related_terms_index(self) -> SqliteRelatedTermsIndex:
        return self._rel_terms

    @property
    def conversation_threads(self) -> ConversationThreads:
        return self._threads

    # -- metadata --------------------------------------------------------------------

    async def get_conversation_metadata(self) -> ConversationMetadata:
        cursor = self.db.cursor()
        cursor.execute("SELECT key, value FROM ConversationMetadata")
        rows = cursor.fetchall()
        if not rows:
            return ConversationMetadata()
        kv: dict[str, list[str]] = {}
        for key, value in rows:
            kv.setdefault(key, []).append(value)

        def one_of(key: str) -> str | None:
            values = kv.get(key)
            if values is None:
                return None
            if len(values) > 1:
                raise ValueError(
                    f"Expected single value for key '{key}', got {len(values)}"
                )
            return values[0]

        def as_datetime(value_str: str) -> datetime:
            if value_str.endswith("Z"):
                value_str = value_str[:-1] + "+00:00"
            try:
                return datetime.fromisoformat(value_str)
            except ValueError:
                return datetime.now(timezone.utc)

        raw_version = one_of("schema_version")
        raw_created = one_of("created_at")
        raw_updated = one_of("updated_at")
        reserved_keys = {
            "name_tag", "schema_version", "created_at", "updated_at",
            "tag", "embedding_size", "embedding_name",
        }
        extra = {
            key: ", ".join(values)
            for key, values in kv.items()
            if key not in reserved_keys
        }
        return ConversationMetadata(
            name_tag=one_of("name_tag"),
            schema_version=int(raw_version) if raw_version else None,
            created_at=as_datetime(raw_created) if raw_created else None,
            updated_at=as_datetime(raw_updated) if raw_updated else None,
            embedding_model=one_of("embedding_name"),
            tags=kv.get("tag"),
            extra=extra if extra else None,
        )

    async def set_conversation_metadata(self, **kwds: str | list[str] | None) -> None:
        set_conversation_metadata(self.db, **kwds)

    async def update_conversation_timestamps(
        self,
        created_at: datetime | None = None,
        updated_at: datetime | None = None,
    ) -> None:
        cursor = self.db.cursor()
        cursor.execute("SELECT 1 FROM ConversationMetadata LIMIT 1")
        if not cursor.fetchone():
            name_tag = self._metadata.name_tag if self._metadata else "conversation"
            live_model_name = (
                self.message_text_index_settings.embedding_index_settings.embedding_model.model_name
            )
            updates: dict[str, str | None] = {
                "name_tag": name_tag or "conversation",
                "schema_version": str(CONVERSATION_SCHEMA_VERSION),
                "embedding_name": live_model_name,
            }
        else:
            updates = {}
        if created_at is not None:
            updates["created_at"] = format_timestamp_utc(created_at)
        if updated_at is not None:
            updates["updated_at"] = format_timestamp_utc(updated_at)
        if updates:
            set_conversation_metadata(self.db, **updates)

    def get_db_version(self) -> int:
        return get_db_schema_version(self.db)

    # -- ingestion tracking ------------------------------------------------------------

    async def is_source_ingested(self, source_id: str) -> bool:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT status FROM IngestedSources WHERE source_id = ?", (source_id,)
        )
        row = cursor.fetchone()
        return row is not None and row[0] == STATUS_INGESTED

    async def are_sources_ingested(self, source_ids: list[str]) -> set[str]:
        if not source_ids:
            return set()
        cursor = self.db.cursor()
        result: set[str] = set()
        sql_var_batch = 500  # stay under SQLITE_MAX_VARIABLE_NUMBER
        for i in range(0, len(source_ids), sql_var_batch):
            chunk = source_ids[i : i + sql_var_batch]
            placeholders = ",".join("?" for _ in chunk)
            cursor.execute(
                f"SELECT source_id FROM IngestedSources "
                f"WHERE source_id IN ({placeholders}) AND status = ?",
                [*chunk, STATUS_INGESTED],
            )
            result.update(row[0] for row in cursor.fetchall())
        return result

    async def get_source_status(self, source_id: str) -> str | None:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT status FROM IngestedSources WHERE source_id = ?", (source_id,)
        )
        row = cursor.fetchone()
        return row[0] if row else None

    async def mark_source_ingested(
        self, source_id: str, status: str = STATUS_INGESTED
    ) -> None:
        self.db.cursor().execute(
            "INSERT OR REPLACE INTO IngestedSources (source_id, status) VALUES (?, ?)",
            (source_id, status),
        )

    async def mark_sources_ingested_batch(
        self, source_ids: list[str], status: str = STATUS_INGESTED
    ) -> None:
        if not source_ids:
            return
        self.db.cursor().executemany(
            "INSERT OR REPLACE INTO IngestedSources (source_id, status) VALUES (?, ?)",
            [(sid, status) for sid in source_ids],
        )

    # -- chunk-failure tracking ------------------------------------------------------------

    async def record_chunk_failure(
        self,
        message_ordinal: int,
        chunk_ordinal: int,
        error_class: str,
        error_message: str,
    ) -> None:
        failed_at = datetime.now(timezone.utc).isoformat()
        self.db.cursor().execute(
            "INSERT OR REPLACE INTO ChunkFailures "
            "(msg_id, chunk_ordinal, error_class, error_message, failed_at) "
            "VALUES (?, ?, ?, ?, ?)",
            (message_ordinal, chunk_ordinal, error_class, error_message, failed_at),
        )

    async def clear_chunk_failure(
        self, message_ordinal: int, chunk_ordinal: int
    ) -> None:
        self.db.cursor().execute(
            "DELETE FROM ChunkFailures WHERE msg_id = ? AND chunk_ordinal = ?",
            (message_ordinal, chunk_ordinal),
        )

    async def get_chunk_failures(self) -> list[ChunkFailure]:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT msg_id, chunk_ordinal, error_class, error_message, failed_at "
            "FROM ChunkFailures ORDER BY msg_id, chunk_ordinal"
        )
        return [
            ChunkFailure(
                message_ordinal=row[0],
                chunk_ordinal=row[1],
                error_class=row[2],
                error_message=row[3],
                failed_at=datetime.fromisoformat(row[4]),
            )
            for row in cursor.fetchall()
        ]
