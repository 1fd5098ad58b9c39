"""SQLite schema — table/column parity with the reference
(`storage/sqlite/schema.py:18-171`) so databases interoperate.

11 tables: Messages (shredded columns), ConversationMetadata (key-value),
SemanticRefs, SemanticRefIndex, MessageTextIndex (embedding BLOBs),
PropertyIndex, RelatedTermsAliases, RelatedTermsFuzzy, IngestedSources,
ChunkFailures (+ indexes).

The port of ``typeagent_tpu/storage/sqlite/schema.py``: an embedding BLOB
is the vector's little-endian f32 bytes, as there.
"""

from __future__ import annotations

import sqlite3
from datetime import datetime, timezone

import numpy as np

from ...knowpro.interfaces import STATUS_INGESTED, ConversationMetadata

CONVERSATION_SCHEMA_VERSION = 1

_TABLES = [
    """
CREATE TABLE IF NOT EXISTS ConversationMetadata (
    key TEXT NOT NULL,
    value TEXT NOT NULL,
    PRIMARY KEY (key, value)          -- multiple values per key (e.g. tags)
);
""",
    """
CREATE TABLE IF NOT EXISTS Messages (
    msg_id INTEGER PRIMARY KEY AUTOINCREMENT,
    chunks JSON NULL,             -- JSON array of text chunks, or NULL if chunk_uri
    chunk_uri TEXT NULL,          -- external chunk storage URI
    start_timestamp TEXT NULL,    -- ISO format with Z timezone
    tags JSON NULL,
    metadata JSON NULL,
    extra JSON NULL,
    CONSTRAINT chunks_xor_chunkuri CHECK (
        (chunks IS NOT NULL AND chunk_uri IS NULL) OR
        (chunks IS NULL AND chunk_uri IS NOT NULL)
    )
);
""",
    """
CREATE TABLE IF NOT EXISTS SemanticRefs (
    semref_id INTEGER PRIMARY KEY,
    range_json JSON NOT NULL,
    knowledge_type TEXT NOT NULL,
    knowledge_json JSON NOT NULL
);
""",
    """
CREATE TABLE IF NOT EXISTS SemanticRefIndex (
    term TEXT NOT NULL,             -- lowercased/normalized
    semref_id INTEGER NOT NULL,
    FOREIGN KEY (semref_id) REFERENCES SemanticRefs(semref_id) ON DELETE CASCADE
);
""",
    """
CREATE TABLE IF NOT EXISTS MessageTextIndex (
    msg_id INTEGER NOT NULL,
    chunk_ordinal INTEGER NOT NULL,
    embedding BLOB NOT NULL,
    index_position INTEGER,
    PRIMARY KEY (msg_id, chunk_ordinal),
    FOREIGN KEY (msg_id) REFERENCES Messages(msg_id) ON DELETE CASCADE
);
""",
    """
CREATE TABLE IF NOT EXISTS PropertyIndex (
    prop_name TEXT NOT NULL,
    value_str TEXT NOT NULL,
    score REAL NOT NULL DEFAULT 1.0,
    semref_id INTEGER NOT NULL,
    FOREIGN KEY (semref_id) REFERENCES SemanticRefs(semref_id) ON DELETE CASCADE
);
""",
    """
CREATE TABLE IF NOT EXISTS RelatedTermsAliases (
    term TEXT NOT NULL,
    alias TEXT NOT NULL,
    PRIMARY KEY (term, alias)
);
""",
    """
CREATE TABLE IF NOT EXISTS RelatedTermsFuzzy (
    term TEXT NOT NULL PRIMARY KEY,
    term_embedding BLOB NOT NULL
);
""",
    f"""
CREATE TABLE IF NOT EXISTS IngestedSources (
    source_id TEXT PRIMARY KEY,
    status TEXT NOT NULL DEFAULT {STATUS_INGESTED}
);
""",
    """
CREATE TABLE IF NOT EXISTS ChunkFailures (
    msg_id INTEGER NOT NULL,
    chunk_ordinal INTEGER NOT NULL,
    error_class TEXT NOT NULL,
    error_message TEXT NOT NULL,
    failed_at TEXT NOT NULL,
    PRIMARY KEY (msg_id, chunk_ordinal)
);
""",
]

_INDEXES = [
    "CREATE INDEX IF NOT EXISTS idx_messages_start_timestamp ON Messages(start_timestamp);",
    "CREATE INDEX IF NOT EXISTS idx_semantic_ref_index_term ON SemanticRefIndex(term);",
    "CREATE INDEX IF NOT EXISTS idx_message_text_index_message ON MessageTextIndex(msg_id, chunk_ordinal);",
    "CREATE INDEX IF NOT EXISTS idx_message_text_index_position ON MessageTextIndex(index_position);",
    "CREATE INDEX IF NOT EXISTS idx_property_index_prop_name ON PropertyIndex(prop_name);",
    "CREATE INDEX IF NOT EXISTS idx_property_index_value_str ON PropertyIndex(value_str);",
    "CREATE INDEX IF NOT EXISTS idx_property_index_combined ON PropertyIndex(prop_name, value_str);",
    "CREATE INDEX IF NOT EXISTS idx_related_aliases_term ON RelatedTermsAliases(term);",
    "CREATE INDEX IF NOT EXISTS idx_related_aliases_alias ON RelatedTermsAliases(alias);",
    "CREATE INDEX IF NOT EXISTS idx_related_fuzzy_term ON RelatedTermsFuzzy(term);",
    "CREATE INDEX IF NOT EXISTS idx_chunk_failures_msg ON ChunkFailures(msg_id);",
]

# Row tuple aliases
type ShreddedMessage = tuple[
    str | None, str | None, str | None, str | None, str | None, str | None
]
type ShreddedSemanticRef = tuple[int, str, str, str]


def serialize_embedding(embedding: np.ndarray | None) -> bytes | None:
    if embedding is None:
        return None
    return np.asarray(embedding, dtype=np.float32).tobytes()


def deserialize_embedding(blob: bytes | None) -> np.ndarray | None:
    if blob is None:
        return None
    return np.frombuffer(blob, dtype=np.float32)


def init_db_schema(db: sqlite3.Connection) -> None:
    cursor = db.cursor()
    for stmt in _TABLES:
        cursor.execute(stmt)
    for stmt in _INDEXES:
        cursor.execute(stmt)


def get_db_schema_version(db: sqlite3.Connection) -> int:
    try:
        cursor = db.cursor()
        cursor.execute(
            "SELECT value FROM ConversationMetadata WHERE key = 'schema_version' LIMIT 1"
        )
        row = cursor.fetchone()
        return int(row[0]) if row else CONVERSATION_SCHEMA_VERSION
    except sqlite3.OperationalError:
        return CONVERSATION_SCHEMA_VERSION


def set_conversation_metadata(
    db: sqlite3.Connection, **kwds: str | list[str] | None
) -> None:
    """Set metadata key-value pairs: str replaces, list multi-values, None deletes."""
    cursor = db.cursor()
    for key, value in kwds.items():
        cursor.execute("DELETE FROM ConversationMetadata WHERE key = ?", (key,))
        if value is None:
            continue
        values = value if isinstance(value, list) else [value]
        for v in values:
            cursor.execute(
                "INSERT INTO ConversationMetadata (key, value) VALUES (?, ?)",
                (key, str(v)),
            )
