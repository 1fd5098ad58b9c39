"""SQLite semref-term, property, and timestamp indexes.

(Parity: reference storage/sqlite/{semrefindex,propindex,timestampindex}.py —
term normalization adds strip + NFC + whitespace collapse on top of
lowercasing; timestamps live as an index over Messages.start_timestamp,
no separate table.)
The port of ``typeagent_tpu/storage/sqlite/indexes.py``; the device query
engine normalizes its terms with :func:`prepare_term`, as in JAX.
"""

from __future__ import annotations

import re
import sqlite3
import unicodedata
from collections.abc import Sequence

from ...knowpro import interfaces
from ...knowpro.interfaces import ScoredSemanticRefOrdinal
from ...knowpro.propindex import make_property_term_text, split_property_term_text
from ...knowpro.universal_message import format_timestamp_utc


def prepare_term(term: str) -> str:
    """strip + NFC unicode normalize + whitespace collapse + lowercase."""
    term = term.strip()
    term = unicodedata.normalize("NFC", term)
    term = re.sub(r"\s+", " ", term)
    return term.lower()


class SqliteTermToSemanticRefIndex(interfaces.ITermToSemanticRefIndex):
    def __init__(self, db: sqlite3.Connection):
        self.db = db

    async def size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(DISTINCT term) FROM SemanticRefIndex")
        return cursor.fetchone()[0]

    async def get_terms(self) -> list[str]:
        cursor = self.db.cursor()
        cursor.execute("SELECT DISTINCT term FROM SemanticRefIndex ORDER BY term")
        return [row[0] for row in cursor.fetchall()]

    async def add_term(
        self,
        term: str,
        semantic_ref_ordinal: (
            interfaces.SemanticRefOrdinal | ScoredSemanticRefOrdinal
        ),
    ) -> str:
        if not term:
            return term
        term = prepare_term(term)
        semref_id = (
            semantic_ref_ordinal.semantic_ref_ordinal
            if isinstance(semantic_ref_ordinal, ScoredSemanticRefOrdinal)
            else semantic_ref_ordinal
        )
        cursor = self.db.cursor()
        cursor.execute(
            "INSERT OR IGNORE INTO SemanticRefIndex (term, semref_id) VALUES (?, ?)",
            (term, semref_id),
        )
        return term

    async def add_terms_batch(
        self,
        terms: Sequence[
            tuple[str, interfaces.SemanticRefOrdinal | ScoredSemanticRefOrdinal]
        ],
    ) -> None:
        rows = []
        for term, ordinal in terms:
            if not term:
                continue
            semref_id = (
                ordinal.semantic_ref_ordinal
                if isinstance(ordinal, ScoredSemanticRefOrdinal)
                else ordinal
            )
            rows.append((prepare_term(term), semref_id))
        if rows:
            cursor = self.db.cursor()
            cursor.executemany(
                "INSERT OR IGNORE INTO SemanticRefIndex (term, semref_id) VALUES (?, ?)",
                rows,
            )

    async def remove_term(
        self, term: str, semantic_ref_ordinal: interfaces.SemanticRefOrdinal
    ) -> None:
        cursor = self.db.cursor()
        cursor.execute(
            "DELETE FROM SemanticRefIndex WHERE term = ? AND semref_id = ?",
            (prepare_term(term), semantic_ref_ordinal),
        )

    async def lookup_term(self, term: str) -> list[ScoredSemanticRefOrdinal] | None:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT semref_id FROM SemanticRefIndex WHERE term = ?",
            (prepare_term(term),),
        )
        return [ScoredSemanticRefOrdinal.fast(row[0], 1.0) for row in cursor.fetchall()]

    async def clear(self) -> None:
        self.db.cursor().execute("DELETE FROM SemanticRefIndex")

    async def serialize(self) -> interfaces.TermToSemanticRefIndexData:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT term, semref_id FROM SemanticRefIndex ORDER BY term, semref_id"
        )
        grouped: dict[str, list[interfaces.ScoredSemanticRefOrdinalData]] = {}
        for term, semref_id in cursor.fetchall():
            grouped.setdefault(term, []).append(
                ScoredSemanticRefOrdinal(semref_id, 1.0).serialize()
            )
        return interfaces.TermToSemanticRefIndexData(
            items=[
                interfaces.TermToSemanticRefIndexItemData(
                    term=term, semanticRefOrdinals=ordinals
                )
                for term, ordinals in grouped.items()
            ]
        )

    async def deserialize(self, data: interfaces.TermToSemanticRefIndexData) -> None:
        cursor = self.db.cursor()
        cursor.execute("DELETE FROM SemanticRefIndex")
        rows = []
        for item in data["items"]:
            if item and item["term"]:
                term = prepare_term(item["term"])
                for ordinal_data in item["semanticRefOrdinals"]:
                    semref_id = (
                        ordinal_data["semanticRefOrdinal"]
                        if isinstance(ordinal_data, dict)
                        else ordinal_data
                    )
                    rows.append((term, semref_id))
        if rows:
            cursor.executemany(
                "INSERT OR IGNORE INTO SemanticRefIndex (term, semref_id) VALUES (?, ?)",
                rows,
            )


def _split_prop(property_name: str, value: str) -> tuple[str, str]:
    """Normalize via the shared 'prop.{name}@@{value}' lowercase form."""
    term_text = make_property_term_text(property_name, value).lower()
    name, value = split_property_term_text(term_text)
    return name.removeprefix("prop."), value


class SqlitePropertyIndex(interfaces.IPropertyToSemanticRefIndex):
    def __init__(self, db: sqlite3.Connection):
        self.db = db

    async def size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT COUNT(*) FROM (SELECT DISTINCT prop_name, value_str FROM PropertyIndex)"
        )
        return cursor.fetchone()[0]

    async def get_values(self) -> list[str]:
        cursor = self.db.cursor()
        cursor.execute("SELECT DISTINCT value_str FROM PropertyIndex ORDER BY value_str")
        return [row[0] for row in cursor.fetchall()]

    async def add_property(
        self,
        property_name: str,
        value: str,
        semantic_ref_ordinal: (
            interfaces.SemanticRefOrdinal | ScoredSemanticRefOrdinal
        ),
    ) -> None:
        await self.add_properties_batch([(property_name, value, semantic_ref_ordinal)])

    async def add_properties_batch(
        self,
        properties: Sequence[
            tuple[
                str,
                str,
                interfaces.SemanticRefOrdinal | ScoredSemanticRefOrdinal,
            ]
        ],
    ) -> None:
        if not properties:
            return
        rows = []
        for property_name, value, ordinal in properties:
            if isinstance(ordinal, ScoredSemanticRefOrdinal):
                semref_id, score = ordinal.semantic_ref_ordinal, ordinal.score
            else:
                semref_id, score = ordinal, 1.0
            name, val = _split_prop(property_name, value)
            rows.append((name, val, score, semref_id))
        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT INTO PropertyIndex (prop_name, value_str, score, semref_id) "
            "VALUES (?, ?, ?, ?)",
            rows,
        )

    async def clear(self) -> None:
        self.db.cursor().execute("DELETE FROM PropertyIndex")

    async def lookup_property(
        self, property_name: str, value: str
    ) -> list[ScoredSemanticRefOrdinal] | None:
        name, val = _split_prop(property_name, value)
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT semref_id, score FROM PropertyIndex "
            "WHERE prop_name = ? AND value_str = ?",
            (name, val),
        )
        results = [
            ScoredSemanticRefOrdinal.fast(semref_id, score)
            for semref_id, score in cursor.fetchall()
        ]
        return results or None

    async def remove_property(self, prop_name: str, semref_id: int) -> None:
        self.db.cursor().execute(
            "DELETE FROM PropertyIndex WHERE prop_name = ? AND semref_id = ?",
            (prop_name, semref_id),
        )

    async def remove_all_for_semref(self, semref_id: int) -> None:
        self.db.cursor().execute(
            "DELETE FROM PropertyIndex WHERE semref_id = ?", (semref_id,)
        )

    async def all_postings(self) -> list[tuple[str, int, float]]:
        """Dump (prop key, semref, score) triples for device-engine builds."""
        cursor = self.db.cursor()
        cursor.execute(
            "SELECT prop_name, value_str, semref_id, score FROM PropertyIndex"
        )
        return [
            (make_property_term_text(name, value), semref, score)
            for name, value, semref, score in cursor.fetchall()
        ]


class SqliteTimestampToTextRangeIndex(interfaces.ITimestampToTextRangeIndex):
    """Range scans over Messages.start_timestamp (no separate table)."""

    def __init__(self, db: sqlite3.Connection):
        self.db = db

    async def size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(*) FROM Messages WHERE start_timestamp IS NOT NULL")
        return cursor.fetchone()[0]

    async def add_timestamp(
        self, message_ordinal: interfaces.MessageOrdinal, timestamp: str
    ) -> bool:
        cursor = self.db.cursor()
        cursor.execute(
            "UPDATE Messages SET start_timestamp = ? WHERE msg_id = ?",
            (timestamp, message_ordinal),
        )
        return cursor.rowcount > 0

    async def add_timestamps(
        self, message_timestamps: list[tuple[interfaces.MessageOrdinal, str]]
    ) -> None:
        if not message_timestamps:
            return
        cursor = self.db.cursor()
        cursor.executemany(
            "UPDATE Messages SET start_timestamp = ? WHERE msg_id = ?",
            [(ts, ordinal) for ordinal, ts in message_timestamps],
        )

    async def lookup_range(
        self, date_range: interfaces.DateRange
    ) -> list[interfaces.TimestampedTextRange]:
        cursor = self.db.cursor()
        start_ts = format_timestamp_utc(date_range.start)
        if date_range.end is None:
            cursor.execute(
                "SELECT msg_id, start_timestamp FROM Messages "
                "WHERE start_timestamp = ? ORDER BY msg_id",
                (start_ts,),
            )
        else:
            end_ts = format_timestamp_utc(date_range.end)
            cursor.execute(
                "SELECT msg_id, start_timestamp FROM Messages "
                "WHERE start_timestamp >= ? AND start_timestamp < ? ORDER BY msg_id",
                (start_ts, end_ts),
            )
        return [
            interfaces.TimestampedTextRange(
                timestamp=ts,
                range=interfaces.TextRange(
                    start=interfaces.TextLocation(msg_id, 0), end=None
                ),
            )
            for msg_id, ts in cursor.fetchall()
        ]
