"""SQLite related-terms index: alias table + fuzzy embeddings (BLOBs loaded
into the vector store on the settings' device at init; dedupe via an
added-terms set).

(Parity: reference storage/sqlite/reltermsindex.py.) Batched lookup_terms is
one batched store lookup (the reference loops per term).
The port of ``typeagent_tpu/storage/sqlite/reltermsindex.py``.
"""

from __future__ import annotations

import sqlite3

import numpy as np

from ...knowpro import interfaces
from ...utils.trace import span
from ...vectorstore import TextEmbeddingIndexSettings, VectorStore
from .schema import deserialize_embedding, serialize_embedding


class SqliteRelatedTermsAliases(interfaces.ITermToRelatedTerms):
    def __init__(self, db: sqlite3.Connection):
        self.db = db

    async def lookup_term(self, text: str) -> list[interfaces.Term] | None:
        cursor = self.db.cursor()
        cursor.execute("SELECT alias FROM RelatedTermsAliases WHERE term = ?", (text,))
        results = [interfaces.Term(row[0]) for row in cursor.fetchall()]
        return results or None

    async def add_related_term(
        self, text: str, related_terms: interfaces.Term | list[interfaces.Term]
    ) -> None:
        if isinstance(related_terms, interfaces.Term):
            related_terms = [related_terms]
        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT OR IGNORE INTO RelatedTermsAliases (term, alias) VALUES (?, ?)",
            [(text, rt.text) for rt in related_terms],
        )

    async def remove_term(self, text: str) -> None:
        self.db.cursor().execute(
            "DELETE FROM RelatedTermsAliases WHERE term = ?", (text,)
        )

    async def clear(self) -> None:
        self.db.cursor().execute("DELETE FROM RelatedTermsAliases")

    async def size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(DISTINCT term) FROM RelatedTermsAliases")
        return cursor.fetchone()[0]

    async def is_empty(self) -> bool:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(*) FROM RelatedTermsAliases")
        return cursor.fetchone()[0] == 0

    async def serialize(self) -> interfaces.TermToRelatedTermsData:
        cursor = self.db.cursor()
        cursor.execute("SELECT term, alias FROM RelatedTermsAliases ORDER BY term, alias")
        grouped: dict[str, list[str]] = {}
        for term, alias in cursor.fetchall():
            grouped.setdefault(term, []).append(alias)
        return interfaces.TermToRelatedTermsData(
            relatedTerms=[
                interfaces.TermsToRelatedTermsDataItem(
                    termText=term,
                    relatedTerms=[interfaces.TermData(text=a) for a in aliases],
                )
                for term, aliases in grouped.items()
            ]
        )

    async def deserialize(self, data: interfaces.TermToRelatedTermsData | None) -> None:
        cursor = self.db.cursor()
        cursor.execute("DELETE FROM RelatedTermsAliases")
        if data is None:
            return
        rows = []
        for item in data.get("relatedTerms") or []:
            if item and item.get("termText") and item.get("relatedTerms"):
                for term_data in item["relatedTerms"]:
                    rows.append((item["termText"], term_data["text"]))
        if rows:
            cursor.executemany(
                "INSERT INTO RelatedTermsAliases (term, alias) VALUES (?, ?)", rows
            )


class SqliteRelatedTermsFuzzy(interfaces.ITermToRelatedTermsFuzzy):
    def __init__(self, db: sqlite3.Connection, settings: TextEmbeddingIndexSettings):
        self.db = db
        self.settings = settings
        self._vector_base = VectorStore(settings)
        self._terms_list: list[str] = []
        self._added_terms: set[str] = set()
        with span("sqlite.related_terms.load"):
            self._load_from_db()

    def _load_from_db(self) -> None:
        if self._size() > 0:
            cursor = self.db.cursor()
            cursor.execute(
                "SELECT term, term_embedding FROM RelatedTermsFuzzy ORDER BY term"
            )
            rows = cursor.fetchall()
            embeddings = []
            for term, blob in rows:
                assert blob is not None, term
                self._terms_list.append(term)
                self._added_terms.add(term)
                embeddings.append(deserialize_embedding(blob))
            sizes = {len(e) for e in embeddings}
            if len(sizes) > 1:
                raise ValueError(
                    f"Embedding size mismatch: RelatedTermsFuzzy holds embeddings "
                    f"of sizes {sorted(sizes)}. The database may be corrupted."
                )
            self._vector_base.add_embeddings(None, np.array(embeddings))

    def _size(self) -> int:
        cursor = self.db.cursor()
        cursor.execute("SELECT COUNT(term) FROM RelatedTermsFuzzy")
        return cursor.fetchone()[0]

    async def size(self) -> int:
        return self._size()

    async def get_terms(self) -> list[str]:
        cursor = self.db.cursor()
        cursor.execute("SELECT term FROM RelatedTermsFuzzy ORDER BY term")
        return [row[0] for row in cursor.fetchall()]

    async def add_terms(self, texts: list[str]) -> None:
        new_terms = [t for t in texts if t not in self._added_terms]
        if not new_terms:
            return
        embeddings = await self._vector_base.get_embeddings(new_terms)
        await self.add_terms_with_embeddings(new_terms, list(embeddings))

    async def add_terms_with_embeddings(
        self, texts: list[str], embeddings: list[np.ndarray]
    ) -> None:
        if len(texts) != len(embeddings):
            raise ValueError(
                "texts and embeddings must have the same length: "
                f"{len(texts)} != {len(embeddings)}"
            )
        pairs = [
            (term, emb)
            for term, emb in zip(texts, embeddings)
            if term not in self._added_terms
        ]
        if not pairs:
            return
        new_terms = [t for t, _ in pairs]
        new_embeddings = [e for _, e in pairs]
        self._vector_base.add_embeddings(
            new_terms, np.stack(new_embeddings, axis=0).astype(np.float32, copy=False)
        )
        cursor = self.db.cursor()
        cursor.executemany(
            "INSERT OR REPLACE INTO RelatedTermsFuzzy (term, term_embedding) "
            "VALUES (?, ?)",
            [(t, serialize_embedding(e)) for t, e in pairs],
        )
        self._terms_list.extend(new_terms)
        self._added_terms.update(new_terms)

    async def lookup_term(
        self,
        text: str,
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[interfaces.Term]:
        matches = await self._vector_base.fuzzy_lookup(
            text, max_hits=max_hits, min_score=min_score
        )
        return [
            interfaces.Term(self._terms_list[m.item], m.score)
            for m in matches
            if m.item < len(self._terms_list)
        ]

    async def lookup_terms(
        self,
        texts: list[str],
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[list[interfaces.Term]]:
        """Batched: embed all texts, one fused device lookup."""
        if not texts:
            return []
        if max_hits is None:
            max_hits = self.settings.max_matches
        if min_score is None:
            min_score = self.settings.min_score
        queries = await self._vector_base.get_embeddings(texts)
        if max_hits is None:
            max_hits = len(self._vector_base)
        if len(self._vector_base) == 0:
            return [[] for _ in texts]
        batches = await self._vector_base.fuzzy_lookup_embeddings_batch_async(
            np.asarray(queries), max_hits=max_hits, min_score=min_score
        )
        return [
            [
                interfaces.Term(self._terms_list[m.item], m.score)
                for m in batch
                if m.item < len(self._terms_list)
            ]
            for batch in batches
        ]

    async def remove_term(self, term: str) -> None:
        raise NotImplementedError("Removal from the fuzzy index is not supported")

    async def clear(self) -> None:
        self.db.cursor().execute("DELETE FROM RelatedTermsFuzzy")
        self._vector_base.clear()
        self._terms_list.clear()
        self._added_terms.clear()

    def serialize(self) -> interfaces.TextEmbeddingIndexData:
        return interfaces.TextEmbeddingIndexData(
            textItems=self._terms_list.copy(),
            embeddings=self._vector_base.serialize(),
        )

    async def deserialize(self, data: interfaces.TextEmbeddingIndexData) -> None:
        await self.clear()
        text_items = data.get("textItems")
        embeddings_data = data.get("embeddings")
        if not text_items or embeddings_data is None:
            return
        self._vector_base.deserialize(embeddings_data)
        rows = []
        for i, text in enumerate(text_items):
            if i < len(self._vector_base):
                embedding = self._vector_base.get_embedding_at(i)
                rows.append((text, serialize_embedding(embedding)))
                self._terms_list.append(text)
                self._added_terms.add(text)
        if rows:
            self.db.cursor().executemany(
                "INSERT OR REPLACE INTO RelatedTermsFuzzy (term, term_embedding) "
                "VALUES (?, ?)",
                rows,
            )


class SqliteRelatedTermsIndex(interfaces.ITermToRelatedTermsIndex):
    def __init__(self, db: sqlite3.Connection, settings: TextEmbeddingIndexSettings):
        self.db = db
        self._aliases = SqliteRelatedTermsAliases(db)
        self._fuzzy_index = SqliteRelatedTermsFuzzy(db, settings)

    @property
    def aliases(self) -> interfaces.ITermToRelatedTerms:
        return self._aliases

    @property
    def fuzzy_index(self) -> interfaces.ITermToRelatedTermsFuzzy | None:
        return self._fuzzy_index

    async def serialize(self) -> interfaces.TermsToRelatedTermsIndexData:
        return interfaces.TermsToRelatedTermsIndexData(
            aliasData=await self._aliases.serialize(),
            textEmbeddingData=self._fuzzy_index.serialize(),
        )

    async def deserialize(self, data: interfaces.TermsToRelatedTermsIndexData) -> None:
        alias_data = data.get("aliasData")
        if alias_data is not None:
            await self._aliases.deserialize(alias_data)
        text_embedding_data = data.get("textEmbeddingData")
        if text_embedding_data is not None:
            await self._fuzzy_index.deserialize(text_embedding_data)
