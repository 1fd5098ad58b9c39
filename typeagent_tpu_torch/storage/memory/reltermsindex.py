"""Related-terms index: alias table + device-backed fuzzy term expansion.

(Parity: reference storage/memory/reltermsindex.py. Resolution rules:
aliases first; fuzzy fallback only when aliases found nothing; dedupe keeps
the max-weight occurrence of each related term across search terms and never
duplicates a term already used as a search term; skipped for "and" groups.)

The port of ``typeagent_tpu/storage/memory/reltermsindex.py``. As there,
``lookup_terms`` embeds the whole batch and runs ONE batched store lookup
for all query terms — the reference loops per term
(`reltermsindex.py:320-332`).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import TYPE_CHECKING, Protocol

import numpy as np

from ...knowpro.collections import TermSet
from ...knowpro.common import is_search_term_wildcard
from ...knowpro.convsettings import RelatedTermIndexSettings
from ...knowpro.interfaces import (
    IConversation,
    IMessage,
    ITermToRelatedTerms,
    ITermToRelatedTermsFuzzy,
    ITermToRelatedTermsIndex,
    ITermToSemanticRefIndex,
    SearchTerm,
    Term,
    TermsToRelatedTermsDataItem,
    TermsToRelatedTermsIndexData,
    TermToRelatedTermsData,
    TextEmbeddingIndexData,
)
from ...vectorstore import ScoredInt, TextEmbeddingIndexSettings, VectorStore

if TYPE_CHECKING:
    from ...knowpro.query import CompiledSearchTerm, CompiledTermGroup


class TermToRelatedTermsMap(ITermToRelatedTerms):
    """Alias table: term text -> set of related terms (weights ignored)."""

    def __init__(self):
        self.map: dict[str, dict[str, Term]] = {}

    async def add_related_term(
        self, text: str, related_terms: Term | list[Term]
    ) -> None:
        if not isinstance(related_terms, list):
            related_terms = [related_terms]
        terms = self.map.setdefault(text, {})
        for related in related_terms:
            terms.setdefault(related.text, related)

    async def lookup_term(self, text: str) -> list[Term] | None:
        result = self.map.get(text)
        return list(result.values()) if result else None

    async def remove_term(self, text: str) -> None:
        self.map.pop(text, None)

    async def clear(self) -> None:
        self.map.clear()

    async def size(self) -> int:
        return len(self.map)

    async def is_empty(self) -> bool:
        return len(self.map) == 0

    async def serialize(self) -> TermToRelatedTermsData:
        return TermToRelatedTermsData(
            relatedTerms=[
                TermsToRelatedTermsDataItem(
                    termText=key,
                    relatedTerms=[term.serialize() for term in value.values()],
                )
                for key, value in self.map.items()
            ]
        )

    async def deserialize(self, data: TermToRelatedTermsData | None) -> None:
        self.map.clear()
        if data is None:
            return
        items = data.get("relatedTerms")
        if items is None:
            return
        for item in items:
            await self.add_related_term(
                item["termText"],
                [
                    Term(td["text"], weight=td.get("weight"))
                    for td in item["relatedTerms"]
                ],
            )


class ITermEmbeddingIndex(ITermToRelatedTermsFuzzy, Protocol):
    def serialize(self) -> TextEmbeddingIndexData: ...
    def deserialize(self, data: TextEmbeddingIndexData) -> None: ...


class TermEmbeddingIndex(ITermEmbeddingIndex):
    """Device vector store over term texts; fuzzy expansion = batched top-k."""

    def __init__(
        self,
        settings: TextEmbeddingIndexSettings,
        data: TextEmbeddingIndexData | None = None,
    ):
        self.settings = settings
        self._vectorbase = VectorStore(settings)
        self._texts: list[str] = []
        if data:
            self.deserialize(data)

    def clear(self) -> None:
        self._vectorbase.clear()
        self._texts.clear()

    def serialize(self) -> TextEmbeddingIndexData:
        return TextEmbeddingIndexData(
            textItems=self._texts,
            embeddings=self._vectorbase.serialize(),
        )

    def deserialize(self, data: TextEmbeddingIndexData | None) -> None:
        self.clear()
        if data is not None:
            self._texts = data.get("textItems", [])
            self._vectorbase.deserialize(data.get("embeddings"))

    async def size(self) -> int:
        return len(self._vectorbase)

    async def add_terms(self, texts: list[str]) -> None:
        if not texts:
            return
        embeddings = await self._vectorbase.get_embeddings(texts)
        await self.add_terms_with_embeddings(texts, list(embeddings))

    async def add_terms_with_embeddings(
        self, texts: list[str], embeddings: list[np.ndarray]
    ) -> None:
        if len(texts) != len(embeddings):
            raise ValueError(
                "texts and embeddings must have the same length: "
                f"{len(texts)} != {len(embeddings)}"
            )
        if not texts:
            return
        array = np.stack(embeddings, axis=0).astype(np.float32, copy=False)
        self._vectorbase.add_embeddings(texts, array)
        self._texts.extend(texts)

    async def lookup_term(
        self, text: str, max_hits: int | None = None, min_score: float | None = None
    ) -> list[Term]:
        matches = await self._vectorbase.fuzzy_lookup(
            text, max_hits=max_hits, min_score=min_score
        )
        return self.matches_to_terms(matches)

    async def lookup_terms(
        self,
        texts: list[str],
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[list[Term]]:
        """Batched expansion: embed all texts, one fused device lookup."""
        if not texts:
            return []
        if max_hits is None:
            max_hits = self.settings.max_matches
        if min_score is None:
            min_score = self.settings.min_score
        queries = await self._vectorbase.get_embeddings(texts)
        if max_hits is None:
            max_hits = len(self._vectorbase)
        batches = await self._vectorbase.fuzzy_lookup_embeddings_batch_async(
            np.asarray(queries), max_hits=max_hits, min_score=min_score
        )
        return [self.matches_to_terms(m) for m in batches]

    def matches_to_terms(self, matches: list[ScoredInt]) -> list[Term]:
        return [Term(text=self._texts[m.item], weight=m.score) for m in matches]


class RelatedTermsIndex(ITermToRelatedTermsIndex):
    """Index 5: aliases + fuzzy expansion behind one surface."""

    def __init__(self, settings: RelatedTermIndexSettings):
        self.settings = settings
        self._alias_map = TermToRelatedTermsMap()
        self._term_index = TermEmbeddingIndex(settings.embedding_index_settings)

    @property
    def aliases(self) -> TermToRelatedTermsMap:
        return self._alias_map

    @property
    def fuzzy_index(self) -> ITermToRelatedTermsFuzzy | None:
        return self._term_index

    async def serialize(self) -> TermsToRelatedTermsIndexData:
        return TermsToRelatedTermsIndexData(
            aliasData=await self._alias_map.serialize(),
            textEmbeddingData=self._term_index.serialize(),
        )

    async def deserialize(self, data: TermsToRelatedTermsIndexData) -> None:
        await self._alias_map.clear()
        self._term_index.clear()
        await self._alias_map.deserialize(data.get("aliasData"))
        text_embedding_data = data.get("textEmbeddingData")
        if text_embedding_data is not None:
            self._term_index.deserialize(text_embedding_data)


async def build_related_terms_index[
    TMessage: IMessage,
    TTermToSemanticRefIndex: ITermToSemanticRefIndex,
](
    conversation: IConversation[TMessage, TTermToSemanticRefIndex],
    settings: RelatedTermIndexSettings,
) -> None:
    csr = conversation.semantic_ref_index
    csi = conversation.secondary_indexes
    if csr is not None and csi is not None:
        if csi.term_to_related_terms_index is None:
            csi.term_to_related_terms_index = RelatedTermsIndex(settings)
        fuzzy_index = csi.term_to_related_terms_index.fuzzy_index
        if fuzzy_index is not None:
            all_terms = await csr.get_terms()
            if all_terms:
                await fuzzy_index.add_terms(all_terms)


# ---------------------------------------------------------------------------
# Query-time related-term resolution
# ---------------------------------------------------------------------------


async def resolve_related_terms(
    related_terms_index: ITermToRelatedTermsIndex,
    compiled_terms: list["CompiledTermGroup"],
    ensure_single_occurrence: bool = True,
    should_resolve_fuzzy: Callable[[SearchTerm], bool] | None = None,
) -> None:
    """Fill in related_terms for search terms that have none (None).

    Aliases first; unresolved terms go to one batched fuzzy lookup. Modifies
    SearchTerm.related_terms in place. Terms with related_terms == [] are
    deliberately left alone.
    """
    all_search_terms = [term for ct in compiled_terms for term in ct.terms]
    searchable_terms = TermSet()
    needing_fuzzy: list[SearchTerm] = []

    for search_term in all_search_terms:
        if is_search_term_wildcard(search_term):
            continue
        searchable_terms.add_or_union(search_term.term)
        term_text = search_term.term.text
        if search_term.related_terms is None:
            search_term.related_terms = await related_terms_index.aliases.lookup_term(
                term_text
            )
        if search_term.related_terms is None:
            if should_resolve_fuzzy is None or should_resolve_fuzzy(search_term):
                needing_fuzzy.append(search_term)

    if related_terms_index.fuzzy_index is not None and needing_fuzzy:
        related_lists = await related_terms_index.fuzzy_index.lookup_terms(
            [st.term.text for st in needing_fuzzy]
        )
        for search_term, related_terms in zip(needing_fuzzy, related_lists):
            search_term.related_terms = related_terms

    # Fuzzy expansion can produce overlapping related terms across search
    # terms — dedupe to avoid double-counted scores ("and" groups excepted).
    for ct in compiled_terms:
        dedupe_related_terms(
            ct.terms, ensure_single_occurrence and ct.boolean_op != "and"
        )


def dedupe_related_terms(
    compiled_terms: list["CompiledSearchTerm"],
    ensure_single_occurrence: bool,
) -> None:
    all_search_terms = TermSet()
    all_related_terms: TermSet | None = None

    for st in compiled_terms:
        all_search_terms.add(st.term)
    if ensure_single_occurrence:
        all_related_terms = TermSet()
        for st in compiled_terms:
            all_related_terms.add_or_union(st.related_terms)

    for search_term in compiled_terms:
        if search_term.related_terms_required:
            continue
        if search_term.related_terms:
            unique: list[Term] = []
            for candidate in search_term.related_terms:
                if candidate in all_search_terms:
                    continue  # already a search term in its own right
                if ensure_single_occurrence and all_related_terms is not None:
                    # Keep one occurrence per related term: the max-weight one.
                    max_weight_term = all_related_terms.get(candidate)
                    if (
                        max_weight_term is not None
                        and max_weight_term.weight == candidate.weight
                    ):
                        unique.append(max_weight_term)
                        all_related_terms.remove(candidate)
                else:
                    unique.append(candidate)
            search_term.related_terms = unique
