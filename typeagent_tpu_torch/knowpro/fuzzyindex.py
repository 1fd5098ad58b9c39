"""EmbeddingIndex: thin facade over the device VectorStore.

The port of ``typeagent_tpu/knowpro/fuzzyindex.py``, over the port's
``VectorStore`` (its kernels run when the settings' device is a card).
(Parity: reference knowpro/fuzzyindex.py — a wrapper re-exporting VectorBase
ops as get_indexes_of_nearest / push / add_texts.)
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np

from ..vectorstore import ScoredInt, TextEmbeddingIndexSettings, VectorStore


class EmbeddingIndex:
    """Device-backed embedding index with nearest-neighbor lookups."""

    def __init__(
        self,
        settings: TextEmbeddingIndexSettings,
        embeddings: np.ndarray | None = None,
    ):
        self._vector_base = VectorStore(settings)
        if embeddings is not None:
            self._vector_base.add_embeddings(None, embeddings)

    def __len__(self) -> int:
        return len(self._vector_base)

    async def size(self) -> int:
        return len(self._vector_base)

    async def is_empty(self) -> bool:
        return len(self._vector_base) == 0

    async def get_embedding(self, key: str, cache: bool = True) -> np.ndarray:
        return await self._vector_base.get_embedding(key, cache)

    async def get_embeddings(
        self, keys: list[str], cache: bool = True
    ) -> np.ndarray:
        return await self._vector_base.get_embeddings(keys, cache=cache)

    def host_rows(self, start: int, stop: int) -> np.ndarray:
        """Live rows [start, stop) as host f32 — O(stop-start) incremental
        sync for mirrors (e.g. ConversationCorpus.refresh)."""
        return self._vector_base.host_rows(start, stop)

    def get(self, pos: int) -> np.ndarray:
        return self._vector_base.get_embedding_at(pos)

    def push(self, embeddings: np.ndarray) -> None:
        self._vector_base.add_embeddings(None, embeddings)

    async def add_texts(self, texts: list[str]) -> None:
        await self._vector_base.add_keys(texts)

    def get_indexes_of_nearest(
        self,
        embedding: np.ndarray,
        max_matches: int | None = None,
        min_score: float | None = None,
        predicate: Callable[[int], bool] | None = None,
    ) -> list[ScoredInt]:
        return self._vector_base.fuzzy_lookup_embedding(
            embedding, max_hits=max_matches, min_score=min_score, predicate=predicate
        )

    def get_indexes_of_nearest_batch(
        self,
        embeddings: np.ndarray,
        max_matches: int | None = None,
        min_score: float | None = None,
    ) -> list[list[ScoredInt]]:
        """Batched lookup: one fused device call for all queries."""
        return self._vector_base.fuzzy_lookup_embeddings_batch(
            embeddings, max_hits=max_matches, min_score=min_score
        )

    async def get_indexes_of_nearest_batch_async(
        self,
        embeddings: np.ndarray,
        max_matches: int | None = None,
        min_score: float | None = None,
    ) -> list[list[ScoredInt]]:
        """Async batched lookup through the store's LookupBatcher: the
        event loop stays live during the device round trip and concurrent
        callers' lookups coalesce into shared dispatches."""
        if len(self._vector_base) == 0:
            return [[] for _ in range(np.asarray(embeddings).shape[0])]
        return await self._vector_base.fuzzy_lookup_embeddings_batch_async(
            embeddings, max_hits=max_matches, min_score=min_score
        )

    def get_indexes_of_nearest_in_subset(
        self,
        embedding: np.ndarray,
        ordinals_of_subset: list[int],
        max_matches: int | None = None,
        min_score: float | None = None,
    ) -> list[ScoredInt]:
        return self._vector_base.fuzzy_lookup_embedding_in_subset(
            embedding, ordinals_of_subset, max_matches, min_score
        )

    async def get_indexes_of_nearest_in_subset_async(
        self,
        embedding: np.ndarray,
        ordinals_of_subset: list[int],
        max_matches: int | None = None,
        min_score: float | None = None,
    ) -> list[ScoredInt]:
        """Async subset lookup: the event loop stays live during the device
        round trip so concurrent queries overlap their re-rank fetches."""
        return await self._vector_base.fuzzy_lookup_embedding_in_subset_async(
            embedding, ordinals_of_subset, max_matches, min_score
        )

    def clear(self) -> None:
        self._vector_base.clear()

    def serialize(self) -> np.ndarray:
        return self._vector_base.serialize()

    def deserialize(self, embeddings: np.ndarray) -> None:
        assert isinstance(embeddings, np.ndarray), type(embeddings)
        assert embeddings.ndim == 2, embeddings.shape
        self._vector_base.deserialize(embeddings)
