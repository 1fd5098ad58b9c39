"""Embedding model interfaces and caching.

Behavioral parity with the reference (`aitools/embeddings.py`):
  * ``IEmbedder`` — minimal provider protocol (nocache single/batch).
  * ``IEmbeddingModel`` — consumer protocol adding cache methods.
  * ``CachingEmbeddingModel`` — exact-string in-memory cache; batch calls
    fill only the misses (`embeddings.py:106-114`).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
from numpy.typing import NDArray

type NormalizedEmbedding = NDArray[np.float32]  # A single embedding
type NormalizedEmbeddings = NDArray[np.float32]  # An array of embeddings

TEST_MODEL_NAME = "test"

# Model-specific Azure endpoint env-var lookup (parity: embeddings.py:119-123).
model_to_envvar: dict[str, str] = {
    "text-embedding-ada-002": "AZURE_OPENAI_ENDPOINT_EMBEDDING",
    "text-embedding-3-small": "AZURE_OPENAI_ENDPOINT_EMBEDDING_3_SMALL",
    "text-embedding-3-large": "AZURE_OPENAI_ENDPOINT_EMBEDDING_3_LARGE",
}


@runtime_checkable
class IEmbedder(Protocol):
    """Minimal provider interface: raw embedding computation only."""

    @property
    def model_name(self) -> str: ...

    async def get_embedding_nocache(self, input: str) -> NormalizedEmbedding: ...

    async def get_embeddings_nocache(self, input: list[str]) -> NormalizedEmbeddings: ...


@runtime_checkable
class IEmbeddingModel(Protocol):
    """Consumer-facing interface with caching."""

    @property
    def model_name(self) -> str: ...

    def add_embedding(self, key: str, embedding: NormalizedEmbedding) -> None: ...

    async def get_embedding_nocache(self, input: str) -> NormalizedEmbedding: ...

    async def get_embeddings_nocache(self, input: list[str]) -> NormalizedEmbeddings: ...

    async def get_embedding(self, key: str) -> NormalizedEmbedding: ...

    async def get_embeddings(self, keys: list[str]) -> NormalizedEmbeddings: ...


def normalize(embeddings: np.ndarray) -> NormalizedEmbeddings:
    """L2-normalize rows, guarding zero vectors (parity: model_adapters.py:176-184)."""
    embeddings = np.asarray(embeddings, dtype=np.float32)
    norms = np.linalg.norm(embeddings, axis=-1, keepdims=True).astype(np.float32)
    norms = np.where(norms > 0, norms, np.float32(1.0))
    return (embeddings / norms).astype(np.float32)


class CachingEmbeddingModel:
    """Wraps an :class:`IEmbedder` with an exact-string in-memory cache."""

    def __init__(self, embedder: IEmbedder) -> None:
        self._embedder = embedder
        self._cache: dict[str, NormalizedEmbedding] = {}

    @property
    def model_name(self) -> str:
        return self._embedder.model_name

    def add_embedding(self, key: str, embedding: NormalizedEmbedding) -> None:
        self._cache[key] = embedding

    async def get_embedding_nocache(self, input: str) -> NormalizedEmbedding:
        return await self._embedder.get_embedding_nocache(input)

    async def get_embeddings_nocache(self, input: list[str]) -> NormalizedEmbeddings:
        return await self._embedder.get_embeddings_nocache(input)

    async def get_embedding(self, key: str) -> NormalizedEmbedding:
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        embedding = await self._embedder.get_embedding_nocache(key)
        self._cache[key] = embedding
        return embedding

    async def get_embeddings(self, keys: list[str]) -> NormalizedEmbeddings:
        if not keys:
            raise ValueError("Cannot embed an empty list")
        missing = [k for k in keys if k not in self._cache]
        if missing:
            fresh = await self._embedder.get_embeddings_nocache(missing)
            for i, k in enumerate(missing):
                self._cache[k] = fresh[i]
        return np.array([self._cache[k] for k in keys], dtype=np.float32)
