"""Deterministic offline embedding models.

The HTTP chat and embedding adapters of the JAX package
(``typeagent_tpu/models/adapters.py``) are not ported yet: they need
``httpx``. What the store's tests and ``chip_smoke.py`` need is the
deterministic fake, which gives the same vector for the same string in
every process and in both packages.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .embeddings import (
    TEST_MODEL_NAME,
    CachingEmbeddingModel,
    NormalizedEmbedding,
    NormalizedEmbeddings,
    normalize,
)

__all__ = ["FakeEmbedder", "create_test_embedding_model"]


def _fake_embedding(text: str, size: int) -> np.ndarray:
    """Deterministic pseudo-embedding: sha256-seeded floats, unnormalized.

    Same string -> same vector across runs and processes. Raises on empty
    input.
    """
    if not text:
        raise ValueError("Empty input text")
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    rng = np.random.default_rng(np.frombuffer(digest[:16], dtype=np.uint64))
    return rng.random(size, dtype=np.float32)


class FakeEmbedder:
    """Offline deterministic embedder for hermetic tests (model_name='test')."""

    def __init__(self, embedding_size: int = 3):
        self._size = embedding_size

    @property
    def model_name(self) -> str:
        return TEST_MODEL_NAME

    async def get_embedding_nocache(self, input: str) -> NormalizedEmbedding:
        return normalize(_fake_embedding(input, self._size))

    async def get_embeddings_nocache(self, input: list[str]) -> NormalizedEmbeddings:
        if not input:
            raise ValueError("Cannot embed an empty list")
        return normalize(np.stack([_fake_embedding(t, self._size) for t in input]))


def create_test_embedding_model(embedding_size: int = 3) -> CachingEmbeddingModel:
    """Deterministic offline embedding model — no keys, no network."""
    return CachingEmbeddingModel(FakeEmbedder(embedding_size))
