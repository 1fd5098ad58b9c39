"""Deterministic offline embedding and chat models.

The HTTP chat and embedding adapters of the JAX package
(``typeagent_tpu/models/adapters.py``) are not ported yet: they need
``httpx`` (ROADMAP.md Queue 1 item 14). What the store's tests and
``chip_smoke.py`` need is the deterministic fake embedder, which gives the
same vector for the same string in every process and in both packages, and
the fake chat model; :func:`create_chat_model` builds only the ``test``
provider and raises for every other spec.
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

from .result import Failure, Result, Success
from .retry import AsyncRetrier
from .structured import IChatModel, PromptSection

__all__ = [
    "FakeChatModel",
    "FakeEmbedder",
    "create_chat_model",
    "create_embedding_model",
    "create_test_embedding_model",
]


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


def create_embedding_model(
    model_spec: str | None = None,
    retrier: AsyncRetrier | None = None,
) -> CachingEmbeddingModel:
    """The embedding model of a ``provider:model`` spec: ``test`` or
    ``test:<dim>`` (the offline deterministic embedder, 3 wide unless a
    width is given) is built here; every HTTP provider, and the default
    spec, raises."""
    provider, _, model_name = (model_spec or "").partition(":")
    if model_spec is not None and provider == "test":
        return create_test_embedding_model(int(model_name) if model_name.isdigit() else 3)
    raise NotImplementedError(
        "the HTTP embedding adapters are not ported yet (ROADMAP.md Queue 1 "
        f"item 14), so there is no embedding model for {model_spec or 'the default spec'!r}; "
        "use the 'test' or 'test:<dim>' spec or pass a model "
        "(e.g. models.adapters.create_test_embedding_model())"
    )


class FakeChatModel:
    """Offline chat model returning canned or echo responses (for tests)."""

    model_name = TEST_MODEL_NAME

    def __init__(self, responses: list[str] | None = None):
        self.responses = list(responses or [])
        self.prompts: list = []

    async def complete(self, prompt: list[PromptSection]) -> Result[str]:
        self.prompts.append(prompt)
        if self.responses:
            return Success(self.responses.pop(0))
        return Failure("FakeChatModel has no canned responses left")


def create_chat_model(
    model_spec: str | None = None,
    *,
    retrier: AsyncRetrier | None = None,
) -> IChatModel:
    """The chat model of a ``provider:model`` spec: only ``test`` is built
    here; every HTTP provider, and the default spec, raises."""
    if model_spec is not None and model_spec.partition(":")[0] == "test":
        return FakeChatModel()
    raise NotImplementedError(
        "the HTTP chat adapters are not ported yet (ROADMAP.md Queue 1 item "
        f"14), so there is no chat model for {model_spec or 'the default spec'!r}; "
        "pass a chat model (e.g. models.adapters.FakeChatModel or "
        "models.canned.CannedChatModel)"
    )
