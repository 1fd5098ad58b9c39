"""Conversation settings tree (parity: reference knowpro/convsettings.py).

The port of ``typeagent_tpu/knowpro/convsettings.py``. All index settings
share one embedding model (one shared cache). Defaults: related-terms
min_score 0.85 / max 50 matches, message-text min_score 0.70, extraction
concurrency 4, auto-extract on.

With no ``model``, the settings build the default HTTP embedding model
from the environment (``models.adapters.create_embedding_model`` with
``embed_retrier``), as the JAX settings do. One difference: ``device``
names where every embedding-backed index (message text, related-terms
fuzzy index, threads) keeps its rows. It defaults to the card, and
without a card the settings raise unless ``device="cpu"`` is given:
nothing falls back to the CPU on its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.embeddings import IEmbeddingModel
from ..models.retry import AsyncRetrier
from ..vectorstore import TextEmbeddingIndexSettings
from .interfaces import IKnowledgeExtractor, IStorageProvider

DEFAULT_RELATED_TERM_MIN_SCORE = 0.85
DEFAULT_MESSAGE_TEXT_MIN_SCORE = 0.7
DEFAULT_RELATED_TERM_MAX_MATCHES = 50
DEFAULT_EXTRACTION_CONCURRENCY = 4


@dataclass
class MessageTextIndexSettings:
    """Index 4 (message text <-> chunk embeddings) knobs."""

    embedding_index_settings: TextEmbeddingIndexSettings


@dataclass
class RelatedTermIndexSettings:
    """Index 5 (related-terms fuzzy expansion) knobs."""

    embedding_index_settings: TextEmbeddingIndexSettings


@dataclass
class SemanticRefIndexSettings:
    """LLM knowledge-extraction knobs for index 1."""

    concurrency: int
    auto_extract_knowledge: bool
    knowledge_extractor: IKnowledgeExtractor | None = None


class ConversationSettings:
    """Settings for conversation processing and indexing.

    The storage provider is lazy: constructing settings never touches disk;
    `get_storage_provider()` materializes an in-memory provider on first use
    unless one was injected.
    """

    def __init__(
        self,
        model: IEmbeddingModel | None = None,
        storage_provider: IStorageProvider | None = None,
        *,
        chat_retrier: AsyncRetrier | None = None,
        embed_retrier: AsyncRetrier | None = None,
        mesh: object | None = None,
        embedding_dtype: str = "float32",
        search_mode: str = "exact",
        device: str | torch.device = "cuda",
    ):
        self.chat_retrier = chat_retrier
        self.embed_retrier = embed_retrier
        self._storage_provider = storage_provider
        self.mesh = mesh

        if model is None:
            from ..models.adapters import create_embedding_model

            model = create_embedding_model(retrier=embed_retrier)
        self.embedding_model = model

        def emb(min_score: float, max_matches: int | None = None) -> TextEmbeddingIndexSettings:
            return TextEmbeddingIndexSettings(
                model,
                min_score=min_score,
                max_matches=max_matches,
                dtype=embedding_dtype,
                mesh=mesh,
                search_mode=search_mode,
                device=device,
            )

        self.related_term_index_settings = RelatedTermIndexSettings(
            emb(DEFAULT_RELATED_TERM_MIN_SCORE, DEFAULT_RELATED_TERM_MAX_MATCHES)
        )
        self.thread_settings = emb(DEFAULT_RELATED_TERM_MIN_SCORE)
        self.message_text_index_settings = MessageTextIndexSettings(
            emb(DEFAULT_MESSAGE_TEXT_MIN_SCORE)
        )
        self.device = self.thread_settings.device
        self.semantic_ref_index_settings = SemanticRefIndexSettings(
            concurrency=DEFAULT_EXTRACTION_CONCURRENCY,
            auto_extract_knowledge=True,
        )

    @property
    def storage_provider(self) -> IStorageProvider:
        provider = self._storage_provider
        if provider is None:
            raise RuntimeError(
                "Storage provider not initialized. Use await "
                "ConversationSettings.get_storage_provider() or provide "
                "storage_provider in the constructor."
            )
        return provider

    @storage_provider.setter
    def storage_provider(self, value: IStorageProvider) -> None:
        self._storage_provider = value

    async def get_storage_provider(self) -> IStorageProvider:
        if self._storage_provider is not None:
            return self._storage_provider
        from ..storage.memory import MemoryStorageProvider

        provider = MemoryStorageProvider(
            message_text_settings=self.message_text_index_settings,
            related_terms_settings=self.related_term_index_settings,
        )
        self._storage_provider = provider
        return provider
