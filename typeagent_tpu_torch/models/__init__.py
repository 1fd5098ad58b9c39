"""Model adapters: embedding + chat providers, caching, structured translation.

The port of ``typeagent_tpu/models/``. The reference delegates provider
wiring to pydantic-ai/openai/typechat (`aitools/model_adapters.py`). This
framework is standalone: an OpenAI-compatible HTTP adapter (``http.client``
here, httpx in the JAX package), its own retry layer, and its own
structured-JSON translation (`models/structured.py`).
"""

from .embeddings import (
    CachingEmbeddingModel,
    IEmbedder,
    IEmbeddingModel,
    NormalizedEmbedding,
    NormalizedEmbeddings,
    TEST_MODEL_NAME,
)
from .adapters import (
    create_chat_model,
    create_embedding_model,
    create_test_embedding_model,
    configure_models,
)
from .result import Failure, Result, Success
from .structured import PromptSection, TypedTranslator

__all__ = [
    "CachingEmbeddingModel",
    "IEmbedder",
    "IEmbeddingModel",
    "NormalizedEmbedding",
    "NormalizedEmbeddings",
    "TEST_MODEL_NAME",
    "create_chat_model",
    "create_embedding_model",
    "create_test_embedding_model",
    "configure_models",
    "Failure",
    "Result",
    "Success",
    "PromptSection",
    "TypedTranslator",
]
