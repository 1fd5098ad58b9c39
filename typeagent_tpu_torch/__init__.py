"""PyTorch and CUDA port of typeagent-tpu.

The JAX package ``typeagent_tpu`` is the reference; this package mirrors
its module names. It holds the device-resident embedding store
(``vectorstore.VectorStore``), its coalescing server
(``serve.LookupBatcher``), the hand-written Hopper kernels under them
(``ops/topk.py``, sources in ``csrc/``), and the conversation layer
(``knowpro/``, ``storage/memory/``): the data model, the six indexes,
batch and streaming ingest, the ``_data.json`` snapshot and the query
pipeline behind ``ConversationBase.query()``. It imports torch, numpy and
the standard library only; kernels build at first use, never at import.
"""

from typing import TYPE_CHECKING as _TYPE_CHECKING, Any as _Any

if _TYPE_CHECKING:
    from .knowpro.conversation_base import ConversationBase


def create_conversation(*args: _Any, **kwargs: _Any) -> "ConversationBase":
    """Create a conversation (lazy import; see knowpro.factory)."""
    from .knowpro.factory import create_conversation as _create

    return _create(*args, **kwargs)


def __getattr__(name: str) -> _Any:
    # Lazy exports so `import typeagent_tpu_torch` stays light.
    if name == "ConversationSettings":
        from .knowpro.convsettings import ConversationSettings

        return ConversationSettings
    if name == "ConversationBase":
        from .knowpro.conversation_base import ConversationBase

        return ConversationBase
    if name == "ConversationMessage":
        from .knowpro.universal_message import ConversationMessage

        return ConversationMessage
    if name == "ConversationMessageMeta":
        from .knowpro.universal_message import ConversationMessageMeta

        return ConversationMessageMeta
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "create_conversation",
    "ConversationSettings",
    "ConversationBase",
    "ConversationMessage",
    "ConversationMessageMeta",
]
