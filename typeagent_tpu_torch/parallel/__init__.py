"""The corpus scale-out path on one CUDA device.

The JAX package shards the fragment axis (embedding rows) over a device
mesh; this port keeps that store's API and its per-shard program plus
merge structure on one device. ``ConversationCorpus`` mirrors many
conversations' message indexes into one such store. Meshes of several
devices are ROADMAP.md Queue 1 item 9.
"""

from .corpus import CorpusHit, CorpusVectorStore
from .sharded import ShardedVectorStore


def __getattr__(name: str) -> object:
    # Lazy: conversation_corpus pulls in the knowpro stack.
    if name in ("ConversationCorpus", "CorpusMessageHit"):
        from . import conversation_corpus

        return getattr(conversation_corpus, name)
    raise AttributeError(name)


__all__ = [
    "ShardedVectorStore",
    "CorpusVectorStore",
    "CorpusHit",
    "ConversationCorpus",
    "CorpusMessageHit",
]
