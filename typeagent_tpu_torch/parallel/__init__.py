"""Multi-device scaling: device meshes and row-sharded search.

The fragment axis (embedding rows) shards over a (dp, shard) grid of
devices (``mesh.py``): each shard's fused top-k on its own device, then a
merge of the k winners on the dp rank's first device, with the query batch
split over the dp axis. ``ConversationCorpus`` mirrors many conversations'
message indexes into one such store; ``checkpoint.py`` saves and restores
stores and corpora across mesh shapes; ``multislice.py`` runs the search
across processes on ``torch.distributed``.
"""

from .corpus import CorpusHit, CorpusVectorStore
from .mesh import AXIS_DP, AXIS_SHARD, Mesh, create_mesh, default_mesh
from .sharded import ShardedVectorStore

_CHECKPOINT = (
    "PendingSave",
    "save_sharded_store",
    "restore_sharded_store",
    "save_corpus",
    "restore_corpus",
    "save_vector_store",
    "restore_vector_store",
)


def __getattr__(name: str) -> object:
    # Lazy: conversation_corpus pulls in the knowpro stack.
    if name in ("ConversationCorpus", "CorpusMessageHit"):
        from . import conversation_corpus

        return getattr(conversation_corpus, name)
    if name in _CHECKPOINT:
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(name)


__all__ = [
    "AXIS_DP",
    "AXIS_SHARD",
    "Mesh",
    "create_mesh",
    "default_mesh",
    "ShardedVectorStore",
    "CorpusVectorStore",
    "CorpusHit",
    "ConversationCorpus",
    "CorpusMessageHit",
    *_CHECKPOINT,
]
