"""The corpus scale-out path on one CUDA device.

The JAX package shards the fragment axis (embedding rows) over a device
mesh; this port keeps that store's API and its per-shard program plus
merge structure on one device. Meshes of several devices are ROADMAP.md
Queue 1 item 9.
"""

from .corpus import CorpusHit, CorpusVectorStore
from .sharded import ShardedVectorStore

__all__ = ["ShardedVectorStore", "CorpusVectorStore", "CorpusHit"]
