"""Sharded IVF on one CUDA device: per-shard learned buckets and the winner
merge (port of ``typeagent_tpu/parallel/ivf.py``).

Each shard builds an independent IVF index (``ops/ivf.py``) over its own
rows, with row ordinals local to the shard. A search runs each shard's IVF
program, shifts its ordinals to global ones, merges the shards' winners
(``sharded._merge_shard_winners``) and ANDs their certificates. The AND is
sound across the merge: the merged k-th score is at least every shard's
k-th score, each shard's certificate bounds the buckets it excluded, and
every tail was scanned exactly.

Here one device holds the store, so it is one shard (as
``parallel/sharded.py``), holding every live row. The JAX package stacks
the shards' states into mesh-sharded arrays (and gives a shard with no
live rows a dead index); with one device they stay a tuple of states.
Rows appended after the snapshot are found by the store (an exact interval
scan merged on the host), as in the JAX package.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, NamedTuple

import torch

from ..ops.ivf import IVFState, ivf_build, ivf_topk_program

if TYPE_CHECKING:
    from .sharded import ShardedVectorStore

__all__ = ["ShardedIVF", "build_sharded_ivf", "sharded_ivf_search_dispatch"]


class ShardedIVF(NamedTuple):
    """Per-shard IVF snapshots of a :class:`ShardedVectorStore`.

    ``states[s]`` is shard s's index, with LOCAL row ordinals; shard s owns
    global rows from ``s * local_n``.
    ``local_n`` is the rows per shard at build time (later growth never
    moves a global ordinal); ``built_count`` is the store count the
    snapshot covers.
    """

    states: tuple[IVFState, ...]
    local_n: int
    built_count: int


def build_sharded_ivf(store: ShardedVectorStore, **build_kwargs: Any) -> ShardedIVF:
    """Build per-shard IVF indexes over a store's live rows;
    ``build_kwargs`` go to :func:`ops.ivf.ivf_build`. Raises on an empty
    or int8 store."""
    with store._view() as (buf, _scales, count):
        if count == 0:
            raise ValueError("build_sharded_ivf: store is empty")
        if store._quantized:
            raise ValueError("sharded IVF supports float32/bfloat16 stores only")
        # One shard: the whole buffer, at row offset 0.
        return ShardedIVF((ivf_build(buf, count, **build_kwargs),), buf.shape[0], count)


def _shard_ivf_topk(state: IVFState, offset: int, q: torch.Tensor, k: int, B: int):
    """One shard's IVF program: ``(vals, idx, cert)`` with GLOBAL ordinals."""
    vals, idx, cert = ivf_topk_program(*state, q, k, B=B)
    return vals, torch.where(idx >= 0, idx + offset, -1), cert


def sharded_ivf_search_dispatch(
    store: ShardedVectorStore, snapshot: ShardedIVF, q_padded: torch.Tensor, k: int,
    min_score: float,
) -> tuple[torch.Tensor, ...]:
    """Launch the per-shard IVF search and the merge without waiting:
    ``(vals, idx, cert)`` device tensors, ordinals global."""
    from .sharded import _merge_shard_winners

    parts = [
        _shard_ivf_topk(state, s * snapshot.local_n, q_padded, k, store.ivf_b)
        for s, state in enumerate(snapshot.states)
    ]
    vals = torch.cat([p[0] for p in parts], dim=1)
    idx = torch.cat([p[1] for p in parts], dim=1)
    cert = torch.stack([p[2] for p in parts]).all(dim=0)
    mvals, midx = _merge_shard_winners(vals, idx, min(k, vals.shape[1]), min_score)
    return mvals, midx, cert
