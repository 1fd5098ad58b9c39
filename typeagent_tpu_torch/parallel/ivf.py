"""Sharded IVF: per-shard learned buckets and the winner merge (port of
``typeagent_tpu/parallel/ivf.py``).

Each shard builds an independent IVF index (``ops/ivf.py``) over its own
live rows, on its own device, with row ordinals local to the shard; a dp
rank whose shard sits on another device gets a copy of that shard's index
there. A search runs each shard's IVF program, shifts its ordinals to
global ones, merges the shards' winners on the dp rank's first device
(``sharded._merge_shard_winners``) and ANDs their certificates. The AND is
sound across the merge: the merged k-th score is at least every shard's
k-th score, each shard's certificate bounds the buckets it excluded, and
every tail was scanned exactly.

A shard with no live rows at build time gets a dead index: it holds no
rows, is not searched, and its certificate counts as True (the JAX
package pads such a shard with dead buckets, because its one SPMD program
needs every shard's arrays; here each shard is launched on its own).
Rows appended after the snapshot are found by the store (an exact interval
scan merged on the host), as in the JAX package.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, NamedTuple

import numpy as np
import torch

from ..ops.ivf import IVFState, ivf_build, ivf_topk_program

if TYPE_CHECKING:
    from .sharded import ShardedVectorStore

__all__ = ["ShardedIVF", "build_sharded_ivf", "sharded_ivf_search_dispatch"]


class ShardedIVF(NamedTuple):
    """Per-shard IVF snapshots of a :class:`ShardedVectorStore`.

    ``states[i][s]`` is shard s's index as dp rank i holds it, with LOCAL
    row ordinals, or None for a dead shard; shard s owns global rows from
    ``s * local_n``. ``local_n`` is the rows per shard at build time
    (later growth moves rows between shards but never a global ordinal,
    so the build-time offsets stay right); ``built_count`` is the store
    count the snapshot covers.
    """

    states: tuple[tuple[IVFState | None, ...], ...]
    local_n: int
    built_count: int


def _state_on(state: IVFState, device: torch.device) -> IVFState:
    return IVFState(*(t.to(device) if isinstance(t, torch.Tensor) else t for t in state))


def build_sharded_ivf(store: ShardedVectorStore, **build_kwargs: Any) -> ShardedIVF:
    """Build per-shard IVF indexes over a store's live rows, each on its
    shard's device; ``build_kwargs`` go to :func:`ops.ivf.ivf_build`.
    Raises on an empty or int8 store."""
    with store._view() as count:
        if count == 0:
            raise ValueError("build_sharded_ivf: store is empty")
        if store._quantized:
            raise ValueError("sharded IVF supports float32/bfloat16 stores only")
        local_n = store.local_n
        built = []
        for s, rows in enumerate(store.shard_rows(0)):
            local_count = max(0, min(count - s * local_n, local_n))
            built.append(ivf_build(rows, local_count, **build_kwargs) if local_count else None)
        states = []
        for i in range(store.n_dp):
            row = []
            for s, state in enumerate(built):
                device = store.mesh.devices[i, s]
                same = state is None or state.emb_r.device == device
                row.append(state if same else _state_on(state, device))
            states.append(tuple(row))
        return ShardedIVF(tuple(states), local_n, count)


def _shard_ivf_topk(state: IVFState, offset: int, q: torch.Tensor, k: int, B: int):
    """One shard's IVF program: ``(vals, idx, cert)`` with GLOBAL ordinals."""
    vals, idx, cert = ivf_topk_program(*state, q, k, B=B)
    return vals, torch.where(idx >= 0, idx + offset, -1), cert


def sharded_ivf_search_dispatch(
    store: ShardedVectorStore, snapshot: ShardedIVF, queries: np.ndarray, k: int,
    min_score: float,
) -> tuple[torch.Tensor, ...]:
    """Launch every live shard's IVF program and the merges without
    waiting: ``(vals, idx, cert)`` on the store's first device, ordinals
    global, rows padded as :meth:`ShardedVectorStore._query_blocks` pads
    them."""
    from .sharded import _merge_shard_winners, gather_winners

    blocks = store._query_blocks(queries)
    launched = []
    for i, states in enumerate(snapshot.states):
        parts = [
            _shard_ivf_topk(state, s * snapshot.local_n, blocks[i][store.mesh.devices[i, s]],
                            k, store.ivf_b)
            for s, state in enumerate(states)
            if state is not None
        ]
        launched.append(parts)
    ranks = []
    for i, parts in enumerate(launched):
        vals, idx, certs = gather_winners(
            [(v, x, c[:, None]) for v, x, c in parts], store.mesh.devices[i, 0]
        )
        mvals, midx = _merge_shard_winners(vals, idx, min(k, vals.shape[1]), min_score)
        ranks.append((mvals, midx, certs.all(dim=1)))
    if len(ranks) == 1:
        return ranks[0]
    return tuple(torch.cat([r[j].to(store.device) for r in ranks], dim=0) for j in range(3))
