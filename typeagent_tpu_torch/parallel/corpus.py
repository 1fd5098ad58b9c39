"""Multi-conversation corpus store: many conversations, one device matrix.

BASELINE.json config #5: a store holding millions of fragments across many
conversations. All conversations' chunk embeddings live in ONE matrix
(``ShardedVectorStore``); each conversation owns contiguous row segments.
Search targets one conversation, a set, or the whole corpus; scoping turns
the wanted conversations' segments into an interval table, from which the
device builds its row filter, so a scoped search costs the same fused scan
as a global one. With ``search_mode="approx"`` global searches ride the
approx route, with ``"ivf"`` the IVF snapshot once :meth:`build_ivf` has
run (exact until then); scoped searches stay exact either way. Port of ``typeagent_tpu/parallel/corpus.py`` on one
device (``device=`` takes the place of ``mesh=``).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import numpy as np
import torch

from .sharded import ShardedVectorStore

__all__ = ["CorpusVectorStore", "CorpusHit"]


@dataclass
class CorpusHit:
    conversation: str
    local_ordinal: int  # fragment ordinal within the conversation
    global_ordinal: int
    score: float


@dataclass
class _Segment:
    conversation: str
    start: int  # global row start
    count: int
    local_base: int  # conversation-local ordinal of the segment's first row


class CorpusVectorStore:
    """Append-only multi-tenant fragment store over one device matrix."""

    def __init__(
        self,
        dim: int,
        device: str | torch.device = "cuda",
        dtype: str | torch.dtype | None = None,
        search_mode: str = "exact",
        *,
        mesh: object | None = None,
    ):
        self._store = ShardedVectorStore(
            dim, dtype=dtype or "float32", search_mode=search_mode, device=device, mesh=mesh
        )
        self.device = self._store.device
        self._segments: list[_Segment] = []  # ordered by global start
        self._local_counts: dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._store)

    @property
    def conversations(self) -> list[str]:
        return list(self._local_counts)

    def count_for(self, conversation: str) -> int:
        return self._local_counts.get(conversation, 0)

    def append(self, conversation: str, rows: np.ndarray) -> None:
        """Append fragment embeddings for a conversation; rows are
        unit-normalized here, so the (cos+1)/2 score stays in [0, 1]
        whatever the caller's embedding scale."""
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[0] == 0:
            return
        norms = np.linalg.norm(rows, axis=1, keepdims=True)
        rows = rows / np.where(norms > 0, norms, 1.0)
        self._append_segment(conversation, rows.shape[0], self._store.append, rows)

    def reserve(self, n_rows: int) -> None:
        """Pre-size the device buffer for a known corpus size."""
        self._store.reserve(n_rows)

    def build_ivf(self, **build_kwargs) -> None:
        """Snapshot the corpus into per-shard IVF indexes
        (``parallel/ivf.py``): global searches of an ``"ivf"`` corpus then
        ride it (rows appended later through an exact suffix scan until the
        next build); scoped searches stay exact."""
        self._store.build_ivf(**build_kwargs)

    def append_device(self, conversation: str, rows: torch.Tensor | np.ndarray) -> None:
        """Bulk-adopt rows for a conversation, normalized on the device
        (no host round trip: the 10M-fragment ingest path)."""
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(rows).to(self.device)
        if rows.ndim != 2 or rows.shape[0] == 0:
            return
        norms = torch.linalg.vector_norm(rows.float(), dim=1, keepdim=True)
        unit = rows / torch.where(norms > 0, norms, 1.0)
        self._append_segment(conversation, rows.shape[0], self._store.append_device, unit)

    def adopt_quantized(
        self, q_rows: np.ndarray, scales: np.ndarray,
        segments: list[tuple[str, int, int, int]],
    ) -> None:
        """Replace an int8 corpus's contents with already quantized state:
        int8 rows ``[count, dim]``, f32 scales ``[count]`` and the segment
        list as ``(conversation, start, count, local_base)`` tuples (a JAX
        corpus's ``_store.buf``, ``_store._scales`` and ``_segments``)."""
        self._store.adopt_quantized(q_rows, scales)
        self._segments = [_Segment(*seg) for seg in segments]
        self._local_counts = {}
        for seg in self._segments:
            self._local_counts[seg.conversation] = max(
                self._local_counts.get(seg.conversation, 0), seg.local_base + seg.count
            )

    def _append_segment(self, conversation: str, n: int, store_append, rows) -> None:
        """Shared segment/local-count bookkeeping around a store append."""
        start = len(self._store)
        local_base = self._local_counts.get(conversation, 0)
        store_append(rows)
        self._segments.append(_Segment(conversation, start, n, local_base))
        self._local_counts[conversation] = local_base + n

    def _resolve(self, starts: list[int], global_ordinal: int) -> tuple[str, int]:
        segment = self._segments[bisect.bisect_right(starts, global_ordinal) - 1]
        return segment.conversation, segment.local_base + (global_ordinal - segment.start)

    def _segment_intervals(self, wanted: set[str]) -> np.ndarray:
        """[S, 2] (start, stop) table of the wanted conversations'
        segments, adjacent ones merged: O(segments) host work."""
        spans: list[tuple[int, int]] = []
        for seg in self._segments:
            if seg.conversation in wanted:
                start, stop = seg.start, seg.start + seg.count
                if spans and spans[-1][1] == start:  # merge adjacent
                    spans[-1] = (spans[-1][0], stop)
                else:
                    spans.append((start, stop))
        return np.asarray(spans, dtype=np.int32).reshape(-1, 2)

    def search(
        self,
        queries: np.ndarray,
        k: int,
        conversations: list[str] | None = None,
        min_score: float = 0.0,
    ) -> list[list[CorpusHit]]:
        """Batched corpus search, optionally scoped to conversations.

        Scoped search is EXACT: the target conversations' segments become
        an interval table and the device filters rows inside the fused
        scan, so a small conversation's best matches are never shadowed by
        other conversations' winners. Queries are unit-normalized here, as
        rows are on append.
        """
        queries = np.asarray(queries, dtype=np.float32)
        norms = np.linalg.norm(queries, axis=1, keepdims=True)
        queries = queries / np.where(norms > 0, norms, 1.0)
        if conversations is None:
            raw = self._store.search(queries, k, min_score)
        else:
            intervals = self._segment_intervals(set(conversations))
            if intervals.size == 0:
                return [[] for _ in range(queries.shape[0])]
            raw = self._store.search_intervals(queries, intervals, k, min_score)
        starts = [s.start for s in self._segments]
        results: list[list[CorpusHit]] = []
        for per_query in raw:
            hits: list[CorpusHit] = []
            for global_ordinal, score in per_query:
                conversation, local = self._resolve(starts, global_ordinal)
                hits.append(CorpusHit(conversation, local, global_ordinal, score))
            results.append(hits)
        return results
