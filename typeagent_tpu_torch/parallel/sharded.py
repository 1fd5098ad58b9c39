"""Row-sharded vector search, on one CUDA device.

The JAX package (``typeagent_tpu/parallel/sharded.py``) shards the
embedding matrix's row axis over a mesh and runs one SPMD program per
query batch: each shard's fused top-k over its local rows, an
``all_gather`` of the k winners, and a final top-k merge. Here one device
holds every row, so the store is a single shard; the search keeps the same
two steps as functions (a program per shard, then
:func:`_merge_shard_winners`), which at one shard only sorts and filters.
Sharding over several cards with NCCL (ROADMAP.md Queue 1 item 9) adds
the gather between them without reshaping the class.

Routes (``ops/topk.py``), as in the JAX package:

  * global search: the one-phase K1 for f32/bf16 stores, K6 for int8;
    ``search_mode="approx"``: each shard's approx route (the bucket argmax
    K2' on large shards, K1 below); ``search_mode="ivf"`` with a snapshot
    (:meth:`ShardedVectorStore.build_ivf`): each shard's IVF program
    (``parallel/ivf.py``), plus an exact interval scan of rows appended
    after the snapshot;
  * ``search_intervals``: a table of <= 8 intervals rides K4, a larger one
    a row mask built on the device and K5; an int8 store always takes the
    row mask and K7;
  * ``search_subset`` / ``search_masked``: K5, or K7 for int8.

``min_score`` is applied on the device; unfilled slots are (-1, -1).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any

import numpy as np
import torch

from ..ops import append as append_ops
from ..ops import topk
from ..vectorstore import _fetch

__all__ = ["ShardedVectorStore"]

_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_INTERVAL_BUCKETS = (8, 32, 128, 512)
# The ROADMAP.md Queue 1 item that ports what this store refuses.
_MESH_NOT_PORTED = "a mesh of devices (ROADMAP.md Queue 1 item 9)"


def _bucket_size(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + buckets[-1] - 1) // buckets[-1]) * buckets[-1]


def _local_count(count: int, offset: int, local_n: int) -> int:
    return max(0, min(count - offset, local_n))


def _to_global(vals: torch.Tensor, idx: torch.Tensor, offset: int):
    return vals, torch.where(vals >= 0.0, idx + offset, -1)


# ---------------------------------------------------------------------------
# Per-shard programs and the merge. Each program takes the shard's rows
# (and scales, None unless int8), the shard's row offset, the global count
# and the query block, and returns its top-k in global row ordinals.
# ---------------------------------------------------------------------------


def _shard_topk(emb, scales, offset: int, q, count: int, k: int):
    local_count = _local_count(count, offset, emb.shape[0])
    if scales is not None:
        out = topk.topk_program_quantized(emb, scales, q, local_count, k)
    else:
        out = topk.cosine_topk(emb, q, local_count, k)
    return _to_global(*out, offset)


def _shard_approx_topk(emb, scales, offset: int, q, count: int, k: int, *, recall_target: float):
    """The approx route over one shard (f32/bf16 rows; ``scales`` is None)."""
    local_count = _local_count(count, offset, emb.shape[0])
    out = topk.cosine_topk_approx(emb, q, local_count, k, recall_target=recall_target)
    return _to_global(*out, offset)


def _shard_masked_topk(emb, scales, offset: int, mask, q, count: int, k: int):
    """``mask``: this shard's [local_n] int32 slice of the row mask."""
    local_count = _local_count(count, offset, emb.shape[0])
    if scales is not None:
        out = topk.topk_program_masked_quantized(emb, scales, q, local_count, mask, k)
    else:
        out = topk.topk_program_masked(emb, q, local_count, mask, k)
    return _to_global(*out, offset)


def _shard_interval_topk(emb, scales, offset: int, intervals, q, count: int, k: int):
    """``intervals``: the global [s_pad, 2] table, shifted here into the
    shard's local rows so the kernels compare local row ids."""
    local_n = emb.shape[0]
    local_count = _local_count(count, offset, local_n)
    local_iv = (intervals - offset).clamp(0, local_n)
    if scales is not None:
        out = topk.topk_program_intervals_quantized(emb, scales, q, local_count, local_iv, k)
    else:
        out = topk.topk_program_intervals(emb, q, local_count, local_iv, k)
    return _to_global(*out, offset)


def _merge_shard_winners(vals, idx, k: int, min_score: float):
    """Merge the shards' winners (``[b, S*k]``, in shard order) into the
    top ``k`` and filter by ``min_score``. At one shard the gather is the
    identity. The stable sort keeps shard order among equal scores, so a
    tie stays at the lowest global row."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    merged_vals = vals.gather(1, order)
    merged_idx = idx.gather(1, order)
    keep = (merged_vals >= min_score) & (merged_idx >= 0)
    return torch.where(keep, merged_vals, topk._NEG), torch.where(keep, merged_idx, -1)


class ShardedVectorStore:
    """An appendable embedding matrix searched as row shards; one shard on
    one device here (BASELINE.json config #5's store).

    Mirrors the JAX class's feature set: pending-buffer batching, f32,
    bf16 and int8 storage, on-device min_score, exact subset, mask and
    interval search, approx and IVF global search, and
    serialize/deserialize round-trips. ``device`` takes the place of the
    JAX ``mesh``; passing ``mesh=`` raises.
    """

    def __init__(
        self,
        dim: int,
        dtype: str | torch.dtype = "float32",
        search_mode: str = "exact",
        recall_target: float = 0.95,
        ivf_b: int = 16,
        *,
        device: str | torch.device = "cuda",
        mesh: object | None = None,
    ):
        if mesh is not None:
            raise NotImplementedError(_MESH_NOT_PORTED)
        if isinstance(dtype, str):
            dtype = _DTYPE_NAMES[dtype]
        if dtype not in _DTYPE_NAMES.values():
            raise ValueError(f"dtype must be float32, bfloat16 or int8, got {dtype}")
        if search_mode not in ("exact", "approx", "ivf"):
            raise ValueError(f"unknown search_mode {search_mode!r}")
        if search_mode in ("approx", "ivf") and dtype == torch.int8:
            raise ValueError(f"search_mode={search_mode!r} supports float32/bfloat16 stores only")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        self.search_mode = search_mode
        self.recall_target = recall_target
        self.ivf_b = ivf_b  # buckets rescored per shard per query
        self._ivf = None  # parallel.ivf.ShardedIVF snapshot
        self.device = device
        self.dim = dim
        self.dim_pad = append_ops.round_up(dim, append_ops.LANES)
        self._dtype = dtype
        self._quantized = dtype == torch.int8
        self._pending: list[np.ndarray] = []  # host rows awaiting flush
        self._pending_rows = 0
        # Guards the pending list and its counter only: an append landing
        # between a flush's concatenate and its reset would be lost.
        self._pending_lock = threading.Lock()
        # Held while a flush grows or writes the buffer and while a search
        # launches against it, so no search pairs an old buffer with a new
        # count; fetches wait for the device outside it.
        self._lock = threading.RLock()
        self._reset_buffers()

    def _reset_buffers(self) -> None:
        cap = append_ops.MIN_CAPACITY
        self.buf = append_ops.make_buffer(cap, self.dim_pad, self._dtype, self.device)
        self._scales = append_ops.make_scales(cap, self.device) if self._quantized else None
        self.count = 0  # rows committed to the device buffer

    def __len__(self) -> int:
        return self.count + self._pending_rows

    # -- appends -------------------------------------------------------------

    def append(self, rows: np.ndarray) -> None:
        """Buffer unit-normalized rows for append (CorpusVectorStore
        normalizes for you); they flush before the next search."""
        rows = np.asarray(rows, dtype=np.float32)
        if rows.ndim != 2 or rows.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}] rows, got {rows.shape}")
        if rows.shape[0] == 0:
            return
        with self._pending_lock:
            self._pending.append(rows)
            self._pending_rows += rows.shape[0]

    def reserve(self, n_rows: int) -> None:
        """Pre-size the buffer for a known ingest (``round_up(n_rows,
        1024)`` rows), instead of doubling past it."""
        needed = append_ops.round_up(max(int(n_rows), 1), 1024)
        with self._lock:
            self._grow_to(needed)

    def _grow_to(self, capacity: int) -> None:
        if capacity <= self.buf.shape[0]:
            return
        self.buf = append_ops.grow_buffer(self.buf, capacity, exact_capacity=capacity)
        if self._quantized:
            self._scales = append_ops.grow_scales(self._scales, self.buf.shape[0])

    def _grow(self, needed: int) -> None:
        cap = self.buf.shape[0]
        while cap < needed:
            cap *= 2
        self._grow_to(cap)

    def _write_rows(self, rows: torch.Tensor) -> None:
        """Write ``[n, dim]`` f32/bf16 rows at the watermark (quantized
        first for an int8 store); caller holds the lock."""
        n = rows.shape[0]
        self._grow(self.count + n)
        if self._quantized:
            rows, row_scales = topk.quantize_rows_device(rows)
            append_ops.append_rows(self._scales, row_scales, self.count)
        self.buf[self.count : self.count + n, : self.dim].copy_(rows)
        self.count += n

    def append_device(self, rows: torch.Tensor) -> None:
        """Bulk-adopt unit-normalized ``[n, dim]`` rows already on the
        store's device, with no host round trip (an on-device encoder or
        generator, a restore)."""
        n, size = rows.shape
        if size != self.dim:
            raise ValueError(f"rows of width {size}, store width {self.dim}")
        if rows.device.type != self.device.type:
            raise ValueError(f"rows on {rows.device}, store on {self.device}")
        with self._lock:
            self._flush_locked()
            if n:
                self._write_rows(rows)

    def adopt_quantized(self, q_rows: np.ndarray, scales: np.ndarray) -> None:
        """Replace an int8 store's contents with already quantized state:
        int8 rows ``[count, dim]`` and f32 scales ``[count]`` (for example
        a JAX store's ``buf``/``_scales``), bytes kept as given."""
        if not self._quantized:
            raise ValueError("adopt_quantized needs an int8 store")
        q_rows = np.array(q_rows, dtype=np.int8)  # a writable copy for torch
        scales = np.array(scales, dtype=np.float32)
        n = q_rows.shape[0]
        if q_rows.shape != (n, self.dim) or scales.shape != (n,):
            raise ValueError(f"rows {q_rows.shape} and scales {scales.shape} for dim {self.dim}")
        self.clear()
        with self._lock:
            self._grow(n)
            self.buf[:n, : self.dim].copy_(torch.from_numpy(q_rows))
            append_ops.append_rows(self._scales, scales, 0)
            self.count = n

    def _take_pending(self) -> np.ndarray | None:
        with self._pending_lock:
            if not self._pending:
                return None
            pending = self._pending
            self._pending = []
            self._pending_rows = 0
        return np.concatenate(pending, axis=0)

    def _flush_locked(self) -> None:
        rows = self._take_pending()
        if rows is None:
            return
        if self._quantized:
            # int8 rows quantize on the host from f32, as in the JAX store.
            n = rows.shape[0]
            self._grow(self.count + n)
            q_rows, row_scales = topk.quantize_rows(rows)
            self.buf[self.count : self.count + n, : self.dim].copy_(torch.from_numpy(q_rows))
            append_ops.append_rows(self._scales, row_scales, self.count)
            self.count += n
        else:
            # f32 rows go up as they are; a bf16 buffer casts them on the device.
            self._write_rows(torch.from_numpy(rows).to(self.device))

    def _flush(self) -> None:
        with self._lock:
            self._flush_locked()

    @contextlib.contextmanager
    def _view(self):
        """Flush, then hold the lock while the caller launches against the
        yielded ``(buf, scales, count)``."""
        with self._lock:
            self._flush_locked()
            yield self.buf, self._scales, self.count

    # -- lookups ---------------------------------------------------------------

    def _pad_queries(self, queries: np.ndarray) -> torch.Tensor:
        """f32 ``[round_up(b, 8), dim_pad]`` on the device; the kernels
        cast to the store dtype (bf16 for int8 stores) there."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        q = np.zeros((append_ops.round_up(max(b, 1), 8), self.dim_pad), dtype=np.float32)
        q[:b, : self.dim] = queries
        return torch.from_numpy(q).to(self.device)

    def _search_shards(self, program, q, k: int, min_score: float, buf, scales, count, *operands):
        """Run ``program`` on each shard (one here, at row offset 0) and
        merge the winners."""
        kk = min(k, buf.shape[0])
        vals, idx = program(buf, scales, 0, *operands, q, count, kk)
        return _merge_shard_winners(vals, idx, kk, min_score)

    @staticmethod
    def _collect(vals, idx, b: int) -> list[list[tuple[int, float]]]:
        """Fetch once and build per-query (ordinal, score) lists; min_score
        was applied on the device, so only padding (-1) is dropped."""
        vals, idx = _fetch(vals, idx)
        vals, idx = vals[:b], idx[:b]
        from ..native import load_results_module

        native = load_results_module()
        if native is not None:
            vals_c = np.ascontiguousarray(vals, dtype=np.float32)
            idx_c = np.ascontiguousarray(idx, dtype=np.int32)
            return native.build_pairs(vals_c, idx_c, b, vals_c.shape[1], -1e30)
        out = []
        for r in range(b):
            keep = idx[r] >= 0
            out.append([(int(i), float(v)) for v, i in zip(vals[r][keep], idx[r][keep])])
        return out

    def search_dispatch(self, queries: np.ndarray, k: int, min_score: float = 0.0) -> tuple:
        """Launch a batched lookup WITHOUT waiting for it; pair with
        :meth:`collect_search` to pipeline batches."""
        b = queries.shape[0]
        with self._view() as (buf, scales, count):
            if count == 0:
                return ("empty", b)
            q = self._pad_queries(queries)
            program = _shard_topk
            if self.search_mode == "approx":
                program = functools.partial(_shard_approx_topk, recall_target=self.recall_target)
            vals, idx = self._search_shards(program, q, min(k, count), min_score, buf, scales, count)
        return (vals, idx, b)

    def collect_search(self, handle: tuple) -> list[list[tuple[int, float]]]:
        """Materialize a :meth:`search_dispatch` handle."""
        if handle[0] == "empty":
            return [[] for _ in range(handle[1])]
        vals, idx, b = handle
        return self._collect(vals, idx, b)

    def search(self, queries: np.ndarray, k: int, min_score: float = 0.0) -> list[list[tuple[int, float]]]:
        """Batched lookup -> per-query (ordinal, score) lists. An IVF store
        with a snapshot searches it (:meth:`search_ivf`)."""
        if self.search_mode == "ivf" and self._ivf is not None:
            return self.search_ivf(queries, k, min_score)[0]
        return self.collect_search(self.search_dispatch(queries, k, min_score))

    # -- sharded IVF (per-shard learned buckets; parallel/ivf.py) -------------

    def build_ivf(self, **build_kwargs: Any) -> None:
        """Snapshot the live rows into per-shard IVF indexes
        (``build_kwargs`` go to ``ops.ivf.ivf_build``). Rows appended
        later are found by an exact interval scan until the next build.
        No-op on an empty store."""
        from .ivf import build_sharded_ivf

        self._flush()
        if self.count == 0:
            return
        self._ivf = build_sharded_ivf(self, **build_kwargs)

    def search_ivf(
        self, queries: np.ndarray, k: int, min_score: float = 0.0
    ) -> tuple[list[list[tuple[int, float]]], list[bool]]:
        """IVF lookup -> (per-query results, per-query certificates). A True
        certificate means the result is provably the exact top-k (up to
        eps ties): every shard certified its excluded buckets, and the
        outlier tails and the post-snapshot suffix were scanned exactly."""
        from .ivf import sharded_ivf_search_dispatch

        b = queries.shape[0]
        with self._view() as (_buf, _scales, count):
            if count == 0:
                return [[] for _ in range(b)], [True] * b
            snapshot = self._ivf
            if snapshot is None:
                raise RuntimeError("search_ivf before build_ivf")
            k_eff = min(k, count)
            vals, idx, cert = sharded_ivf_search_dispatch(
                self, snapshot, self._pad_queries(queries), k_eff, min_score
            )
        certs = cert[:b].cpu().tolist()
        results = self._collect(vals, idx, b)
        # Rows appended after the snapshot: an exact interval scan, merged
        # in score space (the suffix is exact, so certificates stay sound).
        if count > snapshot.built_count:
            extra = self.search_intervals(
                queries, np.asarray([[snapshot.built_count, count]]), k_eff, min_score
            )
            for r in range(b):
                merged = results[r] + extra[r]
                merged.sort(key=lambda t: -t[1])
                results[r] = merged[:k_eff]
        return results, certs

    def _search_rowmask(self, queries, make_mask, k: int, min_score: float):
        """Exact top-k over the rows where ``make_mask(capacity, count)``
        (a [capacity] int32 device tensor) is > 0."""
        b = queries.shape[0]
        with self._view() as (buf, scales, count):
            if count == 0:
                return [[] for _ in range(b)]
            q = self._pad_queries(queries)
            mask = make_mask(buf.shape[0], count)
            vals, idx = self._search_shards(
                _shard_masked_topk, q, min(k, count), min_score, buf, scales, count, mask
            )
        return self._collect(vals, idx, b)

    def search_subset(
        self, queries: np.ndarray, ordinals: list[int] | np.ndarray, k: int,
        min_score: float = 0.0,
    ) -> list[list[tuple[int, float]]]:
        """Exact top-k restricted to a set of global ordinals. The subset
        becomes a row mask built on the device (O(subset) upload), so the
        scoped search runs the same fused scan as a global one."""
        ordinals = np.asarray(ordinals, dtype=np.int64).reshape(-1)
        if ordinals.size == 0:
            return [[] for _ in range(queries.shape[0])]

        def make_mask(capacity, count):
            mask = torch.zeros((capacity,), dtype=torch.int32, device=self.device)
            mask[torch.from_numpy(ordinals[ordinals < count]).to(self.device)] = 1
            return mask

        return self._search_rowmask(queries, make_mask, k, min_score)

    def search_masked(
        self, queries: np.ndarray, mask: np.ndarray, k: int, min_score: float = 0.0
    ) -> list[list[tuple[int, float]]]:
        """Exact top-k over rows where ``mask`` (bool, [>= count]) is True."""
        mask = np.asarray(mask, dtype=bool)

        def make_mask(capacity, count):
            full = np.zeros((capacity,), dtype=np.int32)
            m = min(mask.shape[0], capacity)
            full[:m] = mask[:m]
            return torch.from_numpy(full).to(self.device)

        return self._search_rowmask(queries, make_mask, k, min_score)

    def search_intervals(
        self, queries: np.ndarray, intervals: np.ndarray, k: int, min_score: float = 0.0
    ) -> list[list[tuple[int, float]]]:
        """Exact top-k over rows inside any [start, stop) interval.

        The scoped-corpus fast path: ``intervals`` is a small [S, 2] table
        (one row per owned segment), padded with (0, 0) rows to a bucket of
        8, 32, 128 or 512; the row mask, where one is needed, is built from
        it on the device, so host work and upload are O(S).
        """
        b = queries.shape[0]
        if len(intervals) == 0:
            return [[] for _ in range(b)]
        intervals = np.asarray(intervals, dtype=np.int32).reshape(-1, 2)
        s_pad = _bucket_size(intervals.shape[0], _INTERVAL_BUCKETS)
        table = np.zeros((s_pad, 2), dtype=np.int32)
        table[: intervals.shape[0]] = intervals
        with self._view() as (buf, scales, count):
            if count == 0:
                return [[] for _ in range(b)]
            q = self._pad_queries(queries)
            table_dev = torch.from_numpy(table).to(self.device)
            vals, idx = self._search_shards(
                _shard_interval_topk, q, min(k, count), min_score, buf, scales, count, table_dev
            )
        return self._collect(vals, idx, b)

    def scores(self, queries: np.ndarray) -> np.ndarray:
        """Full masked score matrix [b, count] (host-predicate paths)."""
        b = queries.shape[0]
        with self._view() as (buf, scales, count):
            if count == 0:
                return np.empty((b, 0), dtype=np.float32)
            q = self._pad_queries(queries)
            if self._quantized:
                out = topk.cosine_scores_quantized(buf, scales, q, count)
            else:
                out = topk.cosine_scores(buf, q, count)
        return out[:b, :count].cpu().numpy()

    def get_row(self, pos: int) -> np.ndarray:
        """One live row as a host f32 vector (dequantized)."""
        return self.get_rows(pos, pos + 1)[0]

    def get_rows(self, start: int, stop: int) -> np.ndarray:
        """Live rows [start, stop) as host f32, O(stop - start)."""
        with self._view() as (buf, scales, count):
            stop = min(stop, count)
            if stop <= start:
                return np.empty((0, self.dim), dtype=np.float32)
            rows = buf[start:stop, : self.dim].float()
            if scales is not None:
                rows = rows * scales[start:stop, None]
        return rows.cpu().numpy()

    # -- persistence -----------------------------------------------------------

    def serialize(self) -> np.ndarray:
        """All live rows as a host array [len, dim] (dequantized)."""
        return self.get_rows(0, len(self))

    def deserialize(self, data: np.ndarray | None) -> None:
        self.clear()
        if data is None:
            return
        data = np.asarray(data, dtype=np.float32)
        if data.ndim < 2 or data.shape[0] == 0:
            return
        if data.shape[1] != self.dim:
            raise ValueError(f"rows of width {data.shape[1]}, store width {self.dim}")
        self.append(data)

    def clear(self) -> None:
        with self._lock:
            self._reset_buffers()
            self._ivf = None  # a derived index: rebuild after a clear or restore
            with self._pending_lock:
                self._pending = []
                self._pending_rows = 0
