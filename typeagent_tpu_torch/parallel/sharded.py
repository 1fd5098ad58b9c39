"""Row-sharded vector search over a mesh of devices.

Port of ``typeagent_tpu/parallel/sharded.py``. The embedding matrix's row
axis is split over the mesh's ``shard`` axis in the JAX block layout: with
capacity ``cap`` and ``S`` shards, shard s holds global rows
``[s * cap/S, (s + 1) * cap/S)`` on its device, so the count watermark
may fall inside one shard and leave the later ones empty. Each dp rank
holds a full replica of the rows, and a query batch is split over the dp
ranks (the JAX ``P(dp, None)`` query sharding). A store without a mesh is
a mesh of one device, with the same API and answers.

A search issues every shard's program (``ops/topk.py``) before it fetches
anything, so the devices of a mesh run side by side; each shard answers
its top-k in global row ordinals, the winners are copied to the dp rank's
first device (a device-to-device copy, ordered after the producing stream
by PyTorch) and :func:`_merge_shard_winners` takes the top-k there, ties to
the lowest global row. The ranks' answers are then stacked on the mesh's
first device. Growing the capacity moves rows between shards (the block
boundaries move), piece by piece from device to device; global ordinals
never move.

Routes, as in the JAX package:

  * global search: the one-phase K1 for f32/bf16 stores, K6 for int8;
    ``search_mode="approx"``: each shard's approx route (the bucket argmax
    K2' on large shards, K1 below); ``search_mode="ivf"`` with a snapshot
    (:meth:`ShardedVectorStore.build_ivf`): each shard's IVF program
    (``parallel/ivf.py``), plus an exact interval scan of rows appended
    after the snapshot;
  * ``search_intervals``: the table is shifted into each shard's local rows
    and clamped there (an interval that straddles a boundary splits in
    two); <= 8 intervals ride K4, a larger table a row mask built on the
    device and K5; an int8 store always takes the row mask and K7;
  * ``search_subset`` / ``search_masked``: K5, or K7 for int8, each shard
    given its slice of the row mask.

``min_score`` is applied on the device; unfilled slots are (-1, -1).

:meth:`ShardedVectorStore.search` and :meth:`~ShardedVectorStore.search_intervals`,
the corpus's searches, open the spans ``corpus.launch`` (the query and
table uploads, every shard's program and the merge; its seconds in
``METRICS`` ``corpus.host_s``) and ``corpus.fetch`` (``corpus.fetch_s``).
Two spans belong to an int8 store alone: ``corpus.rowmask``, under
``corpus.launch``, the row mask an interval-scoped search builds over each
shard's whole capacity (``corpus.rowmask_s``, not added to
``corpus.host_s``, which its launch already holds; ``corpus.rowmask_rows``
grows by each mask's length), and ``corpus.quantize``, the quantized ingest
of every append (``corpus.quantize_s``; ``corpus.quantized_rows``). Both
time the host's side, as ``corpus.launch`` does, and add no wait for the
device.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable

import numpy as np
import torch

from ..ops import _build
from ..ops import append as append_ops
from ..ops import topk
from ..utils import trace
from ..utils.metrics import METRICS
from ..vectorstore import _fetch, _native_results
from .mesh import AXIS_DP, AXIS_SHARD, Mesh, single_device_mesh

__all__ = ["ShardedVectorStore"]

_DTYPE_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_INTERVAL_BUCKETS = (8, 32, 128, 512)
# A shard's rows are whole 128-row buckets (the bucket kernels and the IVF
# build walk them), so the capacity is a multiple of n_shard * 128.
_SHARD_ROW_QUANTUM = 128

_LAUNCH = trace.Site("corpus.launch", "corpus.host_s")
_FETCH = trace.Site("corpus.fetch", "corpus.fetch_s")
_ROWMASK = trace.Site("corpus.rowmask", "corpus.rowmask_s")
_QUANTIZE = trace.Site("corpus.quantize", "corpus.quantize_s")


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
# (and scales, None unless int8), the shard's row offset, its operands, the
# global count and the query block, and returns its top-k in global row
# ordinals.
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
        # topk.topk_program_intervals_quantized's two steps, the mask's in a span.
        with _ROWMASK():
            rowmask = topk.intervals_to_rowmask(local_n, local_iv)
        METRICS.incr("corpus.rowmask_rows", rowmask.shape[1])
        out = topk.topk_program_masked_quantized(emb, scales, q, local_count, rowmask, k)
    else:
        out = topk.topk_program_intervals(emb, q, local_count, local_iv, k)
    return _to_global(*out, offset)


def _merge_shard_winners(vals, idx, k: int, min_score: float):
    """Merge the shards' winners (``[b, S*k]``, in shard order) into the
    top ``k`` and filter by ``min_score``. The stable sort keeps shard
    order among equal scores, and shards hold ascending row blocks, so a
    tie stays at the lowest global row."""
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    merged_vals = vals.gather(1, order)
    merged_idx = idx.gather(1, order)
    keep = (merged_vals >= min_score) & (merged_idx >= 0)
    return torch.where(keep, merged_vals, topk._NEG), torch.where(keep, merged_idx, -1)


def gather_winners(parts: list[tuple], home: torch.device) -> list[torch.Tensor]:
    """Copy each shard's outputs to ``home`` and join them along the last
    axis (dim 1 of ``[b, k]``, dim 0 of ``[b]``), in shard order."""
    out = []
    for j in range(len(parts[0])):
        pieces = [p[j].to(home, non_blocking=True) for p in parts]
        out.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=pieces[0].dim() - 1))
    return out


class ShardedVectorStore:
    """An appendable embedding matrix searched as row shards over a mesh
    (BASELINE.json config #5's store).

    Mirrors the JAX class's feature set: pending-buffer batching, f32,
    bf16 and int8 storage, on-device min_score, exact subset, mask and
    interval search, approx and IVF global search, and
    serialize/deserialize round-trips. ``mesh`` (``parallel.mesh.Mesh``)
    names the devices; without one the store is one shard on ``device``.
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
        mesh: Mesh | None = None,
    ):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
        if isinstance(dtype, str):
            dtype = _DTYPE_NAMES[dtype]
        if dtype not in _DTYPE_NAMES.values():
            raise ValueError(f"dtype must be float32, bfloat16 or int8, got {dtype}")
        if search_mode not in ("exact", "approx", "ivf"):
            raise ValueError(f"unknown search_mode {search_mode!r}")
        if search_mode in ("approx", "ivf") and dtype == torch.int8:
            raise ValueError(f"search_mode={search_mode!r} supports float32/bfloat16 stores only")
        if mesh is None:
            if torch.device(device).type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "device='cuda' but no CUDA device is available; "
                    "pass device='cpu' to run the plain PyTorch versions"
                )
            mesh = single_device_mesh(device)
        self.mesh = mesh
        self.n_dp = mesh.shape[AXIS_DP]
        self.n_shard = mesh.shape[AXIS_SHARD]
        # Merged answers land here (dp rank 0's first device).
        self.device = mesh.devices[0, 0]
        if self.device.type == "cuda":
            _build.start_building()  # nvcc runs while the store is filled
        self.search_mode = search_mode
        self.recall_target = recall_target
        self.ivf_b = ivf_b  # buckets rescored per shard per query
        self._ivf = None  # parallel.ivf.ShardedIVF snapshot
        self.dim = dim
        self.dim_pad = append_ops.round_up(dim, append_ops.LANES)
        self._dtype = dtype
        self._quantized = dtype == torch.int8
        self._cap_quantum = self.n_shard * _SHARD_ROW_QUANTUM
        self._pending: list[np.ndarray] = []  # host rows awaiting flush
        self._pending_rows = 0
        # Guards the pending list and its counter only: an append landing
        # between a flush's concatenate and its reset would be lost.
        self._pending_lock = threading.Lock()
        # Held while a flush grows or writes the shards and while a search
        # launches against them, so no search pairs old shards with a new
        # count; fetches wait for the devices outside it.
        self._lock = threading.RLock()
        self._reset_buffers()

    # -- layout ----------------------------------------------------------------

    def _reset_buffers(self) -> None:
        cap = append_ops.round_up(max(append_ops.MIN_CAPACITY, self._cap_quantum), self._cap_quantum)
        self._allocate(cap)
        self.count = 0  # rows committed to the device shards

    def _allocate(self, capacity: int) -> None:
        """Fresh zeroed shards (and unit scales) of ``capacity`` rows."""
        local_n = capacity // self.n_shard
        self.capacity = capacity
        self.local_n = local_n
        self._shards = [
            [append_ops.make_buffer(local_n, self.dim_pad, self._dtype, dev) for dev in row]
            for row in self.mesh.devices
        ]
        self._shard_scales = (
            [[append_ops.make_scales(local_n, dev) for dev in row] for row in self.mesh.devices]
            if self._quantized else None
        )

    def shard_rows(self, i_dp: int = 0) -> list[torch.Tensor]:
        """dp rank ``i_dp``'s shard tensors ``[local_n, dim_pad]``, in shard order."""
        return self._shards[i_dp]

    def shard_scales(self, i_dp: int = 0) -> list[torch.Tensor | None]:
        """dp rank ``i_dp``'s per-row scales (None for f32/bf16 stores)."""
        if self._shard_scales is None:
            return [None] * self.n_shard
        return self._shard_scales[i_dp]

    @property
    def buf(self) -> torch.Tensor:
        """The whole row buffer ``[capacity, dim_pad]`` of dp rank 0: the
        shard itself on a one-shard mesh, a copy joined on the first device
        otherwise."""
        return self._joined(self._shards[0])

    @property
    def _scales(self) -> torch.Tensor | None:
        """The whole ``[capacity]`` scale buffer of an int8 store (as
        :attr:`buf`), else None."""
        return None if self._shard_scales is None else self._joined(self._shard_scales[0])

    def _joined(self, parts: list[torch.Tensor]) -> torch.Tensor:
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.device) for p in parts], dim=0)

    def _live_shards(self, count: int) -> int:
        """Shards holding at least one of the ``count`` live rows."""
        return min(self.n_shard, -(-count // self.local_n))

    def _spans(self, start: int, stop: int, local_n: int | None = None):
        """``(shard, local_start, local_stop, global_start)`` pieces of the
        global rows ``[start, stop)``, in row order."""
        local_n = self.local_n if local_n is None else local_n
        g = start
        while g < stop:
            s, lo = divmod(g, local_n)
            take = min(stop - g, local_n - lo)
            yield s, lo, lo + take, g
            g += take

    def _resize(self, capacity: int) -> None:
        """Re-lay the live rows over shards of ``capacity / n_shard`` rows:
        each piece of an old shard is copied (device to device) to the new
        shard or shards that now own its rows."""
        old_rows, old_scales, old_local = self._shards, self._shard_scales, self.local_n
        self._allocate(capacity)
        for i in range(self.n_dp):
            for s, lo, hi, g in self._spans(0, self.count, old_local):
                for t, a, b, h in self._spans(g, g + hi - lo):
                    src = slice(lo + h - g, lo + h - g + b - a)
                    self._shards[i][t][a:b].copy_(old_rows[i][s][src])
                    if old_scales is not None:
                        self._shard_scales[i][t][a:b].copy_(old_scales[i][s][src])

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
        """Pre-size the shards for a known ingest (``n_rows`` rounded to a
        multiple of 1024 and of the shard quantum), instead of doubling
        past it."""
        quantum = math.lcm(1024, self._cap_quantum)
        needed = append_ops.round_up(max(int(n_rows), 1), quantum)
        with self._lock:
            if needed > self.capacity:
                self._resize(needed)

    def _grow(self, needed: int) -> None:
        cap = self.capacity
        while cap < needed:
            cap *= 2
        if cap != self.capacity:
            self._resize(cap)

    def _write(self, rows, row_scales, start: int) -> None:
        """Write ``rows`` ([n, dim] host array or tensor, cast on the copy)
        and an int8 store's scales at global row ``start`` of every dp
        replica; each piece is uploaded once per distinct device."""
        n = rows.shape[0]
        for s, lo, hi, g in self._spans(start, start + n):
            piece = rows[g - start : g - start + (hi - lo)]
            scale_piece = None if row_scales is None else row_scales[g - start : g - start + (hi - lo)]
            if isinstance(piece, np.ndarray):
                piece = torch.from_numpy(piece)
                scale_piece = None if scale_piece is None else torch.from_numpy(scale_piece)
            on: dict[torch.device, tuple] = {}
            for i in range(self.n_dp):
                dev = self.mesh.devices[i, s]
                if dev not in on:
                    on[dev] = (
                        piece.to(dev, non_blocking=True),
                        None if scale_piece is None else scale_piece.to(dev, non_blocking=True),
                    )
                self._shards[i][s][lo:hi, : self.dim].copy_(on[dev][0])
                if on[dev][1] is not None:
                    self._shard_scales[i][s][lo:hi].copy_(on[dev][1])

    def _write_rows(self, rows: torch.Tensor) -> None:
        """Write ``[n, dim]`` f32/bf16 device rows at the watermark
        (quantized first, on their device, for an int8 store); caller holds
        the lock."""
        n = rows.shape[0]
        self._grow(self.count + n)
        row_scales = None
        if self._quantized:
            with _QUANTIZE():
                rows, row_scales = topk.quantize_rows_device(rows)
            METRICS.incr("corpus.quantized_rows", n)
        self._write(rows, row_scales, self.count)
        self.count += n

    def append_device(self, rows: torch.Tensor) -> None:
        """Bulk-adopt unit-normalized ``[n, dim]`` rows already on a device
        of the store's type, with no host round trip (an on-device encoder
        or generator, a restore)."""
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
            self._write(q_rows, scales, 0)
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
        n = rows.shape[0]
        self._grow(self.count + n)
        row_scales = None
        if self._quantized:
            # int8 rows quantize on the host from f32, as in the JAX store.
            with _QUANTIZE():
                rows, row_scales = topk.quantize_rows(rows)
            METRICS.incr("corpus.quantized_rows", n)
        # f32 rows go up as they are; a bf16 shard casts them on the device.
        self._write(rows, row_scales, self.count)
        self.count += n

    def _flush(self) -> None:
        with self._lock:
            self._flush_locked()

    @contextlib.contextmanager
    def _view(self):
        """Flush, then hold the lock while the caller launches against the
        shards; yields the live row count."""
        with self._lock:
            self._flush_locked()
            yield self.count

    # -- lookups ---------------------------------------------------------------

    def _query_blocks(self, queries: np.ndarray) -> list[dict[torch.device, torch.Tensor]]:
        """The padded f32 batch ``[round_up(b, 8 * n_dp), dim_pad]`` split
        over the dp ranks; each rank's block on each of its devices (the
        kernels cast to the store dtype, bf16 for int8 stores, there)."""
        queries = np.asarray(queries, dtype=np.float32)
        b = queries.shape[0]
        b_pad = append_ops.round_up(max(b, 1), 8 * self.n_dp)
        q = np.zeros((b_pad, self.dim_pad), dtype=np.float32)
        q[:b, : self.dim] = queries
        per = b_pad // self.n_dp
        blocks = []
        for i, row in enumerate(self.mesh.devices):
            host = torch.from_numpy(q[i * per : (i + 1) * per])
            blocks.append({dev: host.to(dev) for dev in dict.fromkeys(row)})
        return blocks

    def _launch(self, program: Callable, queries: np.ndarray, k: int, count: int,
                operands: Callable | None = None) -> list[list[tuple]]:
        """Issue ``program`` on every live shard of every dp rank, all
        before any result is read: ``[dp][shard]`` lists of its outputs.
        ``operands(i, s)`` gives shard (i, s)'s extra operands."""
        blocks = self._query_blocks(queries)
        kk = min(k, self.local_n)
        launched = []
        for i in range(self.n_dp):
            parts = []
            for s in range(self._live_shards(count)):
                dev = self.mesh.devices[i, s]
                extra = operands(i, s) if operands is not None else ()
                parts.append(program(
                    self._shards[i][s], self.shard_scales(i)[s], s * self.local_n, *extra,
                    blocks[i][dev], count, kk,
                ))
            launched.append(parts)
        return launched

    def _merge(self, launched: list[list[tuple]], k: int, min_score: float):
        """Each dp rank's shard winners merged on its first device, then
        the ranks' rows stacked on the mesh's first device."""
        ranks = []
        for i, parts in enumerate(launched):
            vals, idx = gather_winners(parts, self.mesh.devices[i, 0])
            ranks.append(_merge_shard_winners(vals, idx, min(k, vals.shape[1]), min_score))
        if len(ranks) == 1:
            return ranks[0]
        return tuple(torch.cat([r[j].to(self.device) for r in ranks], dim=0) for j in range(2))

    def _search_shards(self, program, queries, k: int, min_score: float, count: int, operands=None):
        return self._merge(self._launch(program, queries, k, count, operands), k, min_score)

    @staticmethod
    def _collect(vals, idx, b: int) -> list[list[tuple[int, float]]]:
        """Fetch once and build per-query (ordinal, score) lists; min_score
        was applied on the device, so only padding (-1) is dropped."""
        vals, idx = _fetch(vals, idx)
        vals, idx = vals[:b], idx[:b]
        native = _native_results()
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
        with self._view() as count:
            if count == 0:
                return ("empty", b)
            program = _shard_topk
            if self.search_mode == "approx":
                program = functools.partial(_shard_approx_topk, recall_target=self.recall_target)
            vals, idx = self._search_shards(program, queries, min(k, count), min_score, count)
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
        with _LAUNCH():
            handle = self.search_dispatch(queries, k, min_score)
        with _FETCH():
            return self.collect_search(handle)

    # -- sharded IVF (per-shard learned buckets; parallel/ivf.py) -------------

    def build_ivf(self, **build_kwargs: Any) -> None:
        """Snapshot the live rows into per-shard IVF indexes, each built on
        its shard's device (``build_kwargs`` go to ``ops.ivf.ivf_build``).
        Rows appended later are found by an exact interval scan until the
        next build. No-op on an empty store."""
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
        with self._view() as count:
            if count == 0:
                return [[] for _ in range(b)], [True] * b
            snapshot = self._ivf
            if snapshot is None:
                raise RuntimeError("search_ivf before build_ivf")
            k_eff = min(k, count)
            vals, idx, cert = sharded_ivf_search_dispatch(self, snapshot, queries, k_eff, min_score)
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

    def _search_rowmask(self, queries, shard_mask: Callable, k: int, min_score: float):
        """Exact top-k over the rows where each shard's mask is > 0;
        ``shard_mask(s, device, count)`` gives shard s's [local_n] int32
        mask on ``device``, made once per distinct device."""
        b = queries.shape[0]
        with self._view() as count:
            if count == 0:
                return [[] for _ in range(b)]
            made: dict[tuple, torch.Tensor] = {}

            def operands(i, s):
                key = (s, self.mesh.devices[i, s])
                if key not in made:
                    made[key] = shard_mask(s, key[1], count)
                return (made[key],)

            vals, idx = self._search_shards(
                _shard_masked_topk, queries, min(k, count), min_score, count, operands
            )
        return self._collect(vals, idx, b)

    def search_subset(
        self, queries: np.ndarray, ordinals: list[int] | np.ndarray, k: int,
        min_score: float = 0.0,
    ) -> list[list[tuple[int, float]]]:
        """Exact top-k restricted to a set of global ordinals. Each shard's
        slice of the subset becomes a row mask built on its device (an
        O(subset) upload), so the scoped search runs the same fused scan as
        a global one."""
        ordinals = np.asarray(ordinals, dtype=np.int64).reshape(-1)
        if ordinals.size == 0:
            return [[] for _ in range(queries.shape[0])]

        def shard_mask(s, device, count):
            lo = s * self.local_n
            mine = ordinals[(ordinals >= lo) & (ordinals < min(count, lo + self.local_n))] - lo
            mask = torch.zeros((self.local_n,), dtype=torch.int32, device=device)
            mask[torch.from_numpy(mine).to(device)] = 1
            return mask

        return self._search_rowmask(queries, shard_mask, k, min_score)

    def search_masked(
        self, queries: np.ndarray, mask: np.ndarray, k: int, min_score: float = 0.0
    ) -> list[list[tuple[int, float]]]:
        """Exact top-k over rows where ``mask`` (bool, [>= count]) is True."""
        mask = np.asarray(mask, dtype=bool)

        def shard_mask(s, device, count):
            lo = s * self.local_n
            part = np.zeros((self.local_n,), dtype=np.int32)
            m = max(0, min(mask.shape[0] - lo, self.local_n))
            part[:m] = mask[lo : lo + m]
            return torch.from_numpy(part).to(device)

        return self._search_rowmask(queries, shard_mask, k, min_score)

    def search_intervals(
        self, queries: np.ndarray, intervals: np.ndarray, k: int, min_score: float = 0.0
    ) -> list[list[tuple[int, float]]]:
        """Exact top-k over rows inside any [start, stop) interval.

        The scoped-corpus fast path: ``intervals`` is a small [S, 2] table
        (one row per owned segment), padded with (0, 0) rows to a bucket of
        8, 32, 128 or 512; each shard clamps it into its own rows, and the
        row mask, where one is needed, is built from it on the device, so
        host work and upload are O(S).
        """
        b = queries.shape[0]
        if len(intervals) == 0:
            return [[] for _ in range(b)]
        with _LAUNCH():
            intervals = np.asarray(intervals, dtype=np.int32).reshape(-1, 2)
            s_pad = _bucket_size(intervals.shape[0], _INTERVAL_BUCKETS)
            table = np.zeros((s_pad, 2), dtype=np.int32)
            table[: intervals.shape[0]] = intervals
            host = torch.from_numpy(table)
            with self._view() as count:
                if count == 0:
                    return [[] for _ in range(b)]
                on = {dev: host.to(dev) for dev in self.mesh.distinct_devices()}
                vals, idx = self._search_shards(
                    _shard_interval_topk, queries, min(k, count), min_score, count,
                    lambda i, s: (on[self.mesh.devices[i, s]],),
                )
        with _FETCH():
            return self._collect(vals, idx, b)

    def scores(self, queries: np.ndarray) -> np.ndarray:
        """Full masked score matrix [b, count] (host-predicate paths)."""
        b = queries.shape[0]
        with self._view() as count:
            if count == 0:
                return np.empty((b, 0), dtype=np.float32)

            def program(emb, scales, offset, q, count, _k):
                local_count = _local_count(count, offset, emb.shape[0])
                if scales is not None:
                    return (topk.cosine_scores_quantized(emb, scales, q, local_count),)
                return (topk.cosine_scores(emb, q, local_count),)

            launched = self._launch(program, queries, 1, count)
            ranks = [gather_winners(parts, self.device)[0] for parts in launched]
        out = ranks[0] if len(ranks) == 1 else torch.cat(ranks, dim=0)
        return out[:b, :count].cpu().numpy()

    def get_row(self, pos: int) -> np.ndarray:
        """One live row as a host f32 vector (dequantized)."""
        return self.get_rows(pos, pos + 1)[0]

    def get_rows(self, start: int, stop: int) -> np.ndarray:
        """Live rows [start, stop) as host f32, O(stop - start): dp rank
        0's pieces, one shard at a time."""
        with self._view() as count:
            stop = min(stop, count)
            if stop <= start:
                return np.empty((0, self.dim), dtype=np.float32)
            parts = []
            for s, lo, hi, _g in self._spans(start, stop):
                rows = self._shards[0][s][lo:hi, : self.dim].float()
                if self._quantized:
                    rows = rows * self._shard_scales[0][s][lo:hi, None]
                parts.append(rows.cpu())
        return torch.cat(parts, dim=0).numpy()

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
