"""Device-resident vector store: exact cosine top-k on a CUDA device.

API and score semantics are those of the JAX package's store
(``typeagent_tpu/vectorstore.py``): ``score = clip((cos+1)/2, 0, 1)``,
min-score filter and descending top-k, the per-model default min-score
table, lazy embedding-size adoption.

  * Embeddings live on the device as a padded ``[capacity, dim_pad]``
    tensor with a count watermark; appends write in place
    (``ops/append.py``). An int8 store (``dtype="int8"``) quantizes each
    row (per-row symmetric scale) on append and keeps the scales in a
    second buffer beside the rows.
  * Lookups are batched: one kernel route per query batch
    (``ops/topk.py``). Below ``EXACT2_MIN_ROWS`` rows the one-phase kernel
    runs; at or above it, the two-phase exact2 search (bf16-shadow bucket
    selection plus exact f32 rescore for f32 stores), whose certificate
    misses rerun the one-phase kernel for the queries that missed. An
    int8 store always runs its one-phase kernel (K6).
  * ``search_mode="approx"`` rides the bucket argmax (K2') from
    ``EXACT2_MIN_ROWS`` rows on, the exact one-phase kernel below.
  * ``search_mode="ivf"`` searches a snapshot built by :meth:`build_ivf`
    (``ops/ivf.py``); rows appended after it ride an exact interval scan
    (K4), merged. In ``ivf_certified`` mode a certificate miss escalates
    through a 4x-bucket IVF pass and then the exact one-phase rerun.
  * Small appends buffer on the host and flush before the next lookup.

``TextEmbeddingIndexSettings.device`` names the device. ``"cpu"`` runs
the kernels' plain PyTorch versions (the tests use it); ``"cuda"``, the
default, runs the kernels and raises where there is no CUDA device.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading
from collections.abc import Callable
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from . import native as _native_mod
from .ops import _build, append, ivf, topk
from .utils.metrics import METRICS

if TYPE_CHECKING:
    from .models.embeddings import IEmbeddingModel
    from .serve import LookupBatcher

DEFAULT_MIN_SCORE = 0.85

# Per-model score cutoffs (the JAX package's table).
MODEL_DEFAULT_MIN_SCORES: dict[str, float] = {
    "text-embedding-3-large": 0.74,
    "text-embedding-3-small": 0.73,
    "text-embedding-ada-002": 0.93,
}

_QUERY_BUCKETS = (8, 16, 32, 64, 128, 256, 512)
_SUBSET_MIN_BUCKET = 64
# Row count at which "exact" lookups route to the two-phase exact2 search.
# Kept at the JAX package's TPU crossover; the H100's own crossover is
# still to be measured (ROADMAP.md Queue 1 item 3).
EXACT2_MIN_ROWS = 131_072

# Certificate-miss resolution: row count from which a miss escalates
# through a bigger-B IVF pass before the exact rescan (below it the full
# scan is cheap enough that the extra pass costs more than it saves; tests
# shrink it to exercise the path).
_ESCALATE_MIN_ROWS = 2_000_000
# Adaptive escalation floor: skip the bigger-B pass once the EMA of the
# fraction of misses it resolved falls below this (resolving fewer than
# half rarely empties the exact rescan, so the pass is pure extra work).
_ESCALATE_MIN_YIELD = 0.5

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
_SEARCH_MODES = ("exact", "exact1", "exact2", "approx", "ivf")
# ROADMAP.md Queue 1 items that port the settings this store refuses.
_NOT_PORTED = {
    "mesh": "mesh= (ROADMAP.md Queue 1 item 9)",
    "query_wire": "query_wire='int8' (ROADMAP.md Queue 1 item 7)",
}


def get_default_min_score(model_name: str) -> float:
    """Repository default score cutoff for a known embedding model name."""
    return MODEL_DEFAULT_MIN_SCORES.get(model_name, DEFAULT_MIN_SCORE)


def cosine_to_score(cosine_similarity: np.ndarray) -> np.ndarray:
    """Map cosine similarity from -1..1 to the public 0..1 score scale."""
    return np.clip((cosine_similarity + 1.0) / 2.0, 0.0, 1.0)


@dataclass
class ScoredInt:
    """An integer ordinal paired with its similarity score."""

    item: int
    score: float


def _materialize_rows(vals, idx, b: int, min_score: float):
    """[b, k] fetched host arrays -> list[list[ScoredInt]] (order kept;
    entries with score < min_score or ordinal < 0 dropped). The native
    materializer's ScoredInt compares equal to the dataclass above."""
    native = _native_mod.load_results_module()
    if native is not None:
        vals_c = np.ascontiguousarray(vals[:b], dtype=np.float32)
        idx_c = np.ascontiguousarray(idx[:b], dtype=np.int32)
        return native.build(vals_c, idx_c, b, vals_c.shape[1], float(min_score))
    results = []
    for r in range(b):
        keep = (vals[r] >= min_score) & (idx[r] >= 0)
        results.append(
            [ScoredInt(int(i), float(v)) for v, i in zip(vals[r][keep], idx[r][keep])]
        )
    return results


def _fetch(vals: torch.Tensor, idx: torch.Tensor, cert: torch.Tensor | None = None):
    """One synchronisation and one device-to-host copy for a dispatch's
    outputs: ``vals`` (f32), ``idx`` (i32, carried bit for bit) and the
    optional certificate are packed into one f32 tensor before the copy."""
    k = vals.shape[-1]
    parts = [vals.float(), idx.to(torch.int32).view(torch.float32)]
    if cert is not None:
        parts.append(cert.to(torch.float32)[..., None])
    host = torch.cat(parts, dim=-1).cpu().numpy()
    vals_h = host[..., :k]
    idx_h = np.ascontiguousarray(host[..., k : 2 * k]).view(np.int32)
    if cert is None:
        return vals_h, idx_h
    return vals_h, idx_h, host[..., 2 * k] > 0.5


class TextEmbeddingIndexSettings:
    """Runtime settings for embedding-backed fuzzy lookup.

    ``dtype`` is the device buffer's type (``float32``, the parity
    default, ``bfloat16`` or ``int8``); ``search_mode`` is ``exact``
    (routes by row count), ``exact1``, ``exact2``, ``approx`` or ``ivf``
    (f32/bf16 stores); ``device`` is where the store lives.
    """

    def __init__(
        self,
        embedding_model: IEmbeddingModel | None = None,
        min_score: float | None = None,
        max_matches: int | None = None,
        batch_size: int | None = None,
        dtype: str = "float32",
        mesh: object | None = None,
        search_mode: str = "exact",
        recall_target: float = 0.95,
        query_wire: str = "auto",
        device: str | torch.device = "cuda",
    ):
        if embedding_model is None:
            raise NotImplementedError(
                "the HTTP embedding adapters are not ported yet; pass "
                "embedding_model= (e.g. models.adapters.create_test_embedding_model())"
            )
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be float32, bfloat16 or int8, got {dtype!r}")
        if search_mode in ("approx", "ivf") and dtype == "int8":
            raise ValueError(f"search_mode={search_mode!r} supports float32/bfloat16 stores only")
        if search_mode not in _SEARCH_MODES:
            raise ValueError(f"unknown search_mode {search_mode!r}")
        if mesh is not None:
            raise NotImplementedError(_NOT_PORTED["mesh"])
        if query_wire == "int8" and dtype != "bfloat16":
            raise ValueError("query_wire='int8' requires dtype='bfloat16'")
        if query_wire == "int8":
            raise NotImplementedError(_NOT_PORTED["query_wire"])
        if query_wire != "auto":
            raise ValueError(f"unknown query_wire {query_wire!r}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        self.embedding_model = embedding_model
        model_name = getattr(self.embedding_model, "model_name", "")
        default_min_score = get_default_min_score(model_name)
        self.min_score = min_score if min_score is not None else default_min_score
        self.max_matches = max_matches if max_matches and max_matches >= 1 else None
        self.batch_size = batch_size if batch_size and batch_size >= 1 else 8
        self.dtype = dtype
        self.mesh = None
        self.search_mode = search_mode
        # Kept as in the JAX settings; the port's approx routes have no
        # recall knob (ops.topk.cosine_topk_approx).
        self.recall_target = recall_target
        # IVF knobs: buckets rescored per query (the recall lever), the
        # exiled outlier fraction at build, and whether a certificate miss
        # reruns exactly (exact results always).
        self.ivf_b = 16
        self.ivf_outlier_frac = 0.1
        self.ivf_certified = False
        # Rows appended after build_ivf() ride an exact interval scan; with
        # ivf_auto_rebuild a query that sees the appended fraction past
        # ivf_rebuild_frac starts one background rebuild.
        self.ivf_rebuild_frac = 0.25
        self.ivf_auto_rebuild = False
        self.query_wire = query_wire
        self.device = device


def _bucket(n: int, buckets=_QUERY_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return append.round_up(n, buckets[-1])


def _ivf_suffix_merged(
    state: ivf.IVFState, buf: torch.Tensor, q: torch.Tensor, count: int,
    ivf_count: int, *, k: int, B: int,
):
    """IVF snapshot search plus an exact interval scan (K4) of the rows
    appended after it, ``[ivf_count, count)``, merged in score space. The
    certificate stays sound: the suffix is exact and the merged k-th score
    only grows."""
    vals, idx, cert = ivf.ivf_topk_program(*state, q, k, B=B)
    intervals = torch.tensor([[ivf_count, count]], dtype=torch.int32, device=q.device)
    v2, i2 = topk.topk_program_intervals(buf, q, count, intervals, k)
    sv = torch.cat([vals, v2], dim=1)
    si = torch.cat([idx, i2], dim=1)
    mv, pos = torch.topk(sv, min(k, sv.shape[1]), dim=1)
    return mv, si.gather(1, pos), cert


def _ivf_many(
    state: ivf.IVFState, buf: torch.Tensor, qs: torch.Tensor, count: int,
    ivf_count: int, *, k: int, B: int,
):
    """R query batches ``[R, b_pad, d_pad]`` through the IVF route in one
    launch per kernel (the port of ``_ivf_topk_many`` and
    ``_ivf_suffix_merged_many``): queries are independent, so the batches
    are stacked and the outputs reshaped back."""
    r_n, b_pad, d_pad = qs.shape
    flat = qs.reshape(r_n * b_pad, d_pad)
    if count <= ivf_count:
        out = ivf.ivf_topk_program(*state, flat, k, B=B)
    else:
        out = _ivf_suffix_merged(state, buf, flat, count, ivf_count, k=k, B=B)
    return tuple(t.reshape(r_n, b_pad, *t.shape[1:]) for t in out)


class VectorStore:
    """Append-only store of L2-normalized embeddings with device top-k."""

    settings: TextEmbeddingIndexSettings

    def __init__(self, settings: TextEmbeddingIndexSettings):
        self.settings = settings
        self._model = settings.embedding_model
        self._device = settings.device
        self._dtype = _DTYPES[settings.dtype]
        self._quantized = self._dtype == torch.int8
        # bf16 selection shadow: one (key, shadow) tuple, swapped whole so a
        # serving thread never pairs a key with another buffer's shadow.
        self._shadow_cache: tuple | None = None
        self._embedding_size = 0
        self._dim_pad = 0
        self._buf: torch.Tensor | None = None
        self._scales: torch.Tensor | None = None  # per-row scales (int8)
        self._count = 0  # rows committed to the device buffer
        self._reserve_hint = 0  # known final size (see reserve())
        self._pending: list[np.ndarray] = []  # host rows awaiting flush
        self._pending_rows = 0
        # Lookups from concurrent serving threads all call _flush; the
        # flush body must run once, and no lookup may launch against a
        # half-updated buffer. Launches happen under this lock; fetches
        # (which wait for the device) happen outside it.
        self._flush_lock = threading.Lock()
        # Guards ONLY the pending list and its row counter: appends (event
        # loop thread) run concurrently with flushes (executor threads).
        self._pending_lock = threading.Lock()
        # Per-event-loop LookupBatcher for the async lookup route.
        self._batcher: LookupBatcher | None = None
        self._batcher_loop = None
        # search_mode="ivf": the snapshot (ops.ivf.IVFState) and the row
        # count it covers.
        self._ivf: ivf.IVFState | None = None
        self._ivf_count = 0
        # EMA of the fraction of certificate misses the bigger-B IVF pass
        # resolved (None: not yet tried on this snapshot). Written under
        # _flush_lock, and only while its snapshot is current.
        self._esc_ema: float | None = None
        # Buffers a rebuild thread is reading (_pinned_view): a flush into
        # one writes a copy, never the pinned tensor. Guarded by _flush_lock.
        self._pinned_bufs: list[torch.Tensor] = []
        self._ivf_rebuild_thread: threading.Thread | None = None

    # -- embedding model passthrough ----------------------------------------

    async def get_embedding(self, key: str, cache: bool = True) -> np.ndarray:
        if cache:
            return await self._model.get_embedding(key)
        return await self._model.get_embedding_nocache(key)

    async def get_embeddings(self, keys: list[str], cache: bool = True) -> np.ndarray:
        if cache:
            return await self._model.get_embeddings(keys)
        return await self._model.get_embeddings_nocache(keys)

    # -- size / shape -------------------------------------------------------

    def __len__(self) -> int:
        return self._count + self._pending_rows

    def __bool__(self) -> bool:  # an empty index must not be falsy
        return True

    @property
    def embedding_size(self) -> int:
        return self._embedding_size

    def _set_embedding_size(self, size: int) -> None:
        if size <= 0:
            raise ValueError(f"embedding size must be positive, got {size}")
        self._embedding_size = size
        self._dim_pad = append.round_up(size, append.LANES)

    # -- appends ------------------------------------------------------------

    def add_embedding(self, key: str | None, embedding: np.ndarray | list[float]) -> None:
        row = np.asarray(embedding, dtype=np.float32)
        if self._embedding_size == 0:
            self._set_embedding_size(row.shape[-1])
        if row.shape[-1] != self._embedding_size:
            raise ValueError(
                f"Embedding size mismatch: expected {self._embedding_size}, "
                f"got {row.shape[-1]}"
            )
        with self._pending_lock:
            self._pending.append(row.reshape(1, -1))
            self._pending_rows += 1
        if key is not None:
            self._model.add_embedding(key, row)

    def add_embeddings(self, keys: list[str] | None, embeddings: np.ndarray) -> None:
        embeddings = np.asarray(embeddings, dtype=np.float32)
        if embeddings.ndim != 2:
            raise ValueError(f"Expected 2D embeddings array, got {embeddings.ndim}D")
        if self._embedding_size == 0:
            self._set_embedding_size(embeddings.shape[1])
        if embeddings.shape[1] != self._embedding_size:
            raise ValueError(
                f"Embedding size mismatch: expected {self._embedding_size}, "
                f"got {embeddings.shape[1]}"
            )
        if embeddings.shape[0]:
            with self._pending_lock:
                self._pending.append(embeddings)
                self._pending_rows += embeddings.shape[0]
        if keys is not None:
            for key, emb in zip(keys, embeddings):
                self._model.add_embedding(key, emb)

    async def add_key(self, key: str, cache: bool = True) -> None:
        emb = await self.get_embedding(key, cache=cache)
        self.add_embedding(key if cache else None, emb)

    async def add_keys(self, keys: list[str], cache: bool = True) -> np.ndarray | None:
        if not keys:
            return None
        embeddings = await self.get_embeddings(keys, cache=cache)
        self.add_embeddings(keys if cache else None, embeddings)
        return embeddings

    def _initial_capacity(self, n: int) -> int:
        """First-buffer capacity: power-of-two headroom by default; a
        reserve() hint switches to exact 1024-row sizing."""
        if self._reserve_hint >= n:
            return append.round_up(max(self._reserve_hint, append.MIN_CAPACITY), 1024)
        return max(append.MIN_CAPACITY, 1 << (n - 1).bit_length())

    def reserve(self, n_rows: int) -> None:
        """Declare the expected final row count before a bulk ingest: the
        buffer is sized to ``round_up(n_rows, 1024)`` instead of doubling.
        Appends beyond the reservation fall back to doubling."""
        with self._flush_lock:
            self._reserve_hint = max(self._reserve_hint, int(n_rows))
            if self._buf is not None and self._buf.shape[0] < self._reserve_hint:
                self._set_buffer(
                    append.grow_buffer(
                        self._buf, self._reserve_hint, exact_capacity=self._reserve_hint
                    )
                )

    def _set_buffer(self, buf: torch.Tensor) -> None:
        """Adopt a new (grown) buffer; the old shadow describes the old one,
        and an int8 store's scales grow with it."""
        if buf is not self._buf:
            self._shadow_cache = None
            if self._quantized:
                self._scales = append.grow_scales(self._scales, buf.shape[0])
        self._buf = buf

    def _ensure_capacity_locked(self, n: int) -> None:
        """Make room for ``n`` more rows in a buffer the caller may write
        in place: growth allocates a new buffer, and a buffer pinned by a
        rebuild (:meth:`_pinned_view`) is copied once rather than written."""
        if self._buf is None:
            cap = self._initial_capacity(n)
            self._buf = append.make_buffer(cap, self._dim_pad, self._dtype, self._device)
            if self._quantized:
                self._scales = append.make_scales(cap, self._device)
        elif self._count + n > self._buf.shape[0]:
            self._set_buffer(
                append.grow_buffer(
                    self._buf, self._count + n, exact_capacity=self._reserve_hint or None
                )
            )
        elif any(self._buf is p for p in self._pinned_bufs):
            self._set_buffer(self._buf.clone())

    def load_device_rows(self, rows: torch.Tensor) -> None:
        """Bulk-adopt embedding rows already on the store's device (an
        on-device encoder, a checkpoint restore): padded and cast there,
        with no host round trip. Rows must be L2-normalized
        ``[n, embedding_size]`` f32 or bf16; an int8 store quantizes them
        on the device."""
        if rows.device.type != self._device.type:
            raise ValueError(f"rows on {rows.device}, store on {self._device}")
        n, size = rows.shape
        if self._embedding_size == 0:
            self._set_embedding_size(size)
        if size != self._embedding_size:
            raise ValueError(
                f"Embedding size mismatch: expected {self._embedding_size}, got {size}"
            )
        with self._flush_lock:
            self._flush_locked()
            if n == 0:
                return
            self._ensure_capacity_locked(n)
            if self._quantized:
                rows, row_scales = topk.quantize_rows_device(rows)
                append.append_rows(self._scales, row_scales, self._count)
            self._buf[self._count : self._count + n, :size].copy_(rows)
            self._count += n

    def adopt_quantized(self, q_rows: np.ndarray, scales: np.ndarray) -> None:
        """Replace an int8 store's contents with already quantized state:
        int8 rows ``[count, embedding_size]`` and f32 scales ``[count]``
        (for example a JAX int8 store's ``_buf``/``_scales``). Unlike
        :meth:`deserialize`, which quantizes dequantized rows again, the
        bytes are kept as given."""
        if not self._quantized:
            raise ValueError("adopt_quantized needs an int8 store")
        q_rows = np.array(q_rows, dtype=np.int8)  # a writable copy for torch
        scales = np.array(scales, dtype=np.float32)
        n, size = q_rows.shape
        if scales.shape != (n,):
            raise ValueError(f"scales of shape {scales.shape} for {n} rows")
        self.clear()
        if self._embedding_size == 0:
            self._set_embedding_size(size)
        if size != self._embedding_size:
            raise ValueError(
                f"Embedding size mismatch: expected {self._embedding_size}, got {size}"
            )
        if n == 0:
            return
        with self._flush_lock:
            self._ensure_capacity_locked(n)
            self._buf[:n, :size].copy_(torch.from_numpy(q_rows))
            append.append_rows(self._scales, scales, 0)
            self._count = n

    def _flush(self) -> None:
        with self._flush_lock:
            self._flush_locked()

    @contextlib.contextmanager
    def _dispatch_view(self):
        """Flush, then hold the flush lock while the caller LAUNCHES device
        work against the yielded ``(buf, count)``.

        A flush grows or swaps the buffer and bumps the count, so reading
        the attributes piecemeal could pair an old buffer with a new count.
        Launches made under the lock are ordered on the stream before any
        later in-place append; fetch results OUTSIDE the ``with`` block so
        ingest never waits on a device round trip. Yields ``(buf, scales,
        count)``; ``scales`` is None unless the store is int8.
        """
        self._kernels_ready()
        with self._flush_lock:
            self._flush_locked()
            yield self._buf, self._scales, self._count

    def _kernels_ready(self) -> None:
        """Build the kernel library (once per process) before a caller
        takes ``_flush_lock``: no build may run inside it, where it would
        stall every serving thread and ingest flush."""
        if self._device.type == "cuda":
            _build.kernels()

    def _take_pending(self) -> np.ndarray | None:
        """Atomically detach the pending rows for a flush."""
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
        padded = np.zeros((n, self._dim_pad), dtype=np.float32)
        padded[:, : self._embedding_size] = rows
        self._ensure_capacity_locked(n)
        if self._quantized:
            # int8 rows quantize on the host from f32, as in the JAX store.
            padded, row_scales = topk.quantize_rows(padded)
            append.append_rows(self._scales, row_scales, self._count)
        # f32 rows go up as they are; a bf16 buffer casts them on the device.
        append.append_rows(self._buf, padded, self._count)
        self._count += n

    # -- lookups ------------------------------------------------------------

    def _pad_queries(self, queries: np.ndarray) -> torch.Tensor:
        """Upload queries as f32 ``[b_pad, dim_pad]`` (zero padding); the
        kernels cast them to the store dtype on the device."""
        b = queries.shape[0]
        out = np.zeros((_bucket(b), self._dim_pad), dtype=np.float32)
        out[:b, : self._embedding_size] = queries
        return torch.from_numpy(out).to(self._device)

    def _pad_query_rows(self, sub: torch.Tensor) -> torch.Tensor:
        """Re-pad a slice of already padded device queries to the next
        batch bucket with zero rows."""
        m = sub.shape[0]
        m_pad = _bucket(m)
        if m_pad == m:
            return sub.contiguous()
        out = torch.zeros((m_pad, sub.shape[1]), dtype=sub.dtype, device=sub.device)
        out[:m] = sub
        return out

    def warm_serving(self, max_batch: int = 256, k: int = 10) -> int:
        """Run one lookup per query-batch bucket up to ``max_batch``, so the
        kernel build and the bf16 shadow happen before traffic; an IVF
        store with a snapshot also runs its certificate-miss routes (the
        escalated IVF pass and the exact rerun) once at the smallest
        bucket. Returns the number of lookups run."""
        self._flush()
        if len(self) == 0:
            return 0
        dispatched = 0
        for bucket in _QUERY_BUCKETS:
            if bucket > _bucket(max_batch):
                break
            queries = np.zeros((bucket, self._embedding_size), np.float32)
            self.fuzzy_lookup_embeddings_batch(queries, max_hits=k)
            dispatched += 1
        state, count = self._ivf, self._count
        if self.settings.search_mode == "ivf" and state is not None:
            q = self._pad_queries(np.zeros((1, self._embedding_size), np.float32))
            kk = min(k, count)
            self._rerun_ivf(q, kk, count, min(4 * self.settings.ivf_b, state.n_buckets), state)
            self._rerun_exact1(q, kk, count)
        return dispatched

    def fuzzy_lookup_embedding(
        self,
        embedding: np.ndarray,
        max_hits: int | None = None,
        min_score: float | None = None,
        predicate: Callable[[int], bool] | None = None,
    ) -> list[ScoredInt]:
        """Single-query lookup."""
        return self.fuzzy_lookup_embeddings_batch(
            np.asarray(embedding, dtype=np.float32).reshape(1, -1),
            max_hits=max_hits,
            min_score=min_score,
            predicate=predicate,
        )[0]

    def fuzzy_lookup_embeddings_batch(
        self,
        queries: np.ndarray,
        max_hits: int | None = None,
        min_score: float | None = None,
        predicate: Callable[[int], bool] | None = None,
    ) -> list[list[ScoredInt]]:
        """Batched multi-query lookup — one kernel route for all queries."""
        if max_hits is None:
            max_hits = 10
        if min_score is None:
            min_score = 0.0
        b = queries.shape[0]
        with self._dispatch_view() as (buf, scales, count):
            if count == 0 or b == 0:
                return [[] for _ in range(b)]
            q = self._pad_queries(queries)
            if predicate is not None:
                scores_dev = self._all_scores(q, buf, scales, count)
            else:
                k = min(max_hits, count)
                vals, idx, cert = self._topk_dispatch(q, k, buf, scales, count)
        if predicate is not None:
            # Host-callback path: the full masked score matrix, then the
            # predicate over candidates above the threshold.
            scores = scores_dev[:b].cpu().numpy()
            results = []
            for row in scores:
                cand = np.flatnonzero(row >= min_score)
                scored = [ScoredInt(int(i), float(row[i])) for i in cand if predicate(int(i))]
                scored.sort(key=lambda s: s.score, reverse=True)
                results.append(scored[:max_hits])
            return results
        if cert is None:
            vals, idx = _fetch(vals, idx)
        else:
            vals, idx, cert_h = _fetch(vals, idx, cert)
            vals, idx = self._resolve_cert_misses(vals, idx, cert_h, q, k, count, b, b)
        return _materialize_rows(vals, idx, b, min_score)

    def _all_scores(self, q: torch.Tensor, buf: torch.Tensor, scales, count: int):
        """Full masked score matrix (the host-predicate path)."""
        if self._quantized:
            return topk.cosine_scores_quantized(buf, scales, q, count)
        return topk.cosine_scores(buf, q, count)

    def _topk_dispatch(self, q: torch.Tensor, k: int, buf: torch.Tensor, scales, count: int):
        """Launch the engine route WITHOUT waiting for it.

        ``(buf, scales, count)`` come from one :meth:`_dispatch_view`
        capture (call this inside the ``with`` block). Returns ``(vals, idx,
        cert)`` device tensors; ``cert`` is None for the one-phase routes.
        """
        if self._quantized:
            vals, idx = topk.cosine_topk_quantized(buf, scales, q, count, k)
            return vals, idx, None
        if self.settings.search_mode == "approx":
            vals, idx = topk.cosine_topk_approx(
                buf, q, count, k, recall_target=self.settings.recall_target
            )
            return vals, idx, None
        if self.settings.search_mode == "ivf" and self._ivf is not None:
            return self._topk_ivf(q, k, buf, count)
        if self._use_exact2(k, count):
            if self._dtype == torch.float32:
                # Hybrid: bf16-shadow bucket selection (half the bytes of an
                # f32 scan) + exact f32 rescore, same results as exact1.
                return topk.cosine_topk_exact2_hybrid(buf, self._shadow(buf, count), q, count, k)
            return topk.cosine_topk_exact2(buf, q, count, k)
        vals, idx = topk.cosine_topk(buf, q, count, k)
        return vals, idx, None

    def _topk_ivf(self, q: torch.Tensor, k: int, buf: torch.Tensor, count: int):
        """IVF dispatch (caller holds ``_flush_lock``): the snapshot search,
        plus the exact interval scan of rows appended after it. The
        certificate is returned only in ``ivf_certified`` mode, where a
        miss is resolved exactly."""
        state = self._ivf
        B = min(self.settings.ivf_b, state.n_buckets)
        if count <= self._ivf_count:
            vals, idx, cert = ivf.ivf_topk_program(*state, q, k, B=B)
        else:
            vals, idx, cert = _ivf_suffix_merged(state, buf, q, count, self._ivf_count, k=k, B=B)
            self._maybe_auto_rebuild_locked(count)
        return vals, idx, (cert if self.settings.ivf_certified else None)

    def _rerun_exact1(self, q: torch.Tensor, k: int, count: int):
        """Certificate-miss rerun against the CURRENT buffer, windowed to
        the row count the original dispatch saw (the store is append-only,
        so rows [0, count) are what that dispatch searched)."""
        self._kernels_ready()
        with self._flush_lock:
            vals, idx = topk.cosine_topk(self._buf, q, count, k)
        return _fetch(vals, idx)

    def _rerun_ivf(self, q: torch.Tensor, k: int, count: int, B: int, state: ivf.IVFState):
        """Escalated-B IVF pass for certificate misses, on the snapshot
        ``state`` the escalation decided on and the appended suffix the
        original dispatch saw. Returns host ``(vals, idx, cert)``, or None
        when ``state`` is no longer current (a rebuild swapped in a newer
        snapshot, whose buckets may hold rows past ``count``; the windowed
        exact rerun handles those queries)."""
        self._kernels_ready()
        with self._flush_lock:
            if self._ivf is not state or count < self._ivf_count:
                return None
            B = min(B, state.n_buckets)
            if count == self._ivf_count:
                out = ivf.ivf_topk_program(*state, q, k, B=B)
            else:
                out = _ivf_suffix_merged(state, self._buf, q, count, self._ivf_count, k=k, B=B)
        return _fetch(*out)

    def _resolve_cert_misses(
        self,
        vals: np.ndarray,
        idx: np.ndarray,
        cert_h: np.ndarray,
        q: torch.Tensor,
        k: int,
        count: int,
        n_rows: int,
        n_queries: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Per-query certificate-miss resolution over the first ``n_rows``
        rows of the dispatch, which carry ``n_queries`` real queries (the
        many route passes its padded population and its real count apart;
        padding slots arrive certified).

        An IVF store's misses first escalate through one bigger-B IVF pass
        (4x B, capped at every bucket) over just the missed queries, when
        the store is large, misses are at most half the real queries, and
        the pass has been paying on this snapshot; the queries still
        uncertified then rerun the exact one-phase kernel. Rows whose
        certificate held are returned untouched; every replaced row is
        exact."""
        miss = np.flatnonzero(~np.asarray(cert_h)[:n_rows])
        METRICS.incr("vectorstore.cert_queries", n_queries)
        METRICS.incr("vectorstore.cert_misses", miss.size)
        if miss.size == 0:
            return vals, idx
        vals = np.array(vals)
        idx = np.array(idx)
        state, ema = self._ivf, self._esc_ema
        if (
            count >= _ESCALATE_MIN_ROWS
            and 2 * miss.size <= n_queries
            and self.settings.search_mode == "ivf"
            and state is not None
            and (ema is None or ema >= _ESCALATE_MIN_YIELD)
        ):
            b0 = min(self.settings.ivf_b, state.n_buckets)
            b_esc = min(4 * max(b0, 1), state.n_buckets)
            if b_esc > b0:
                sub = self._pad_query_rows(q[torch.from_numpy(miss).to(q.device)])
                out = self._rerun_ivf(sub, k, count, b_esc, state)
                if out is not None:
                    v2, i2, c2 = out
                    m = miss.size
                    vals[miss] = v2[:m]
                    idx[miss] = i2[:m]
                    miss = miss[~c2[:m]]
                    resolved = 1.0 - miss.size / m
                    with self._flush_lock:
                        if self._ivf is state:  # learned on the current snapshot
                            self._esc_ema = (
                                resolved
                                if self._esc_ema is None
                                else 0.7 * self._esc_ema + 0.3 * resolved
                            )
                    if miss.size == 0:
                        return vals, idx
        sub = q[torch.from_numpy(miss).to(q.device)]
        v3, i3 = self._rerun_exact1(self._pad_query_rows(sub), k, count)
        vals[miss] = v3[: miss.size]
        idx[miss] = i3[: miss.size]
        return vals, idx

    # -- IVF snapshot lifecycle ---------------------------------------------

    def build_ivf(self, **kwargs) -> None:
        """Snapshot the current rows into an IVF index (``ops/ivf.py``;
        ``kwargs`` go to ``ivf_build``). Rows appended later are still
        found, through an exact interval scan, until the next build. No-op
        on an empty store."""
        if self._quantized:
            raise ValueError("IVF supports float32/bfloat16 stores only")
        with self._dispatch_view() as (buf, _scales, count):
            if not count:
                return
            kwargs.setdefault("outlier_frac", self.settings.ivf_outlier_frac)
            self._ivf = ivf.ivf_build(buf, count, **kwargs)
            self._ivf_count = count
            self._esc_ema = None  # new buckets: re-learn the escalation yield

    def adopt_ivf(self, arrays) -> None:
        """Take an already built IVF snapshot of this store's current rows:
        the nine arrays of a JAX ``IVFState`` as numpy (see
        ``ops.ivf.adopt_ivf_state``)."""
        if self._quantized:
            raise ValueError("IVF supports float32/bfloat16 stores only")
        with self._flush_lock:
            self._flush_locked()
            self._ivf = ivf.adopt_ivf_state(arrays, self._device, self._dtype)
            self._ivf_count = self._count
            self._esc_ema = None

    @contextlib.contextmanager
    def _pinned_view(self):
        """Capture ``(buf, count)`` and PIN the buffer: until exit, a flush
        writes into a copy of it (:meth:`_ensure_capacity_locked`), so the
        captured tensor stays exactly what was captured through a long read
        outside the lock (the background rebuild). The lock is held only
        for the capture and the unpin."""
        with self._flush_lock:
            self._flush_locked()
            buf, count = self._buf, self._count
            self._pinned_bufs.append(buf)
        try:
            yield buf, count
        finally:
            with self._flush_lock:
                self._pinned_bufs.remove(buf)

    def build_ivf_background(self, **kwargs) -> threading.Thread | None:
        """Rebuild the IVF snapshot on a thread and swap it in when done;
        queries keep serving the current snapshot (plus the interval scan)
        meanwhile. Returns the rebuild thread (the running one if a rebuild
        is in flight), or None on an empty store; ``join()`` it to wait."""
        with self._flush_lock:
            self._flush_locked()
            if not self._count:
                return None
            t = self._ivf_rebuild_thread
            if t is not None and t.is_alive():
                return t
            t = threading.Thread(
                target=self._rebuild_and_swap, kwargs=kwargs, daemon=True, name="tat-ivf-rebuild"
            )
            self._ivf_rebuild_thread = t
        t.start()
        return t

    def _rebuild_and_swap(self, **kwargs) -> None:
        kwargs.setdefault("outlier_frac", self.settings.ivf_outlier_frac)
        with self._pinned_view() as (buf, count):
            if not count:
                return
            state = ivf.ivf_build(buf, count, **kwargs)
        with self._flush_lock:
            # Append-only store: rows [0, count) are what the build read, so
            # the swap is sound; rows appended since ride the interval scan.
            if count >= self._ivf_count:
                self._ivf = state
                self._ivf_count = count
                self._esc_ema = None

    def _maybe_auto_rebuild_locked(self, count: int) -> None:
        """Query-driven rebuild trigger (caller holds ``_flush_lock``): when
        the appended fraction passes ``ivf_rebuild_frac``, start ONE
        background rebuild (it takes the lock itself, in _pinned_view)."""
        settings = self.settings
        if not settings.ivf_auto_rebuild:
            return
        if count - self._ivf_count <= settings.ivf_rebuild_frac * max(self._ivf_count, 1):
            return
        t = self._ivf_rebuild_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(target=self._rebuild_and_swap, daemon=True, name="tat-ivf-rebuild")
        self._ivf_rebuild_thread = t
        t.start()

    def _shadow(self, buf: torch.Tensor | None = None, count: int | None = None) -> torch.Tensor:
        """Cached bf16 cast of the f32 buffer (the exact2 selection shadow),
        rebuilt after appends. Growth drops the cache (``_set_buffer``), so
        a reused ``id`` can never return another buffer's shadow."""
        if buf is None:
            buf, count = self._buf, self._count
        key = (id(buf), count)
        cached = self._shadow_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        shadow = buf.to(torch.bfloat16)
        self._shadow_cache = (key, shadow)
        return shadow

    def _use_exact2(self, k: int, count: int | None = None) -> bool:
        mode = self.settings.search_mode
        if mode == "exact2":
            return True
        if count is None:
            count = self._count
        return mode == "exact" and count >= EXACT2_MIN_ROWS and k <= topk._PALLAS_MAX_K

    def _engine_mode(self, k: int, buf: torch.Tensor, scales, count: int):
        """Engine mode and auxiliary operand for :func:`ops.topk.topk_many`."""
        if self._quantized:
            return "quantized", scales
        if self.settings.search_mode == "approx":
            return "approx", None
        if self._use_exact2(k, count):
            if self._dtype == torch.float32:
                return "exact2h", self._shadow(buf, count)
            return "exact2", None
        return "exact1", None

    async def fuzzy_lookup_embeddings_batch_async(
        self,
        queries: np.ndarray,
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[list[ScoredInt]]:
        """Async batched lookup through the store's per-loop LookupBatcher:
        the device wait runs on an executor thread, and concurrent tasks'
        lookups coalesce into shared dispatches. Results are identical to
        :meth:`fuzzy_lookup_embeddings_batch`."""
        from .serve import LookupBatcher  # local import: serve imports us

        loop = asyncio.get_running_loop()
        if self._batcher is None or self._batcher_loop is not loop or self._batcher._closed:
            old, old_loop = self._batcher, self._batcher_loop
            if old is not None and not old._closed and old_loop is not None:
                # Don't orphan the previous loop's batcher.
                if old_loop.is_closed():
                    old.close_nowait()
                else:
                    try:
                        old_loop.call_soon_threadsafe(old.close_nowait)
                    except RuntimeError:
                        old.close_nowait()  # loop shut down mid-check
            self._batcher = LookupBatcher(self, max_delay_ms=0.2, max_coalesce=16, max_inflight=2)
            self._batcher_loop = loop
        return await self._batcher.lookup(
            np.asarray(queries, dtype=np.float32),
            max_hits=10 if max_hits is None else max_hits,
            min_score=0.0 if min_score is None else float(min_score),
        )

    def fuzzy_lookup_embeddings_many(
        self,
        query_batches: np.ndarray,
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[list[list[ScoredInt]]]:
        """R query batches ``[R, b, embedding_size]`` through one launch
        per kernel (the coalesced serving path)."""
        if max_hits is None:
            max_hits = 10
        if min_score is None:
            min_score = 0.0
        qb = np.asarray(query_batches, dtype=np.float32)
        if qb.ndim != 3:
            raise ValueError(f"Expected [R, b, d] query batches, got {qb.shape}")
        r_n, b = qb.shape[0], qb.shape[1]
        with self._dispatch_view() as (buf, scales, count):
            if count == 0 or r_n == 0 or b == 0:
                return [[[] for _ in range(b)] for _ in range(r_n)]
            padded = np.zeros((r_n, _bucket(b), self._dim_pad), dtype=np.float32)
            padded[:, :b, : self._embedding_size] = qb
            q_dev = torch.from_numpy(padded).to(self._device)
            k = min(max_hits, count)
            state = self._ivf
            if not self._quantized and self.settings.search_mode == "ivf" and state is not None:
                # Coalesced serving rides the IVF snapshot too.
                out = _ivf_many(
                    state, buf, q_dev, count, self._ivf_count, k=k,
                    B=min(self.settings.ivf_b, state.n_buckets),
                )
                if count > self._ivf_count:
                    self._maybe_auto_rebuild_locked(count)
                if not self.settings.ivf_certified:
                    out = out[:2]
            else:
                mode, aux = self._engine_mode(k, buf, scales, count)
                out = topk.topk_many(
                    buf, aux, q_dev, count, k=k, mode=mode,
                    recall_target=self.settings.recall_target,
                )
        fetched = _fetch(*out)
        vals, idx = fetched[0], fetched[1]
        if len(fetched) > 2:
            # Per-query certificate resolution over the flattened R x b_pad
            # population; padding slots carry no query and are pre-certified,
            # and only the R x b real queries count.
            cert = np.array(fetched[2])
            cert[:, b:] = True
            flat = cert.size
            v, i = self._resolve_cert_misses(
                vals.reshape(flat, k),
                idx.reshape(flat, k),
                cert.reshape(flat),
                q_dev.reshape(flat, q_dev.shape[-1]),
                k,
                count,
                flat,
                r_n * b,
            )
            vals = v.reshape(vals.shape)
            idx = i.reshape(idx.shape)
        vals = vals[:, :b]
        idx = idx[:, :b]
        return [_materialize_rows(vals[i], idx[i], b, min_score) for i in range(r_n)]

    def dispatch_lookup(self, queries: np.ndarray, max_hits: int = 10) -> tuple | None:
        """Launch a batched lookup and return device handles without
        waiting; pair with :meth:`collect_lookup`."""
        with self._dispatch_view() as (buf, scales, count):
            if count == 0 or queries.shape[0] == 0:
                return None
            q = self._pad_queries(queries)
            k = min(max_hits, count)
            # The certificate is checked at collect time (reading it here
            # would wait for the device). The dispatch-time row count rides
            # the handle so a miss rerun scores the same store state.
            vals, idx, cert = self._topk_dispatch(q, k, buf, scales, count)
            if cert is not None:
                return (vals, idx, queries.shape[0], cert, q, k, count)
            return (vals, idx, queries.shape[0])

    def collect_lookup(self, handle: tuple | None, min_score: float = 0.0) -> list[list[ScoredInt]]:
        """Materialize a dispatch_lookup handle into scored results."""
        if handle is None:
            return []
        if len(handle) == 7:  # exact2 dispatch: certificate checked here
            vals, idx, b, cert, q, k, count = handle
            vals, idx, cert_h = _fetch(vals, idx, cert)
            vals, idx = self._resolve_cert_misses(vals, idx, cert_h, q, k, count, b, b)
        else:
            vals, idx, b = handle
            vals, idx = _fetch(vals, idx)
        return _materialize_rows(vals, idx, b, min_score)

    def _subset_dispatch(
        self, embedding: np.ndarray, ordinals_of_subset: list[int], max_hits: int
    ) -> tuple[torch.Tensor, torch.Tensor] | list[ScoredInt]:
        """Launch a subset top-k; returns (vals, idx) device handles, or a
        finished empty list for the trivial case."""
        with self._dispatch_view() as (buf, scales, count):
            if not ordinals_of_subset or count == 0:
                return []
            s = len(ordinals_of_subset)
            s_pad = _bucket(s, (_SUBSET_MIN_BUCKET, 128, 256, 512, 1024, 2048, 4096))
            ords = np.zeros((s_pad,), dtype=np.int32)
            ords[:s] = np.asarray(ordinals_of_subset, dtype=np.int32)
            valid = np.zeros((s_pad,), dtype=bool)
            valid[:s] = True
            q = self._pad_queries(np.asarray(embedding, dtype=np.float32).reshape(1, -1))
            # k from the PADDED size, as the JAX package does: padding slots
            # score -1 and are dropped at collect.
            k = min(max_hits, s_pad)
            ords_dev = torch.from_numpy(ords).to(self._device)
            valid_dev = torch.from_numpy(valid).to(self._device)
            if self._quantized:
                return topk.subset_cosine_topk_quantized(buf, scales, q, ords_dev, valid_dev, k)
            return topk.subset_cosine_topk(buf, q, ords_dev, valid_dev, k)

    @staticmethod
    def _subset_collect(vals: np.ndarray, idx: np.ndarray, min_score: float) -> list[ScoredInt]:
        vals = vals[0]
        idx = idx[0]
        # vals >= 0.0 drops the padded slots (score -1).
        keep = (vals >= min_score) & (vals >= 0.0)
        return [ScoredInt(int(i), float(v)) for v, i in zip(vals[keep], idx[keep])]

    def fuzzy_lookup_embedding_in_subset(
        self,
        embedding: np.ndarray,
        ordinals_of_subset: list[int],
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[ScoredInt]:
        """Top-k within an ordinal subset."""
        if max_hits is None:
            max_hits = 10
        if min_score is None:
            min_score = 0.0
        out = self._subset_dispatch(embedding, ordinals_of_subset, max_hits)
        if isinstance(out, list):
            return out
        vals, idx = _fetch(*out)
        return self._subset_collect(vals, idx, min_score)

    async def fuzzy_lookup_embedding_in_subset_async(
        self,
        embedding: np.ndarray,
        ordinals_of_subset: list[int],
        max_hits: int | None = None,
        min_score: float | None = None,
    ) -> list[ScoredInt]:
        """Async subset top-k: launch inline, wait for the device off-loop."""
        if max_hits is None:
            max_hits = 10
        if min_score is None:
            min_score = 0.0
        out = self._subset_dispatch(embedding, ordinals_of_subset, max_hits)
        if isinstance(out, list):
            return out
        vals, idx = await asyncio.to_thread(_fetch, *out)
        return self._subset_collect(vals, idx, min_score)

    async def fuzzy_lookup(
        self,
        key: str,
        max_hits: int | None = None,
        min_score: float | None = None,
        predicate: Callable[[int], bool] | None = None,
    ) -> list[ScoredInt]:
        if max_hits is None:
            max_hits = self.settings.max_matches
        if min_score is None:
            min_score = self.settings.min_score
        embedding = await self.get_embedding(key)
        if max_hits is None:
            # "No limit": every row above min_score, best-first.
            max_hits = len(self)
        if predicate is None and len(self) > 0:
            rows = await self.fuzzy_lookup_embeddings_batch_async(
                np.asarray(embedding, dtype=np.float32).reshape(1, -1),
                max_hits=max_hits,
                min_score=min_score,
            )
            return rows[0]
        return self.fuzzy_lookup_embedding(
            embedding, max_hits=max_hits, min_score=min_score, predicate=predicate
        )

    # -- raw access / persistence -------------------------------------------

    def clear(self) -> None:
        with self._flush_lock:
            self._buf = None
            self._scales = None
            self._shadow_cache = None
            self._count = 0
            # The snapshot indexes the rows cleared here.
            self._ivf = None
            self._ivf_count = 0
            self._esc_ema = None
            with self._pending_lock:
                self._pending = []
                self._pending_rows = 0

    def _device_rows(self, start: int, stop: int) -> np.ndarray:
        """Committed rows [start, stop) as host f32 (dequantized for int8)."""
        rows = self._buf[start:stop, : self._embedding_size].float()
        if self._quantized:
            rows = rows * self._scales[start:stop, None]
        return rows.cpu().numpy()

    def host_rows(self, start: int, stop: int) -> np.ndarray:
        """Live rows [start, stop) as host f32, O(stop - start)."""
        self._flush()
        stop = min(stop, len(self))
        if stop <= start:
            return np.empty((0, self._embedding_size), dtype=np.float32)
        return self._device_rows(start, stop)

    def get_embedding_at(self, pos: int) -> np.ndarray:
        n = len(self)
        if 0 <= pos < n:
            if pos < self._count:
                return self._device_rows(pos, pos + 1)[0]
            off = pos - self._count
            for chunk in self._pending:
                if off < chunk.shape[0]:
                    return chunk[off]
                off -= chunk.shape[0]
        raise IndexError(f"Index {pos} out of bounds for embedding index of size {n}")

    def serialize_embedding_at(self, pos: int) -> np.ndarray | None:
        return self.get_embedding_at(pos) if 0 <= pos < len(self) else None

    def serialize(self) -> np.ndarray:
        """All live rows as a host f32 array ``[len, embedding_size]`` (the
        JAX store's format, so either package reads the other's output);
        an int8 store's rows come out dequantized."""
        parts = []
        if self._count and self._buf is not None:
            parts.append(self._device_rows(0, self._count))
        parts.extend(self._pending)
        if not parts:
            return np.empty((0, self._embedding_size), dtype=np.float32)
        return np.concatenate(parts, axis=0)

    def deserialize(self, data: np.ndarray | None) -> None:
        self.clear()
        if data is None:
            return
        data = np.asarray(data, dtype=np.float32)
        if data.ndim < 2 or data.shape[0] == 0:
            return
        if self._embedding_size == 0:
            self._set_embedding_size(data.shape[1])
        if data.shape[1] != self._embedding_size:
            raise ValueError(
                f"Embedding size mismatch: expected {self._embedding_size}, got {data.shape[1]}"
            )
        with self._pending_lock:
            self._pending.append(data)
            self._pending_rows += data.shape[0]


# Alias matching the reference class name.
VectorBase = VectorStore
