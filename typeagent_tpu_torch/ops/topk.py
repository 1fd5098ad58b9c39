"""Exact cosine top-k over a padded embedding store.

Public scores are ``clip((cos+1)/2, 0, 1)``; rows at or past the ``count``
watermark never surface. CUDA kernels written for Hopper (``csrc/``) carry
the exact routes:

  * K1 ``fused_topk``: one-phase top-k (k <= 32) that never writes the
    ``[b, n]`` score matrix to device memory; its scoped and int8
    variants share the scan (``csrc/topk.cu``):
    K4 ``fused_topk_iv`` (rows inside <= 8 ``[start, stop)`` intervals),
    K5 ``fused_topk_masked`` (rows whose i32 mask entry is > 0),
    K6 ``fused_topk_q`` (int8 rows with per-row scales) and
    K7 ``fused_topk_mq`` (K6 with K5's mask), the last two on the
    tensor-core loop of K8 (``csrc/mma_tile.cuh``); the scoped scans K4,
    K5 and K7 read only the tiles that hold an in-scope row, which
    :func:`interval_tiles` and :func:`scope_tiles` list on the device
    (``csrc/tile_list.cu``);
  * K2 ``bucket_maxima``: maximum raw cosine of each 128-row bucket, the
    selection phase of the two-phase ("exact2") search; K2'
    ``bucket_argmax``, the same kernel with the argmax row of each bucket,
    carries the bucketed approximate search (``cosine_topk_bucket``);
  * K8 ``bucket_maxima_q``: K2 over an int8 selection shadow with per-row
    scales, phase 1 of the int8-selection hybrid
    (``cosine_topk_exact2_hybrid_i8``); K9, the same over a packed int4
    shadow, lives in :mod:`.int4` (``bucket_maxima_q4``);
  * K3 ``rescore_selected``: exact f32 scores of each query's selected
    buckets, the second phase, which ends in a per-query certificate.

Each kernel has a plain PyTorch version of the same function beside it
(``topk_plain``, ``topk_iv_plain``, ``topk_masked_plain``,
``topk_q_plain``, ``topk_mq_plain``, ``bucket_maxima_plain``,
``bucket_argmax_plain``, ``bucket_maxima_q_plain``,
``rescore_selected_plain``, ``interval_tiles_plain``,
``scope_tiles_plain``). A wrapper runs the
plain version for a tensor on the CPU and launches its kernel for a CUDA
tensor; there is no other fallback. Each wrapper counts its launches, so
a run can show that the serving path went through it.
"""

from __future__ import annotations

import functools
import math
import threading

import numpy as np
import torch

from ..utils.metrics import METRICS
from . import _build

__all__ = [
    "cosine_topk",
    "cosine_topk_exact2",
    "cosine_topk_exact2_hybrid",
    "cosine_topk_exact2_hybrid_i8",
    "topk_program_exact2_hybrid_i8",
    "cosine_topk_approx",
    "cosine_topk_bucket",
    "approx_uses_buckets",
    "cosine_scores",
    "subset_cosine_topk",
    "topk_many",
    "fused_topk",
    "bucket_maxima",
    "bucket_argmax",
    "bucket_maxima_q",
    "rescore_selected",
    "topk_plain",
    "bucket_maxima_plain",
    "bucket_argmax_plain",
    "bucket_maxima_q_plain",
    "rescore_selected_plain",
    "intervals_to_rowmask",
    "scope_tiles",
    "scope_tiles_plain",
    "interval_tiles",
    "interval_tiles_plain",
    "topk_program_masked",
    "topk_program_intervals",
    "quantize_rows",
    "quantize_rows_device",
    "cosine_scores_quantized",
    "subset_cosine_topk_quantized",
    "cosine_topk_quantized",
    "topk_program_quantized",
    "topk_program_masked_quantized",
    "topk_program_intervals_quantized",
    "fused_topk_iv",
    "fused_topk_masked",
    "fused_topk_q",
    "fused_topk_mq",
    "topk_iv_plain",
    "topk_masked_plain",
    "topk_q_plain",
    "topk_mq_plain",
]

# Largest k the fused kernel takes (the warp-held list has 32 lanes); a
# larger k materializes the scores, as the JAX package does past its cap.
_PALLAS_MAX_K = 32
# Largest interval table K4 takes (the JAX kernel's SMEM table); larger
# tables expand to a row mask and ride K5.
_PALLAS_MAX_INTERVALS = 8
_NEG = -1.0  # below any public score in [0, 1]
_RAW_NEG = -3.0  # below any raw cosine in [-1, 1]
_BUCKET_ROWS = 128
# Certificate slack, plain exact2: both phases score the same rows in f32
# but sum in different orders.
_CERT_EPS = 1e-5
# Hybrid certificate slack: phase 1 reads the bf16 shadow, whose cosines
# differ from f32 by about 2^-8 for normalized rows.
_CERT_EPS_HYBRID = 5e-3
_HYBRID_SLACK = 14
# int8-selection certificate slack: the int8 shadow's cosines differ from
# f32 by up to ~1e-2 (7-bit codes, per-row scale), so selection takes more
# slack and the certificate bounds a miss to an eps-score tie.
_CERT_EPS_HYBRID_I8 = 2e-2
_HYBRID_I8_SLACK = 14
_EXACT2_SLACK = 6
# Rows per chunk of the plain bucket maxima (bounds its score temporary).
_PLAIN_CHUNK = 1 << 16
# Rows per chunk of the plain top-k versions: bounds the [b, chunk] score
# temporary and, for int8 stores, the f32 copy of the chunk's rows (a 30M
# x 384 int8 store upcast in one piece would need 46 GB).
_PLAIN_TOPK_CHUNK = 1 << 20
# Kernel tile shape (csrc/tile.cuh): 128-row tiles (one bucket each) and
# the tensor-core loop's 64-query block (csrc/mma_tile.cuh: K2 and K2' on
# bf16 stores, K6-K9); the FFMA tile's query block follows the batch
# (topk_query_block).
_RB = 128
_MMA_QB = 64
# Every scan and bucket kernel is __launch_bounds__(256, 2) with at most
# 113 KB of shared memory (csrc/tile.cuh SMEM_2CTA): two CTAs share an SM,
# so one wave of the grid is 2 x the SM count.
_CTAS_PER_SM = 2


class LaunchCounter:
    """A count of kernel launches; serving threads launch concurrently."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


TOPK_LAUNCHES = LaunchCounter("topk")
TOPK_IV_LAUNCHES = LaunchCounter("topk_iv")
TOPK_MASK_LAUNCHES = LaunchCounter("topk_mask")
TOPK_Q_LAUNCHES = LaunchCounter("topk_q")
TOPK_MQ_LAUNCHES = LaunchCounter("topk_mq")
BUCKET_MAXIMA_LAUNCHES = LaunchCounter("bucket_maxima")
BUCKET_ARGMAX_LAUNCHES = LaunchCounter("bucket_argmax")
BUCKET_MAXIMA_Q_LAUNCHES = LaunchCounter("bucket_maxima_q")
# K9's count (its wrapper is ``int4.bucket_maxima_q4``), here so that
# ``launch_counts`` reads every kernel.
BUCKET_MAXIMA_Q4_LAUNCHES = LaunchCounter("bucket_maxima_q4")
RESCORE_LAUNCHES = LaunchCounter("rescore")
# The scoped scans' tile lists (csrc/tile_list.cu).
INTERVAL_TILES_LAUNCHES = LaunchCounter("interval_tiles")
SCOPE_TILES_LAUNCHES = LaunchCounter("scope_tiles")
# Calls of the k > 32 route, which materializes scores (no kernel).
MATERIALIZED_CALLS = LaunchCounter("materialized_topk")
COUNTERS = (
    TOPK_LAUNCHES, TOPK_IV_LAUNCHES, TOPK_MASK_LAUNCHES, TOPK_Q_LAUNCHES,
    TOPK_MQ_LAUNCHES, BUCKET_MAXIMA_LAUNCHES, BUCKET_ARGMAX_LAUNCHES,
    BUCKET_MAXIMA_Q_LAUNCHES, BUCKET_MAXIMA_Q4_LAUNCHES, RESCORE_LAUNCHES,
    INTERVAL_TILES_LAUNCHES, SCOPE_TILES_LAUNCHES, MATERIALIZED_CALLS,
)


def launch_counts() -> dict[str, int]:
    return {c.name: c.count for c in COUNTERS}


def reset_launch_counts() -> None:
    for c in COUNTERS:
        c.reset()


def _raw_to_score(raw_vals: torch.Tensor, idx: torch.Tensor):
    """Map raw cosines to the public score space: clip((cos+1)/2) for real
    entries, (-1, -1) for unfilled or masked slots."""
    valid = raw_vals > -2.0  # real cosines live in [-1, 1]
    vals = torch.where(valid, ((raw_vals + 1.0) * 0.5).clamp(0.0, 1.0), _NEG)
    return vals, torch.where(valid, idx, -1)


# ---------------------------------------------------------------------------
# Argument checks shared by the kernel wrappers
# ---------------------------------------------------------------------------


def _store_code(emb: torch.Tensor) -> int:
    if emb.dtype == torch.float32:
        return 0
    if emb.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"store dtype must be float32 or bfloat16, got {emb.dtype}")


def _check_geometry(emb: torch.Tensor, queries: torch.Tensor) -> None:
    if emb.device.type != "cuda":
        raise ValueError(f"no kernel for a store on {emb.device}")
    if queries.device != emb.device:
        raise ValueError(f"queries on {queries.device}, store on {emb.device}")
    if emb.dim() != 2 or not emb.is_contiguous():
        raise ValueError("store must be a contiguous [n_rows, d_pad] tensor")
    if queries.dim() != 2 or not queries.is_contiguous():
        raise ValueError("queries must be a contiguous [b, d_pad] tensor")
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    n_rows, d_pad = emb.shape
    if queries.shape[1] != d_pad:
        raise ValueError(f"query width {queries.shape[1]} != store width {d_pad}")
    if d_pad % 32 or n_rows % _RB or n_rows >= 2**31:
        raise ValueError(f"unsupported store shape {tuple(emb.shape)}")
    if emb.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("the kernels stage 16-byte pieces: store and queries must be 16-byte aligned")


def _check_cuda_operands(emb: torch.Tensor, queries: torch.Tensor) -> int:
    """Validate a kernel launch's f32/bf16 store and queries; return the
    dtype code."""
    _check_geometry(emb, queries)
    return _store_code(emb)


def _check_int8_operands(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor
) -> None:
    _check_geometry(emb_q, queries)
    if emb_q.dtype != torch.int8:
        raise TypeError(f"quantized store must be int8, got {emb_q.dtype}")
    if (
        scales.device != emb_q.device
        or scales.dtype != torch.float32
        or tuple(scales.shape) != (emb_q.shape[0],)
        or not scales.is_contiguous()
    ):
        raise ValueError("scales must be a contiguous [n_rows] float32 tensor on the store's device")
    if emb_q.shape[1] % 64:
        raise ValueError(f"int8 rows stage 64-column strips: needs width % 64 == 0, got width {emb_q.shape[1]}")


def _check_rowmask(rowmask: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """The mask as a flat [n_rows] int32 device tensor."""
    mask = rowmask.reshape(-1)
    if (
        mask.device != emb.device
        or mask.dtype != torch.int32
        or mask.shape[0] != emb.shape[0]
        or not mask.is_contiguous()
    ):
        raise ValueError("rowmask must be a contiguous [n_rows] int32 tensor on the store's device")
    return mask


def _check_intervals(intervals: torch.Tensor, emb: torch.Tensor) -> None:
    if (
        intervals.device != emb.device
        or intervals.dtype != torch.int32
        or intervals.dim() != 2
        or intervals.shape[1] != 2
        or intervals.shape[0] > _PALLAS_MAX_INTERVALS
        or not intervals.is_contiguous()
    ):
        raise ValueError(
            f"intervals must be a contiguous [s <= {_PALLAS_MAX_INTERVALS}, 2] "
            "int32 tensor on the store's device"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(t: torch.Tensor):
    """Make ``t``'s card the CUDA runtime's current device for a launch.
    The ctypes entry points launch (and set their kernels' shared-memory
    attributes) on the current device, which need not be the tensor's
    card on a machine with several."""
    return torch.cuda.device(t.device)


# ---------------------------------------------------------------------------
# Launch geometry (pure functions of the shapes and the card's SM count)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a card, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def topk_query_block(b: int) -> int:
    """Queries per CTA of the FFMA tile (csrc/tile.cuh), by the batch
    alone: the power of two from 8 to 64 that holds it, so the store's
    padded batches of 8, 16 and 32 score no padding queries (at such
    batches the store read bounds a scan), and larger batches stream the
    store once per 64 queries."""
    return min(64, max(8, 1 << (max(b, 1) - 1).bit_length()))


def split_range(n: int, n_qb: int, sms: int) -> tuple[int, int]:
    """Cut ``n`` tiles (at least one) into contiguous ranges for one wave of
    ``_CTAS_PER_SM * sms`` CTAs shared by ``n_qb`` query blocks. Returns
    ``(per, ranges)``: range ``i`` is ``[i*per, min((i+1)*per, n))`` and
    none is empty."""
    n = max(1, n)
    ranges = min(n, max(1, _CTAS_PER_SM * sms // n_qb))
    per = math.ceil(n / ranges)
    return per, math.ceil(n / per)


def scan_geometry(count: int, n_rows: int, b: int, sms: int, query_block: int) -> tuple[int, int]:
    """``(rows_per_split, splits)`` of a top-k scan (``csrc/topk.cu``) over
    rows ``[0, count)`` of an ``n_rows`` store: split ``i`` scans rows
    ``[i*rows_per_split, (i+1)*rows_per_split)`` below the count, in
    128-row tiles, for each of the ``ceil(b / query_block)`` query blocks.
    A dead store keeps one (empty) split, whose lists stay unfilled."""
    count = max(0, min(int(count), n_rows))
    per, splits = split_range(math.ceil(count / _RB), math.ceil(b / query_block), sms)
    return per * _RB, splits


def scope_share(n_tiles: int, splits: int, split: int) -> tuple[int, int]:
    """Positions ``[first, last)`` of a listed scan's tile list (K4, K5, K7) that
    CTA ``split`` of ``splits`` walks, as ``csrc/topk.cu`` computes them
    from the device count: contiguous, ascending with ``split``, and
    within one tile of each other in size."""
    return n_tiles * split // splits, n_tiles * (split + 1) // splits


def bucket_geometry(count: int, n_rows: int, b: int, sms: int, query_block: int) -> tuple[int, int]:
    """``(buckets_per_cta, ctas_per_qb)`` of a bucket kernel
    (``csrc/bucket_maxima.cu``): CTA ``c`` of each query block walks the
    live buckets ``[c*buckets_per_cta, (c+1)*buckets_per_cta)`` below
    ``ceil(count/128)``, and writes the dead buckets ``live + c, live + c +
    ctas_per_qb, ...`` below ``n_rows/128``."""
    count = max(0, min(int(count), n_rows))
    return split_range(math.ceil(count / _RB), math.ceil(b / query_block), sms)


# ---------------------------------------------------------------------------
# Plain versions: raw scores by row chunk, lowest-row-tie selection
# ---------------------------------------------------------------------------


def _raw_scores(
    emb: torch.Tensor, queries: torch.Tensor, count: int, start: int = 0,
    stop: int | None = None,
) -> torch.Tensor:
    """Masked raw cosines of rows [start, stop): queries cast to the store
    dtype, both upcast, one f32 product (bf16 products are exact in f32)."""
    rows = emb[start:stop]
    q = queries.to(emb.dtype).float()
    raw = q @ rows.float().T
    ids = torch.arange(start, start + rows.shape[0], device=emb.device)
    return raw.masked_fill(ids[None, :] >= count, _RAW_NEG)


def _raw_scores_q(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, start: int = 0, stop: int | None = None,
) -> torch.Tensor:
    """Masked raw cosines of int8 rows [start, stop): bf16-rounded queries
    against the exactly upcast rows in f32, then each score times its
    row's scale (the JAX kernel's ``raw * s_ref``)."""
    rows = emb_q[start:stop]
    q = queries.to(torch.bfloat16).float()
    raw = (q @ rows.float().T) * scales[start:stop][None, :]
    ids = torch.arange(start, start + rows.shape[0], device=emb_q.device)
    return raw.masked_fill(ids[None, :] >= count, _RAW_NEG)


def _in_intervals(ids: torch.Tensor, intervals: torch.Tensor) -> torch.Tensor:
    iv = intervals.to(ids.device)
    return ((ids[:, None] >= iv[None, :, 0]) & (ids[:, None] < iv[None, :, 1])).any(dim=1)


def _select_topk(raw: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row of ``raw`` ([b, m]): values descending, equal
    values at ascending positions (the lowest row wins a tie)."""
    b = raw.shape[0]
    theta = torch.topk(raw, k, dim=1).values[:, k - 1 : k]
    above = raw > theta
    tied = raw == theta
    need = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    take = above | (tied & (tied.cumsum(dim=1, dtype=torch.int32) <= need))
    pos = take.nonzero()[:, 1].reshape(b, k)  # ascending positions per row
    vals = raw.gather(1, pos)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, order), pos.gather(1, order)


def _topk_chunked(raw_of, n_rows: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw top-k over rows ``[0, n_rows)`` scored chunk by chunk by
    ``raw_of(start, stop)``: each chunk's top-k (ties to its lowest row),
    then one stable descending sort of the candidates, which keeps chunk
    order, so ties stay at the lowest row. Unfilled slots are (-3, -1)."""
    parts_v, parts_i = [], []
    for start in range(0, n_rows, _PLAIN_TOPK_CHUNK):
        stop = min(start + _PLAIN_TOPK_CHUNK, n_rows)
        v, p = _select_topk(raw_of(start, stop), min(k, stop - start))
        parts_v.append(v)
        parts_i.append(p + start)
    vals, idx = torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1)
    if len(parts_v) > 1:
        order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
        vals, idx = vals.gather(1, order), idx.gather(1, order)
    return vals, torch.where(vals > -2.0, idx, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# K1, K4-K7: fused top-k scans (csrc/topk.cu)
# ---------------------------------------------------------------------------


def _launch_topk(
    entry: str, counter: LaunchCounter, emb: torch.Tensor, head: tuple,
    queries: torch.Tensor, count: int, k: int, tail: tuple = (),
    query_block: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch one scan entry point of ``csrc/topk.cu`` and the merge:
    ``entry(emb, *head, q, n_rows, d_pad, b, count, k, rows_per_split,
    splits, query_block, *tail, cand_vals, cand_idx, stream)``. Operands
    are checked by the caller. ``query_block`` defaults to the FFMA tile's
    (:func:`topk_query_block`)."""
    if not 1 <= k <= _PALLAS_MAX_K:
        raise ValueError(f"fused top-k takes 1 <= k <= {_PALLAS_MAX_K}, got {k}")
    n_rows, d_pad = emb.shape
    b = queries.shape[0]
    count = max(0, min(int(count), n_rows))
    if query_block is None:
        query_block = topk_query_block(b)
    rows_per_split, splits = scan_geometry(
        count, n_rows, b, _sm_count(emb.device.index), query_block
    )
    dev = emb.device
    cand_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    stream = _stream(emb)
    with _on_card(emb):
        _build.check(
            getattr(lib, entry)(
                emb.data_ptr(), *head, queries.data_ptr(), n_rows, d_pad, b, count,
                k, rows_per_split, splits, query_block, *tail, cand_v.data_ptr(),
                cand_i.data_ptr(), stream,
            ),
            f"{counter.name} scan",
        )
        _build.check(
            lib.tat_topk_merge(
                cand_v.data_ptr(), cand_i.data_ptr(), b, splits, k,
                out_v.data_ptr(), out_i.data_ptr(), stream,
            ),
            f"{counter.name} merge",
        )
    counter.add()
    return out_v, out_i


def topk_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: raw top-k ``([b, k] f32, [b, k] i32)``, values
    descending, ties to the lowest row, unfilled slots ``(-3.0, -1)``."""
    return _topk_chunked(
        lambda start, stop: _raw_scores(emb, queries, count, start, stop), emb.shape[0], k
    )


def fused_topk(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (``csrc/topk.cu``): raw top-k of ``queries`` over rows
    ``[0, count)`` of ``emb``, as :func:`topk_plain` defines it."""
    if emb.device.type == "cpu":
        return topk_plain(emb, queries, count, k)
    code = _check_cuda_operands(emb, queries)
    return _launch_topk("tat_topk_scan", TOPK_LAUNCHES, emb, (code,), queries, count, k)


def topk_iv_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int,
    intervals: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: :func:`topk_plain` over the rows inside any
    half-open ``[start, stop)`` row of ``intervals`` ([s, 2] int32;
    ``(0, 0)`` padding rows select nothing)."""

    def raw_of(start, stop):
        ids = torch.arange(start, stop, device=emb.device)
        raw = _raw_scores(emb, queries, count, start, stop)
        return raw.masked_fill(~_in_intervals(ids, intervals)[None, :], _RAW_NEG)

    return _topk_chunked(raw_of, emb.shape[0], k)


def fused_topk_iv(
    emb: torch.Tensor, queries: torch.Tensor, count: int,
    intervals: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 (``csrc/topk.cu``), as :func:`topk_iv_plain`; ``intervals`` has
    at most 8 rows. The kernel reads only the tiles
    :func:`interval_tiles` lists, which it builds on the device without a
    host synchronisation."""
    if emb.device.type == "cpu":
        return topk_iv_plain(emb, queries, count, intervals, k)
    code = _check_cuda_operands(emb, queries)
    _check_intervals(intervals, emb)
    tiles, n_tiles = interval_tiles(intervals, count, emb.shape[0])
    return _launch_topk(
        "tat_topk_scan_iv", TOPK_IV_LAUNCHES, emb, (code,), queries, count, k,
        (intervals.data_ptr(), intervals.shape[0], tiles.data_ptr(), n_tiles.data_ptr()),
    )


def topk_masked_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int,
    rowmask: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: :func:`topk_plain` over the rows whose
    ``rowmask`` entry ([n_rows] or [1, n_rows]) is > 0."""
    mask = rowmask.reshape(-1)

    def raw_of(start, stop):
        raw = _raw_scores(emb, queries, count, start, stop)
        return raw.masked_fill(~(mask[start:stop] > 0)[None, :], _RAW_NEG)

    return _topk_chunked(raw_of, emb.shape[0], k)


def fused_topk_masked(
    emb: torch.Tensor, queries: torch.Tensor, count: int,
    rowmask: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K5 (``csrc/topk.cu``), as :func:`topk_masked_plain`; the mask is
    int32. The kernel reads only the tiles :func:`scope_tiles` lists, as
    K7 does."""
    if emb.device.type == "cpu":
        return topk_masked_plain(emb, queries, count, rowmask, k)
    code = _check_cuda_operands(emb, queries)
    mask = _check_rowmask(rowmask, emb)
    tiles, n_tiles = scope_tiles(mask, count)
    return _launch_topk(
        "tat_topk_scan_mask", TOPK_MASK_LAUNCHES, emb, (code,), queries, count,
        k, (mask.data_ptr(), tiles.data_ptr(), n_tiles.data_ptr()),
    )


def topk_q_plain(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: raw top-k over an int8 store with per-row
    ``scales``, scored as :func:`_raw_scores_q` does."""
    return _topk_chunked(
        lambda start, stop: _raw_scores_q(emb_q, scales, queries, count, start, stop),
        emb_q.shape[0], k,
    )


def fused_topk_q(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 (``csrc/topk.cu``, on the tensor-core loop), as
    :func:`topk_q_plain`; queries are f32 and are cast to bf16 once here,
    as the JAX kernel's caller casts them. ``d_pad % 64 == 0``."""
    if emb_q.device.type == "cpu":
        return topk_q_plain(emb_q, scales, queries, count, k)
    _check_int8_operands(emb_q, scales, queries)
    return _launch_topk(
        "tat_topk_scan_q", TOPK_Q_LAUNCHES, emb_q, (scales.data_ptr(),),
        queries.to(torch.bfloat16), count, k, query_block=_MMA_QB,
    )


def topk_mq_plain(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, rowmask: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: :func:`topk_q_plain` over the rows whose
    ``rowmask`` entry is > 0."""
    mask = rowmask.reshape(-1)

    def raw_of(start, stop):
        raw = _raw_scores_q(emb_q, scales, queries, count, start, stop)
        return raw.masked_fill(~(mask[start:stop] > 0)[None, :], _RAW_NEG)

    return _topk_chunked(raw_of, emb_q.shape[0], k)


def fused_topk_mq(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, rowmask: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K7 (``csrc/topk.cu``), as :func:`topk_mq_plain`; the mask is
    int32. The kernel reads only the tiles :func:`scope_tiles` lists,
    which it builds on the device without a host synchronisation."""
    if emb_q.device.type == "cpu":
        return topk_mq_plain(emb_q, scales, queries, count, rowmask, k)
    _check_int8_operands(emb_q, scales, queries)
    mask = _check_rowmask(rowmask, emb_q)
    tiles, n_tiles = scope_tiles(mask, count)
    return _launch_topk(
        "tat_topk_scan_mq", TOPK_MQ_LAUNCHES, emb_q, (scales.data_ptr(),),
        queries.to(torch.bfloat16), count, k,
        (mask.data_ptr(), tiles.data_ptr(), n_tiles.data_ptr()), query_block=_MMA_QB,
    )


# ---------------------------------------------------------------------------
# K2: bucket maxima
# ---------------------------------------------------------------------------


def _bucket_maxima_chunked(raw_of, n_rows: int, b: int, device) -> torch.Tensor:
    """``[b, n_rows/128]`` f32 bucket maxima of the masked raw scores that
    ``raw_of(start, stop)`` gives for rows ``[start, stop)``, a chunk at a
    time (the plain versions of K2, K8 and K9)."""
    out = torch.empty((b, n_rows // _BUCKET_ROWS), dtype=torch.float32, device=device)
    for start in range(0, n_rows, _PLAIN_CHUNK):
        stop = min(start + _PLAIN_CHUNK, n_rows)
        out[:, start // _BUCKET_ROWS : stop // _BUCKET_ROWS] = raw_of(start, stop).view(
            b, -1, _BUCKET_ROWS
        ).amax(dim=2)
    return out


def bucket_maxima_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """Plain version of K2: ``[b, n_rows/128]`` f32 maximum raw cosine per
    128-row bucket, -3.0 where every row is at or past ``count``."""
    return _bucket_maxima_chunked(
        lambda start, stop: _raw_scores(emb, queries, count, start, stop),
        emb.shape[0], queries.shape[0], emb.device,
    )


def bucket_argmax_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2': :func:`bucket_maxima_plain` plus the argmax
    row of each bucket (``[b, n_rows/128]`` i32, the lowest row among
    equal maxima, as ``jnp.argmax``); a bucket with no live row gives
    ``(-3.0, -1)``."""
    n_rows = emb.shape[0]
    b = queries.shape[0]
    nb = n_rows // _BUCKET_ROWS
    vals = torch.empty((b, nb), dtype=torch.float32, device=emb.device)
    idx = torch.empty((b, nb), dtype=torch.int32, device=emb.device)
    for start in range(0, n_rows, _PLAIN_CHUNK):
        stop = min(start + _PLAIN_CHUNK, n_rows)
        grouped = _raw_scores(emb, queries, count, start, stop).view(b, -1, _BUCKET_ROWS)
        # max() returns the first maximal position along the bucket.
        v, pos = grouped.max(dim=2)
        b0, b1 = start // _BUCKET_ROWS, stop // _BUCKET_ROWS
        rows = torch.arange(b0, b1, device=emb.device)[None, :] * _BUCKET_ROWS + pos
        vals[:, b0:b1] = v
        idx[:, b0:b1] = torch.where(v > -2.0, rows, -1).to(torch.int32)
    return vals, idx


def _launch_bucket_maxima(
    emb: torch.Tensor, queries: torch.Tensor, count: int, with_idx: bool
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch ``csrc/bucket_maxima.cu``: K2 (maxima only) or K2' (maxima
    and argmax rows)."""
    code = _check_cuda_operands(emb, queries)
    n_rows, d_pad = emb.shape
    b = queries.shape[0]
    q_arg = queries
    if code == 1:
        # The tensor-core path takes bf16 queries (cast once here, as the
        # JAX kernel casts queries to the store dtype) and stages rows and
        # queries in 64-deep strips.
        q_arg = queries.to(torch.bfloat16)
        if d_pad % 64:
            raise ValueError("bf16 bucket maxima needs d_pad % 64 == 0")
    nb = n_rows // _BUCKET_ROWS
    out = torch.empty((b, nb), dtype=torch.float32, device=emb.device)
    idx = torch.empty((b, nb), dtype=torch.int32, device=emb.device) if with_idx else None
    count = max(0, min(int(count), n_rows))
    query_block = _MMA_QB if code == 1 else topk_query_block(b)
    per, ctas = bucket_geometry(count, n_rows, b, _sm_count(emb.device.index), query_block)
    with _on_card(emb):
        _build.check(
            _build.kernels().tat_bucket_maxima(
                emb.data_ptr(), code, q_arg.data_ptr(), n_rows, d_pad, b, count,
                per, ctas, query_block, out.data_ptr(),
                idx.data_ptr() if with_idx else None, _stream(emb),
            ),
            "bucket argmax" if with_idx else "bucket maxima",
        )
    return out, idx


def bucket_maxima(
    emb: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """K2 (``csrc/bucket_maxima.cu``), as :func:`bucket_maxima_plain`."""
    if emb.device.type == "cpu":
        return bucket_maxima_plain(emb, queries, count)
    out, _ = _launch_bucket_maxima(emb, queries, count, with_idx=False)
    BUCKET_MAXIMA_LAUNCHES.add()
    return out


def bucket_argmax(
    emb: torch.Tensor, queries: torch.Tensor, count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K2' (``csrc/bucket_maxima.cu``, the argmax instance of K2's
    template), as :func:`bucket_argmax_plain`."""
    if emb.device.type == "cpu":
        return bucket_argmax_plain(emb, queries, count)
    out = _launch_bucket_maxima(emb, queries, count, with_idx=True)
    BUCKET_ARGMAX_LAUNCHES.add()
    return out


# ---------------------------------------------------------------------------
# K8 (and K9's launch): bucket maxima over a scaled int8 or int4 shadow
# ---------------------------------------------------------------------------


def bucket_maxima_q_plain(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """Plain version of K8: :func:`bucket_maxima_plain` over an int8 store
    with per-row ``scales``, each row scored as :func:`_raw_scores_q` does
    (bf16-rounded queries against the exactly upcast codes, times the
    row's scale, then the watermark mask)."""
    return _bucket_maxima_chunked(
        lambda start, stop: _raw_scores_q(emb_q, scales, queries, count, start, stop),
        emb_q.shape[0], queries.shape[0], emb_q.device,
    )


def _launch_bucket_maxima_q(
    kind: int, emb: torch.Tensor, scales: torch.Tensor, q_bf16: torch.Tensor, count: int,
    live: int | None = None,
) -> torch.Tensor:
    """Launch ``tat_bucket_maxima_q`` of ``csrc/bucket_maxima.cu``: K8
    (``kind`` 0, int8 codes, ``q_bf16`` [b, width]) or K9 (``kind`` 1,
    packed int4 bytes, ``q_bf16`` the split halves [b, 2*width]), the
    product walking the first ``live`` elements of each row (``None``: the
    whole width). The caller has checked device, dtype and shapes; this
    checks the strip layout the kernel stages with 16-byte loads."""
    n_rows, width = emb.shape
    strip = 64 if kind == 0 else 32
    live = width if live is None else live
    if width % strip or emb.data_ptr() % 16 or q_bf16.data_ptr() % 16:
        raise ValueError(
            f"bucket maxima over a {'packed int4' if kind else 'int8'} shadow needs "
            f"width % {strip} == 0 and 16-byte aligned operands, got width {width}"
        )
    if not 0 < live <= width or live % strip:
        raise ValueError(f"live depth {live} is not a multiple of {strip} in (0, {width}]")
    b = q_bf16.shape[0]
    out = torch.empty((b, n_rows // _BUCKET_ROWS), dtype=torch.float32, device=emb.device)
    count = max(0, min(int(count), n_rows))
    per, ctas = bucket_geometry(count, n_rows, b, _sm_count(emb.device.index), _MMA_QB)
    with _on_card(emb):
        _build.check(
            _build.kernels().tat_bucket_maxima_q(
                emb.data_ptr(), kind, scales.data_ptr(), q_bf16.data_ptr(), n_rows, width,
                live, b, count, per, ctas, out.data_ptr(), _stream(emb),
            ),
            "int4 bucket maxima" if kind else "int8 bucket maxima",
        )
    return out


def bucket_maxima_q(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """K8 (``csrc/bucket_maxima.cu``, the int8 instance of K2's tensor-core
    template), as :func:`bucket_maxima_q_plain`; queries are f32 and are
    cast to bf16 once here, as the JAX kernel's caller casts them."""
    if emb_q.device.type == "cpu":
        return bucket_maxima_q_plain(emb_q, scales, queries, count)
    _check_int8_operands(emb_q, scales, queries)
    out = _launch_bucket_maxima_q(0, emb_q, scales, queries.to(torch.bfloat16), count)
    BUCKET_MAXIMA_Q_LAUNCHES.add()
    return out


# ---------------------------------------------------------------------------
# K3: selected-bucket rescore
# ---------------------------------------------------------------------------


def _bucket_row_ids(bucket_ids: torch.Tensor) -> torch.Tensor:
    b, B = bucket_ids.shape
    lanes = torch.arange(_BUCKET_ROWS, device=bucket_ids.device, dtype=torch.int32)
    return (bucket_ids[:, :, None] * _BUCKET_ROWS + lanes).reshape(b, B * _BUCKET_ROWS)


def rescore_selected_plain(
    emb: torch.Tensor, queries: torch.Tensor, bucket_ids: torch.Tensor
) -> torch.Tensor:
    """Plain version of K3: ``[b, B*128]`` f32 raw cosines of each query
    (in f32) against every row of its B selected buckets."""
    rows = emb[_bucket_row_ids(bucket_ids).long()].float()  # [b, B*128, d]
    return torch.bmm(rows, queries.float()[:, :, None]).squeeze(2)


def rescore_selected(
    emb: torch.Tensor, queries: torch.Tensor, bucket_ids: torch.Tensor
) -> torch.Tensor:
    """K3 (``csrc/rescore.cu``), as :func:`rescore_selected_plain`.
    ``bucket_ids`` must lie in ``[0, n_rows/128)``."""
    if emb.device.type == "cpu":
        return rescore_selected_plain(emb, queries, bucket_ids)
    code = _check_cuda_operands(emb, queries)
    n_rows, d_pad = emb.shape
    b = queries.shape[0]
    if (
        bucket_ids.device != emb.device
        or bucket_ids.dtype != torch.int32
        or bucket_ids.dim() != 2
        or bucket_ids.shape[0] != b
        or not bucket_ids.is_contiguous()
    ):
        raise ValueError("bucket_ids must be a contiguous [b, B] int32 tensor on the store's device")
    if d_pad * 4 > 48 * 1024:
        raise ValueError(f"rescore takes d_pad <= 12288, got {d_pad}")
    B = bucket_ids.shape[1]
    out = torch.empty((b, B * _BUCKET_ROWS), dtype=torch.float32, device=emb.device)
    with _on_card(emb):
        _build.check(
            _build.kernels().tat_rescore(
                emb.data_ptr(), code, queries.data_ptr(), bucket_ids.data_ptr(),
                n_rows, d_pad, b, B, out.data_ptr(), _stream(emb),
            ),
            "rescore",
        )
    RESCORE_LAUNCHES.add()
    return out


# ---------------------------------------------------------------------------
# Search routes
# ---------------------------------------------------------------------------


def cosine_scores(emb: torch.Tensor, queries: torch.Tensor, count: int) -> torch.Tensor:
    """Full masked score matrix ``[b, n_pad]`` in the public score space;
    rows at or past ``count`` score -1 (for host-predicate paths)."""
    scores = ((_raw_scores(emb, queries, count) + 1.0) * 0.5).clamp(0.0, 1.0)
    valid = torch.arange(emb.shape[0], device=emb.device)[None, :] < count
    return torch.where(valid, scores, _NEG)


def _topk_materialized(
    scores: torch.Tensor, k: int, rowmask: torch.Tensor | None = None
):
    """k > 32: the top k of a materialized ``[b, n]`` score matrix (the
    JAX package's own non-Pallas route, ``lax.top_k``); masked slots score
    -1. Equal scores keep the lowest row first, as ``lax.top_k`` does: a
    stable descending sort, since ``torch.topk`` leaves the order of ties
    unspecified, and rows with one embedding (the same text twice) tie
    exactly. With a ``rowmask``, rows whose entry is not > 0 score -1 too
    and invalid slots carry index -1, as the JAX masked routes return
    them."""
    MATERIALIZED_CALLS.add()
    if rowmask is not None:
        scores = scores.masked_fill(~(rowmask.reshape(1, -1) > 0), _NEG)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k].contiguous(), idx[:, :k].to(torch.int32)
    if rowmask is not None:
        idx = torch.where(vals >= 0.0, idx, -1)
    return vals, idx


def cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched exact top-k: ``(vals [b, k], idx [b, k])``, scores in [0, 1]
    descending; invalid slots have ``vals < 0`` (callers filter on it)."""
    k = min(k, emb.shape[0])
    if k <= _PALLAS_MAX_K:
        return _raw_to_score(*fused_topk(emb, queries, count, k))
    return _topk_materialized(cosine_scores(emb, queries, count), k)


def intervals_to_rowmask(n: int, intervals: torch.Tensor) -> torch.Tensor:
    """[1, n] int32 membership mask of the UNION of half-open row intervals
    ([s, 2] int32), on the intervals' device.

    O(n log s) via sort + cummax + searchsorted, no [n, s] intermediate:
    row r is in the union iff r < max(stop | start <= r). Correct for
    unsorted and overlapping tables; (0, 0) padding rows select nothing.
    """
    starts = intervals[:, 0]
    order = torch.argsort(starts, stable=True)
    sorted_starts = starts[order].contiguous()
    cum_stops = torch.cummax(intervals[:, 1][order], dim=0).values
    rows = torch.arange(n, dtype=torch.int32, device=intervals.device)
    pos = torch.searchsorted(sorted_starts, rows, right=True) - 1
    stop_at = cum_stops[pos.clamp(0, sorted_starts.shape[0] - 1)]
    return ((pos >= 0) & (rows < stop_at)).to(torch.int32)[None, :]


def _listed_tiles(hit: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(tiles, n_tiles)`` of a ``[live]`` bool flag per tile: the flagged
    indices ascending, then -1, and a ``[1]`` int32 count, on the flags'
    device, with no host synchronisation: a running count of the flags
    gives each listed tile its position, and a scatter puts it there."""
    live = hit.shape[0]
    pos = torch.cumsum(hit, 0, dtype=torch.int32)
    n_tiles = pos[-1:] if live else torch.zeros((1,), dtype=torch.int32, device=hit.device)
    # Unlisted tiles land in a spare last slot, cut off below.
    tiles = torch.full((live + 1,), -1, dtype=torch.int32, device=hit.device)
    tiles.scatter_(
        0, torch.where(hit, pos - 1, live).long(),
        torch.arange(live, dtype=torch.int32, device=hit.device),
    )
    return tiles[:live], n_tiles


def _mask_tiles(mask: torch.Tensor, count: int) -> tuple[torch.Tensor, int, int]:
    """The flat mask, the count clamped to it, and the live tiles."""
    m = mask.reshape(-1)
    if m.shape[0] % _RB:
        raise ValueError(f"mask length {m.shape[0]} is not a multiple of {_RB}")
    count = max(0, min(int(count), m.shape[0]))
    return m, count, -(-count // _RB)


def _list_buffers(live: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((live,), dtype=torch.int32, device=device),
            torch.empty((1,), dtype=torch.int32, device=device))


def scope_tiles_plain(mask: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The 128-row tiles a scoped scan must read: those holding at least
    one row ``r < count`` whose ``mask`` entry (``[n]`` or ``[1, n]``,
    ``n % 128 == 0``) is > 0.

    Returns ``(tiles, n_tiles)`` on the mask's device: ``tiles``, int32 of
    length ``ceil(count / 128)``, holds their indices ascending, then -1;
    ``n_tiles`` is a ``[1]`` int32 tensor holding how many. Built from torch
    ops alone, with no host synchronisation (no ``.item()``, ``nonzero``
    or ``unique``): a flag per tile, then :func:`_listed_tiles`.
    """
    m, count, live = _mask_tiles(mask, count)
    flags = m[: live * _RB].view(live, _RB) > 0
    if count % _RB:
        flags[-1, count % _RB :] = False  # rows past the count
    return _listed_tiles(flags.any(dim=1))


def scope_tiles(mask: torch.Tensor, count: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scope_tiles_plain` in one call of ``csrc/tile_list.cu`` (a
    word of 32 tile flags per warp, then one CTA's ascending compaction)
    for a contiguous int32 mask on the card: the list stays on the device,
    so a pipelined server never waits on it."""
    if mask.device.type == "cpu":
        return scope_tiles_plain(mask, count)
    m, count, live = _mask_tiles(mask, count)
    if m.dtype != torch.int32 or not m.is_contiguous():
        raise ValueError("the listing kernel takes a contiguous int32 mask")
    words = torch.empty((-(-live // 32),), dtype=torch.int32, device=m.device)  # 32 tile flags each
    tiles, n_tiles = _list_buffers(live, m.device)
    with _on_card(m):
        _build.check(
            _build.kernels().tat_scope_tiles(
                m.data_ptr(), count, words.data_ptr(), tiles.data_ptr(), n_tiles.data_ptr(),
                _stream(m),
            ),
            "scope_tiles",
        )
    SCOPE_TILES_LAUNCHES.add()
    return tiles, n_tiles


def interval_tiles_plain(
    intervals: torch.Tensor, count: int, n_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`scope_tiles_plain` of an interval table (``[s, 2]`` int32
    half-open ``[start, stop)`` rows, unsorted or overlapping; ``(0, 0)``
    padding and other empty rows select nothing) over an ``n_rows`` store,
    without the row mask: with the count clamped to ``[0, n_rows]``, tile
    ``t`` is listed iff some non-empty row meets ``[128t, min(128t + 128,
    count))``. One ``[ceil(count/128), s]`` comparison on the table's
    device, then :func:`_listed_tiles`; no host synchronisation."""
    count = max(0, min(int(count), n_rows))
    live = -(-count // _RB)
    iv = intervals.to(torch.int64)
    lo = torch.arange(live, dtype=torch.int64, device=iv.device)[:, None] * _RB
    hi = (lo + _RB).clamp(max=count)
    meets = torch.maximum(iv[None, :, 0], lo) < torch.minimum(iv[None, :, 1], hi)
    return _listed_tiles(meets.any(dim=1))


def interval_tiles(
    intervals: torch.Tensor, count: int, n_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`interval_tiles_plain` in one launch of ``csrc/tile_list.cu``
    (one CTA flags 32 tiles at a time against the table and compacts the
    listed ones in ascending order) for a contiguous int32 table on the
    card."""
    if intervals.device.type == "cpu":
        return interval_tiles_plain(intervals, count, n_rows)
    if (
        intervals.dtype != torch.int32
        or intervals.dim() != 2
        or intervals.shape[1] != 2
        or not intervals.is_contiguous()
    ):
        raise ValueError("the listing kernel takes a contiguous [s, 2] int32 table")
    count = max(0, min(int(count), n_rows))
    tiles, n_tiles = _list_buffers(-(-count // _RB), intervals.device)
    with _on_card(intervals):
        _build.check(
            _build.kernels().tat_interval_tiles(
                intervals.data_ptr(), intervals.shape[0], count, tiles.data_ptr(),
                n_tiles.data_ptr(), _stream(intervals),
            ),
            "interval_tiles",
        )
    INTERVAL_TILES_LAUNCHES.add()
    return tiles, n_tiles


def topk_program_masked(
    emb: torch.Tensor, queries: torch.Tensor, count: int,
    rowmask: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-masked exact top-k: ``rowmask`` ([n] or [1, n] int32, > 0 =
    searchable) rides K5, with no table-size cap; k > 32 materializes."""
    k = min(k, emb.shape[0])
    if k <= _PALLAS_MAX_K:
        return _raw_to_score(*fused_topk_masked(emb, queries, count, rowmask, k))
    return _topk_materialized(cosine_scores(emb, queries, count), k, rowmask)


def topk_program_intervals(
    emb: torch.Tensor, queries: torch.Tensor, count: int,
    intervals: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interval-scoped exact top-k. ``intervals``: [s_pad, 2] int32
    half-open (start, stop) row spans, padding rows (0, 0). A table of at
    most 8 rows rides K4; a larger one expands to a row mask on the device
    (:func:`intervals_to_rowmask`) and rides K5; k > 32 materializes."""
    k = min(k, emb.shape[0])
    if k <= _PALLAS_MAX_K and intervals.shape[0] <= _PALLAS_MAX_INTERVALS:
        return _raw_to_score(*fused_topk_iv(emb, queries, count, intervals, k))
    return topk_program_masked(
        emb, queries, count, intervals_to_rowmask(emb.shape[0], intervals), k
    )


# ---------------------------------------------------------------------------
# int8 store routes: rows stored as int8 with per-row scales
# ---------------------------------------------------------------------------


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization: returns (q [n,d] i8, scales
    [n] f32); round half to even, scale 1.0 for an all-zero row."""
    rows = np.asarray(rows, dtype=np.float32)
    scales = np.abs(rows).max(axis=1) / 127.0
    scales = np.where(scales > 0, scales, 1.0).astype(np.float32)
    q = np.clip(np.round(rows / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales


# XLA compiles the JAX device quantizer's ``max / 127.0`` into a multiply by
# the f32 reciprocal, which differs from numpy's division by one ulp in a few
# percent of scales; each port twin matches its own JAX twin bit for bit.
_INV_127 = float(np.float32(1.0 / 127.0))


def quantize_rows_device(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """On-device twin of :func:`quantize_rows` (bulk ingest of
    device-resident rows), bit for bit the JAX ``quantize_rows_device``:
    the scale is ``max|row| * f32(1/127)``, not a division."""
    rows = rows.float()
    scales = rows.abs().amax(dim=1) * _INV_127
    scales = torch.where(scales > 0, scales, 1.0)
    q = torch.round(rows / scales[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scales


def cosine_scores_quantized(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """Full masked score matrix for an int8 store (predicate paths); f32
    queries, as the JAX function scores them."""
    raw = queries.float() @ emb_q.float().T
    scores = ((raw * scales[None, :] + 1.0) * 0.5).clamp(0.0, 1.0)
    valid = torch.arange(emb_q.shape[0], device=emb_q.device)[None, :] < count
    return torch.where(valid, scores, _NEG)


def subset_cosine_topk_quantized(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    ordinals: torch.Tensor, valid: torch.Tensor, k: int,
) -> tuple[torch.Tensor, ...]:
    """Top-k of an int8 store restricted to a padded ordinal subset;
    ``valid`` marks real entries, padding scores -1."""
    k = min(k, ordinals.shape[0])
    safe = ordinals.clamp(0, emb_q.shape[0] - 1).long()
    raw = queries.float() @ emb_q[safe].float().T
    scores = ((raw * scales[safe][None, :] + 1.0) * 0.5).clamp(0.0, 1.0)
    scores = torch.where(valid[None, :], scores, _NEG)
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, ordinals[pos].to(torch.int32)


def topk_program_quantized(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched exact top-k over an int8 store: K6 (bf16 queries, as the
    JAX kernel takes them) for k <= 32, else the materialized route with
    f32 queries (the JAX XLA route)."""
    k = min(k, emb_q.shape[0])
    if k <= _PALLAS_MAX_K:
        return _raw_to_score(*fused_topk_q(emb_q, scales, queries, count, k))
    return _topk_materialized(cosine_scores_quantized(emb_q, scales, queries, count), k)


# The JAX package's store-level name for the same route.
cosine_topk_quantized = topk_program_quantized


def topk_program_masked_quantized(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, rowmask: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-masked top-k over an int8 store: K7 for k <= 32."""
    k = min(k, emb_q.shape[0])
    if k <= _PALLAS_MAX_K:
        return _raw_to_score(*fused_topk_mq(emb_q, scales, queries, count, rowmask, k))
    return _topk_materialized(
        cosine_scores_quantized(emb_q, scales, queries, count), k, rowmask
    )


def topk_program_intervals_quantized(
    emb_q: torch.Tensor, scales: torch.Tensor, queries: torch.Tensor,
    count: int, intervals: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Interval-scoped top-k over an int8 store: the table always expands
    to a row mask on the device and rides K7, as in the JAX package."""
    rowmask = intervals_to_rowmask(emb_q.shape[0], intervals)
    return topk_program_masked_quantized(emb_q, scales, queries, count, rowmask, k)


def _exact2_phase2_rescore(
    emb: torch.Tensor, queries: torch.Tensor, count: int, bvals: torch.Tensor,
    *, k: int, B: int, eps: float,
):
    """Rescore the top-B buckets per query exactly; returns
    ``(vals, idx, cert)``. ``cert[i]`` holds when the B-th selected bucket
    maximum is within ``eps`` of the k-th rescored score, so no bucket
    left out can hold a better row."""
    b = queries.shape[0]
    nb = bvals.shape[1]
    top_bvals, bucket_ids = torch.topk(bvals, B, dim=1)
    safe_ids = bucket_ids.clamp(0, emb.shape[0] // _BUCKET_ROWS - 1).to(torch.int32)
    row_ids = _bucket_row_ids(safe_ids)
    raw = rescore_selected(emb, queries, safe_ids)
    raw = torch.where(row_ids < count, raw, _RAW_NEG)
    vals, pos = torch.topk(raw, k, dim=1)
    idx = row_ids.gather(1, pos)
    if B >= nb:
        cert = torch.ones((b,), dtype=torch.bool, device=emb.device)
    else:
        cert = top_bvals[:, B - 1] <= vals[:, k - 1] + eps
    s_vals, s_idx = _raw_to_score(vals, idx)
    return s_vals, s_idx, cert


def cosine_topk_exact2(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int, *,
    slack: int = _EXACT2_SLACK,
) -> tuple[torch.Tensor, ...]:
    """Two-phase exact top-k over one store: bucket maxima (K2), then an
    exact rescore (K3) of the top ``k + slack`` buckets, with certificate."""
    k = min(k, emb.shape[0])
    B = min(k + slack, emb.shape[0] // _BUCKET_ROWS)
    bvals = bucket_maxima(emb, queries, count)
    return _exact2_phase2_rescore(emb, queries, count, bvals, k=k, B=B, eps=_CERT_EPS)


def cosine_topk_exact2_hybrid(
    emb: torch.Tensor, shadow: torch.Tensor, queries: torch.Tensor, count: int,
    k: int, *, slack: int = _HYBRID_SLACK,
) -> tuple[torch.Tensor, ...]:
    """Hybrid exact top-k for f32 stores: bucket selection over the bf16
    ``shadow`` (half the bytes of the f32 scan), exact f32 rescore of the
    selected buckets, certificate at the hybrid slack."""
    k = min(k, emb.shape[0])
    B = min(k + slack, emb.shape[0] // _BUCKET_ROWS)
    bvals = bucket_maxima(shadow, queries, count)
    return _exact2_phase2_rescore(
        emb, queries, count, bvals, k=k, B=B, eps=_CERT_EPS_HYBRID
    )


def topk_program_exact2_hybrid_i8(
    emb: torch.Tensor, shadow_q: torch.Tensor, shadow_scales: torch.Tensor,
    queries: torch.Tensor, count: int, k: int, slack: int = _HYBRID_I8_SLACK,
) -> tuple[torch.Tensor, ...]:
    """int8-selection hybrid exact top-k: bucket selection over the int8
    ``shadow_q`` with per-row ``shadow_scales`` (K8, a quarter of the f32
    scan's bytes), exact f32 rescore of the selected buckets from ``emb``
    (K3), and a certificate at the int8 slack. Returns ``(vals, idx,
    cert)``. No store calls it, as in the JAX package; K8 runs at every
    store size on the card (the JAX package's 64k-row gate works around a
    Mosaic fault) and its plain version on the CPU."""
    k = min(k, emb.shape[0])
    B = min(k + slack, emb.shape[0] // _BUCKET_ROWS)
    bvals = bucket_maxima_q(shadow_q, shadow_scales, queries, count)
    return _exact2_phase2_rescore(
        emb, queries, count, bvals, k=k, B=B, eps=_CERT_EPS_HYBRID_I8
    )


# The JAX package's batched name for the same search (it jits the program).
cosine_topk_exact2_hybrid_i8 = topk_program_exact2_hybrid_i8


# Row count from which the approx route rides the bucket argmax (the
# store's exact2 crossover, ``vectorstore.EXACT2_MIN_ROWS``). One bucket
# yields one hit, so below it a store has too few buckets per hit and the
# route falls back to the exact one-phase kernel.
APPROX_BUCKET_MIN_ROWS = 131_072


def approx_uses_buckets(count: int, k: int) -> bool:
    """The approx route's rule: the bucket argmax for stores of at least
    ``APPROX_BUCKET_MIN_ROWS`` live rows and k within the fused kernel's
    range, else the exact one-phase route. The choice is counted in
    ``METRICS`` (``topk.approx_route.bucket`` / ``.exact``)."""
    bucket = count >= APPROX_BUCKET_MIN_ROWS and k <= _PALLAS_MAX_K
    METRICS.incr("topk.approx_route.bucket" if bucket else "topk.approx_route.exact")
    return bucket


def cosine_topk_bucket(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Bucketed approximate top-k: K2' (maximum and argmax row of every
    128-row bucket), an exact top-k over the ``[b, n/128]`` maxima, and the
    argmax rows of the winners. A true top-k row is missed only when two
    of the true top k share a bucket. Returns at most ``n_rows/128``
    columns (one hit per bucket); dead buckets give (-1, -1)."""
    vals, idx = bucket_argmax(emb, queries, count)
    k = min(k, vals.shape[1])
    top_vals, pos = torch.topk(vals, k, dim=1)
    return _raw_to_score(top_vals, idx.gather(1, pos))


def cosine_topk_approx(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int,
    recall_target: float = 0.95,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate batched top-k (``search_mode="approx"``): the bucketed
    route (:func:`cosine_topk_bucket`) where :func:`approx_uses_buckets`
    says so, else the exact :func:`cosine_topk` (K1, what
    ``lax.approx_max_k`` is off the TPU). ``recall_target`` is accepted for
    the JAX signature; neither route has a recall knob, so the recall is a
    property of the data."""
    del recall_target
    if approx_uses_buckets(count, k):
        return cosine_topk_bucket(emb, queries, count, k)
    return cosine_topk(emb, queries, count, k)


def subset_cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, ordinals: torch.Tensor,
    valid: torch.Tensor, k: int,
) -> tuple[torch.Tensor, ...]:
    """Top-k restricted to a padded ordinal subset; ``valid`` marks real
    entries, padding scores -1."""
    k = min(k, ordinals.shape[0])
    rows = emb[ordinals.clamp(0, emb.shape[0] - 1).long()]
    raw = queries.to(emb.dtype).float() @ rows.float().T
    scores = torch.where(valid[None, :], ((raw + 1.0) * 0.5).clamp(0.0, 1.0), _NEG)
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, ordinals[pos].to(torch.int32)


def topk_many(
    emb: torch.Tensor, aux: torch.Tensor | None, qs: torch.Tensor, count: int,
    *, k: int, mode: str, slack: int | None = None, recall_target: float = 0.95,
) -> tuple[torch.Tensor, ...]:
    """R query batches ``[R, b_pad, d_pad]`` in one launch per kernel:
    queries are independent, so the batches are stacked into one
    ``[R*b_pad, d_pad]`` block and the outputs reshaped back to
    ``[R, b_pad, k]`` (plus ``[R, b_pad]`` certificates for exact2).
    ``aux`` is the bf16 shadow for ``exact2h`` and the per-row scales for
    ``quantized`` (an int8 store); ``approx`` takes none."""
    r_n, b_pad, d_pad = qs.shape
    flat = qs.reshape(r_n * b_pad, d_pad)
    if mode == "exact1":
        out = cosine_topk(emb, flat, count, k)
    elif mode == "exact2":
        out = cosine_topk_exact2(
            emb, flat, count, k, slack=_EXACT2_SLACK if slack is None else slack
        )
    elif mode == "exact2h":
        out = cosine_topk_exact2_hybrid(
            emb, aux, flat, count, k, slack=_HYBRID_SLACK if slack is None else slack
        )
    elif mode == "quantized":
        out = topk_program_quantized(emb, aux, flat, count, k)
    elif mode == "approx":
        out = cosine_topk_approx(emb, flat, count, k, recall_target=recall_target)
    else:
        raise ValueError(f"unknown mode: {mode}")
    return tuple(t.reshape(r_n, b_pad, *t.shape[1:]) for t in out)
