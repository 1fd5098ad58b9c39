"""Exact cosine top-k over a padded embedding store.

Public scores are ``clip((cos+1)/2, 0, 1)``; rows at or past the ``count``
watermark never surface. Three CUDA kernels, written for Hopper
(``csrc/``), carry the exact routes:

  * K1 ``fused_topk``: one-phase top-k (k <= 32) that never writes the
    ``[b, n]`` score matrix to device memory;
  * K2 ``bucket_maxima``: maximum raw cosine of each 128-row bucket, the
    selection phase of the two-phase ("exact2") search;
  * K3 ``rescore_selected``: exact f32 scores of each query's selected
    buckets, the second phase, which ends in a per-query certificate.

Each kernel has a plain PyTorch version of the same function beside it
(``topk_plain``, ``bucket_maxima_plain``, ``rescore_selected_plain``). A
wrapper runs the plain version for a tensor on the CPU and launches its
kernel for a CUDA tensor; there is no other fallback. Each wrapper counts
its launches, so a run can show that the serving path went through it.
"""

from __future__ import annotations

import math
import threading

import torch

from . import _build

__all__ = [
    "cosine_topk",
    "cosine_topk_exact2",
    "cosine_topk_exact2_hybrid",
    "cosine_scores",
    "subset_cosine_topk",
    "topk_many",
    "fused_topk",
    "bucket_maxima",
    "rescore_selected",
    "topk_plain",
    "bucket_maxima_plain",
    "rescore_selected_plain",
]

# Largest k the fused kernel takes (the warp-held list has 32 lanes); a
# larger k materializes the scores, as the JAX package does past its cap.
_PALLAS_MAX_K = 32
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
_EXACT2_SLACK = 6
# Rows per chunk of the plain bucket maxima (bounds its score temporary).
_PLAIN_CHUNK = 1 << 16
# Kernel tile shape (csrc/tile.cuh).
_QB = 32
_RB = 128


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
BUCKET_MAXIMA_LAUNCHES = LaunchCounter("bucket_maxima")
RESCORE_LAUNCHES = LaunchCounter("rescore")
# Calls of the k > 32 route, which materializes scores (no kernel).
MATERIALIZED_CALLS = LaunchCounter("materialized_topk")
COUNTERS = (TOPK_LAUNCHES, BUCKET_MAXIMA_LAUNCHES, RESCORE_LAUNCHES, MATERIALIZED_CALLS)


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


def _check_cuda_operands(emb: torch.Tensor, queries: torch.Tensor) -> int:
    """Validate a kernel launch's store and queries; return the dtype code."""
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
    return _store_code(emb)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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


# ---------------------------------------------------------------------------
# K1: one-phase fused top-k
# ---------------------------------------------------------------------------


def topk_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: raw top-k ``([b, k] f32, [b, k] i32)``, values
    descending, ties to the lowest row, unfilled slots ``(-3.0, -1)``."""
    raw = _raw_scores(emb, queries, count)
    b = raw.shape[0]
    theta = torch.topk(raw, k, dim=1).values[:, k - 1 : k]
    above = raw > theta
    tied = raw == theta
    need = k - above.sum(dim=1, keepdim=True, dtype=torch.int32)
    take = above | (tied & (tied.cumsum(dim=1, dtype=torch.int32) <= need))
    idx = take.nonzero()[:, 1].reshape(b, k)  # ascending rows per query
    vals = raw.gather(1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    vals = vals.gather(1, order)
    idx = idx.gather(1, order)
    return vals, torch.where(vals > -2.0, idx, -1).to(torch.int32)


def fused_topk(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (``csrc/topk.cu``): raw top-k of ``queries`` over rows
    ``[0, count)`` of ``emb``, as :func:`topk_plain` defines it."""
    if emb.device.type == "cpu":
        return topk_plain(emb, queries, count, k)
    code = _check_cuda_operands(emb, queries)
    if not 1 <= k <= _PALLAS_MAX_K:
        raise ValueError(f"fused top-k takes 1 <= k <= {_PALLAS_MAX_K}, got {k}")
    n_rows, d_pad = emb.shape
    b = queries.shape[0]
    count = max(0, min(int(count), n_rows))
    n_tiles = max(1, math.ceil(count / _RB))
    n_qb = math.ceil(b / _QB)
    # About four CTAs per SM: enough row splits to fill the card.
    sms = torch.cuda.get_device_properties(emb.device).multi_processor_count
    splits = min(n_tiles, max(1, math.ceil(4 * sms / n_qb)))
    tiles_per_split = math.ceil(n_tiles / splits)
    splits = math.ceil(n_tiles / tiles_per_split)
    dev = emb.device
    cand_v = torch.empty((b, splits, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, splits, k), dtype=torch.int32, device=dev)
    out_v = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.kernels()
    stream = _stream(emb)
    _build.check(
        lib.tat_topk_scan(
            emb.data_ptr(), code, queries.data_ptr(), n_rows, d_pad, b, count,
            k, tiles_per_split * _RB, splits, cand_v.data_ptr(),
            cand_i.data_ptr(), stream,
        ),
        "topk scan",
    )
    _build.check(
        lib.tat_topk_merge(
            cand_v.data_ptr(), cand_i.data_ptr(), b, splits, k,
            out_v.data_ptr(), out_i.data_ptr(), stream,
        ),
        "topk merge",
    )
    TOPK_LAUNCHES.add()
    return out_v, out_i


# ---------------------------------------------------------------------------
# K2: bucket maxima
# ---------------------------------------------------------------------------


def bucket_maxima_plain(
    emb: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """Plain version of K2: ``[b, n_rows/128]`` f32 maximum raw cosine per
    128-row bucket, -3.0 where every row is at or past ``count``."""
    n_rows = emb.shape[0]
    b = queries.shape[0]
    out = torch.empty((b, n_rows // _BUCKET_ROWS), dtype=torch.float32, device=emb.device)
    for start in range(0, n_rows, _PLAIN_CHUNK):
        stop = min(start + _PLAIN_CHUNK, n_rows)
        raw = _raw_scores(emb, queries, count, start, stop)
        out[:, start // _BUCKET_ROWS : stop // _BUCKET_ROWS] = raw.view(
            b, -1, _BUCKET_ROWS
        ).amax(dim=2)
    return out


def bucket_maxima(
    emb: torch.Tensor, queries: torch.Tensor, count: int
) -> torch.Tensor:
    """K2 (``csrc/bucket_maxima.cu``), as :func:`bucket_maxima_plain`."""
    if emb.device.type == "cpu":
        return bucket_maxima_plain(emb, queries, count)
    code = _check_cuda_operands(emb, queries)
    n_rows, d_pad = emb.shape
    b = queries.shape[0]
    q_arg = queries
    if code == 1:
        # The tensor-core path takes bf16 queries (cast once here, as the
        # JAX kernel casts queries to the store dtype) and stages rows and
        # queries in 64-deep, 16-byte-aligned strips.
        q_arg = queries.to(torch.bfloat16)
        if d_pad % 64 or emb.data_ptr() % 16:
            raise ValueError("bf16 bucket maxima needs d_pad % 64 == 0 and 16-byte alignment")
    out = torch.empty(
        (b, n_rows // _BUCKET_ROWS), dtype=torch.float32, device=emb.device
    )
    _build.check(
        _build.kernels().tat_bucket_maxima(
            emb.data_ptr(), code, q_arg.data_ptr(), n_rows, d_pad, b,
            max(0, min(int(count), n_rows)), out.data_ptr(), _stream(emb),
        ),
        "bucket maxima",
    )
    BUCKET_MAXIMA_LAUNCHES.add()
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


def _topk_materialized(emb, queries, count: int, k: int):
    """k > 32: scores materialized, then ``torch.topk`` (the JAX package's
    own non-Pallas route). Masked slots score -1."""
    MATERIALIZED_CALLS.add()
    vals, idx = torch.topk(cosine_scores(emb, queries, count), k, dim=1)
    return vals, idx.to(torch.int32)


def cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, count: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched exact top-k: ``(vals [b, k], idx [b, k])``, scores in [0, 1]
    descending; invalid slots have ``vals < 0`` (callers filter on it)."""
    k = min(k, emb.shape[0])
    if k <= _PALLAS_MAX_K:
        return _raw_to_score(*fused_topk(emb, queries, count, k))
    return _topk_materialized(emb, queries, count, k)


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
):
    """Two-phase exact top-k over one store: bucket maxima (K2), then an
    exact rescore (K3) of the top ``k + slack`` buckets, with certificate."""
    k = min(k, emb.shape[0])
    B = min(k + slack, emb.shape[0] // _BUCKET_ROWS)
    bvals = bucket_maxima(emb, queries, count)
    return _exact2_phase2_rescore(emb, queries, count, bvals, k=k, B=B, eps=_CERT_EPS)


def cosine_topk_exact2_hybrid(
    emb: torch.Tensor, shadow: torch.Tensor, queries: torch.Tensor, count: int,
    k: int, *, slack: int = _HYBRID_SLACK,
):
    """Hybrid exact top-k for f32 stores: bucket selection over the bf16
    ``shadow`` (half the bytes of the f32 scan), exact f32 rescore of the
    selected buckets, certificate at the hybrid slack."""
    k = min(k, emb.shape[0])
    B = min(k + slack, emb.shape[0] // _BUCKET_ROWS)
    bvals = bucket_maxima(shadow, queries, count)
    return _exact2_phase2_rescore(
        emb, queries, count, bvals, k=k, B=B, eps=_CERT_EPS_HYBRID
    )


def subset_cosine_topk(
    emb: torch.Tensor, queries: torch.Tensor, ordinals: torch.Tensor,
    valid: torch.Tensor, k: int,
):
    """Top-k restricted to a padded ordinal subset; ``valid`` marks real
    entries, padding scores -1."""
    k = min(k, ordinals.shape[0])
    rows = emb[ordinals.clamp(0, emb.shape[0] - 1).long()]
    raw = queries.to(emb.dtype).float() @ rows.float().T
    scores = torch.where(valid[None, :], ((raw + 1.0) * 0.5).clamp(0.0, 1.0), _NEG)
    vals, pos = torch.topk(scores, k, dim=1)
    return vals, ordinals[pos].to(torch.int32)


# ROADMAP.md Queue 1 items that port the other engine modes.
_MODE_ITEMS = {"quantized": 7, "approx": 8}


def topk_many(
    emb: torch.Tensor, aux: torch.Tensor | None, qs: torch.Tensor, count: int,
    *, k: int, mode: str, slack: int | None = None,
):
    """R query batches ``[R, b_pad, d_pad]`` in one launch per kernel:
    queries are independent, so the batches are stacked into one
    ``[R*b_pad, d_pad]`` block and the outputs reshaped back to
    ``[R, b_pad, k]`` (plus ``[R, b_pad]`` certificates for exact2)."""
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
    elif mode in _MODE_ITEMS:
        raise NotImplementedError(
            f"engine mode {mode!r} is not ported yet "
            f"(ROADMAP.md Queue 1 item {_MODE_ITEMS[mode]})"
        )
    else:
        raise ValueError(f"unknown mode: {mode}")
    return tuple(t.reshape(r_n, b_pad, *t.shape[1:]) for t in out)
