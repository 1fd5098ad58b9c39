"""int4 selection shadow: packed-nibble bucket maxima + exact rescore.

A per-row-scaled int4 shadow of a 1M x 384 store holds 256 MB where the
bf16 shadow holds 768 MB. The layout is the JAX package's
(``typeagent_tpu/ops/int4.py``), so a shadow quantized by either package
searches the same in both:

  * **Column-split packing**: byte ``packed[i, c]`` holds column ``c`` of
    row ``i`` (low nibble) and column ``c + ceil(d/2)`` (high nibble),
    codes in [-7, 7]; each half is zero-padded to ``dh = _half_pad(d)``
    bytes (a multiple of 128). Packed rows are original rows, so the
    128-row buckets and the whole exact2 phase 2 carry over unchanged.
  * K9 ``bucket_maxima_q4`` (``csrc/bucket_maxima.cu``, the int4 instance
    of K2's tensor-core template) unpacks the sign-extended nibbles into
    bf16 while staging each strip and takes the JAX kernel's two
    half-width dots against the split query halves
    (:func:`split_pad_queries`) in one product; then the per-row scale,
    the watermark mask and the 128-row bucket maxima. Given the rows'
    width ``d``, both halves' dots cover only the ``live_depth(d)`` packed
    bytes that hold codes: the padding past them meets query columns that
    :func:`split_pad_queries` zeroes, so the maxima are the whole width's.
    Its plain version ``bucket_maxima_q4_plain`` sits beside it.

The selection feeds the exact2 phase 2 (:mod:`.topk`): the top-B buckets
per query are rescored exactly from the full-precision buffer (K3), so the
returned scores are the exact engines'. NOTE: the i4 certificate is
HEURISTIC, not a proven bound: it compares int4-approximate bucket maxima,
and ``_CERT_EPS_I4`` covers the *measured* p100 quantization error, so a
true bucket maximum can in principle still exceed the approximation. Treat
a True certificate as quality telemetry; callers that need a sound
exactness certificate use the bf16-shadow hybrid or the exact engines.
No store calls this search, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import topk
from .topk import _BUCKET_ROWS

__all__ = [
    "quantize_rows_int4_device",
    "quantize_rows_int4",
    "split_pad_queries",
    "live_depth",
    "adopt_int4_shadow",
    "bucket_maxima_q4",
    "bucket_maxima_q4_plain",
    "topk_program_exact2_i4",
    "cosine_topk_exact2_i4",
]

# int4-selection certificate slack: |deq_int4_cos - f32_cos|. Per element
# the code error is <= scale/2 with scale = max|row|/7; the bound is the
# measured p100 over real corpora (~3e-2), so the certificate is telemetry
# at this eps, not an exactness proof.
_CERT_EPS_I4 = 5e-2
_I4_SLACK = 14
_K_LANES = 128
_STRIP_BYTES = 32  # packed bytes of a row in one K9 strip

# XLA compiles the JAX device quantizer's ``max / 7.0`` into a multiply by
# the f32 reciprocal, which differs from numpy's division by one ulp in
# about half the rows; each port twin matches its own JAX twin bit for bit.
_INV_7 = float(np.float32(1.0 / 7.0))


def _half_pad(d: int) -> int:
    half = (d + 1) // 2
    return -(-half // _K_LANES) * _K_LANES


def live_depth(d: int) -> int:
    """The packed bytes of a row of width ``d`` that K9's product walks:
    ``ceil(d/2)`` rounded up to a 32-byte strip, at most ``_half_pad(d)``
    (192 of 256 at d = 384, 64 of 128 at d = 100). Past them every byte
    meets query columns that :func:`split_pad_queries` zeroes in both
    halves."""
    return -(-((d + 1) // 2) // _STRIP_BYTES) * _STRIP_BYTES


def _pack_codes(codes: torch.Tensor, dh: int) -> torch.Tensor:
    """[n, d] int8 codes -> [n, dh] packed bytes (lo = col c, hi = col
    c + ceil(d/2); hi columns past d and lane padding are zero)."""
    n, d = codes.shape
    half = (d + 1) // 2
    lo = torch.zeros((n, dh), dtype=torch.int32, device=codes.device)
    hi = torch.zeros((n, dh), dtype=torch.int32, device=codes.device)
    lo[:, :half] = codes[:, :half]
    hi[:, : d - half] = codes[:, half:]
    return (((hi & 0xF) << 4) | (lo & 0xF)).to(torch.uint8).view(torch.int8)


def quantize_rows_int4_device(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int4 quantization, column-split packed, on the
    rows' device: ``[n, d]`` -> ``(packed [n, _half_pad(d)] int8, scales
    [n] f32)``. Bit for bit the JAX ``quantize_rows_int4_device``: the
    scale is ``max|row| * f32(1/7)`` (1.0 for an all-zero row), codes
    round half to even and clip to [-7, 7]."""
    rows = rows.float()
    scales = rows.abs().amax(dim=1) * _INV_7
    scales = torch.where(scales > 0, scales, 1.0)
    codes = torch.round(rows / scales[:, None]).clamp(-7, 7).to(torch.int8)
    return _pack_codes(codes, _half_pad(rows.shape[1])), scales


def quantize_rows_int4(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`quantize_rows_int4_device` (numpy, the scale a
    division ``max / 7``), bit for bit the JAX ``quantize_rows_int4``."""
    rows = np.asarray(rows, dtype=np.float32)
    n, d = rows.shape
    scales = np.abs(rows).max(axis=1) / 7.0
    scales = np.where(scales > 0, scales, 1.0).astype(np.float32)
    codes = np.clip(np.round(rows / scales[:, None]), -7, 7).astype(np.int8)
    half = (d + 1) // 2
    dh = _half_pad(d)
    lo = np.zeros((n, dh), np.int8)
    hi = np.zeros((n, dh), np.int8)
    lo[:, :half] = codes[:, :half]
    hi[:, : d - half] = codes[:, half:]
    return ((hi << 4) | (lo & 0xF)).astype(np.int8), scales


def split_pad_queries(queries: torch.Tensor, d: int) -> torch.Tensor:
    """[b, d] queries -> [b, 2*_half_pad(d)] bf16 split halves, zero-padded
    so that each half lines up with its nibble stream."""
    b = queries.shape[0]
    half = (d + 1) // 2
    dh = _half_pad(d)
    q = queries.to(torch.bfloat16)
    out = torch.zeros((b, 2 * dh), dtype=torch.bfloat16, device=queries.device)
    out[:, :half] = q[:, :half]
    out[:, dh : dh + (d - half)] = q[:, half:]
    return out


def adopt_int4_shadow(
    packed: np.ndarray, scales: np.ndarray, device: torch.device | str = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """A JAX int4 shadow carried across: the numpy of a JAX
    ``quantize_rows_int4_device`` (or host) result ``(packed [n, dh] int8,
    scales [n] f32)`` as the port's tensors on ``device``, the bytes kept
    as given (quantizing dequantized rows again could move codes)."""
    packed = np.array(packed, dtype=np.int8)
    scales = np.array(scales, dtype=np.float32)
    if packed.ndim != 2 or packed.shape[1] % _K_LANES:
        raise ValueError(f"packed shadow of shape {packed.shape}: need [n, dh] with dh % 128 == 0")
    if scales.shape != (packed.shape[0],):
        raise ValueError(f"scales of shape {scales.shape} for {packed.shape[0]} rows")
    return torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device)


def _nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[m, w] packed bytes -> the (lo, hi) [m, w] f32 codes, with the JAX
    kernel's int32 shifts on the sign-extended bytes."""
    p = packed.to(torch.int32)
    return ((p << 28) >> 28).float(), (p >> 4).float()


def _unpack(packed: torch.Tensor) -> torch.Tensor:
    """[m, dh] packed bytes -> [m, 2*dh] f32 codes ``[lo | hi]``."""
    return torch.cat(_nibbles(packed), dim=1)


def _live_of(packed: torch.Tensor, d: int | None) -> int:
    """The packed bytes K9 walks: the whole width for ``d=None``, else
    :func:`live_depth` of rows of width ``d`` (which must pack to this
    shadow's width)."""
    dh = packed.shape[1]
    if d is None:
        return dh
    if _half_pad(d) != dh:
        raise ValueError(f"packed shadow width {dh} is not _half_pad({d}) = {_half_pad(d)}")
    return live_depth(d)


def bucket_maxima_q4_plain(
    packed: torch.Tensor, scales: torch.Tensor, queries_split: torch.Tensor, count: int,
    *, d: int | None = None,
) -> torch.Tensor:
    """Plain version of K9: ``[b, n_rows/128]`` f32 maximum per 128-row
    bucket of ``(q_lo . lo + q_hi . hi) * scale`` (the bf16 split query
    halves against the exactly upcast codes, f32 sums), -3.0 for rows at
    or past ``count``. Each half's dot covers the first
    ``live_depth(d)`` packed bytes, as the kernel's does (``d=None``: the
    whole width, padding included)."""
    dh = packed.shape[1]
    live = _live_of(packed, d)
    q = queries_split.float()
    q_lo, q_hi = q[:, :live], q[:, dh : dh + live]

    def raw_of(start, stop):
        lo, hi = _nibbles(packed[start:stop, :live])
        raw = (q_lo @ lo.T + q_hi @ hi.T) * scales[start:stop][None, :]
        ids = torch.arange(start, stop, device=packed.device)
        return raw.masked_fill(ids[None, :] >= count, topk._RAW_NEG)

    return topk._bucket_maxima_chunked(raw_of, packed.shape[0], q.shape[0], packed.device)


def _check_q4_operands(
    packed: torch.Tensor, scales: torch.Tensor, queries_split: torch.Tensor
) -> None:
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for a shadow on {packed.device}")
    if packed.dtype != torch.int8 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("packed shadow must be a contiguous [n_rows, dh] int8 tensor")
    n_rows, dh = packed.shape
    if n_rows % _BUCKET_ROWS or n_rows >= 2**31:
        raise ValueError(f"unsupported shadow shape {tuple(packed.shape)}")
    if (
        scales.device != packed.device
        or scales.dtype != torch.float32
        or tuple(scales.shape) != (n_rows,)
        or not scales.is_contiguous()
    ):
        raise ValueError("scales must be a contiguous [n_rows] float32 tensor on the shadow's device")
    if (
        queries_split.device != packed.device
        or queries_split.dtype != torch.bfloat16
        or queries_split.dim() != 2
        or queries_split.shape[1] != 2 * dh
        or not queries_split.is_contiguous()
    ):
        raise ValueError(
            f"queries_split must be a contiguous [b, {2 * dh}] bfloat16 tensor on the "
            "shadow's device (split_pad_queries)"
        )


def bucket_maxima_q4(
    packed: torch.Tensor, scales: torch.Tensor, queries_split: torch.Tensor, count: int,
    *, d: int | None = None,
) -> torch.Tensor:
    """K9 (``csrc/bucket_maxima.cu``), as :func:`bucket_maxima_q4_plain`;
    ``queries_split`` comes from :func:`split_pad_queries` (of width
    ``d``, when given: then the product skips the padding)."""
    if packed.device.type == "cpu":
        return bucket_maxima_q4_plain(packed, scales, queries_split, count, d=d)
    _check_q4_operands(packed, scales, queries_split)
    out = topk._launch_bucket_maxima_q(1, packed, scales, queries_split, count, _live_of(packed, d))
    topk.BUCKET_MAXIMA_Q4_LAUNCHES.add()
    return out


def topk_program_exact2_i4(
    emb: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
    queries: torch.Tensor, count: int, k: int, slack: int = _I4_SLACK,
):
    """int4-selection two-phase top-k: bucket selection over the packed
    nibble shadow (K9, a third of the bf16 shadow's bytes), exact rescore
    of the selected buckets from ``emb`` (K3; the store's bf16 or f32
    buffer). Returns ``(vals, idx, cert)`` with final scores identical to
    the exact engines'; the certificate is heuristic (module docstring).

    ``d = emb.shape[1]`` splits the queries, so the shadow must have been
    quantized from rows of ``emb``'s width (``packed.shape[1] ==
    _half_pad(emb.shape[1])``), and ``queries`` are ``[b, d]``. K9 runs at
    every store size on the card (the JAX package's 64k-row gate works
    around a Mosaic fault) and its plain version on the CPU."""
    k = min(k, emb.shape[0])
    B = min(k + slack, emb.shape[0] // _BUCKET_ROWS)
    d = emb.shape[1]
    if packed.shape[1] != _half_pad(d):
        raise ValueError(
            f"packed shadow width {packed.shape[1]} is not _half_pad({d}) = {_half_pad(d)}"
        )
    bvals = bucket_maxima_q4(packed, scales, split_pad_queries(queries, d), count, d=d)
    return topk._exact2_phase2_rescore(
        emb, queries, count, bvals, k=k, B=B, eps=_CERT_EPS_I4
    )


# The JAX package's batched name for the same search (it jits the program).
cosine_topk_exact2_i4 = topk_program_exact2_i4
