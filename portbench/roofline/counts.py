"""Operations and bytes of each kernel, as functions of its shape.

The least time a launch could take is the larger of its operations over
the chip's peak rate for its arithmetic and its bytes over the memory's
peak bandwidth (``peaks.json``). Each input byte counts once, whatever the
kernel reads again, and only rows in scope count: a scoped scan's bound
is that of its in-scope rows, as ``PERF.md``'s kernel table counts it.
Where a count cannot be known from the shapes a call was given, the
smaller one is taken, so that a share of the bound is never overstated.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

_HERE = os.path.dirname(os.path.abspath(__file__))
F32 = 4
BF16 = 2
INT8 = 1
ROW = 128  # rows per bucket and per tile


def peaks() -> dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


@dataclass(frozen=True)
class Work:
    ops: float  # multiply-adds count two
    bytes: float
    rate: str  # the key of peaks.json that bounds the operations

    def bound_s(self, peak: dict) -> float:
        return max(self.ops / peak[self.rate], self.bytes / peak["hbm_bytes_per_s"])

    def bound_side(self, peak: dict) -> str:
        return "ops" if self.ops / peak[self.rate] >= self.bytes / peak["hbm_bytes_per_s"] else "bytes"


def scan_f32(b: int, rows: int, dim: int, k: int = 10, mask: bool = False) -> Work:
    """K1 (``rows`` = the live count), K4 and K5 (``rows`` = the rows in
    scope) over an f32 store: every query against every row on the FFMA
    units; the rows, the queries, a row mask's entries for the rows in
    scope, and the ``[b, k]`` winners."""
    return Work(
        ops=2.0 * b * rows * dim,
        bytes=rows * dim * F32 + b * dim * F32 + (rows * 4 if mask else 0) + b * k * 8,
        rate="fp32_flops",
    )


def bucket_maxima_bf16(rows: int, dim: int, b: int = 1) -> Work:
    """K2 over a bf16 shadow of ``rows`` live rows: the shadow, the f32
    queries and the ``[b, rows / 128]`` f32 maxima, on the bf16 tensor
    cores. The batch of a launch inside a coalesced dispatch is not known
    from outside, so callers pass the smallest, ``b = 1``."""
    buckets = -(-rows // ROW)
    return Work(
        ops=2.0 * b * rows * dim,
        bytes=rows * dim * BF16 + b * dim * F32 + b * buckets * F32,
        rate="bf16_flops",
    )


def scan_int8(b: int, rows: int, dim: int, k: int = 10, mask: bool = False) -> Work:
    """K6 (``rows`` = the live count) and K7 (``rows`` = the rows in scope,
    ``mask`` True) over an int8 store: every query against every row on
    the bf16 tensor cores, counted for the real batch and not the padded
    query block; the codes, the f32 scales, the bf16 queries, a row mask's
    entries for the rows in scope, and the ``[b, k]`` winners."""
    return Work(
        ops=2.0 * b * rows * dim,
        bytes=rows * dim * INT8 + rows * F32 + b * dim * BF16 + (rows * 4 if mask else 0) + b * k * 8,
        rate="bf16_flops",
    )
