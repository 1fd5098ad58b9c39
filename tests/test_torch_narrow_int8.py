"""The narrow int8 scans' arithmetic and geometry, on the CPU.

K6 and K7 take ``csrc/topk_narrow.cu`` up to 16 queries where its plan
fits the width (``narrow_plan``) and the 64-query loop of ``csrc/topk.cu``
otherwise (``ops/topk.py`` ``int8_query_block``). The
narrow kernel cannot run here, so these tests hold what it rests on:

  * the kernel's plan by width, the route's query block and its grid
    (``int8_scan_geometry``) at the benchmark's shapes, as pure functions;
  * a bit-level numpy twin of the kernel's code conversion (two LOP3 and
    one bf16x2 subtraction per pair of codes), exact for all 256 codes;
  * a numpy twin of one warp's work on one slab: the lanes' shared-memory
    words, the converted A fragments, the B fragments read from
    ``narrow_query_operand``, the ``mma.sync`` m16n8k16 products, and the
    shuffles that hand slab row r to lane r for the fold, held to the
    plain product of the codes and the bf16 queries.
"""

import math

import numpy as np
import pytest
import torch

from typeagent_tpu_torch.ops import topk

RB = 128


@pytest.mark.parametrize("b,want", [(1, 8), (3, 8), (8, 8), (9, 16), (16, 16), (17, 64), (64, 64), (257, 64)])
def test_int8_query_block_follows_the_batch(b, want):
    assert topk.int8_query_block(b, 768) == want


# The plans the kernel's tat_topk_narrow_plan gave on the card (PERF.md),
# and the edges past which none fits.
@pytest.mark.parametrize("width,query_block,want", [
    (384, 8, (8, 4)), (768, 8, (8, 2)), (768, 16, (8, 2)), (832, 8, (8, 2)), (832, 16, (4, 3)),
    (1024, 8, (4, 3)), (1024, 16, (4, 3)), (1536, 8, (4, 2)), (1536, 16, (2, 3)),
    (2048, 8, (2, 3)), (2048, 16, (2, 2)), (3072, 8, (2, 1)), (3072, 16, (2, 1)),
    (4096, 8, (2, 1)), (4096, 16, None), (3584, 16, (2, 1)), (3648, 16, None),
    (4800, 8, (2, 1)), (4864, 8, None), (768, 32, None), (800, 8, None),
])
def test_narrow_plan_by_width(width, query_block, want):
    assert topk.narrow_plan(width, query_block) == want


def test_narrow_plan_fits_the_shared_memory():
    """Every plan's queries and ring fit an H100 block's shared memory, and
    the widest plans are those the route takes."""
    for width in range(64, 8193, 64):
        for query_block in (8, 16):
            plan = topk.narrow_plan(width, query_block)
            if plan is None:
                continue
            warps, stages = plan
            used = 1024 + 2 * query_block * width + warps * stages * (16 * width + 64)
            assert used <= 232448 and stages >= 1 and warps in (2, 4, 8)
    assert max(w for w in range(64, 8193, 64) if topk.narrow_plan(w, 8)) == 4800
    assert max(w for w in range(64, 8193, 64) if topk.narrow_plan(w, 16)) == 3584


@pytest.mark.parametrize("b,d,want", [
    (8, 3072, 8), (16, 3072, 16), (8, 4096, 8), (16, 4096, 64), (9, 3584, 16), (9, 3648, 64),
    (1, 4800, 8), (1, 4864, 64), (17, 1024, 64), (3, 1536, 8),
])
def test_int8_query_block_follows_the_width(b, d, want):
    """The narrow kernel wherever its plan fits, else the 64-query loop,
    which streams its query strips at any width."""
    assert topk.int8_query_block(b, d) == want


def test_int8_scan_geometry_at_4096_wide_rows():
    """7,813 live tiles: b = 8 on the narrow kernel (one CTA per SM), b =
    16 on the loop (two)."""
    assert topk.int8_scan_geometry(1_000_000, 1_000_064, 8, 132, 4096) == (60 * RB, 131)
    assert topk.int8_scan_geometry(1_000_000, 1_000_064, 16, 132, 4096) == (30 * RB, 261)


def _covers_once(rows_per_split, splits, count):
    """Split i walks live tiles [i*per, (i+1)*per), as the kernels do."""
    per, live = rows_per_split // RB, math.ceil(count / RB)
    tiles = [t for i in range(splits) for t in range(i * per, min((i + 1) * per, live))]
    return tiles == list(range(live))


@pytest.mark.parametrize("b,per_tiles,splits", [
    # The int8 cells: one caller's query padded to 8, one CTA per SM.
    (8, 5919, 132), (1, 5919, 132), (16, 5919, 132),
    # Above 16 queries: the 64-query loop's two CTAs per SM, as before.
    (17, 2960, 264), (64, 2960, 264),
])
def test_int8_scan_geometry_at_the_cells_shapes(b, per_tiles, splits):
    count, n_rows = 100_000_000, 100_000_768  # the corpus's count and capacity
    rows_per_split, n = topk.int8_scan_geometry(count, n_rows, b, 132, 768)
    assert (rows_per_split // RB, n) == (per_tiles, splits)
    assert rows_per_split % RB == 0 and (n - 1) * rows_per_split < count
    assert _covers_once(rows_per_split, n, count)
    qb = topk.int8_query_block(b, 768)
    assert (rows_per_split, n) == topk.scan_geometry(
        count, n_rows, b, 132, qb, 1 if qb < 64 else topk._CTAS_PER_SM)


def test_int8_scan_geometry_at_30m_rows():
    """chip_smoke's narrow phase: 30,000,000 rows, b = 8, 132 SMs."""
    rows_per_split, splits = topk.int8_scan_geometry(30_000_000, 30_000_000, 8, 132, 768)
    assert (rows_per_split // RB, splits) == (1776, 132)
    assert _covers_once(rows_per_split, splits, 30_000_000)


# ---------------------------------------------------------------------------
# The code conversion, bit for bit
# ---------------------------------------------------------------------------


def _bf16_bits_to_f64(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _f64_to_bf16_bits_exact(x: np.ndarray) -> np.ndarray:
    """bf16 bits of values that bf16 holds exactly (asserted)."""
    f = x.astype(np.float32)
    assert np.array_equal(f.astype(np.float64), x)
    bits = f.view(np.uint32)
    assert not (bits & 0xFFFF).any(), "not exact in bf16"
    return (bits >> 16).astype(np.uint16)


def codes02_bf16(x: np.ndarray) -> np.ndarray:
    """The kernel's ``codes02_bf16``: the int8 codes in bytes 0 and 2 of
    each uint32 of ``x`` as bf16 pairs (byte 0 in the low half). The
    subtraction's exact result is representable, so any correctly rounded
    bf16 subtraction gives these bits."""
    x = x.astype(np.uint32)
    low7 = (x & np.uint32(0x007F007F)) | np.uint32(0x43004300)
    sign = (x & np.uint32(0x00800080)) | np.uint32(0x43004300)
    out = np.zeros_like(x)
    for half in (0, 16):
        a = _bf16_bits_to_f64((low7 >> half) & 0xFFFF)
        s = _bf16_bits_to_f64((sign >> half) & 0xFFFF)
        out |= _f64_to_bf16_bits_exact(a - s).astype(np.uint32) << half
    return out


def _pack(codes: np.ndarray) -> np.ndarray:
    """[..., 4] int8 -> uint32 words, code j in byte j (little-endian)."""
    return np.ascontiguousarray(codes.astype(np.int8)).view(np.uint32)[..., 0]


def test_conversion_is_exact_for_every_code():
    c = np.arange(-128, 128, dtype=np.int64)
    other = np.roll(c, 77)
    words = _pack(np.stack([c, other, other[::-1], c[::-1]], axis=1))
    even, odd = codes02_bf16(words), codes02_bf16(words >> np.uint32(8))
    want = lambda v: _f64_to_bf16_bits_exact(v.astype(np.float64)).astype(np.uint32)  # noqa: E731
    assert np.array_equal(even & 0xFFFF, want(c))                  # byte 0
    assert np.array_equal(even >> 16, want(other[::-1]))           # byte 2
    assert np.array_equal(odd & 0xFFFF, want(other))               # byte 1
    assert np.array_equal(odd >> 16, want(c[::-1]))                # byte 3
    # And as values: every code comes back as itself.
    assert np.array_equal(_bf16_bits_to_f64(even & 0xFFFF), c.astype(np.float64))


def test_conversion_constants_are_the_documented_values():
    # 0x4300 is 128.0 with 7 mantissa bits of units; 0x4380 is 256.0.
    assert _bf16_bits_to_f64(np.array([0x4300, 0x4380, 0x437F])).tolist() == [128.0, 256.0, 255.0]


# ---------------------------------------------------------------------------
# One warp's slab, lane by lane
# ---------------------------------------------------------------------------

MT = 16


def _physical_rows(gr: int) -> tuple[int, int]:
    """Slab rows of m-tile rows gr and gr + 8 (the kernel's p0, p1)."""
    p0 = (gr & 1) * 8 + (gr >> 1)
    return p0, p0 + 4


def _warp_scores(codes: np.ndarray, qp: np.ndarray, nt: int) -> np.ndarray:
    """[16 slab rows, 8 queries] as lanes r < 16 hold them after the fold's
    shuffles, for n-tile ``nt``: the kernel's loads, conversion, B words
    and m16n8k16 fragments, with the products summed in f64."""
    d = codes.shape[1]
    words = _pack(codes.reshape(MT, d // 4, 4))  # word w of a row: codes 4w .. 4w + 3
    qwords = qp.view(np.uint32).reshape(qp.shape[0], d // 64, 2, 32, 4)
    acc = np.zeros((32, 4))  # per lane: c0..c3
    for s in range(d // 64):
        for kk in range(4):
            A = np.zeros((16, 16))
            B = np.zeros((16, 8))
            for lane in range(32):
                gr, t = lane >> 2, lane & 3
                p0, p1 = _physical_rows(gr)
                w0, w1 = (words[p, 16 * s + 4 * t + kk] for p in (p0, p1))
                frags = [codes02_bf16(np.array([w]))[0] for w in (w0, w1, w0 >> np.uint32(8), w1 >> np.uint32(8))]
                # a0: (gr, 2t..2t+1), a1: (gr+8, 2t..), a2: (gr, 2t+8..), a3: (gr+8, 2t+8..)
                for (row, col), f in zip([(gr, 2 * t), (gr + 8, 2 * t), (gr, 2 * t + 8), (gr + 8, 2 * t + 8)], frags):
                    A[row, col] = _bf16_bits_to_f64(np.array([f & 0xFFFF]))[0]
                    A[row, col + 1] = _bf16_bits_to_f64(np.array([f >> 16]))[0]
                v = qwords[nt, s, kk >> 1, lane]
                b0, b1 = (v[2], v[3]) if kk & 1 else (v[0], v[1])
                for col, f in ((2 * t, b0), (2 * t + 8, b1)):  # b0: k 2t..2t+1, b1: k 2t+8..; n = gr
                    B[col, gr] = _bf16_bits_to_f64(np.array([f & 0xFFFF]))[0]
                    B[col + 1, gr] = _bf16_bits_to_f64(np.array([f >> 16]))[0]
            D = A @ B
            for lane in range(32):
                gr, t = lane >> 2, lane & 3
                acc[lane] += [D[gr, 2 * t], D[gr, 2 * t + 1], D[gr + 8, 2 * t], D[gr + 8, 2 * t + 1]]
    out = np.zeros((MT, 8))
    for r in range(MT):  # lane r's shuffles: fold_src, fold_hi
        src = (2 * (r & 3) + ((r >> 3) & 1)) * 4
        hi = (r >> 2) & 1
        for q in range(8):
            out[r, q] = acc[src + (q >> 1), (q & 1) + 2 * hi]
    return out


@pytest.mark.parametrize("b,d", [(1, 64), (8, 128), (13, 192)])
def test_one_slab_lane_by_lane_gives_the_plain_product(b, d):
    rng = np.random.default_rng(24)
    codes = rng.integers(-128, 128, size=(MT, d)).astype(np.int8)
    codes[0, :16] = np.arange(-128, 128, 16)  # the extremes, -128 among them
    codes[1, :] = -128
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    qb = topk.int8_query_block(b, d)
    qp = topk.narrow_query_operand(q, qb)
    assert qp.dtype == torch.bfloat16 and qp.is_contiguous()
    assert qp.numel() == qb * d and tuple(qp.shape[:3]) == (qb // 8, d // 64, 2)
    qp_bits = qp.view(torch.int16).numpy().view(np.uint16).reshape(qb // 8, -1)
    q_bf = q.to(torch.bfloat16).double().numpy()
    want = codes.astype(np.float64) @ np.concatenate([q_bf, np.zeros((qb - b, d))]).T
    for nt in range(qb // 8):
        got = _warp_scores(codes, qp_bits, nt)
        np.testing.assert_allclose(got, want[:, 8 * nt : 8 * nt + 8], rtol=1e-12, atol=1e-12)


def test_query_operand_is_a_permutation_of_the_padded_block():
    rng = np.random.default_rng(25)
    q = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32))
    qp = topk.narrow_query_operand(q, 8)
    block = torch.zeros((8, 128), dtype=torch.bfloat16)
    block[:5] = q
    assert torch.equal(torch.sort(qp.reshape(-1).float()).values, torch.sort(block.reshape(-1).float()).values)
    # Lane (g=2, t=1), strip 1, half 0: query 2, columns 64 + 16 + (0, 2, 1, 3), then + 4.
    lane = qp[0, 1, 0, 2 * 4 + 1]
    cols = [80, 82, 81, 83, 84, 86, 85, 87]
    assert torch.equal(lane, block[2, cols])
