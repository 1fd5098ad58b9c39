"""Launch geometry of the port's scan and bucket kernels, on the CPU.

The grids of ``csrc/topk.cu`` (K1, K4-K7) and ``csrc/bucket_maxima.cu``
(K2, K2', K8, K9) come from pure functions of the shapes and the card's SM
count (``ops/topk.py``: ``topk_query_block``, ``split_range``,
``scan_geometry``, ``bucket_geometry``). These tests hold them to what the
kernels assume: every tile or bucket is covered exactly once, no split is
empty, a dead or over-full count and a batch below one query block still
give a valid grid, and one wave of the grid fits the card.
"""

import math

import pytest

from typeagent_tpu_torch.ops import topk

RB = 128
SMS = (1, 8, 114, 132)


def _ranges(per, n_ranges, n):
    return [(i * per, min((i + 1) * per, n)) for i in range(n_ranges)]


@pytest.mark.parametrize("b,want", [(1, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32), (33, 64), (256, 64), (4096, 64)])
def test_query_block_follows_the_batch(b, want):
    assert topk.topk_query_block(b) == want


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("n", [1, 2, 7, 263, 264, 265, 7813, 78_000])
@pytest.mark.parametrize("n_qb", [1, 4, 300])
def test_split_range_covers_each_tile_once(n, n_qb, sms):
    per, n_ranges = topk.split_range(n, n_qb, sms)
    ranges = _ranges(per, n_ranges, n)
    covered = [t for lo, hi in ranges for t in range(lo, hi)]
    assert covered == list(range(n))  # each tile once, in order
    assert all(hi > lo for lo, hi in ranges)  # no empty range
    # One wave: no more CTAs than two per SM, unless the query blocks alone
    # need more.
    assert n_qb * n_ranges <= max(n_qb, topk._CTAS_PER_SM * sms)
    assert n_ranges <= n


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b", [1, 7, 8, 16, 30, 63, 64, 65, 256, 257])
@pytest.mark.parametrize("n_rows,count", [
    (1 << 20, 1_000_000), (1 << 20, 1 << 20), (9216, 8955), (128, 77), (256, 0), (1024, 5000),
])
def test_scan_geometry(n_rows, count, b, sms):
    qb = topk.topk_query_block(b)
    rows_per_split, splits = topk.scan_geometry(count, n_rows, b, sms, qb)
    live = max(0, min(count, n_rows))
    assert rows_per_split % RB == 0 and rows_per_split > 0 and splits >= 1
    # The kernel's split i scans rows [i*rows_per_split, ...) below the
    # live count, tile by tile.
    rows = [r for lo, hi in _ranges(rows_per_split, splits, live) for r in range(lo, hi, RB)]
    assert rows == list(range(0, live, RB))
    if live:
        assert (splits - 1) * rows_per_split < live  # no split without rows
    else:
        assert splits == 1  # a dead store: one split, unfilled lists
    assert math.ceil(b / qb) * splits <= max(math.ceil(b / qb), topk._CTAS_PER_SM * sms)


def _bucket_cover(n_rows, count, b, sms, qb):
    """Every bucket each CTA of one query block writes, as the kernels'
    BucketRange assigns them: its live range, then its dead stride."""
    per, ctas = topk.bucket_geometry(count, n_rows, b, sms, qb)
    nb = n_rows // RB
    live_nb = math.ceil(max(0, min(count, n_rows)) / RB)
    written = []
    for c in range(ctas):
        written += range(c * per, min((c + 1) * per, live_nb))
        written += range(live_nb + c, nb, ctas)
    return sorted(written), nb, per, ctas, live_nb


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("b,qb", [(1, 64), (64, 64), (65, 64), (256, 64), (8, 8), (16, 16), (30, 32)])
@pytest.mark.parametrize("n_rows,count", [
    (1 << 20, 1_000_000), (6144, 5000), (128, 77), (256, 0), (9216, 9216), (1024, 1 << 20),
    (1_100_000 // RB * RB, 1_000_000),
])
def test_bucket_geometry_writes_each_bucket_once(n_rows, count, b, qb, sms):
    written, nb, per, ctas, live_nb = _bucket_cover(n_rows, count, b, sms, qb)
    assert written == list(range(nb))
    assert per >= 1 and ctas >= 1
    if live_nb:
        assert (ctas - 1) * per < live_nb  # no CTA without a live bucket
    assert math.ceil(b / qb) * ctas <= max(math.ceil(b / qb), topk._CTAS_PER_SM * sms)


def test_store_fewer_buckets_than_persistent_ctas():
    """A 3-bucket store on a 132-SM card: three CTAs per query block, one
    bucket each."""
    per, ctas = topk.bucket_geometry(300, 384, 256, 132, 64)
    assert (per, ctas) == (1, 3)
    per, ctas = topk.bucket_geometry(0, 384, 256, 132, 64)
    assert (per, ctas) == (1, 1)  # the one CTA writes every dead bucket


def test_main_path_geometry_is_one_wave():
    """1M rows at b = 256 on 132 SMs: K1 splits the 7,813 tiles over 66
    splits of the 4 query blocks, K2 the buckets over 66 CTAs each: 264
    CTAs, two per SM."""
    rows_per_split, splits = topk.scan_geometry(1_000_003, 1_000_448, 256, 132, 64)
    assert (rows_per_split // RB, splits) == (119, 66)
    assert topk.bucket_geometry(1_000_003, 1_000_448, 256, 132, 64) == (119, 66)
    # b = 8: one query block of 8, 264 splits of 30 tiles.
    assert topk.scan_geometry(1_000_003, 1_000_448, 8, 132, 8) == (30 * RB, 261)


def test_count_past_the_store_is_clamped():
    assert topk.scan_geometry(10**9, 1024, 4, 132, 8) == topk.scan_geometry(1024, 1024, 4, 132, 8)
    assert topk.bucket_geometry(-5, 1024, 4, 132, 8) == topk.bucket_geometry(0, 1024, 4, 132, 8)
