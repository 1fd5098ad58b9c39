"""The scoped scans' tile lists and their persistent split, on the CPU.

K5 and K7 (``csrc/topk.cu``) read only the 128-row tiles that
``ops/topk.py:scope_tiles`` lists: those holding at least one row below the
count whose mask entry is > 0. K4 reads those that ``interval_tiles``
lists from its interval table: those that a non-empty interval meets below
the count. Each of a query block's CTAs walks the contiguous share of the
list that ``scope_share`` gives it. On the card ``csrc/tile_list.cu``
builds both lists; on the CPU their plain versions do, and these tests hold
them to numpy references and the shares to what the kernels assume: every
listed tile in exactly one share, shares ascending, none longer than the
unscoped scan's split at any query block.
"""

import numpy as np
import pytest
import torch

from typeagent_tpu_torch.ops import topk

RB = 128


def _reference(mask: np.ndarray, count: int) -> np.ndarray:
    """Ascending indices of the tiles with an in-scope row below count."""
    count = max(0, min(count, mask.size))
    rows = np.nonzero(mask[:count] > 0)[0]
    return np.unique(rows // RB).astype(np.int32)


def _segments(n_rows: int, n_segments: int, names: tuple, keep: set) -> np.ndarray:
    """chip_smoke.py's corpus layout at a small size: ``n_segments``
    equal segments cycling over ``names``; rows of the ``keep``
    conversations in scope."""
    seg = n_rows // n_segments
    mask = np.zeros(n_rows, np.int32)
    for i in range(n_segments):
        if names[i % len(names)] in keep:
            mask[i * seg : (i + 1) * seg] = 1
    return mask


def _case(name: str):
    """(mask, count) of one case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    names = ("podcast", "mailbox", "wiki")
    return {
        "random_dense": lambda: ((rng.random(1 << 14) < 0.3).astype(np.int32), (1 << 14) - 333),
        "random_sparse": lambda: ((rng.random(1 << 15) < 0.002).astype(np.int32), 1 << 15),
        "random_signed": lambda: (rng.integers(-3, 2, 1 << 13).astype(np.int32), 5000),
        "ragged_count": lambda: (np.ones(1024, np.int32), 1000),
        "count_one_row_into_tile": lambda: (np.ones(1024, np.int32), 513),
        "all_zero": lambda: (np.zeros(4096, np.int32), 4096),
        "all_one": lambda: (np.ones(4096, np.int32), 4096),
        "only_past_count": lambda: (np.r_[np.zeros(3000, np.int32), np.ones(1096, np.int32)], 3000),
        "past_count_same_tile": lambda: (np.r_[np.zeros(2945, np.int32), np.ones(1151, np.int32)], 2944),
        "one_tile_store": lambda: (np.r_[np.zeros(100, np.int32), np.ones(28, np.int32)], 77 + 30),
        "one_tile_store_dead": lambda: (np.ones(128, np.int32), 0),
        "corpus_one_conversation": lambda: (_segments(24 * 640, 24, names, {"podcast"}), 24 * 640 - 45),
        "corpus_two_conversations": lambda: (_segments(24 * 640, 24, names, {"podcast", "wiki"}), 24 * 640),
        "corpus_unaligned_segments": lambda: (_segments(24 * 1000 + 64, 24, names, {"mailbox"}), 24 * 1000),
    }[name]()


CASES = [
    "random_dense", "random_sparse", "random_signed", "ragged_count", "count_one_row_into_tile",
    "all_zero", "all_one", "only_past_count", "past_count_same_tile", "one_tile_store",
    "one_tile_store_dead", "corpus_one_conversation", "corpus_two_conversations",
    "corpus_unaligned_segments",
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", ["flat", "row"])
def test_scope_tiles_matches_numpy(case, shape):
    mask, count = _case(case)
    want = _reference(mask, count)
    m = torch.from_numpy(mask)
    tiles, n_tiles = topk.scope_tiles(m if shape == "flat" else m[None, :], count)
    live = -(-max(0, min(count, mask.size)) // RB)
    assert tiles.dtype == torch.int32 and n_tiles.dtype == torch.int32
    assert tuple(tiles.shape) == (live,) and tuple(n_tiles.shape) == (1,)
    assert n_tiles.item() == want.size
    assert tiles[: want.size].tolist() == want.tolist()
    assert bool((tiles[want.size :] == -1).all())


def test_scope_tiles_rejects_a_ragged_mask():
    with pytest.raises(ValueError):
        topk.scope_tiles(torch.ones(1000, dtype=torch.int32), 1000)


def test_scope_tiles_leaves_the_mask_alone():
    mask = torch.ones(512, dtype=torch.int32)
    topk.scope_tiles(mask, 300)
    assert bool((mask == 1).all())


@pytest.mark.parametrize("n_tiles", [0, 1, 2, 7, 131, 263, 264, 265, 78_125])
@pytest.mark.parametrize("splits", [1, 3, 66, 132, 264])
def test_scope_share_covers_the_list_once_in_order(n_tiles, splits):
    """Every listed tile falls in exactly one CTA's share; the shares are
    contiguous and ascend with the CTA, so the merge keeps the lowest-row
    tie rule; their sizes differ by at most one."""
    shares = [topk.scope_share(n_tiles, splits, s) for s in range(splits)]
    walked = [j for first, last in shares for j in range(first, last)]
    assert walked == list(range(n_tiles))
    assert all(0 <= first <= last for first, last in shares)
    sizes = [last - first for first, last in shares]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("b", [1, 8, 9, 16, 17, 32, 64, 256])
@pytest.mark.parametrize("n_rows,count", [(30_000_000 // RB * RB, 30_000_000), (1 << 16, (1 << 16) - 333), (128, 77)])
def test_scoped_scan_grid_holds_any_list(n_rows, count, b):
    """A listed scan's grid is its unscoped scan's (scan_geometry over the
    count), fixed before the list's length is known on the device: K7's
    with K6's 64-query blocks, K4's and K5's with K1's FFMA query block
    (8, 16, 32 or 64 by the batch). A share is never longer than the
    unscoped split, whatever part of the live tiles is listed."""
    for query_block in {64, topk.topk_query_block(b)}:
        rows_per_split, splits = topk.scan_geometry(count, n_rows, b, 132, query_block)
        live = -(-count // RB)
        for n_tiles in {0, 1, live // 3, live}:
            shares = [topk.scope_share(n_tiles, splits, s) for s in range(splits)]
            assert max(last - first for first, last in shares) <= rows_per_split // RB


def test_scope_tiles_of_the_corpus_layout_read_a_third():
    """One conversation of three, 24 interleaved segments: the list holds
    the 8 segments' tiles, a third of the live ones."""
    mask, count = _case("corpus_one_conversation")
    tiles, n_tiles = topk.scope_tiles(torch.from_numpy(mask), count)
    assert n_tiles.item() == 8 * 640 // RB
    assert tiles[0].item() == 0 and tiles[n_tiles.item() - 1].item() == (21 * 640 + 639) // RB


def _store_rows(count: int) -> int:
    """The rows of the smallest store holding ``count`` rows."""
    return max(RB, -(-count // RB) * RB)


def _interval_reference(table, count: int) -> np.ndarray:
    """Ascending indices of the tiles that a non-empty interval of
    ``table`` meets below ``count``, through a row mask."""
    rows = np.zeros(max(count, 0), bool)
    for start, stop in table:
        rows[max(start, 0) : max(min(stop, count), 0)] = True
    return _reference(rows.astype(np.int32), count)


def _segment_table(n_segments: int, seg: int, names: tuple, keep: set) -> list:
    """The merged interval table of the ``keep`` conversations in the
    corpus layout of :func:`_segments` (adjacent segments merge, as
    ``CorpusVectorStore._segment_intervals`` merges them)."""
    table = []
    for i in range(n_segments):
        if names[i % len(names)] in keep:
            if table and table[-1][1] == i * seg:
                table[-1][1] = (i + 1) * seg
            else:
                table.append([i * seg, (i + 1) * seg])
    return table


_NAMES = ("podcast", "mailbox", "wiki")
INTERVAL_CASES = {
    "padding_rows": ([[300, 400], [0, 0], [0, 0], [5, 6], [0, 0], [0, 0], [0, 0], [0, 0]], 2000),
    "overlapping_unsorted": ([[700, 900], [0, 50], [40, 120], [800, 1200], [600, 650]], 5000),
    "nested": ([[0, 2048], [100, 200], [150, 160]], 2048),
    "empty_intervals": ([[7, 7], [500, 500], [900, 100]], 4096),
    "no_rows": ([], 1000),
    "past_count": ([[1900, 2500], [10, 20]], 2000),
    "only_past_count": ([[3000, 4096], [5000, 6000]], 3000),
    "ends_one_row_into_a_tile": ([[0, 129], [1000, 1025]], 4096),
    "starts_on_a_tile_edge": ([[256, 257], [1023, 1024]], 4096),
    "count_one_row_into_tile": ([[0, 4096]], 513),
    "dead_store": ([[0, 100]], 0),
    "one_row": ([[77, 78]], 128),
    "corpus_one_conversation": (_segment_table(24, 640, _NAMES, {"podcast"}), 24 * 640 - 45),
    "corpus_two_conversations": (_segment_table(24, 640, _NAMES, {"podcast", "wiki"}), 24 * 640),
    "ivf_suffix": ([[1_000_000, 1_100_000]], 1_100_000),
}


@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_interval_tiles_matches_numpy(case):
    table, count = INTERVAL_CASES[case]
    want = _interval_reference(table, count)
    iv = torch.tensor(table, dtype=torch.int32).reshape(-1, 2)
    tiles, n_tiles = topk.interval_tiles(iv, count, _store_rows(count))
    live = -(-count // RB)
    assert tiles.dtype == torch.int32 and n_tiles.dtype == torch.int32
    assert tuple(tiles.shape) == (live,) and tuple(n_tiles.shape) == (1,)
    assert n_tiles.item() == want.size
    assert tiles[: want.size].tolist() == want.tolist()
    assert bool((tiles[want.size :] == -1).all())


@pytest.mark.parametrize("case", sorted(c for c, (table, _) in INTERVAL_CASES.items() if table))
def test_interval_tiles_equal_the_row_masks_tiles(case):
    """K4's list from the table is K5's list from the table's row mask."""
    table, count = INTERVAL_CASES[case]
    iv = torch.tensor(table, dtype=torch.int32)
    n_rows = max(RB, -(-max(count, int(iv.max()) + 1) // RB) * RB)
    from_mask = topk.scope_tiles(topk.intervals_to_rowmask(n_rows, iv), count)
    from_table = topk.interval_tiles(iv, count, n_rows)
    assert torch.equal(from_table[0], from_mask[0]) and torch.equal(from_table[1], from_mask[1])


def test_interval_tiles_of_the_corpus_layout_read_a_third():
    """One conversation of three, 24 interleaved segments, 8 intervals: the
    list holds the 8 segments' tiles, a third of the live ones."""
    table, count = INTERVAL_CASES["corpus_one_conversation"]
    assert len(table) == 8
    tiles, n_tiles = topk.interval_tiles(torch.tensor(table, dtype=torch.int32), count, _store_rows(count))
    assert n_tiles.item() == 8 * 640 // RB == -(-count // RB) // 3
    assert tiles[0].item() == 0 and tiles[n_tiles.item() - 1].item() == (21 * 640 + 639) // RB


def test_interval_tiles_of_an_ivf_suffix():
    """The rows appended after an IVF snapshot of 1M rows, [1M, 1.1M): the
    suffix scan reads 782 of the 8,594 live tiles, from tile 7,812 (which
    also holds snapshot rows) on."""
    table = torch.tensor([[1_000_000, 1_100_000]], dtype=torch.int32)
    tiles, n_tiles = topk.interval_tiles(table, 1_100_000, _store_rows(1_100_000))
    assert tiles.shape[0] == 8594 and n_tiles.item() == 782
    assert tiles[0].item() == 1_000_000 // RB and tiles[781].item() == 8593


def test_interval_tiles_leave_the_table_alone():
    table = torch.tensor([[700, 900], [0, 50]], dtype=torch.int32)
    topk.interval_tiles(table, 1000, 1024)
    assert table.tolist() == [[700, 900], [0, 50]] and table.dtype == torch.int32


@pytest.mark.parametrize("count", [1024, 1025, 5000, 1 << 40])
def test_interval_tiles_clamp_the_count_to_the_store(count):
    """A count past the store lists only the store's tiles, as the row
    mask's list does (the scans clamp the count the same way)."""
    table = torch.tensor([[0, 200], [900, 6000]], dtype=torch.int32)
    tiles, n_tiles = topk.interval_tiles(table, count, 1024)
    want = topk.scope_tiles(topk.intervals_to_rowmask(1024, table), count)
    assert tiles.shape[0] == 8 and tiles.tolist() == [0, 1, 7, -1, -1, -1, -1, -1]
    assert torch.equal(tiles, want[0]) and torch.equal(n_tiles, want[1])


@pytest.mark.parametrize("lister", ["interval_tiles", "scope_tiles"])
def test_listing_wrappers_take_the_plain_version_on_the_cpu(lister):
    """A CPU tensor gets the plain version's list, with no kernel launch."""
    table = torch.tensor([[300, 400], [0, 0], [2000, 2100]], dtype=torch.int32)
    topk.reset_launch_counts()
    if lister == "interval_tiles":
        got, want = topk.interval_tiles(table, 2048, 2048), topk.interval_tiles_plain(table, 2048, 2048)
    else:
        mask = topk.intervals_to_rowmask(2048, table)
        got, want = topk.scope_tiles(mask, 2048), topk.scope_tiles_plain(mask, 2048)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert topk.launch_counts()[lister] == 0
