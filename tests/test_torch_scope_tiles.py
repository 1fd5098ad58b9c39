"""The scoped int8 scan's tile list and its persistent split, on the CPU.

K7 (``csrc/topk.cu``) reads only the 128-row tiles that
``ops/topk.py:scope_tiles`` lists: those holding at least one row below the
count whose mask entry is > 0. Each of a query block's CTAs walks the
contiguous share of the list that ``scope_share`` gives it. These tests
hold ``scope_tiles`` to a numpy reference and the shares to what the
kernel assumes: every listed tile in exactly one share, shares ascending.
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


@pytest.mark.parametrize("b", [1, 8, 64, 256])
@pytest.mark.parametrize("n_rows,count", [(30_000_000 // RB * RB, 30_000_000), (1 << 16, (1 << 16) - 333), (128, 77)])
def test_scoped_scan_grid_holds_any_list(n_rows, count, b):
    """K7's grid is K6's (scan_geometry over the count, 64-query blocks),
    fixed before the list's length is known on the device: a share is never
    longer than K6's split, whatever part of the live tiles is listed."""
    rows_per_split, splits = topk.scan_geometry(count, n_rows, b, 132, 64)
    live = -(-count // RB)
    for n_tiles in {0, 1, live // 3, live}:
        longest = max(last - first for first, last in (topk.scope_share(n_tiles, splits, s) for s in range(splits)))
        assert longest <= rows_per_split // RB


def test_scope_tiles_of_the_corpus_layout_read_a_third():
    """One conversation of three, 24 interleaved segments: the list holds
    the 8 segments' tiles, a third of the live ones."""
    mask, count = _case("corpus_one_conversation")
    tiles, n_tiles = topk.scope_tiles(torch.from_numpy(mask), count)
    assert n_tiles.item() == 8 * 640 // RB
    assert tiles[0].item() == 0 and tiles[n_tiles.item() - 1].item() == (21 * 640 + 639) // RB
