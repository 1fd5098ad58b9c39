"""Seed-made data of the benchmark: topic-mixture rows, layouts, queries.

Every tensor is drawn on the device from a ``torch.Generator`` seeded by
``(seed, stream, index)``, so a block of rows is the same whenever it is
made again from the same seed: the program is fed block by block, and the
reference (``reference.py``) remakes the same blocks after the window
instead of holding a second copy of the matrix.

The rows are a topic mixture (after ``bench.py`` section B): unit topic
centres, each row a centre plus isotropic noise of norm about ``sigma``,
and a ``background`` share of rows drawn with no topic; every row is
normalized. Queries are drawn the same way, near uniformly drawn topics.
A corpus's conversations are ranges of ids (``CorpusLayout``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

STREAM_CENTERS = 1
STREAM_ROWS = 2
STREAM_QUERIES = 3
STREAM_TRAFFIC = 5


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit generator seed for ``(seed, stream, index)``; any whole
    ``seed``, negative or past 64 bits included."""
    words = np.random.SeedSequence([seed % (1 << 64), stream, index]).generate_state(2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & ((1 << 63) - 1)


def generator(device: torch.device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, index))
    return g


def host_rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream, index))


def topic_centers(n_topics: int, dim: int, seed: int, device: torch.device) -> torch.Tensor:
    """``[n_topics, dim]`` f32 unit centres."""
    g = generator(device, seed, STREAM_CENTERS)
    c = torch.randn((n_topics, dim), generator=g, device=device)
    return c.div_(torch.linalg.vector_norm(c, dim=1, keepdim=True))


def mixture(
    centers: torch.Tensor, topics: torch.Tensor, g: torch.Generator, sigma: float,
    background: float,
) -> torch.Tensor:
    """Unit rows ``centers[topics] + sigma * noise / sqrt(d)``; a share
    ``background`` of them is the noise alone (no topic). One ``randn`` of
    the block's size; the gather and the sums are in place."""
    n, dim = topics.shape[0], centers.shape[1]
    noise = torch.randn((n, dim), generator=g, device=centers.device)
    bg = torch.rand((n,), generator=g, device=centers.device) < background
    rows = centers.index_select(0, topics)
    rows.add_(noise, alpha=sigma / math.sqrt(dim))
    rows = torch.where(bg[:, None], noise, rows)
    return rows.div_(torch.linalg.vector_norm(rows, dim=1, keepdim=True))


@dataclass
class Block:
    """Rows ``[start, stop)`` of the matrix, made from ``index``."""

    index: int
    start: int
    stop: int


def even_blocks(n_rows: int, block_rows: int) -> list[Block]:
    return [
        Block(i, s, min(s + block_rows, n_rows))
        for i, s in enumerate(range(0, n_rows, block_rows))
    ]


# -- the rows ------------------------------------------------------------------


def rows_block(cfg: dict, centers: torch.Tensor, seed: int, block: Block) -> torch.Tensor:
    """Block ``block`` of a configuration's rows, on ``centers``' device;
    each row on a uniformly drawn topic."""
    g = generator(centers.device, seed, STREAM_ROWS, block.index)
    n = block.stop - block.start
    topics = torch.randint(0, cfg["topics"], (n,), generator=g, device=centers.device)
    return mixture(centers, topics, g, cfg["sigma"], cfg["background"])


# -- the corpus of conversations ----------------------------------------------


@dataclass
class CorpusLayout:
    """Who owns which rows: conversations of ``conv_rows[c]`` rows each,
    registered in turn, so that conversation ``c`` holds a contiguous range
    of ids; ``segments[i] = (conversation, start, count, local_base)`` are
    the appends the program is given, in order (a conversation cut by a
    block's end is appended in two)."""

    conv_rows: np.ndarray  # [n_conversations] rows owned, in id order
    segments: list[tuple[int, int, int, int]]

    @property
    def n_conversations(self) -> int:
        return self.conv_rows.shape[0]

    def conv_starts(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.conv_rows)[:-1]])

    def rows_in(self, lo: int, hi: int) -> int:
        """Rows of conversations ``[lo, hi)``."""
        return int(self.conv_rows[lo:hi].sum())

    def conversations_from(self, row: int) -> tuple[int, int]:
        """``(lo, hi)``: the conversations whose rows are the ids ``row``
        and up; ``row`` must start a conversation."""
        starts = self.conv_starts()
        lo = int(np.searchsorted(starts, row))
        if lo >= len(starts) or starts[lo] != row:
            raise ValueError(f"row {row} does not start a conversation")
        return lo, self.n_conversations


def conversation_name(conv: int) -> str:
    return f"c{conv:05d}"


def corpus_layout(cfg: dict) -> CorpusLayout:
    """The corpus configuration's rows cut into conversations of
    ``layout.conversation_rows`` rows in id order, each appended in the
    blocks it falls in."""
    per = cfg["layout"]["conversation_rows"]
    conv_rows = np.full(-(-cfg["rows"] // per), per, dtype=np.int64)
    conv_rows[-1] = cfg["rows"] - per * (conv_rows.shape[0] - 1)
    starts = np.concatenate([[0], np.cumsum(conv_rows)[:-1]])
    segments = []
    for block in even_blocks(cfg["rows"], cfg["block_rows"]):
        c = int(np.searchsorted(starts, block.start, side="right")) - 1
        at = block.start
        while at < block.stop:
            stop = min(block.stop, int(starts[c] + conv_rows[c]))
            segments.append((c, at, stop - at, at - int(starts[c])))
            at, c = stop, c + 1
    return CorpusLayout(conv_rows, segments)


def row_conversations(layout: CorpusLayout, start: int, stop: int,
                      device: torch.device) -> torch.Tensor:
    """``[stop - start]`` int64 conversation of each of the ids ``[start, stop)``."""
    starts = torch.from_numpy(layout.conv_starts()).to(device)
    ids = torch.arange(start, stop, device=device)
    return torch.searchsorted(starts, ids, right=True) - 1


# -- queries -------------------------------------------------------------------


def queries_near(
    centers: torch.Tensor, topics: np.ndarray, sigma: float, seed: int, index: int
) -> np.ndarray:
    """Host f32 unit queries, one near each of ``topics`` (no background)."""
    g = generator(centers.device, seed, STREAM_QUERIES, index)
    t = torch.from_numpy(np.asarray(topics, dtype=np.int64)).to(centers.device)
    return mixture(centers, t, g, sigma, 0.0).cpu().numpy()
