"""Appendable padded device buffers.

The embedding matrix is a padded ``[capacity, dim_pad]`` tensor with a
host-side count watermark. Appends write in place; growth allocates the new
capacity (doubling, or exact with a reserve hint) and copies the old rows.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_buffer", "append_rows", "grow_buffer", "round_up"]

MIN_CAPACITY = 1024
LANES = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_buffer(
    capacity: int,
    dim_pad: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Allocate a zeroed [capacity, dim_pad] buffer on ``device``."""
    return torch.zeros((capacity, dim_pad), dtype=dtype, device=device)


def append_rows(
    buf: torch.Tensor, rows: np.ndarray | torch.Tensor, count: int
) -> torch.Tensor:
    """Write ``rows`` at offset ``count`` and return ``buf``.

    The JAX package's donated ``dynamic_update_slice`` becomes an in-place
    ``copy_`` into the slice: the buffer is updated where it lies, with no
    second copy of the store. The copy runs on the current stream, after
    any kernel already launched there that reads the buffer. ``rows`` must
    already be padded to ``dim_pad`` columns and fit in capacity; f32 rows
    are cast to the buffer dtype on the device.
    """
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(rows)
    n = rows.shape[0]
    if count + n > buf.shape[0]:
        raise ValueError(f"append of {n} rows at {count} overflows {buf.shape[0]}")
    buf[count : count + n].copy_(rows)
    return buf


def grow_buffer(
    buf: torch.Tensor, needed: int, exact_capacity: int | None = None
) -> torch.Tensor:
    """Grow capacity (doubling) until >= needed rows fit.

    ``exact_capacity`` (a reserve hint) skips the doubling: near device
    capacity a power-of-two jump wastes up to 2x. Returns ``buf`` itself
    when it already fits; otherwise a new zero-padded buffer.
    """
    if exact_capacity is not None and exact_capacity >= needed:
        cap = round_up(max(exact_capacity, MIN_CAPACITY), 1024)
    else:
        cap = max(buf.shape[0], MIN_CAPACITY)
        while cap < needed:
            cap *= 2
    if cap <= buf.shape[0]:
        return buf
    out = torch.zeros((cap, buf.shape[1]), dtype=buf.dtype, device=buf.device)
    out[: buf.shape[0]].copy_(buf)
    return out
