"""Appendable padded device buffers.

The embedding matrix is a padded ``[capacity, dim_pad]`` tensor with a
host-side count watermark. Appends write in place; growth allocates the new
capacity (doubling, or exact with a reserve hint) and copies the old rows.
An int8 store keeps a per-row f32 scale buffer beside its rows: it grows
with them, is padded with 1.0, and takes each append's scales in place at
the same watermark.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "make_buffer", "append_rows", "grow_buffer", "round_up", "make_scales", "grow_scales",
]

MIN_CAPACITY = 1024
LANES = 128


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def make_buffer(
    capacity: int,
    dim_pad: int,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """Allocate a zeroed [capacity, dim_pad] buffer on ``device`` (the card
    unless the caller names another, as the JAX buffers land on the default
    device, the accelerator)."""
    return torch.zeros((capacity, dim_pad), dtype=dtype, device=device)


def append_rows(
    buf: torch.Tensor, rows: np.ndarray | torch.Tensor, count: int
) -> torch.Tensor:
    """Write ``rows`` at offset ``count`` and return ``buf`` (a row buffer,
    or an int8 store's 1-D scale buffer with its rows' scales).

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


def make_scales(capacity: int, device: torch.device | str = "cuda") -> torch.Tensor:
    """An int8 store's [capacity] f32 scale buffer, padded with 1.0, on
    ``device`` (the card unless the caller names another)."""
    return torch.ones((capacity,), dtype=torch.float32, device=device)


def grow_scales(scales: torch.Tensor, capacity: int) -> torch.Tensor:
    """The scale buffer padded with 1.0 to ``capacity`` (its rows' new
    capacity); ``scales`` itself when it already has that length."""
    if capacity <= scales.shape[0]:
        return scales
    out = make_scales(capacity, scales.device)
    out[: scales.shape[0]].copy_(scales)
    return out
