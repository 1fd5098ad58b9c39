"""Parity: the port's appendable buffers (typeagent_tpu_torch/ops/append.py)
against the JAX package's (typeagent_tpu/ops/append.py), same numpy rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.ops import append as jax_append
from typeagent_tpu_torch.ops import append


def test_constants_match():
    assert append.LANES == jax_append.LANES
    assert append.MIN_CAPACITY == jax_append.MIN_CAPACITY
    for x, m in [(0, 128), (1, 128), (128, 128), (129, 128), (1000, 1024)]:
        assert append.round_up(x, m) == jax_append.round_up(x, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_then_grow_matches_jax(dtype):
    rng = np.random.default_rng(11)
    d_pad = 128
    chunks = [rng.standard_normal((n, d_pad)).astype(np.float32) for n in (700, 500, 900)]
    t_dtype = getattr(torch, dtype)
    j_dtype = getattr(jnp, dtype)
    tbuf = append.make_buffer(append.MIN_CAPACITY, d_pad, t_dtype, "cpu")
    jbuf = jax_append.make_buffer(jax_append.MIN_CAPACITY, d_pad, j_dtype)
    count = 0
    for rows in chunks:
        tbuf = append.grow_buffer(tbuf, count + rows.shape[0])
        jbuf = jax_append.grow_buffer(jbuf, count + rows.shape[0])
        assert tbuf.shape == tuple(jbuf.shape)
        tbuf = append.append_rows(tbuf, rows, count)
        jbuf = jax_append.append_rows(jbuf, rows, count)
        count += rows.shape[0]
    assert tbuf.shape[0] == 4096  # 1024 -> 2048 -> 4096 doubling
    np.testing.assert_array_equal(
        tbuf.float().numpy(), np.asarray(jbuf.astype(jnp.float32))
    )


def test_exact_capacity_hint_matches_jax():
    tbuf = append.make_buffer(1024, 128)
    jbuf = jax_append.make_buffer(1024, 128)
    for needed, hint in [(1500, 5000), (6000, None), (9000, 8000)]:
        tbuf = append.grow_buffer(tbuf, needed, exact_capacity=hint)
        jbuf = jax_append.grow_buffer(jbuf, needed, exact_capacity=hint)
        assert tbuf.shape[0] == jbuf.shape[0]


def test_append_is_in_place_and_grow_keeps_rows():
    buf = append.make_buffer(1024, 128)
    before = buf.data_ptr()
    rows = np.ones((3, 128), np.float32)
    out = append.append_rows(buf, rows, 10)
    assert out is buf and buf.data_ptr() == before
    assert float(buf[10:13].sum()) == 3 * 128 and float(buf[:10].sum()) == 0
    grown = append.grow_buffer(buf, 2000)
    assert grown.shape[0] == 2048
    assert torch.equal(grown[:1024], buf) and float(grown[1024:].abs().sum()) == 0
    assert append.grow_buffer(grown, 100) is grown


def test_append_overflow_raises():
    buf = append.make_buffer(1024, 128)
    with pytest.raises(ValueError, match="overflows"):
        append.append_rows(buf, np.zeros((10, 128), np.float32), 1020)
