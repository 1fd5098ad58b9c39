"""Parity: the port's int8-selection hybrid exact search
(typeagent_tpu_torch/ops/topk.py ``cosine_topk_exact2_hybrid_i8``, K8 +
K3) against the JAX package's on the same numpy inputs.

K8's plain version is held against the JAX Pallas kernel
(``_bucket_maxima_pallas_q``), which has no interpret flag: the test
patches ``pallas_call`` to run in interpret mode for its own duration,
which changes nothing in the JAX package. Both take bf16 queries. It is
also held against the JAX XLA route (what the JAX search runs on the CPU,
with f32 queries) on bf16-representable queries. Raw tolerance 1e-5
(exact bf16 x int8 products, f32 sums in another order, times the scale).
The searches: f32 scores 1e-6, indices equal except at ties, certificates
equal.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from typeagent_tpu.ops import topk as jtopk
from typeagent_tpu_torch.ops import topk

from test_torch_topk import _bf16_round, _normed, _pad, assert_topk_equivalent

F32_TOL = 1e-6
RAW_TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(45)


def test_constants_match_jax():
    for name in ("_CERT_EPS_HYBRID_I8", "_HYBRID_I8_SLACK"):
        assert getattr(topk, name) == getattr(jtopk, name), name


@pytest.mark.parametrize("b", [8, 16])
def test_bucket_maxima_q_plain_matches_pallas_interpret(rng, monkeypatch, b):
    """65,536 int8 rows (the Pallas tile is then at least 1024 rows), a
    ragged watermark inside bucket 510, so bucket 511 is dead."""
    n, d = 65536, 128
    count = n - 173
    m = _normed(rng, n, d)
    q_rows, scales = topk.quantize_rows(m)
    q = _normed(rng, b, d)
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    pal = np.asarray(jtopk._bucket_maxima_pallas_q(
        jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q).astype(jnp.bfloat16),
        jnp.asarray([count], jnp.int32),
    ))
    monkeypatch.undo()
    got = topk.bucket_maxima_q(
        torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count
    )
    nb = n // 128
    assert tuple(got.shape) == (b, nb)
    np.testing.assert_allclose(got.numpy(), pal[:, :nb], atol=RAW_TOL)
    assert (pal[:, nb:] <= -2.0).all()
    assert (got[:, -1] == -3.0).all() and (got[:, :-1] > -2.0).all()


def _jax_xla_bucket_maxima_q(q_rows, scales, q, count):
    """The JAX XLA branch of ``_topk_exact2_hybrid_i8_impl``
    (``typeagent_tpu/ops/topk.py:1564-1579``), which the JAX search runs
    off the TPU; it is inline there, so it is restated here with the same
    jnp calls."""
    raw = jnp.einsum(
        "bd,nd->bn", jnp.asarray(q, jnp.float32), jnp.asarray(q_rows).astype(jnp.float32),
        preferred_element_type=jnp.float32,
    ) * jnp.asarray(scales)[None, :]
    b, n_pad = raw.shape
    row_ids = jnp.arange(n_pad, dtype=jnp.int32)[None, :]
    raw = jnp.where(row_ids < count, raw, jtopk._RAW_NEG)
    return np.asarray(jnp.max(raw.reshape(b, n_pad // 128, 128), axis=2))


@pytest.mark.parametrize("n_pad,count", [(2048, 2048), (4096, 3001), (1024, 77)])
def test_bucket_maxima_q_plain_matches_jax_xla(rng, n_pad, count):
    d = 64
    m = _pad(_normed(rng, count, d), n_pad, 128)
    q_rows, scales = topk.quantize_rows(m)
    q = _pad(_bf16_round(_normed(rng, 6, d)), 8, 128)
    want = _jax_xla_bucket_maxima_q(q_rows, scales, q, count)
    got = topk.bucket_maxima_q(
        torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count
    )
    np.testing.assert_allclose(got.numpy(), want, atol=RAW_TOL)


def _search_both(m_pad, q, count, k, slack):
    q_rows, scales = topk.quantize_rows(m_pad)
    jout = jtopk.cosine_topk_exact2_hybrid_i8(
        jnp.asarray(m_pad), jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q),
        count, k, slack=slack,
    )
    tout = topk.cosine_topk_exact2_hybrid_i8(
        torch.from_numpy(m_pad), torch.from_numpy(q_rows), torch.from_numpy(scales),
        torch.from_numpy(q), count, k, slack=slack,
    )
    return jout, tout


@pytest.mark.parametrize(
    "n_pad,count,k,slack",
    [
        (1024, 1000, 10, 14),   # B >= nb: every bucket rescored, all certified
        (4096, 4096, 10, 14),   # B < nb
        (4096, 3001, 1, 2),     # watermark inside a bucket, tight slack
        (8192, 8000, 32, 6),
        (4096, 3500, 10, 22),
    ],
)
def test_exact2_hybrid_i8_matches_jax(rng, n_pad, count, k, slack):
    d = 64
    m = _normed(rng, n_pad, d)  # rows past the watermark hold data too
    m_pad = _pad(m, n_pad, 128)
    q = _pad(_bf16_round(_normed(rng, 8, d)), 8, 128)
    (jv, ji, jc), (tv, ti, tc) = _search_both(m_pad, q, count, k, slack)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)
    assert bool((ti < count).all())
    if k + slack >= n_pad // 128:
        assert bool(tc.all())


def test_exact2_hybrid_i8_certified_answers_are_exact(rng):
    """Where the certificate holds, the answer is the exact one-phase top-k
    (up to ties within the f32 tolerance)."""
    d, n_pad, count, k = 64, 8192, 8000, 10
    m_pad = _pad(_normed(rng, count, d), n_pad, 128)
    q = _pad(_normed(rng, 16, d), 16, 128)
    q_rows, scales = topk.quantize_rows(m_pad)
    vals, idx, cert = topk.topk_program_exact2_hybrid_i8(
        torch.from_numpy(m_pad), torch.from_numpy(q_rows), torch.from_numpy(scales),
        torch.from_numpy(q), count, k,
    )
    ev, ei = topk.cosine_topk(torch.from_numpy(m_pad), torch.from_numpy(q), count, k)
    assert cert.float().mean().item() >= 0.9
    keep = cert.numpy()
    assert_topk_equivalent(vals[keep], idx[keep], ev[keep], ei[keep], F32_TOL)


def test_exact2_hybrid_i8_with_the_device_quantizer(rng):
    """The shadow from the port's device quantizer (bit for bit the JAX
    device twin) searches as the JAX search over the JAX device shadow."""
    d, n_pad, count, k = 64, 4096, 3900, 10
    m_pad = _pad(_normed(rng, count, d), n_pad, 128)
    q = _pad(_bf16_round(_normed(rng, 8, d)), 8, 128)
    tq, ts = topk.quantize_rows_device(torch.from_numpy(m_pad))
    jq, js = jtopk.quantize_rows_device(jnp.asarray(m_pad))
    jv, ji, jc = jtopk.cosine_topk_exact2_hybrid_i8(jnp.asarray(m_pad), jq, js, jnp.asarray(q), count, k)
    tv, ti, tc = topk.cosine_topk_exact2_hybrid_i8(
        torch.from_numpy(m_pad), tq, ts, torch.from_numpy(q), count, k
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)


def test_program_and_batched_names_are_one_search():
    assert topk.cosine_topk_exact2_hybrid_i8 is topk.topk_program_exact2_hybrid_i8


def test_cpu_plain_route_counts_no_launch(rng):
    m_pad = _pad(_normed(rng, 1000, 32), 1024, 128)
    q_rows, scales = topk.quantize_rows(m_pad)
    topk.reset_launch_counts()
    topk.cosine_topk_exact2_hybrid_i8(
        torch.from_numpy(m_pad), torch.from_numpy(q_rows), torch.from_numpy(scales),
        torch.from_numpy(m_pad[:4]), 1000, 5,
    )
    counts = topk.launch_counts()
    assert counts["bucket_maxima_q"] == 0 and counts["rescore"] == 0
    assert "bucket_maxima_q4" in counts


def test_wrapper_refuses_non_cpu_non_cuda_operands():
    """The kernel path's argument checks run before any build."""
    emb = torch.zeros((1024, 128), dtype=torch.int8, device="meta")
    scales = torch.ones((1024,), device="meta")
    q = torch.zeros((4, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        topk.bucket_maxima_q(emb, scales, q, 1000)
