"""Parity: the port's int4 selection shadow (typeagent_tpu_torch/ops/int4.py)
against the JAX package's (typeagent_tpu/ops/int4.py) on the same numpy
inputs.

The quantizers and the query split must match bit for bit. K9's plain
version is held against the JAX Pallas kernel in interpret mode (both take
bf16 split queries) and against the JAX XLA route with bf16-representable
queries (that route scores f32 queries); raw tolerance 1e-5 (exact bf16 x
int4 products, f32 sums in another order). The searches run the port's
plain versions against the JAX functions as its CPU tests run them (the
XLA route): f32 scores 1e-6, bf16 rescore buffers 1e-5, indices equal
except at ties, certificates equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.ops import int4 as jint4
from typeagent_tpu_torch.ops import int4, topk

from test_torch_topk import _bf16_round, _normed, assert_topk_equivalent

F32_TOL = 1e-6
BF16_TOL = 1e-5
RAW_TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(44)


def test_constants_match_jax():
    for name in ("_CERT_EPS_I4", "_I4_SLACK", "_K_LANES"):
        assert getattr(int4, name) == getattr(jint4, name), name
    for d in (1, 2, 64, 100, 128, 255, 256, 257, 384, 1536):
        assert int4._half_pad(d) == jint4._half_pad(d), d


def _rows_with_zeros(rng, n, d):
    rows = _normed(rng, n, d)
    rows[[3, n - 1]] = 0.0  # all-zero rows take scale 1.0
    return rows


@pytest.mark.parametrize("d", [128, 384, 100])
def test_host_quantizer_matches_jax_bit_for_bit(rng, d):
    rows = _rows_with_zeros(rng, 300, d)
    p_t, s_t = int4.quantize_rows_int4(rows)
    p_j, s_j = jint4.quantize_rows_int4(rows)
    assert p_t.dtype == np.int8 and p_t.shape == (300, int4._half_pad(d))
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(s_t.view(np.int32), s_j.view(np.int32))
    assert (s_t[[3, 299]] == 1.0).all()


@pytest.mark.parametrize("d", [128, 384, 100])
def test_device_quantizer_matches_jax_bit_for_bit(rng, d):
    rows = _rows_with_zeros(rng, 2000, d)
    p_t, s_t = int4.quantize_rows_int4_device(torch.from_numpy(rows))
    p_j, s_j = jint4.quantize_rows_int4_device(jnp.asarray(rows))
    assert p_t.dtype == torch.int8 and tuple(p_t.shape) == (2000, int4._half_pad(d))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(s_t.numpy().view(np.int32), np.asarray(s_j).view(np.int32))
    # The device scale is a multiply by f32(1/7), not the host's division.
    live = np.abs(rows).max(axis=1) > 0
    want = (np.abs(rows).max(axis=1) * np.float32(1.0 / 7.0)).astype(np.float32)
    np.testing.assert_array_equal(s_t.numpy()[live], want[live])


def test_device_and_host_scales_differ_by_the_reciprocal():
    """On unit rows the two twins' scales differ by an ulp in many rows
    (the reason each port twin follows its own JAX twin)."""
    rows = _normed(np.random.default_rng(7), 5000, 384)
    _, s_host = int4.quantize_rows_int4(rows)
    _, s_dev = int4.quantize_rows_int4_device(torch.from_numpy(rows))
    differ = s_host != s_dev.numpy()
    assert differ.mean() > 0.2
    np.testing.assert_allclose(s_host, s_dev.numpy(), rtol=2e-7)


def test_unpack_roundtrip_dequantizes_rows(rng):
    for d in (128, 384, 100):
        rows = _normed(rng, 64, d)
        packed, scales = int4.quantize_rows_int4(rows)
        codes = int4._unpack(torch.from_numpy(packed)).numpy()
        dh, half = int4._half_pad(d), (d + 1) // 2
        deq = np.concatenate([codes[:, :half], codes[:, dh : dh + d - half]], axis=1)
        np.testing.assert_allclose(deq * scales[:, None], rows, atol=0.05)  # scale/2 per element
        assert (np.abs(codes) <= 7).all()


@pytest.mark.parametrize("d", [384, 100, 64])
def test_split_pad_queries_matches_jax(rng, d):
    q = _normed(rng, 5, d)
    got = int4.split_pad_queries(torch.from_numpy(q), d)
    want = jint4.split_pad_queries(jnp.asarray(q), d)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("batch", [1, 8, 256])
def test_bucket_maxima_q4_plain_matches_pallas_interpret(rng, batch):
    """K9's plain version against the JAX Pallas kernel run in interpret
    mode (the same bf16 split queries): n = 32,768 rows (two output blocks
    of the Pallas table), a ragged watermark inside the last tile."""
    n, d = 32768, 384
    rows = _normed(rng, n, d)
    packed, scales = int4.quantize_rows_int4(rows)
    q = _normed(rng, batch, d)
    count = n - 173
    qs_j = jint4.split_pad_queries(jnp.asarray(q), d)
    pal = np.asarray(jint4._bucket_maxima_pallas_q4(
        jnp.asarray(packed), jnp.asarray(scales), qs_j, jnp.asarray([count], jnp.int32),
        interpret=True,
    ))
    qs_t = int4.split_pad_queries(torch.from_numpy(q), d)
    got = int4.bucket_maxima_q4(torch.from_numpy(packed), torch.from_numpy(scales), qs_t, count)
    nb = n // 128
    assert tuple(got.shape) == (batch, nb)
    np.testing.assert_allclose(got.numpy(), pal[:, :nb], atol=RAW_TOL)
    # The port's table is exactly [b, nb]; the Pallas padding lanes hold the floor.
    assert (pal[:, nb:] <= -2.0).all()
    assert (got[:, (count + 127) // 128 :] == -3.0).all()


def test_live_depth_rule():
    """K9's live depth: whole 32-byte strips that cover the ceil(d/2)
    packed bytes holding codes, never past the packing's width."""
    for d in range(1, 1025):
        live = int4.live_depth(d)
        assert live % 32 == 0 and (d + 1) // 2 <= live <= int4._half_pad(d), d
    assert [int4.live_depth(d) for d in (100, 128, 256, 384, 2048)] == [64, 64, 128, 192, 1024]


@pytest.mark.parametrize("d", [1, 33, 100, 128, 255, 384, 1000])
def test_jax_split_queries_are_zero_past_the_live_depth(rng, d):
    """What makes the skip exact: the JAX split puts no query value in
    either half's columns past live_depth(d)."""
    dh, live = jint4._half_pad(d), int4.live_depth(d)
    qs = np.asarray(jint4.split_pad_queries(jnp.asarray(_normed(rng, 3, d)), d).astype(jnp.float32))
    assert qs.shape == (3, 2 * dh)
    assert (qs[:, live:dh] == 0).all() and (qs[:, dh + live :] == 0).all()


def _with_random_padding(rng, packed, d):
    """A copy of the packed shadow whose bytes past live_depth(d) hold
    random codes in both nibbles."""
    out = packed.copy()
    live = int4.live_depth(d)
    out[:, live:] = rng.integers(-128, 128, size=out[:, live:].shape, dtype=np.int8)
    return out


@pytest.mark.parametrize("d", [100, 128, 384])
def test_bucket_maxima_q4_plain_live_depth_matches_pallas_interpret(rng, d):
    """K9's plain version over the live depth only (as the kernel walks
    it) against the JAX Pallas kernel in interpret mode over the untouched
    shadow, at a ragged watermark; and, to the bit, against the port's
    whole-width result, even when the bytes past the live depth hold
    random codes."""
    n, batch = 8192, 8
    rows = _normed(rng, n, d)
    packed, scales = int4.quantize_rows_int4(rows)
    q = _normed(rng, batch, d)
    count = n - 173
    pal = np.asarray(jint4._bucket_maxima_pallas_q4(
        jnp.asarray(packed), jnp.asarray(scales), jint4.split_pad_queries(jnp.asarray(q), d),
        jnp.asarray([count], jnp.int32), interpret=True,
    ))
    qs = int4.split_pad_queries(torch.from_numpy(q), d)
    sc = torch.from_numpy(scales)
    noisy = torch.from_numpy(_with_random_padding(rng, packed, d))
    live = int4.bucket_maxima_q4(torch.from_numpy(packed), sc, qs, count, d=d)
    nb = n // 128
    np.testing.assert_allclose(live.numpy(), pal[:, :nb], atol=RAW_TOL)
    whole = int4.bucket_maxima_q4_plain(torch.from_numpy(packed), sc, qs, count)
    for got in (live, int4.bucket_maxima_q4_plain(noisy, sc, qs, count, d=d),
                int4.bucket_maxima_q4_plain(noisy, sc, qs, count)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), whole.numpy().view(np.int32))


def test_live_depth_refuses_a_width_that_does_not_pack_to_the_shadow():
    packed = torch.zeros((256, 128), dtype=torch.int8)  # _half_pad(384) = 256
    qs = torch.zeros((2, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="_half_pad"):
        int4.bucket_maxima_q4(packed, torch.ones(256), qs, 200, d=384)


@pytest.mark.parametrize("d", [100, 384])
def test_exact2_i4_passes_its_width_to_k9(rng, monkeypatch, d):
    """The program hands K9 its rows' width, so the product walks the
    live depth only, and still matches the JAX search."""
    n, count, k = 2048, 1900, 10
    rows = _normed(rng, n, d)
    packed, scales = int4.quantize_rows_int4(rows)
    q = _bf16_round(_normed(rng, 8, d))
    seen = []
    k9 = int4.bucket_maxima_q4

    def spy(*args, **kwargs):
        seen.append(kwargs.get("d"))
        return k9(*args, **kwargs)

    monkeypatch.setattr(int4, "bucket_maxima_q4", spy)
    (jv, ji, jc), (tv, ti, tc) = _search_both(rows, packed, scales, q, count, k, 6, "float32")
    assert seen == [d]
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)


@pytest.mark.parametrize("d,n,count", [(64, 1024, 1024), (100, 2048, 1500), (384, 1024, 77)])
def test_bucket_maxima_q4_plain_matches_jax_xla(rng, d, n, count):
    rows = _normed(rng, n, d)
    packed, scales = int4.quantize_rows_int4(rows)
    q = _bf16_round(_normed(rng, 6, d))  # the XLA route scores f32 queries
    want = np.asarray(jint4._bucket_maxima_xla_q4(
        jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(q), jnp.asarray(count, jnp.int32), d
    ))
    got = int4.bucket_maxima_q4(
        torch.from_numpy(packed), torch.from_numpy(scales),
        int4.split_pad_queries(torch.from_numpy(q), d), count,
    )
    np.testing.assert_allclose(got.numpy(), want, atol=RAW_TOL)


def _search_both(rows, packed, scales, q, count, k, slack, dtype):
    """(JAX (vals, idx, cert), port (vals, idx, cert)) over the rescore
    buffer ``rows`` in ``dtype``."""
    jemb = jnp.asarray(rows)
    temb = torch.from_numpy(rows.copy())
    if dtype == "bfloat16":
        jemb, temb = jemb.astype(jnp.bfloat16), temb.bfloat16()
    jout = jint4.cosine_topk_exact2_i4(
        jemb, jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(q), count, k, slack=slack
    )
    tout = int4.cosine_topk_exact2_i4(
        temb, torch.from_numpy(packed), torch.from_numpy(scales), torch.from_numpy(q),
        count, k, slack=slack,
    )
    return jout, tout


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,count,k,slack",
    [
        (512, 512, 10, 4),      # B >= nb: every bucket rescored, all certified
        (4096, 4096, 10, 14),   # B < nb: the realistic regime
        (4096, 3001, 5, 6),     # watermark inside a bucket
        (2048, 1900, 32, 2),
    ],
)
def test_exact2_i4_matches_jax(rng, dtype, n, count, k, slack):
    d = 96
    rows = _normed(rng, n, d)
    rows[count:] = _normed(rng, n - count, d)  # data past the watermark must not surface
    packed, scales = int4.quantize_rows_int4(rows)
    q = _bf16_round(_normed(rng, 8, d))
    (jv, ji, jc), (tv, ti, tc) = _search_both(rows, packed, scales, q, count, k, slack, dtype)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, BF16_TOL if dtype == "bfloat16" else F32_TOL)
    assert bool((ti < count).all())
    if k + slack >= n // 128:
        assert bool(tc.all())


def test_exact2_i4_matches_exact_topk_when_every_bucket_is_rescored(rng):
    n, d, k = 512, 96, 10
    rows = _normed(rng, n, d)
    packed, scales = int4.quantize_rows_int4(rows)
    q = _normed(rng, 8, d)
    vals, idx, cert = int4.topk_program_exact2_i4(
        torch.from_numpy(rows), torch.from_numpy(packed), torch.from_numpy(scales),
        torch.from_numpy(q), n, k, slack=n // 128,
    )
    ev, ei = topk.cosine_topk(torch.from_numpy(rows), torch.from_numpy(q), n, k)
    assert bool(cert.all())
    assert_topk_equivalent(vals, idx, ev, ei, F32_TOL)


def test_carry_over_of_a_jax_int4_shadow(rng):
    """A JAX device-quantized shadow carried across searches in the port as
    it does in JAX, and as the port's own device quantization of the same
    rows does (the two quantizers agree bit for bit)."""
    n, d, count, k = 4096, 128, 4000, 10
    rows = _normed(rng, n, d)
    jp, js = jint4.quantize_rows_int4_device(jnp.asarray(rows))
    packed, scales = int4.adopt_int4_shadow(np.asarray(jp), np.asarray(js), device="cpu")
    assert packed.dtype == torch.int8 and scales.dtype == torch.float32
    own_p, own_s = int4.quantize_rows_int4_device(torch.from_numpy(rows))
    assert torch.equal(packed, own_p) and torch.equal(scales, own_s)
    q = _bf16_round(_normed(rng, 8, d))
    jv, ji, jc = jint4.cosine_topk_exact2_i4(jnp.asarray(rows), jp, js, jnp.asarray(q), count, k)
    tv, ti, tc = int4.cosine_topk_exact2_i4(
        torch.from_numpy(rows), packed, scales, torch.from_numpy(q), count, k
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)


def test_adopt_int4_shadow_refuses_bad_shapes():
    with pytest.raises(ValueError, match="dh % 128"):
        int4.adopt_int4_shadow(np.zeros((4, 100), np.int8), np.ones(4, np.float32), device="cpu")
    with pytest.raises(ValueError, match="scales"):
        int4.adopt_int4_shadow(np.zeros((4, 128), np.int8), np.ones(3, np.float32), device="cpu")


def test_shadow_width_must_match_the_rescore_buffer(rng):
    rows = _normed(rng, 256, 384)
    packed, scales = int4.quantize_rows_int4(rows[:, :200])  # dh 128, not 256
    with pytest.raises(ValueError, match="_half_pad"):
        int4.topk_program_exact2_i4(
            torch.from_numpy(rows), torch.from_numpy(packed), torch.from_numpy(scales),
            torch.from_numpy(rows[:2]), 256, 5,
        )


def test_cpu_plain_route_counts_no_launch(rng):
    rows = _normed(rng, 1024, 64)
    packed, scales = int4.quantize_rows_int4(rows)
    topk.reset_launch_counts()
    int4.cosine_topk_exact2_i4(
        torch.from_numpy(rows), torch.from_numpy(packed), torch.from_numpy(scales),
        torch.from_numpy(rows[:4]), 1024, 5,
    )
    counts = topk.launch_counts()
    assert counts["bucket_maxima_q4"] == 0 and counts["rescore"] == 0


def test_wrapper_refuses_non_cpu_non_cuda_operands():
    """The kernel path's argument checks run before any build."""
    packed = torch.zeros((1024, 128), dtype=torch.int8, device="meta")
    scales = torch.ones((1024,), device="meta")
    qs = torch.zeros((4, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        int4.bucket_maxima_q4(packed, scales, qs, 1000)
