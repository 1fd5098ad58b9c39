"""Parity: the port's exact top-k routes (typeagent_tpu_torch/ops/topk.py)
against the JAX package's (typeagent_tpu/ops/topk.py) on the same numpy
inputs. JAX runs as its own CPU tests run it (the XLA route); the port runs
its kernels' plain versions, which is what a CPU tensor gets.

Tolerances: f32 scores 1e-6 (summation order); bf16 stores 1e-5 (exact
bf16 products, f32 sums). Indices must match except where scores tie;
invalid slots are compared after filtering to ``vals >= 0`` (the JAX XLA
route points them at masked rows, the port returns -1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.ops import topk as jtopk
from typeagent_tpu_torch.ops import topk

F32_TOL = 1e-6
BF16_TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _normed(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


def _pad(m, n_pad, d_pad):
    out = np.zeros((n_pad, d_pad), np.float32)
    out[: m.shape[0], : m.shape[1]] = m
    return out


def _bf16_round(a):
    """Round to bf16 values, kept as f32 (so both packages see the same q)."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _stores(m_pad, dtype):
    """(jax store, port store) holding the same rows in ``dtype``."""
    j = jnp.asarray(m_pad)
    t = torch.from_numpy(m_pad.copy())
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_topk_equivalent(vals_a, idx_a, vals_b, idx_b, tol):
    """Same top-k up to score ties within ``tol``, after dropping invalid
    slots (vals < 0)."""
    vals_a, idx_a, vals_b, idx_b = map(_np, (vals_a, idx_a, vals_b, idx_b))
    for va, ia, vb, ib in zip(vals_a, idx_a, vals_b, idx_b):
        ka, kb = va >= 0, vb >= 0
        va, ia, vb, ib = va[ka], ia[ka], vb[kb], ib[kb]
        assert va.shape == vb.shape
        np.testing.assert_allclose(va, vb, atol=tol)
        only_a = set(ia.tolist()) - set(ib.tolist())
        kth = vb.min() if vb.size else -1.0
        for pos, i in enumerate(ia):
            if int(i) in only_a:
                assert abs(float(va[pos]) - float(kth)) <= tol, (i, va[pos], kth)
        assert len(set(ia.tolist())) == ia.size  # no index twice


def test_raw_to_score_matches_jax():
    raw = np.array([[0.5, -1.0, 1.0, -3.0, 1.0000001, -0.2]], np.float32)
    idx = np.array([[4, 5, 6, -1, 7, 8]], np.int32)
    jv, ji = jtopk._raw_to_score(jnp.asarray(raw), jnp.asarray(idx))
    tv, ti = topk._raw_to_score(torch.from_numpy(raw), torch.from_numpy(idx))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32


def test_constants_match_jax():
    for name in ("_PALLAS_MAX_K", "_BUCKET_ROWS", "_CERT_EPS", "_CERT_EPS_HYBRID",
                 "_HYBRID_SLACK", "_NEG", "_RAW_NEG"):
        assert getattr(topk, name) == getattr(jtopk, name), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 10, 32, 50])
@pytest.mark.parametrize("n_pad,count", [(2048, 2048), (4096, 3001), (1024, 30)])
def test_cosine_topk_matches_jax(rng, dtype, k, n_pad, count):
    d = 48
    m = _pad(_normed(rng, count, d), n_pad, 128)
    q = _pad(_bf16_round(_normed(rng, 8, d)), 8, 128)
    jemb, temb = _stores(m, dtype)
    jv, ji = jtopk.cosine_topk(jemb, jnp.asarray(q), count, k)
    tv, ti = topk.cosine_topk(temb, torch.from_numpy(q), count, k)
    assert tuple(tv.shape) == tuple(jv.shape)
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL if dtype == "float32" else BF16_TOL)


def test_k_over_32_takes_materialized_route(rng):
    m = _pad(_normed(rng, 500, 16), 1024, 128)
    q = _pad(_normed(rng, 3, 16), 8, 128)
    topk.reset_launch_counts()
    topk.cosine_topk(torch.from_numpy(m), torch.from_numpy(q), 500, 33)
    topk.cosine_topk(torch.from_numpy(m), torch.from_numpy(q), 500, 32)
    assert topk.launch_counts()["materialized_topk"] == 1
    # CPU tensors run the plain versions: no kernel launch is counted.
    assert topk.launch_counts()["topk"] == 0


def test_topk_plain_ties_go_to_lowest_row(rng):
    d = 32
    m = _normed(rng, 1000, d)
    dupes = [3, 250, 251, 700, 999]
    m[dupes] = m[dupes[0]]
    emb = torch.from_numpy(_pad(m, 1024, 128))
    q = torch.from_numpy(_pad(m[3:4], 8, 128))
    vals, idx = topk.topk_plain(emb, q, 1000, 3)
    assert idx[0].tolist() == [3, 250, 251]
    assert float(vals[0, 0]) == float(vals[0, 2])
    vals, idx = topk.topk_plain(emb, q, 600, 4)  # watermark hides 700, 999
    assert idx[0, :3].tolist() == [3, 250, 251]
    assert 700 not in idx[0].tolist() and 999 not in idx[0].tolist()


def test_topk_plain_unfilled_slots(rng):
    emb = torch.from_numpy(_pad(_normed(rng, 5, 16), 1024, 128))
    q = torch.from_numpy(_pad(_normed(rng, 2, 16), 8, 128))
    vals, idx = topk.topk_plain(emb, q, 5, 8)
    assert (idx[:, 5:] == -1).all() and (vals[:, 5:] == -3.0).all()
    assert sorted(idx[0, :5].tolist()) == [0, 1, 2, 3, 4]
    jv, ji = jtopk.cosine_topk(jnp.asarray(emb.numpy()), jnp.asarray(q.numpy()), 5, 8)
    assert_topk_equivalent(*topk._raw_to_score(vals, idx), jv, ji, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [4096, 3000, 130])
def test_bucket_maxima_matches_jax_xla(rng, dtype, count):
    d = 64
    m = _pad(_normed(rng, count, d), 4096, 128)
    q = _pad(_bf16_round(_normed(rng, 16, d)), 16, 128)
    jemb, temb = _stores(m, dtype)
    jv, _ = jtopk._bucket_maxima_xla(jemb, jnp.asarray(q), jnp.int32(count))
    tv = topk.bucket_maxima(temb, torch.from_numpy(q), count)
    assert tuple(tv.shape) == tuple(jv.shape)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=BF16_TOL if dtype == "bfloat16" else F32_TOL)
    assert (tv[:, -(-count // 128):] == -3.0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rescore_selected_matches_jax_gather(rng, dtype):
    d, B = 64, 5
    m = _pad(_normed(rng, 2048, d), 2048, 128)
    q = _pad(_bf16_round(_normed(rng, 8, d)), 8, 128)
    ids = np.stack([rng.permutation(16)[:B] for _ in range(8)]).astype(np.int32)
    jemb, temb = _stores(m, dtype)
    got = topk.rescore_selected(temb, torch.from_numpy(q), torch.from_numpy(ids))
    rows = np.asarray(jemb.astype(jnp.float32))
    row_ids = ids[:, :, None] * 128 + np.arange(128)[None, None, :]
    want = np.einsum("bd,bjrd->bjr", q, rows[row_ids]).reshape(8, B * 128)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,B", [(10, 16), (5, 12), (10, 4)])
def test_exact2_phase2_rescore_matches_jax(rng, dtype, k, B):
    d, count = 64, 1900
    m = _pad(_normed(rng, count, d), 2048, 128)
    q = _pad(_bf16_round(_normed(rng, 8, d)), 8, 128)
    jemb, temb = _stores(m, dtype)
    jb, _ = jtopk._bucket_maxima_xla(jemb, jnp.asarray(q), jnp.int32(count))
    bvals = np.array(jb)
    eps = jtopk._CERT_EPS
    jv, ji, jc = jtopk._exact2_phase2_rescore(
        jemb, jnp.asarray(q), jnp.int32(count), jnp.asarray(bvals), k=k, B=B,
        use_pallas=False, eps=eps,
    )
    tv, ti, tc = topk._exact2_phase2_rescore(
        temb, torch.from_numpy(q), count, torch.from_numpy(bvals), k=k, B=B, eps=eps
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, BF16_TOL if dtype == "bfloat16" else F32_TOL)


@pytest.mark.parametrize("n_pad,count", [(2048, 2048), (4096, 3000), (1024, 130)])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_exact2_matches_jax(rng, n_pad, count, k):
    d = 64
    m = _pad(_normed(rng, count, d), n_pad, 128)
    q = _pad(_normed(rng, 16, d), 16, 128)
    jv, ji, jc = jtopk.cosine_topk_exact2(jnp.asarray(m), jnp.asarray(q), count, k)
    tv, ti, tc = topk.cosine_topk_exact2(torch.from_numpy(m), torch.from_numpy(q), count, k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tc.all()
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)
    # and against the port's own one-phase route
    ev, ei = topk.cosine_topk(torch.from_numpy(m), torch.from_numpy(q), count, k)
    assert_topk_equivalent(tv, ti, ev, ei, F32_TOL)


@pytest.mark.parametrize("k", [1, 10, 32])
def test_exact2_hybrid_matches_jax(rng, k):
    d, count = 64, 4000
    m = _pad(_normed(rng, count, d), 4096, 128)
    q = _pad(_normed(rng, 8, d), 8, 128)
    jemb = jnp.asarray(m)
    jv, ji, jc = jtopk.cosine_topk_exact2_hybrid(
        jemb, jemb.astype(jnp.bfloat16), jnp.asarray(q), count, k
    )
    temb = torch.from_numpy(m)
    tv, ti, tc = topk.cosine_topk_exact2_hybrid(
        temb, temb.bfloat16(), torch.from_numpy(q), count, k
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)


def test_exact2_adversarial_same_bucket_cluster(rng):
    """All true top-k rows packed into ONE 128-row bucket (the case of
    tests/test_topk_exact2.py::test_exact2_adversarial_same_bucket_cluster)."""
    d, count, k = 64, 2048, 10
    m = _normed(rng, count, d)
    target = _normed(rng, 1, d)[0]
    for j in range(32):
        v = target + 0.01 * rng.standard_normal(d).astype(np.float32)
        m[256 + j] = v / np.linalg.norm(v)
    mp = _pad(m, 2048, 128)
    q = _pad(target.reshape(1, -1), 8, 128)
    jv, ji, jc = jtopk.cosine_topk_exact2(jnp.asarray(mp), jnp.asarray(q), count, k, slack=2)
    tv, ti, tc = topk.cosine_topk_exact2(torch.from_numpy(mp), torch.from_numpy(q), count, k, slack=2)
    assert bool(tc.all()) and bool(np.asarray(jc).all())
    assert set(ti[0].tolist()) == set(np.asarray(ji)[0].tolist())
    assert all(256 <= i < 288 for i in ti[0].tolist())
    hv, hi, hc = topk.cosine_topk_exact2_hybrid(
        torch.from_numpy(mp), torch.from_numpy(mp).bfloat16(), torch.from_numpy(q), count, k
    )
    assert bool(hc.all()) and set(hi[0].tolist()) == set(ti[0].tolist())


def test_exact2_tied_scores_across_buckets(rng):
    d, count, k = 64, 2048, 10
    m = _normed(rng, count, d)
    target = _normed(rng, 1, d)[0]
    dupes = list(range(0, 2048, 128))  # one per bucket, 16 ties
    for i in dupes:
        m[i] = target
    mp = _pad(m, 2048, 128)
    q = _pad(target.reshape(1, -1), 8, 128)
    jv, ji, jc = jtopk.cosine_topk_exact2(jnp.asarray(mp), jnp.asarray(q), count, k, slack=8)
    tv, ti, tc = topk.cosine_topk_exact2(torch.from_numpy(mp), torch.from_numpy(q), count, k, slack=8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=F32_TOL)
    assert set(ti[0].tolist()) <= set(dupes)
    # The one-phase route breaks the tie at the lowest rows.
    ev, ei = topk.cosine_topk(torch.from_numpy(mp), torch.from_numpy(q), count, k)
    assert ei[0].tolist() == dupes[:k]


def test_exact2_small_store_fewer_buckets_than_B(rng):
    d, count, k = 32, 100, 10
    m = _pad(_normed(rng, count, d), 1024, 128)
    q = _pad(_normed(rng, 4, d), 8, 128)
    jv, ji, jc = jtopk.cosine_topk_exact2(jnp.asarray(m), jnp.asarray(q), count, k)
    tv, ti, tc = topk.cosine_topk_exact2(torch.from_numpy(m), torch.from_numpy(q), count, k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_scores_matches_jax(rng, dtype):
    m = _pad(_normed(rng, 900, 40), 1024, 128)
    q = _pad(_bf16_round(_normed(rng, 5, 40)), 8, 128)
    jemb, temb = _stores(m, dtype)
    js = jtopk.cosine_scores(jemb, jnp.asarray(q), 900)
    ts = topk.cosine_scores(temb, torch.from_numpy(q), 900)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=F32_TOL if dtype == "float32" else BF16_TOL)
    assert (ts[:, 900:] == -1.0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 10, 64])
def test_subset_cosine_topk_matches_jax(rng, dtype, k):
    m = _pad(_normed(rng, 900, 40), 1024, 128)
    q = _pad(_bf16_round(_normed(rng, 1, 40)), 8, 128)
    ords = np.zeros(64, np.int32)
    ords[:20] = rng.choice(900, 20, replace=False)
    valid = np.zeros(64, bool)
    valid[:20] = True
    jemb, temb = _stores(m, dtype)
    jv, ji = jtopk.subset_cosine_topk(jemb, jnp.asarray(q), jnp.asarray(ords), jnp.asarray(valid), k)
    tv, ti = topk.subset_cosine_topk(temb, torch.from_numpy(q), torch.from_numpy(ords), torch.from_numpy(valid), k)
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL if dtype == "float32" else BF16_TOL)
    assert set(ti[0][tv[0] >= 0].tolist()) <= set(ords[:20].tolist())


@pytest.mark.parametrize("mode", ["exact1", "exact2", "exact2h"])
def test_topk_many_matches_jax(rng, mode):
    d, count, k = 48, 3000, 10
    m = _pad(_normed(rng, count, d), 4096, 128)
    qs = np.stack([_pad(_normed(rng, 6, d), 8, 128) for _ in range(3)])
    jemb = jnp.asarray(m)
    temb = torch.from_numpy(m)
    jaux = jemb.astype(jnp.bfloat16) if mode == "exact2h" else None
    taux = temb.bfloat16() if mode == "exact2h" else None
    jout = jtopk.topk_many(jemb, jaux, jnp.asarray(qs), jnp.int32(count), k=k, mode=mode, use_pallas=False)
    tout = topk.topk_many(temb, taux, torch.from_numpy(qs), count, k=k, mode=mode)
    assert len(tout) == len(jout)
    for r in range(3):
        assert_topk_equivalent(tout[0][r], tout[1][r], jout[0][r], jout[1][r], F32_TOL)
    if mode != "exact1":
        np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))
        assert tuple(tout[2].shape) == (3, 8)
    # one stacked launch gives what per-batch calls give (real rows; the
    # zero padding rows tie everywhere)
    for r in range(3):
        single = topk.cosine_topk(temb, torch.from_numpy(qs[r]), count, k)
        np.testing.assert_array_equal(tout[1][r][:6].numpy(), single[1][:6].numpy())


@pytest.mark.parametrize("mode", ["approx", "ivf"])
def test_topk_many_unported_modes_name_their_roadmap_item(mode):
    """Every engine mode of the JAX ``topk_many`` is ported: "approx" runs
    (exact K1 route at this size, as JAX's approx_max_k off the TPU); IVF is
    not a ``topk_many`` mode in either package (the store routes it)."""
    emb = torch.zeros((1024, 128))
    qs = torch.zeros((1, 8, 128))
    if mode == "approx":
        vals, idx = topk.topk_many(emb, None, qs, 10, k=5, mode=mode)
        assert tuple(vals.shape) == tuple(idx.shape) == (1, 8, 5)
    else:
        with pytest.raises(ValueError, match="unknown mode"):
            topk.topk_many(emb, None, qs, 10, k=5, mode=mode)


def test_wrappers_refuse_non_cpu_non_cuda_operands():
    """Argument checks of the kernel path run before any build."""
    emb = torch.zeros((1024, 128))
    q = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="no kernel"):
        topk._check_cuda_operands(emb, q)
    with pytest.raises(TypeError):
        topk._store_code(torch.zeros((4, 4), dtype=torch.float16))


def test_launch_counter_is_thread_safe():
    import sys
    import threading

    counter = topk.LaunchCounter("t")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.count == 16 * 2000
    counter.reset()
    assert counter.count == 0
