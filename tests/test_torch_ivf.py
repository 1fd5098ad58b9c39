"""The port's IVF engine (``typeagent_tpu_torch/ops/ivf.py``, the store's
``search_mode="ivf"`` lifecycle and ``parallel/ivf.py``) against the JAX
package's and against an exact numpy oracle.

The port runs its kernels' plain versions (CPU tensors); the JAX package
runs ``ivf_topk(use_pallas=False)``, as its own tests do. The k-means
sample comes from another generator in each package, so parity is held
two ways: the JAX index carried across (``adopt_ivf_state``) must search
the same (scores 1e-6, indices equal except ties, certificates equal),
and the build given the JAX centroids must lay out the same index
(assignment equal except near-ties, identical perm and exile, bucket
summaries within 1e-6). The whole build is held to properties: recall, a
certificate that never lies, every live row in exactly one of the two
permutations, radii that bound their buckets.

How many queries certify depends on the k-means fit: a sample that merges
two topics into one cluster balloons that cluster's radii, in either
package. Tests that need queries to certify build with ``FIT_KEY``, a
k-means seed whose fit separates the fixtures' topics.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu import vectorstore as jvs
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu.ops import ivf as jivf
from typeagent_tpu.parallel import create_mesh
from typeagent_tpu.parallel.sharded import ShardedVectorStore as JaxSharded
from typeagent_tpu_torch import vectorstore as vs_mod
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import ivf, topk
from typeagent_tpu_torch.parallel import CorpusVectorStore, ShardedVectorStore
from typeagent_tpu_torch.parallel.ivf import ShardedIVF
from typeagent_tpu_torch.utils.metrics import METRICS
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

K = 10
F32_TOL = 1e-6
FIT_KEY = 3


def _mk_clustered(rng, n, d, nclust, sigma, bg_frac=0.0):
    centers = rng.standard_normal((nclust, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    emb = centers[rng.integers(0, nclust, n)] + sigma * rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    if bg_frac:
        bg = rng.random(n) < bg_frac
        emb[bg] = rng.standard_normal((int(bg.sum()), d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, centers


def _pad(emb, n_pad):
    buf = np.zeros((n_pad, emb.shape[1]), np.float32)
    buf[: len(emb)] = emb
    return buf


def _unit(a):
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _oracle(q, emb, k=K):
    true = q @ emb.T
    return true, np.argsort(-true, axis=1)[:, :k]


def _recall(idx, oracle):
    k = oracle.shape[1]
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(idx, oracle)])


def _check_invariants(idx, n, k=K):
    assert (idx >= 0).all() and (idx < n).all()
    for row in idx:
        assert len(set(row.tolist())) == k  # no duplicates, no padding


def _build(emb, n_pad, **kw):
    return ivf.ivf_build(torch.from_numpy(_pad(emb, n_pad)), len(emb), **kw)


def _topk(state, q, k=K, B=8):
    return tuple(t.numpy() for t in ivf.ivf_topk(state, q, k, B=B))


def _check_state(state, count):
    """Every live row in exactly one of perm / out_perm; each radius bounds
    its bucket's residuals; the fill counts match the perm."""
    perm, out_perm = state.perm.numpy(), state.out_perm.numpy()
    live = np.concatenate([perm[perm >= 0], out_perm[out_perm >= 0]])
    assert np.array_equal(np.sort(live), np.arange(count))
    assert state.count_in == (perm >= 0).sum() and state.count_out == (out_perm >= 0).sum()
    rows = state.emb_r.float().numpy().reshape(-1, 128, state.emb_r.shape[1])
    valid = (perm >= 0).reshape(-1, 128)
    np.testing.assert_array_equal(state.bucket_fill.numpy(), valid.sum(1))
    resid = np.linalg.norm(rows - state.centroids.numpy()[:, None, :], axis=2)
    radius = state.radius.numpy()
    live_b = valid.any(1)
    assert (radius[~live_b] == ivf._BOUND_DEAD).all()
    assert (np.where(valid, resid, 0).max(1)[live_b] <= radius[live_b] + 1e-6).all()
    # A bucket's dead rows are its tail (validity is a fill-count compare).
    assert all(valid[b, : f].all() and not valid[b, f:].any() for b, f in enumerate(valid.sum(1)))


# ---------------------------------------------------------------------------
# Parity with the JAX package
# ---------------------------------------------------------------------------


def _jax_state_arrays(state):
    return [np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x) for x in state]


@pytest.fixture(scope="module")
def jax_index():
    """A JAX IVF index over a clustered corpus with background rows, f32
    and bf16, with queries (bf16-exact, so both packages score one q)."""
    rng = np.random.default_rng(40)
    n, d = 4000, 64
    emb, centers = _mk_clustered(rng, n, d, 25, 0.25, bg_frac=0.08)
    out = {}
    for dtype in ("float32", "bfloat16"):
        buf = jnp.asarray(_pad(emb, 4096))
        if dtype == "bfloat16":
            buf = buf.astype(jnp.bfloat16)
        out[dtype] = jivf.ivf_build(buf, n, key=3, train_rows=2048, iters=6, outlier_frac=0.12,
                                    rows_per_cluster=128)
    q = np.concatenate([emb[rng.choice(n, 12, replace=False)], centers[:4],
                        rng.standard_normal((4, d)).astype(np.float32)])
    q = torch.from_numpy(_unit(q + 0.05 * rng.standard_normal(q.shape).astype(np.float32))).bfloat16().float().numpy()
    return emb, out, q


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [1, 4, 8, 64])
def test_ivf_topk_on_the_jax_index_matches_jax(jax_index, dtype, B):
    emb, states, q = jax_index
    jstate = states[dtype]
    tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pstate = ivf.adopt_ivf_state(_jax_state_arrays(jstate), "cpu", tdtype)
    assert pstate.n_buckets == jstate.n_buckets and pstate.emb_r.dtype == tdtype
    jv, ji, jc = (np.asarray(x) for x in jivf.ivf_topk(jstate, jnp.asarray(q), K, B=B, use_pallas=False))
    tv, ti, tc = _topk(pstate, q, B=B)
    tol = F32_TOL if dtype == "float32" else 1e-5
    np.testing.assert_allclose(tv, jv, atol=tol)
    for r in range(len(q)):
        kth = jv[r, -1]
        for item, score in zip(ti[r], tv[r]):
            if item not in ji[r]:
                assert abs(score - kth) <= tol
    np.testing.assert_array_equal(tc, jc)
    assert tc.dtype == bool and (B < pstate.n_buckets or tc.all())


def test_build_given_jax_centroids_reproduces_the_jax_index():
    rng = np.random.default_rng(41)
    n, d = 3500, 48
    emb, _ = _mk_clustered(rng, n, d, 20, 0.3, bg_frac=0.05)
    buf = _pad(emb, 4096)
    kw = dict(train_rows=2048, iters=5, rows_per_cluster=128)
    nb = 4096 // 128
    jcent = jivf._train_centroids(jnp.asarray(buf), jnp.int32(n), jax.random.PRNGKey(7),
                                  train_rows=2048, iters=5, nb=nb)
    jstate = jivf.ivf_build(jnp.asarray(buf), n, key=7, outlier_frac=0.1, **kw)
    # Assignment: equal except near-ties of the two best cluster scores.
    ja, js = (np.asarray(x)[:n] for x in jivf._assign_all(jnp.asarray(buf), jcent))
    ta, ts = ivf._chunked_assign(torch.from_numpy(buf[:n]), torch.from_numpy(np.array(jcent)), 1000)
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-6)
    diff = np.nonzero(ta.numpy() != ja)[0]
    cs = torch.from_numpy(buf[:n]).bfloat16().float().numpy() @ np.asarray(jnp.asarray(jcent).astype(jnp.bfloat16).astype(jnp.float32)).T
    for r in diff:
        assert abs(cs[r, ta[r]] - cs[r, ja[r]]) <= 1e-6
    # The post-training build given the same centroids: the same index.
    pstate = ivf.ivf_build_from_centroids(torch.from_numpy(buf), n, torch.from_numpy(np.array(jcent)),
                                          outlier_frac=0.1)
    np.testing.assert_array_equal(pstate.perm.numpy(), np.asarray(jstate.perm))
    np.testing.assert_array_equal(pstate.out_perm.numpy(), np.asarray(jstate.out_perm))
    np.testing.assert_array_equal(pstate.emb_r.numpy(), np.asarray(jstate.emb_r))
    np.testing.assert_array_equal(pstate.out_emb.numpy(), np.asarray(jstate.out_emb))
    np.testing.assert_allclose(pstate.centroids.numpy(), np.asarray(jstate.centroids), atol=1e-6)
    np.testing.assert_allclose(pstate.radius.numpy(), np.asarray(jstate.radius), atol=1e-6)
    np.testing.assert_array_equal(pstate.bucket_fill.numpy(), np.asarray(jstate.bucket_fill))
    assert (pstate.count_in, pstate.count_out) == (int(jstate.count_in), int(jstate.count_out))
    # The host layout alone, fed the JAX assignment, is bit-identical.
    perm, out_perm, n_in, m = ivf._layout(ja.astype(np.int32), js.astype(np.float16), n, nb, 0.1)
    np.testing.assert_array_equal(perm, np.asarray(jstate.perm))
    np.testing.assert_array_equal(out_perm, np.asarray(jstate.out_perm))


def test_store_ivf_route_on_the_jax_index_matches_the_jax_store():
    """The same snapshot in both stores (carried across): the IVF route,
    the appended-suffix route and the many route answer alike."""
    rng = np.random.default_rng(42)
    d = 32
    emb, _ = _mk_clustered(rng, 2600, d, 12, 0.2)
    extra = _unit(emb[:40] + 0.01 * rng.standard_normal((40, d)).astype(np.float32))
    js = jvs.VectorStore(jvs.TextEmbeddingIndexSettings(jax_model(d), min_score=0.0, search_mode="ivf"))
    ps = VectorStore(TextEmbeddingIndexSettings(create_test_embedding_model(d), min_score=0.0,
                                                search_mode="ivf", device="cpu"))
    js.add_embeddings(None, emb)
    ps.add_embeddings(None, emb)
    js.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3)
    ps._flush()
    ps.adopt_ivf(_jax_state_arrays(js._ivf))
    assert ps._ivf_count == js._ivf_count == 2600
    q = torch.from_numpy(emb[rng.choice(2600, 9, replace=False)]).bfloat16().float().numpy()

    def same(a_rows, b_rows):
        for a, b in zip(a_rows, b_rows):
            np.testing.assert_allclose([x.score for x in a], [x.score for x in b], atol=F32_TOL)
            kth = b[-1].score
            assert all(x.item in {y.item for y in b} or abs(x.score - kth) <= F32_TOL for x in a)

    for settings in (js.settings, ps.settings):
        settings.ivf_b = 4
    same(ps.fuzzy_lookup_embeddings_batch(q, max_hits=K), js.fuzzy_lookup_embeddings_batch(q, max_hits=K))
    for s in (js, ps):
        s.add_embeddings(None, extra)
    same(ps.fuzzy_lookup_embeddings_batch(q, max_hits=K), js.fuzzy_lookup_embeddings_batch(q, max_hits=K))
    qs = q[:8].reshape(2, 4, d)
    for a, b in zip(ps.fuzzy_lookup_embeddings_many(qs, max_hits=K), js.fuzzy_lookup_embeddings_many(qs, max_hits=K)):
        same(a, b)


# ---------------------------------------------------------------------------
# The behaviours of tests/test_ivf.py on the port
# ---------------------------------------------------------------------------


def test_ivf_recall_clustered_with_background():
    rng = np.random.default_rng(0)
    n = 4000
    emb, _ = _mk_clustered(rng, n, 64, 25, 0.25, bg_frac=0.08)
    state = _build(emb, 4096, train_rows=2048, iters=6, outlier_frac=0.12, rows_per_cluster=128)
    _check_state(state, n)
    q = _unit(emb[rng.choice(n, 32, replace=False)] + 0.1 * rng.standard_normal((32, 64)).astype(np.float32))
    true, oracle = _oracle(q, emb)
    vals, idx, _cert = _topk(state, q, B=8)
    _check_invariants(idx, n)
    assert _recall(idx, oracle) >= 0.97
    assert (np.diff(vals, axis=1) <= 1e-6).all()  # public scores, descending
    np.testing.assert_allclose(vals[:, 0], np.clip((true.max(axis=1) + 1) / 2, 0, 1), atol=2e-3)


def test_ivf_certificate_sound_and_achievable():
    rng = np.random.default_rng(1)
    n, d, nclust = 4000, 64, 24
    emb, centers = _mk_clustered(rng, n, d, nclust, 0.05)
    state = _build(emb, 4096, key=FIT_KEY, train_rows=2048, iters=6, outlier_frac=0.05, rows_per_cluster=128)
    q = _unit(centers[rng.integers(0, nclust, 24)] + 0.02 * rng.standard_normal((24, d)).astype(np.float32))
    _true, oracle = _oracle(q, emb)
    _vals, idx, cert = _topk(state, q, B=8)
    _check_invariants(idx, n)
    assert cert.mean() >= 0.8
    for i in np.nonzero(cert)[0]:
        assert set(idx[i].tolist()) == set(oracle[i].tolist())


@pytest.mark.parametrize("sigma,bg", [(0.05, 0.0), (0.35, 0.1), (1.0, 1.0)])
def test_ivf_certificate_never_lies(sigma, bg):
    """Across data regimes (down to hostile isotropic), a certified answer
    is the oracle's top-k up to eps ties."""
    rng = np.random.default_rng(2)
    emb, _ = _mk_clustered(rng, 3000, 48, 20, sigma, bg_frac=bg)
    state = _build(emb, 3072, train_rows=1536, iters=4, rows_per_cluster=128)
    _check_state(state, 3000)
    q = emb[rng.choice(3000, 16, replace=False)]
    true, oracle = _oracle(q, emb)
    _vals, idx, cert = _topk(state, q, B=6)
    kth_true = np.sort(true, axis=1)[:, -K]
    for i in np.nonzero(cert)[0]:
        got, want = set(idx[i].tolist()), set(oracle[i].tolist())
        assert (true[i, sorted(got - want)] >= kth_true[i] - 1e-4).all()


def test_ivf_small_store_scans_everything():
    rng = np.random.default_rng(3)
    emb, _ = _mk_clustered(rng, 900, 32, 5, 0.3)
    state = _build(emb, 1024, train_rows=512, iters=3, outlier_frac=0.0)
    q = emb[:8]
    _true, oracle = _oracle(q, emb)
    _vals, idx, cert = _topk(state, q, B=64)
    _check_invariants(idx, 900)
    for i in range(8):
        assert set(idx[i].tolist()) == set(oracle[i].tolist())
    assert cert.all()  # nothing excluded
    assert idx[:, 0].tolist() == list(range(8))


def test_ivf_no_outliers_mode():
    rng = np.random.default_rng(4)
    emb, _ = _mk_clustered(rng, 2000, 32, 12, 0.2)
    state = _build(emb, 2048, train_rows=1024, iters=4, outlier_frac=0.0, rows_per_cluster=128)
    assert state.count_out == 0
    _true, oracle = _oracle(emb[:4], emb)
    _vals, idx, _cert = _topk(state, emb[:4], B=8)
    assert _recall(idx, oracle) >= 0.9


def test_ivf_single_query_convenience():
    rng = np.random.default_rng(5)
    emb, _ = _mk_clustered(rng, 1500, 32, 10, 0.2)
    state = _build(emb, 2048, train_rows=1024, iters=3)
    vals, idx, cert = ivf.ivf_topk(state, emb[7], K, B=8)
    assert tuple(vals.shape) == tuple(idx.shape) == (K,) and cert.dim() == 0
    assert int(idx[0]) == 7


def test_ivf_build_validates_inputs():
    emb = torch.randn((512, 32))
    with pytest.raises(ValueError):
        ivf.ivf_build(emb[:100], 100)  # padding not a multiple of 128
    with pytest.raises(ValueError):
        ivf.ivf_build(emb, 0)
    with pytest.raises(ValueError):
        ivf.ivf_build(emb, 1000)


def test_ivf_state_roundtrips_as_arrays():
    """IVFState is a flat tuple: its nine fields as numpy rebuild it."""
    rng = np.random.default_rng(7)
    emb, _ = _mk_clustered(rng, 1000, 32, 8, 0.2)
    state = _build(emb, 1024, train_rows=512, iters=3)
    state2 = ivf.adopt_ivf_state([np.asarray(x) for x in state], "cpu")
    v1, i1, _ = _topk(state, emb[:4])
    v2, i2, _ = _topk(state2, emb[:4])
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(v1, v2)


def test_ivf_build_is_seeded_and_timed():
    rng = np.random.default_rng(8)
    emb, _ = _mk_clustered(rng, 1200, 32, 8, 0.2)
    a = _build(emb, 1280, key=5, train_rows=512, iters=3, rows_per_cluster=128)
    b = _build(emb, 1280, key=5, train_rows=512, iters=3, rows_per_cluster=128)
    np.testing.assert_array_equal(a.perm.numpy(), b.perm.numpy())
    for phase in ("train", "assign", "layout", "gather", "summaries"):
        assert METRICS.stats(f"ivf.build.{phase}") is not None


def test_gather_rows_chunked_matches_single_shot(monkeypatch):
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.standard_normal((1024, 16)).astype(np.float32))
    perm = rng.permutation(1024).astype(np.int32)
    perm[::7] = -1  # dead padding rows
    want = np.where((perm >= 0)[:, None], emb.numpy()[np.clip(perm, 0, None)], 0)
    monkeypatch.setattr(ivf, "_GATHER_CHUNK", 100)  # ragged final chunk
    np.testing.assert_array_equal(ivf._gather_rows(emb, torch.from_numpy(perm)).numpy(), want)


def test_ivf_topk_program_runs_the_kernel_routes_once(monkeypatch):
    """One search is one K3 rescore of the selected buckets and one exact2
    search (K2 + K3) of the outlier tail, for the whole batch."""
    rng = np.random.default_rng(5)
    emb = _unit(rng.standard_normal((1536, 32)).astype(np.float32))
    state = ivf.ivf_build(torch.from_numpy(emb), 1536, rows_per_cluster=128, train_rows=512, iters=2)
    calls = []
    for name in ("rescore_selected", "bucket_maxima"):
        real = getattr(topk, name)
        monkeypatch.setattr(topk, name, lambda *a, _n=name, _r=real, **k: calls.append(_n) or _r(*a, **k))
    vals, idx, cert = ivf.ivf_topk_program(*state, torch.from_numpy(emb[:3]), 5, B=4)
    assert sorted(calls) == ["bucket_maxima", "rescore_selected", "rescore_selected"]
    assert tuple(vals.shape) == (3, 5) and tuple(cert.shape) == (3,)


def _settings(d, **kw):
    s = TextEmbeddingIndexSettings(create_test_embedding_model(d), min_score=0.0, search_mode="ivf",
                                   device="cpu")
    for key, value in kw.items():
        setattr(s, key, value)
    return s


def test_vectorstore_ivf_mode_with_appends():
    rng = np.random.default_rng(21)
    d = 32
    emb, _ = _mk_clustered(rng, 3000, d, 12, 0.2)
    store = VectorStore(_settings(d))
    assert (store.settings.ivf_b, store.settings.ivf_outlier_frac, store.settings.ivf_certified,
            store.settings.ivf_rebuild_frac, store.settings.ivf_auto_rebuild) == (16, 0.1, False, 0.25, False)
    store.add_embeddings(None, emb)
    pre = store.fuzzy_lookup_embedding(emb[5], max_hits=5)
    assert pre[0].item == 5  # the exact route until a snapshot exists
    store.build_ivf(rows_per_cluster=128, train_rows=2048, iters=4)
    post = store.fuzzy_lookup_embedding(emb[5], max_hits=5)
    assert post[0].item == 5 and {s.item for s in pre} == {s.item for s in post}
    new = _unit(emb[5:6] + 0.01 * rng.standard_normal((1, d)).astype(np.float32))
    store.add_embeddings(None, new)
    assert 3000 in [s.item for s in store.fuzzy_lookup_embedding(emb[5], max_hits=3)]
    hits = store.fuzzy_lookup_embeddings_batch(emb[:4], max_hits=3)
    assert [h[0].item for h in hits] == [0, 1, 2, 3]
    store.clear()  # the snapshot indexed the cleared rows
    assert store._ivf is None and store._ivf_count == 0


def test_vectorstore_ivf_certified_rerun_is_exact():
    rng = np.random.default_rng(22)
    d = 32
    emb = _unit(rng.standard_normal((2500, d)).astype(np.float32))  # hostile: isotropic
    store = VectorStore(_settings(d, ivf_certified=True, ivf_b=4))
    store.add_embeddings(None, emb)
    store.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3)
    q = emb[rng.choice(2500, 8, replace=False)]
    _true, oracle = _oracle(q, emb, 5)
    for row, want in zip(store.fuzzy_lookup_embeddings_batch(q, max_hits=5), oracle):
        assert {s.item for s in row} == set(want.tolist())


def test_build_ivf_refuses_int8_and_is_a_noop_when_empty():
    store = VectorStore(TextEmbeddingIndexSettings(create_test_embedding_model(16), dtype="int8", device="cpu"))
    with pytest.raises(ValueError):
        store.build_ivf()
    empty = VectorStore(_settings(16))
    empty.build_ivf()
    assert empty._ivf is None


def _mk_topic_rows(rng, centers, n, d):
    e = centers[rng.integers(0, len(centers), n)] + 0.2 * rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    return _unit(e)


def test_vectorstore_ivf_background_rebuild_and_pin():
    rng = np.random.default_rng(31)
    d = 32
    centers = _unit(rng.standard_normal((10, d)).astype(np.float32))
    emb = _mk_topic_rows(rng, centers, 2500, d)
    store = VectorStore(_settings(d))
    store.add_embeddings(None, emb)
    store.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3)
    assert store._ivf_count == 2500
    # Append THROUGH a pin: the flush writes a copy, so the pinned tensor
    # stays exactly what was captured (its rows past the count stay zero).
    with store._pinned_view() as (buf, count):
        assert count == 2500
        before = buf.clone()
        extra = _mk_topic_rows(rng, centers, 600, d)
        store.add_embeddings(None, extra)
        hit = store.fuzzy_lookup_embedding(emb[7], max_hits=3)
        assert hit[0].item == 7 and store._count == 3100
        assert store._buf is not buf and torch.equal(buf, before)
        copy = store._buf
        store.add_embeddings(None, extra[:2])  # the copy is not pinned: written in place
        store._flush()
        assert store._buf is copy
    assert store._pinned_bufs == []
    t = store.build_ivf_background(rows_per_cluster=128, train_rows=1024, iters=3)
    assert t is not None
    t.join(timeout=120)
    assert not t.is_alive() and store._ivf_count == 3102
    allemb = np.concatenate([emb, extra, extra[:2]])
    q = allemb[2700]
    assert store.fuzzy_lookup_embedding(q, max_hits=1)[0].item == int(np.argmax(allemb[:3100] @ q))


def test_vectorstore_ivf_auto_rebuild_policy():
    rng = np.random.default_rng(33)
    d = 32
    centers = _unit(rng.standard_normal((8, d)).astype(np.float32))
    emb = _mk_topic_rows(rng, centers, 2000, d)
    store = VectorStore(_settings(d, ivf_auto_rebuild=True, ivf_rebuild_frac=0.2))
    store.add_embeddings(None, emb)
    store.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3)
    store.add_embeddings(None, _mk_topic_rows(rng, centers, 100, d))
    store.fuzzy_lookup_embedding(emb[0], max_hits=3)
    t = store._ivf_rebuild_thread
    assert t is None and store._ivf_count == 2000  # below the threshold
    store.add_embeddings(None, _mk_topic_rows(rng, centers, 500, d))
    store.fuzzy_lookup_embedding(emb[0], max_hits=3)  # 600 > 0.2 * 2000
    t = store._ivf_rebuild_thread
    assert t is not None
    t.join(timeout=120)
    deadline = time.time() + 5
    while store._ivf_count != 2600 and time.time() < deadline:
        time.sleep(0.01)
    assert store._ivf_count == 2600
    assert store.fuzzy_lookup_embedding(emb[123], max_hits=1)[0].item == 123


def test_vectorstore_ivf_append_route_merges_the_suffix(monkeypatch):
    """Rows appended after the snapshot ride one interval scan (K4) merged
    with the snapshot search, and are found exactly."""
    rng = np.random.default_rng(6)
    emb = _unit(rng.standard_normal((1536, 32)).astype(np.float32))
    store = VectorStore(_settings(32))
    store.add_embeddings(None, emb)
    store.build_ivf(rows_per_cluster=128, train_rows=512, iters=2)
    extra = _unit(rng.standard_normal((200, 32)).astype(np.float32))
    store.add_embeddings(None, extra)
    calls = []
    real = vs_mod._ivf_suffix_merged
    monkeypatch.setattr(vs_mod, "_ivf_suffix_merged", lambda *a, **k: calls.append(1) or real(*a, **k))
    real_iv = topk.fused_topk_iv
    monkeypatch.setattr(topk, "fused_topk_iv", lambda *a: calls.append("K4") or real_iv(*a))
    got = store.fuzzy_lookup_embeddings_batch(emb[:4], max_hits=3)
    assert calls == [1, "K4"]
    assert store.fuzzy_lookup_embedding(extra[10], max_hits=1)[0].item == 1536 + 10
    assert len(got) == 4 and all(len(r) == 3 for r in got)


def _spy(store, name, log):
    """Record the padded query-row count of each call of a store method."""
    orig = getattr(store, name)

    def wrapper(q, *args, **kwargs):
        log.append(int(q.shape[0]))
        return orig(q, *args, **kwargs)

    setattr(store, name, wrapper)


def _force_misses(store, n: int):
    """The first ``n`` real rows of every certified dispatch read as
    certificate misses (small fixtures certify naturally); the resolver
    then runs for real, so results stay oracle-exact."""
    orig = store._resolve_cert_misses

    def forcing(vals, idx, cert_h, q, k, count, n_rows, n_queries):
        cert_h = np.array(cert_h)
        cert_h[: min(n, n_rows)] = False
        return orig(vals, idx, cert_h, q, k, count, n_rows, n_queries)

    store._resolve_cert_misses = forcing


def _certified_store(rng, d, n, nclust, sigma, ivf_b=8):
    emb, centers = _mk_clustered(rng, n, d, nclust, sigma)
    store = VectorStore(_settings(d, ivf_certified=True, ivf_b=ivf_b))
    store.add_embeddings(None, emb)
    store.build_ivf(key=FIT_KEY, rows_per_cluster=128, train_rows=2048, iters=6, outlier_frac=0.05)
    return store, emb, centers


def _assert_oracle_sets(hits, q, emb, k=5):
    """Every answer is the exact top-k up to ties within f32 summation
    noise (1e-6 in raw cosine)."""
    true, oracle = _oracle(q, emb, k)
    for r, (row, want) in enumerate(zip(hits, oracle)):
        got = {s.item for s in row}
        assert len(got) == k
        extra = sorted(got - set(want.tolist()))
        assert (true[r, extra] >= true[r, want[-1]] - 1e-6).all(), (r, sorted(got), sorted(want))


def test_ivf_certified_padded_batch_never_full_reruns():
    rng = np.random.default_rng(7)
    store, emb, centers = _certified_store(rng, 64, 4000, 24, 0.05)
    exact_calls, esc_calls = [], []
    _spy(store, "_rerun_exact1", exact_calls)
    _spy(store, "_rerun_ivf", esc_calls)
    q = _unit(centers[rng.integers(0, 24, 13)] + 0.02 * rng.standard_normal((13, 64)).astype(np.float32))
    _assert_oracle_sets(store.fuzzy_lookup_embeddings_batch(q, max_hits=5), q, emb)
    assert exact_calls == [] and esc_calls == []


def test_ivf_certified_escalates_only_the_missed_queries(monkeypatch):
    monkeypatch.setattr(vs_mod, "_ESCALATE_MIN_ROWS", 0)
    rng = np.random.default_rng(8)
    store, emb, _ = _certified_store(rng, 64, 4000, 16, 0.02)
    exact_calls, esc_calls = [], []
    _spy(store, "_rerun_exact1", exact_calls)
    _spy(store, "_rerun_ivf", esc_calls)
    q = _unit(np.concatenate([emb[rng.choice(4000, 24, replace=False)],
                              rng.standard_normal((8, 64)).astype(np.float32)]))
    hits = store.fuzzy_lookup_embeddings_batch(q, max_hits=5)
    true = q @ emb.T
    for row, want in zip(hits, np.sort(true, axis=1)[:, ::-1][:, :5]):
        np.testing.assert_allclose([s.score for s in row], np.clip((want + 1) / 2, 0, 1), atol=1e-5)
    assert esc_calls, "expected at least one escalated IVF pass"
    assert all(p < 32 for p in exact_calls + esc_calls), (exact_calls, esc_calls)


def test_ivf_certified_async_collect_resolves_per_query():
    rng = np.random.default_rng(9)
    d = 48
    emb, _ = _mk_clustered(rng, 3000, d, 20, 0.05)
    store = VectorStore(_settings(d, ivf_certified=True, ivf_b=4))
    store.add_embeddings(None, emb)
    store.build_ivf(key=FIT_KEY, rows_per_cluster=128, train_rows=1024, iters=4)
    exact_calls = []
    _spy(store, "_rerun_exact1", exact_calls)
    q = _unit(np.concatenate([emb[rng.choice(3000, 10, replace=False)],
                              rng.standard_normal((3, d)).astype(np.float32)]))
    hits = store.collect_lookup(store.dispatch_lookup(q, max_hits=5))
    _assert_oracle_sets(hits, q, emb)
    assert all(p < 16 for p in exact_calls), exact_calls


def test_ivf_rides_the_coalesced_many_route(monkeypatch):
    rng = np.random.default_rng(12)
    d = 64
    emb, _ = _mk_clustered(rng, 4000, d, 16, 0.02)
    store = VectorStore(_settings(d, ivf_b=8))
    store.add_embeddings(None, emb)
    store.build_ivf(rows_per_cluster=128, train_rows=2048, iters=6, outlier_frac=0.05)

    def boom(*a, **k):
        raise AssertionError("topk_many full scan used for an IVF store")

    monkeypatch.setattr(topk, "topk_many", boom)
    qs = emb[rng.choice(4000, 21, replace=False)].reshape(3, 7, d)
    got = store.fuzzy_lookup_embeddings_many(qs, max_hits=5)
    assert len(got) == 3 and all(len(r) == 7 for r in got)
    assert all(hits[0].score > 0.999 for r in got for hits in r)
    store.settings.ivf_certified = True
    got = store.fuzzy_lookup_embeddings_many(qs, max_hits=5)
    _assert_oracle_sets([h for r in got for h in r], qs.reshape(-1, d), emb)
    store.settings.ivf_certified = False
    new = _unit(emb[100:101] + 0.001 * rng.standard_normal((1, d)).astype(np.float32))
    store.add_embeddings(None, new)
    got = store.fuzzy_lookup_embeddings_many(emb[100][None, None, :], max_hits=3)
    assert 4000 in [s.item for s in got[0][0]]


def test_ivf_escalation_ema_learns_to_skip_unyielding_escalation(monkeypatch):
    monkeypatch.setattr(vs_mod, "_ESCALATE_MIN_ROWS", 0)
    rng = np.random.default_rng(21)
    store, emb, _ = _certified_store(rng, 64, 4000, 16, 0.02)
    _force_misses(store, 4)
    esc_calls = []
    orig_rerun = store._rerun_ivf

    def unyielding(q, *args):
        esc_calls.append(int(q.shape[0]))
        out = orig_rerun(q, *args)
        if out is None:
            return None
        v, i, c = out
        return v, i, np.zeros_like(c)  # the pass certifies nothing

    store._rerun_ivf = unyielding
    q = emb[rng.choice(4000, 16, replace=False)]

    def check():
        _assert_oracle_sets(store.fuzzy_lookup_embeddings_batch(q, max_hits=5), q, emb)

    check()
    assert len(esc_calls) == 1 and store._esc_ema == 0.0
    check()
    assert len(esc_calls) == 1, "the EMA should have turned escalation off"
    store.build_ivf(key=FIT_KEY, rows_per_cluster=128, train_rows=2048, iters=6, outlier_frac=0.05)
    assert store._esc_ema is None  # new buckets: the yield is re-learned
    check()
    assert len(esc_calls) == 2


def test_ivf_escalation_ema_keeps_yielding_escalation(monkeypatch):
    monkeypatch.setattr(vs_mod, "_ESCALATE_MIN_ROWS", 0)
    rng = np.random.default_rng(22)
    store, emb, _ = _certified_store(rng, 64, 4000, 16, 0.02)
    _force_misses(store, 4)
    esc_calls, exact_calls = [], []
    _spy(store, "_rerun_ivf", esc_calls)
    _spy(store, "_rerun_exact1", exact_calls)
    q = emb[rng.choice(4000, 16, replace=False)]
    for _ in range(2):
        _assert_oracle_sets(store.fuzzy_lookup_embeddings_batch(q, max_hits=5), q, emb)
    assert len(esc_calls) == 2, (esc_calls, exact_calls)
    assert store._esc_ema is not None and store._esc_ema >= 0.5


def test_ivf_escalation_ema_ignores_a_swapped_snapshot(monkeypatch):
    """A rebuild that swaps in new buckets while an escalation runs: the
    yield it learned belongs to the old snapshot and is not kept, and the
    answer is still exact (the pass refuses; the exact rerun serves)."""
    monkeypatch.setattr(vs_mod, "_ESCALATE_MIN_ROWS", 0)
    rng = np.random.default_rng(23)
    store, emb, _ = _certified_store(rng, 64, 4000, 16, 0.02)
    _force_misses(store, 4)
    orig_rerun = store._rerun_ivf
    results = []

    def swap_then_rerun(q, k, count, B, state):
        fresh = store._ivf._replace()  # a new snapshot object over the same rows
        with store._flush_lock:
            store._ivf = fresh
        results.append(orig_rerun(q, k, count, B, state))
        return results[-1]

    store._rerun_ivf = swap_then_rerun
    q = emb[rng.choice(4000, 16, replace=False)]
    _assert_oracle_sets(store.fuzzy_lookup_embeddings_batch(q, max_hits=5), q, emb)
    assert results == [None] and store._esc_ema is None


def test_escalation_gate_counts_real_queries_not_padding(monkeypatch):
    """Many route, R=3 batches of b=5 (padded to 8): 9 misses of the 15
    real queries is more than half, so no escalation (counting the 24
    padded slots, 2 * 9 <= 24 would have escalated)."""
    monkeypatch.setattr(vs_mod, "_ESCALATE_MIN_ROWS", 0)
    rng = np.random.default_rng(24)
    store, emb, _ = _certified_store(rng, 64, 4000, 16, 0.02)
    orig = store._resolve_cert_misses
    seen = []

    def forcing(vals, idx, cert_h, q, k, count, n_rows, n_queries):
        cert_h = np.array(cert_h)
        real = np.flatnonzero(np.arange(n_rows) % 8 < 5)
        cert_h[real[:9]] = False
        seen.append((n_rows, n_queries))
        return orig(vals, idx, cert_h, q, k, count, n_rows, n_queries)

    store._resolve_cert_misses = forcing
    esc_calls = []
    _spy(store, "_rerun_ivf", esc_calls)
    qs = emb[rng.choice(4000, 15, replace=False)].reshape(3, 5, 64)
    got = store.fuzzy_lookup_embeddings_many(qs, max_hits=5)
    _assert_oracle_sets([h for r in got for h in r], qs.reshape(-1, 64), emb)
    assert seen == [(24, 15)] and esc_calls == []


def test_warm_serving_runs_the_certificate_miss_routes():
    rng = np.random.default_rng(25)
    store, _emb, _ = _certified_store(rng, 32, 2000, 8, 0.1)
    store.settings.ivf_certified = False  # the warm lookups then resolve nothing
    esc_calls, exact_calls = [], []
    _spy(store, "_rerun_ivf", esc_calls)
    _spy(store, "_rerun_exact1", exact_calls)
    assert store.warm_serving(max_batch=16) == 2
    assert esc_calls == [8] and exact_calls == [8]


def test_concurrent_lookups_during_a_background_rebuild():
    """Serving threads and appends race a background rebuild: every answer
    is a live row scored as that row scores, and the swap lands."""
    import sys

    rng = np.random.default_rng(26)
    d = 32
    centers = _unit(rng.standard_normal((8, d)).astype(np.float32))
    rows = _mk_topic_rows(rng, centers, 4000, d)
    store = VectorStore(_settings(d))
    store.add_embeddings(None, rows[:2500])
    store.build_ivf(rows_per_cluster=128, train_rows=1024, iters=2)
    q = rows[:4]
    errors = []

    def reader():
        try:
            for _ in range(10):
                for r, row in enumerate(store.fuzzy_lookup_embeddings_batch(q, max_hits=5)):
                    for hit in row:
                        assert abs(hit.score - vs_mod.cosine_to_score(float(rows[hit.item] @ q[r]))) <= 1e-5
        except Exception as exc:  # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        rebuild = store.build_ivf_background(rows_per_cluster=128, train_rows=1024, iters=2)
        for start in range(2500, 4000, 300):
            store.add_embeddings(None, rows[start : start + 300])
        for t in threads + [rebuild]:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads + [rebuild])
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    assert store._ivf_count >= 2500 and store._pinned_bufs == []


# ---------------------------------------------------------------------------
# Sharded and corpus IVF
# ---------------------------------------------------------------------------


def test_sharded_ivf_on_the_jax_index_matches_jax():
    """The 1-shard JAX mesh's per-shard index carried across: the same
    answers and certificates, the appended suffix merged alike."""
    rng = np.random.default_rng(50)
    d = 32
    emb, _ = _mk_clustered(rng, 2600, d, 12, 0.1)
    extra = _unit(emb[:30] + 0.01 * rng.standard_normal((30, d)).astype(np.float32))
    ref = JaxSharded(create_mesh(n_shard=1, n_dp=1, devices=jax.devices()[:1]), d, search_mode="ivf", ivf_b=4)
    port = ShardedVectorStore(d, search_mode="ivf", ivf_b=4, device="cpu")
    for s in (ref, port):
        s.append(emb)
    ref.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3, outlier_frac=0.05)
    port._flush()
    state = ivf.adopt_ivf_state(_jax_state_arrays(ref._ivf.device_arrays), "cpu")
    port._ivf = ShardedIVF(((state,),), ref._ivf.local_n, ref._ivf.built_count)
    q = torch.from_numpy(emb[rng.choice(2600, 8, replace=False)]).bfloat16().float().numpy()
    for stage in ("snapshot", "suffix"):
        if stage == "suffix":
            for s in (ref, port):
                s.append(extra)
        (got, gc), (want, wc) = port.search_ivf(q, k=5), ref.search_ivf(q, k=5)
        assert gc == wc
        for a, b in zip(got, want):
            np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=F32_TOL)
            kth = b[-1][1]
            assert all(i in {j for j, _ in b} or abs(s - kth) <= F32_TOL for i, s in a)
        assert port.search(q, k=5) == got


def test_sharded_ivf_build_search_and_certificates():
    rng = np.random.default_rng(51)
    d = 48
    emb, centers = _mk_clustered(rng, 3000, d, 16, 0.05)
    store = ShardedVectorStore(d, search_mode="ivf", ivf_b=6, device="cpu")
    store.append(emb)
    with pytest.raises(RuntimeError):
        store.search_ivf(emb[:2], k=5)  # no snapshot yet
    pre = store.search(emb[:4], k=5)  # exact until a build
    store.build_ivf(rows_per_cluster=128, train_rows=2048, iters=4, outlier_frac=0.05)
    assert store._ivf.built_count == 3000 and len(store._ivf.states) == len(store._ivf.states[0]) == 1
    _check_state(store._ivf.states[0][0], 3000)
    assert [r[0][0] for r in store.search(emb[:4], k=5)] == [r[0][0] for r in pre] == [0, 1, 2, 3]
    q = _unit(centers[rng.integers(0, 16, 12)] + 0.02 * rng.standard_normal((12, d)).astype(np.float32))
    res, certs = store.search_ivf(q, k=5)
    _true, oracle = _oracle(q, emb, 5)
    assert np.mean(certs) >= 0.5
    for row, c, want in zip(res, certs, oracle):
        if c:
            assert {i for i, _ in row} == set(want.tolist())
    assert all(s >= 0.9 for row in store.search_ivf(q, k=5, min_score=0.9)[0] for _, s in row)
    store.clear()
    assert store._ivf is None
    with pytest.raises(ValueError):
        ShardedVectorStore(d, dtype="int8", search_mode="ivf", device="cpu")


def test_corpus_ivf_global_rides_the_snapshot_scoped_stays_exact(monkeypatch):
    rng = np.random.default_rng(52)
    d = 32
    centers = _unit(rng.standard_normal((6, d)).astype(np.float32))
    corpus = CorpusVectorStore(d, device="cpu", search_mode="ivf")
    exact = CorpusVectorStore(d, device="cpu")
    for _ in range(4):
        for name in ("podcast", "mailbox", "wiki"):
            rows = _mk_topic_rows(rng, centers, 200, d)
            corpus.append(name, rows)
            exact.append(name, rows)
    corpus.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3)
    from typeagent_tpu_torch.parallel import ivf as pivf

    calls = []
    real = pivf.sharded_ivf_search_dispatch
    monkeypatch.setattr(pivf, "sharded_ivf_search_dispatch", lambda *a: calls.append(1) or real(*a))
    q = corpus._store.get_rows(0, 2400)[rng.choice(2400, 6, replace=False)]
    glob = corpus.search(q, k=5)
    assert calls == [1]
    assert all(row[0].score > 0.999 for row in glob)
    scoped = corpus.search(q, k=5, conversations=["wiki"])
    assert calls == [1]  # scoped searches never take the snapshot
    want = exact.search(q, k=5, conversations=["wiki"])
    assert [[(h.conversation, h.local_ordinal) for h in r] for r in scoped] == \
        [[(h.conversation, h.local_ordinal) for h in r] for r in want]
