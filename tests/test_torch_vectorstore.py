"""Parity: the port's VectorStore (typeagent_tpu_torch/vectorstore.py)
against the JAX package's, on the same seeded rows and queries.

The port runs with ``device="cpu"`` (its kernels' plain versions); the JAX
store runs on the CPU as its own tests run it. Scores must agree within
1e-6 (f32) or 1e-5 (bf16 stores); items must agree except where scores
tie.
"""

import asyncio
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu import vectorstore as jvs
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu_torch import vectorstore as vs_mod
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

F32_TOL = 1e-6
BF16_TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _normed(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def port_store(d, **kw):
    kw.setdefault("min_score", 0.0)
    return VectorStore(
        TextEmbeddingIndexSettings(embedding_model=create_test_embedding_model(d), device="cpu", **kw)
    )


def jax_store(d, **kw):
    kw.setdefault("min_score", 0.0)
    return jvs.VectorStore(jvs.TextEmbeddingIndexSettings(embedding_model=jax_model(d), **kw))


def assert_rows_match(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        sa = np.array([x.score for x in a])
        sb = np.array([x.score for x in b])
        np.testing.assert_allclose(sa, sb, atol=tol)
        ia, ib = [x.item for x in a], [x.item for x in b]
        kth = sb.min() if sb.size else 0.0
        for item, score in zip(ia, sa):
            if item not in ib:
                assert abs(score - kth) <= tol, (item, score, kth)
        assert len(set(ia)) == len(ia)


@pytest.mark.parametrize(
    "mode,dtype",
    [("exact1", "float32"), ("exact2", "float32"), ("exact1", "bfloat16"), ("exact2", "bfloat16")],
)
def test_batch_lookup_matches_jax_store(rng, mode, dtype):
    d = 48
    m = _normed(rng, 3000, d)
    q = _normed(rng, 7, d)
    if dtype == "bfloat16":
        q = _bf16_round(q)
    ps, js = port_store(d, search_mode=mode, dtype=dtype), jax_store(d, search_mode=mode, dtype=dtype)
    for s in (ps, js):
        s.add_embeddings(None, m[:1700])
        s.add_embeddings(None, m[1700:])  # growth path
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for max_hits, min_score in ((10, 0.0), (3, 0.55), (40, 0.0)):
        assert_rows_match(
            ps.fuzzy_lookup_embeddings_batch(q, max_hits=max_hits, min_score=min_score),
            js.fuzzy_lookup_embeddings_batch(q, max_hits=max_hits, min_score=min_score),
            tol,
        )
    if mode == "exact2" and dtype == "float32":
        assert ps._shadow_cache is not None  # the hybrid route ran


def test_exact_mode_routes_by_row_count(rng, monkeypatch):
    store = port_store(8)
    store._count = vs_mod.EXACT2_MIN_ROWS - 1
    assert not store._use_exact2(10)
    store._count = vs_mod.EXACT2_MIN_ROWS
    assert store._use_exact2(10)
    assert not store._use_exact2(50)  # beyond the fused kernel's k
    store.settings.search_mode = "exact1"
    assert not store._use_exact2(10)
    assert vs_mod.EXACT2_MIN_ROWS == jvs.EXACT2_MIN_ROWS


def test_auto_exact2_route_matches_jax(rng, monkeypatch):
    d = 48
    m = _normed(rng, 2500, d)
    q = _normed(rng, 9, d)
    monkeypatch.setattr(vs_mod, "EXACT2_MIN_ROWS", 1000)
    monkeypatch.setattr(jvs, "EXACT2_MIN_ROWS", 1000)
    ps, js = port_store(d), jax_store(d)
    for s in (ps, js):
        s.add_embeddings(None, m)
    calls = []
    real = topk.cosine_topk_exact2_hybrid
    monkeypatch.setattr(vs_mod.topk, "cosine_topk_exact2_hybrid", lambda *a, **k: calls.append(1) or real(*a, **k))
    assert_rows_match(
        ps.fuzzy_lookup_embeddings_batch(q, max_hits=10),
        js.fuzzy_lookup_embeddings_batch(q, max_hits=10),
        F32_TOL,
    )
    assert calls  # exact2h took the lookup


def test_shadow_cache_follows_appends_and_growth(rng):
    d = 32
    s = port_store(d, search_mode="exact2")
    s.add_embeddings(None, _normed(rng, 900, d))
    q = _normed(rng, 2, d)
    s.fuzzy_lookup_embeddings_batch(q, max_hits=3)
    key = s._shadow_cache[0]
    s.add_embeddings(None, _normed(rng, 10, d))
    s.fuzzy_lookup_embeddings_batch(q, max_hits=3)
    assert s._shadow_cache[0] != key
    s.add_embeddings(None, _normed(rng, 2000, d))  # forces growth
    s._flush()
    assert s._shadow_cache is None
    s.fuzzy_lookup_embeddings_batch(q, max_hits=3)
    assert s._shadow_cache[1].shape == s._buf.shape


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forced_certificate_miss_reruns_exact1(rng, monkeypatch, dtype):
    """A failed certificate reruns the one-phase route for the missed
    queries only (the case of tests/test_topk_exact2.py
    ::test_vectorstore_exact2_cert_fallback)."""
    d = 48
    m = _normed(rng, 2000, d)
    q = _normed(rng, 3, d)
    store = port_store(d, search_mode="exact2", dtype=dtype)
    store.add_embeddings(None, m)
    expected = store.fuzzy_lookup_embeddings_batch(q, max_hits=5)
    name = "cosine_topk_exact2" if dtype == "bfloat16" else "cosine_topk_exact2_hybrid"
    real = getattr(topk, name)
    calls = {"route": 0, "rerun": 0}

    def broken_cert(*args, **kwargs):
        calls["route"] += 1
        vals, idx, cert = real(*args, **kwargs)
        cert = cert.clone()
        cert[1] = False  # one real query misses
        return torch.zeros_like(vals), torch.full_like(idx, -1), cert

    real_rerun = store._rerun_exact1

    def counting_rerun(q_sub, k, count):
        calls["rerun"] += 1
        assert q_sub.shape[0] == 8  # one miss, padded to the smallest bucket
        return real_rerun(q_sub, k, count)

    monkeypatch.setattr(vs_mod.topk, name, broken_cert)
    monkeypatch.setattr(store, "_rerun_exact1", counting_rerun)
    got = store.fuzzy_lookup_embeddings_batch(q, max_hits=5)
    assert calls == {"route": 1, "rerun": 1}
    assert [s.item for s in got[1]] == [s.item for s in expected[1]]
    assert got[0] == [] and got[2] == []  # certified rows kept as returned


def test_dispatch_collect_matches_sync_and_reruns_misses(rng, monkeypatch):
    d = 48
    m = _normed(rng, 3000, d)
    q = _normed(rng, 5, d)
    js = jax_store(d)
    js.add_embeddings(None, m)
    for dtype in ("float32", "bfloat16"):
        store = port_store(d, dtype=dtype)
        store.add_embeddings(None, m)
        store._flush()
        monkeypatch.setattr(vs_mod, "EXACT2_MIN_ROWS", 100)  # force exact2
        handle = store.dispatch_lookup(q, max_hits=8)
        assert len(handle) == 7  # certificate deferred to collect
        got = store.collect_lookup(handle, min_score=0.2)
        expected = store.fuzzy_lookup_embeddings_batch(q, max_hits=8, min_score=0.2)
        assert got == expected
        vals, idx, b, cert, qp, k, snap = store.dispatch_lookup(q, max_hits=8)
        redo = store.collect_lookup((vals, idx, b, torch.zeros_like(cert), qp, k, snap), min_score=0.2)
        assert [[s.item for s in r] for r in redo] == [[s.item for s in r] for r in expected]
        monkeypatch.setattr(vs_mod, "EXACT2_MIN_ROWS", jvs.EXACT2_MIN_ROWS)
        one = store.dispatch_lookup(q, max_hits=8)
        assert len(one) == 3
        if dtype == "float32":
            assert_rows_match(
                store.collect_lookup(one), js.collect_lookup(js.dispatch_lookup(q, max_hits=8)), F32_TOL
            )
    assert store.collect_lookup(None) == []


@pytest.mark.parametrize("mode", ["exact1", "exact2"])
def test_lookup_many_matches_jax_and_per_batch(rng, mode):
    d = 48
    m = _normed(rng, 800, d)
    ps, js = port_store(d, search_mode=mode), jax_store(d, search_mode=mode)
    for s in (ps, js):
        s.add_embeddings(None, m)
    batches = np.stack([_normed(rng, 6, d) for _ in range(4)])
    many = ps.fuzzy_lookup_embeddings_many(batches, max_hits=5, min_score=0.3)
    jmany = js.fuzzy_lookup_embeddings_many(batches, max_hits=5, min_score=0.3)
    assert len(many) == 4 and all(len(rows) == 6 for rows in many)
    for i in range(4):
        assert_rows_match(many[i], jmany[i], F32_TOL)
        single = ps.fuzzy_lookup_embeddings_batch(batches[i], max_hits=5, min_score=0.3)
        assert [[s.item for s in r] for r in many[i]] == [[s.item for s in r] for r in single]


def test_lookup_many_empty_and_shape_checks(rng):
    d = 16
    store = port_store(d)
    assert store.fuzzy_lookup_embeddings_many(np.zeros((2, 3, d))) == [[[], [], []], [[], [], []]]
    store.add_embeddings(None, _normed(rng, 10, d))
    with pytest.raises(ValueError, match=r"\[R, b, d\]"):
        store.fuzzy_lookup_embeddings_many(np.zeros((3, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_subset_lookup_matches_jax(rng, dtype):
    d = 40
    m = _normed(rng, 600, d)
    ps, js = port_store(d, dtype=dtype), jax_store(d, dtype=dtype)
    for s in (ps, js):
        s.add_embeddings(None, m)
    q = _bf16_round(_normed(rng, 1, d)[0])
    subset = rng.choice(600, 30, replace=False).tolist()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    got = ps.fuzzy_lookup_embedding_in_subset(q, subset, max_hits=7, min_score=0.4)
    want = js.fuzzy_lookup_embedding_in_subset(q, subset, max_hits=7, min_score=0.4)
    assert_rows_match([got], [want], tol)
    assert all(x.item in subset for x in got)
    got_async = asyncio.run(ps.fuzzy_lookup_embedding_in_subset_async(q, subset, max_hits=7, min_score=0.4))
    assert got_async == got
    assert ps.fuzzy_lookup_embedding_in_subset(q, [], max_hits=3) == []


def test_fuzzy_lookup_by_key_matches_jax():
    d = 24
    keys = [f"term {i}" for i in range(300)]

    async def run(store):
        await store.add_keys(keys)
        await store.add_key("one more")
        return await store.fuzzy_lookup("term 17", max_hits=5), await store.fuzzy_lookup(
            "term 17", max_hits=5, predicate=lambda i: i % 2 == 0
        )

    p_hits, p_pred = asyncio.run(run(port_store(d)))
    j_hits, j_pred = asyncio.run(run(jax_store(d)))
    assert p_hits[0].item == 17 and p_hits[0].score == pytest.approx(1.0, abs=1e-6)
    assert_rows_match([p_hits], [j_hits], F32_TOL)
    assert_rows_match([p_pred], [j_pred], F32_TOL)
    assert all(x.item % 2 == 0 for x in p_pred)


def test_serialize_from_jax_store_answers_identically(rng):
    """The JAX store's serialize() output moves into the port unchanged."""
    d = 48
    js = jax_store(d)
    js.add_embeddings(None, _normed(rng, 1500, d))
    js.add_embedding(None, _normed(rng, 1, d)[0])
    data = js.serialize()
    ps = port_store(d)
    ps.deserialize(data)
    assert len(ps) == len(js) == 1501
    q = _normed(rng, 6, d)
    assert_rows_match(
        ps.fuzzy_lookup_embeddings_batch(q, max_hits=10),
        js.fuzzy_lookup_embeddings_batch(q, max_hits=10),
        F32_TOL,
    )
    np.testing.assert_array_equal(ps.serialize(), data)
    back = jax_store(d)
    back.deserialize(ps.serialize())
    np.testing.assert_array_equal(back.serialize(), data)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_raw_access_matches_jax(rng, dtype):
    d = 20
    m = _normed(rng, 50, d)
    ps, js = port_store(d, dtype=dtype), jax_store(d, dtype=dtype)
    for s in (ps, js):
        s.add_embeddings(None, m[:40])
        s._flush()
        s.add_embeddings(None, m[40:])  # still pending
    for pos in (0, 39, 40, 49):
        np.testing.assert_array_equal(ps.get_embedding_at(pos), js.get_embedding_at(pos))
    np.testing.assert_array_equal(ps.host_rows(10, 45), js.host_rows(10, 45))
    np.testing.assert_array_equal(ps.serialize(), js.serialize())
    assert ps.serialize_embedding_at(50) is None
    with pytest.raises(IndexError):
        ps.get_embedding_at(50)
    ps.clear()
    assert len(ps) == 0 and ps.fuzzy_lookup_embeddings_batch(m[:2]) == [[], []]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_device_rows_matches_host_ingest(rng, dtype):
    d = 48
    m = _normed(rng, 500, d)
    extra = _normed(rng, 700, d)
    q = _normed(rng, 4, d)
    host = port_store(d, dtype=dtype)
    host.add_embeddings(None, m)
    host.add_embeddings(None, extra)
    dev = port_store(d, dtype=dtype)
    dev.load_device_rows(torch.from_numpy(m))
    assert len(dev) == 500
    dev.load_device_rows(torch.from_numpy(extra))  # growth path
    assert len(dev) == 1200
    assert host.fuzzy_lookup_embeddings_batch(q, max_hits=10) == dev.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    with pytest.raises(ValueError, match="size mismatch"):
        dev.load_device_rows(torch.ones((2, 16)))


def test_reserve_sizes_buffer_exactly(rng):
    d = 16
    s = port_store(d)
    s.reserve(5000)
    s.add_embeddings(None, _normed(rng, 100, d))
    s._flush()
    assert s._buf.shape[0] == 5120
    j = jax_store(d)
    j.reserve(5000)
    j.add_embeddings(None, _normed(rng, 100, d))
    j._flush()
    assert j._buf.shape[0] == s._buf.shape[0]
    s.reserve(9000)
    assert s._buf.shape[0] == 9216 and len(s) == 100


def test_warm_serving_runs_each_bucket(rng):
    s = port_store(16)
    assert s.warm_serving() == 0
    s.add_embeddings(None, _normed(rng, 100, 16))
    assert s.warm_serving(max_batch=64) == 4  # 8, 16, 32, 64


def test_settings_refuse_unported_modes_and_missing_device(monkeypatch):
    model = create_test_embedding_model(8)
    for mode in ("approx", "ivf"):  # ported
        assert TextEmbeddingIndexSettings(embedding_model=model, device="cpu", search_mode=mode).search_mode == mode
    # The int8 query wire (ported): taken on a bf16 store, refused on others.
    wire = TextEmbeddingIndexSettings(embedding_model=model, device="cpu", query_wire="int8", dtype="bfloat16")
    assert wire.query_wire == "int8"
    with pytest.raises(ValueError, match="bfloat16"):
        TextEmbeddingIndexSettings(embedding_model=model, device="cpu", query_wire="int8")
    # A mesh (ported): the settings take it and its first device; anything
    # else raises.
    from typeagent_tpu_torch.parallel import create_mesh

    mesh = create_mesh(n_shard=2, devices=[torch.device("cpu")] * 2)
    settings = TextEmbeddingIndexSettings(embedding_model=model, mesh=mesh)
    assert settings.mesh is mesh and settings.device == torch.device("cpu")
    with pytest.raises(TypeError, match="Mesh"):
        TextEmbeddingIndexSettings(embedding_model=model, device="cpu", mesh=object())
    # No model: the default HTTP embedding model from the environment, as
    # in JAX (nothing is requested until an embedding is asked for).
    for name in ("OPENAI_EMBEDDING_MODEL", "OPENAI_API_KEY", "AZURE_OPENAI_API_KEY"):
        monkeypatch.delenv(name, raising=False)
    default = TextEmbeddingIndexSettings(device="cpu").embedding_model
    assert type(default._embedder).__name__ == "HttpEmbedder"
    assert default.model_name == "text-embedding-ada-002"
    with pytest.raises(ValueError):
        TextEmbeddingIndexSettings(embedding_model=model, device="cpu", search_mode="fast")
    # int8 stores are ported; the JAX package's ValueErrors for the
    # combinations it refuses stay.
    assert TextEmbeddingIndexSettings(embedding_model=model, device="cpu", dtype="int8").dtype == "int8"
    for kw in ({"search_mode": "approx"}, {"search_mode": "ivf"}, {"query_wire": "int8"}):
        with pytest.raises(ValueError):
            TextEmbeddingIndexSettings(embedding_model=model, device="cpu", dtype="int8", **kw)


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TextEmbeddingIndexSettings(embedding_model=create_test_embedding_model(8))
    s = TextEmbeddingIndexSettings(embedding_model=create_test_embedding_model(8), device="cpu")
    assert s.device == torch.device("cpu") and s.min_score == vs_mod.DEFAULT_MIN_SCORE


def test_fetch_packs_one_copy():
    vals = torch.tensor([[0.5, 0.25]], dtype=torch.float32)
    idx = torch.tensor([[7, -1]], dtype=torch.int32)
    cert = torch.tensor([False])
    v, i, c = vs_mod._fetch(vals, idx, cert)
    np.testing.assert_array_equal(v, [[0.5, 0.25]])
    np.testing.assert_array_equal(i, [[7, -1]])
    assert i.dtype == np.int32 and c.tolist() == [False]
    v3, i3 = vs_mod._fetch(vals[None], idx[None])
    assert v3.shape == (1, 1, 2) and i3.tolist() == [[[7, -1]]]


def test_concurrent_appends_and_lookups_never_see_phantom_rows(rng):
    """Lookups on threads race appends and flushes: every hit is a live row
    scored as that row scores (no zero-padded row, no torn buffer)."""
    import sys

    d = 16
    store = port_store(d, search_mode="exact2")
    rows = _normed(rng, 6000, d)
    store.add_embeddings(None, rows[:200])
    q = rows[:4] * 0.9 + 0.1 * _normed(rng, 4, d)
    errors = []

    def reader():
        try:
            for _ in range(30):
                for r, row in enumerate(store.fuzzy_lookup_embeddings_batch(q, max_hits=5)):
                    for hit in row:
                        # A zero-padded (unwritten) row would score 0.5.
                        want = vs_mod.cosine_to_score(float(rows[hit.item] @ q[r]))
                        assert abs(hit.score - want) <= 1e-5, (hit, want)
        except Exception as exc:  # reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader) for _ in range(4)]
        for t in threads:
            t.start()
        for start in range(200, 6000, 400):
            store.add_embeddings(None, rows[start : start + 400])
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[0]
    final = store.fuzzy_lookup_embeddings_batch(q, max_hits=5)
    for r, row in enumerate(final):
        for hit in row:
            assert hit.score == pytest.approx(vs_mod.cosine_to_score(float(rows[hit.item] @ q[r])), abs=1e-6)


def test_cert_queries_count_real_queries_not_padding(rng):
    """The many route resolves certificates over its R x b_pad population,
    but ``vectorstore.cert_queries`` counts real queries: R=3 batches of
    b=5 (padded to 8) are 15 queries, not 24."""
    from typeagent_tpu_torch.utils.metrics import METRICS

    d = 16
    store = port_store(d, search_mode="exact2")
    store.add_embeddings(None, _normed(rng, 2000, d))
    qs = _normed(rng, 15, d).reshape(3, 5, d)
    before = METRICS.counters.get("vectorstore.cert_queries", 0)
    rows = store.fuzzy_lookup_embeddings_many(qs, max_hits=4)
    assert [len(r) for r in rows] == [5, 5, 5]
    assert METRICS.counters["vectorstore.cert_queries"] - before == 15
