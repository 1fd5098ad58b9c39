"""The coalesced lookup (``VectorStore.fuzzy_lookup_embeddings_many``) on
the CPU: R batches of b queries go to the device as one flat batch of
``R*b`` rows in ``min(_bucket(R*b), R*_bucket(b))`` query slots, and each
request gets what ``fuzzy_lookup_embeddings_batch`` gives it alone, in every
search mode; a certificate miss is rerun exactly and lands in its own
request and row.
"""

import numpy as np
import pytest

from typeagent_tpu_torch import vectorstore as vs_mod
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.utils.metrics import METRICS
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore, _bucket

D = 32
N = 4000
K = 5
TOL = 1e-6  # f32 sums in another order (the CPU's matmul rounds by operand shape)
SHAPES = [(16, 1), (3, 3), (5, 64), (2, 9)]


def _clustered(rng, n: int, d: int = D, clusters: int = 16) -> np.ndarray:
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    m = centers[rng.integers(0, clusters, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _store(rows: np.ndarray, dtype="float32", search_mode="exact", **attrs) -> VectorStore:
    s = TextEmbeddingIndexSettings(
        create_test_embedding_model(rows.shape[1]), min_score=0.0, dtype=dtype,
        search_mode=search_mode, device="cpu",
    )
    for key, value in attrs.items():
        setattr(s, key, value)
    store = VectorStore(s)
    store.add_embeddings(None, rows)
    return store


def _delta(before: dict, name: str) -> float:
    return METRICS.counters.get(name, 0.0) - before.get(name, 0.0)


def _assert_rows_match(got, want, tol=TOL):
    """Equal answers up to ties: scores within ``tol``, and an id that only
    one side returns scores within ``tol`` of the k-th."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        sa = np.array([x.score for x in a])
        sb = np.array([x.score for x in b])
        np.testing.assert_allclose(sa, sb, atol=tol)
        ib = {x.item for x in b}
        kth = sb.min() if sb.size else 0.0
        for x in a:
            if x.item not in ib:
                assert abs(x.score - kth) <= tol, (x.item, x.score, kth)


MODES = {
    "exact1": {"search_mode": "exact1"},
    "hybrid_exact2": {"search_mode": "exact"},  # with EXACT2_MIN_ROWS lowered
    "int8": {"dtype": "int8", "search_mode": "exact"},
    "approx": {"search_mode": "approx"},  # with APPROX_BUCKET_MIN_ROWS lowered
    "ivf": {"search_mode": "ivf", "ivf_b": 4},
    "ivf_certified": {"search_mode": "ivf", "ivf_b": 4, "ivf_certified": True},
}


@pytest.fixture(scope="module")
def stores():
    rng = np.random.default_rng(21)
    rows = _clustered(rng, N)
    built = {}
    for mode, settings in MODES.items():
        store = _store(rows, **settings)
        if store.settings.search_mode == "ivf":
            store.build_ivf(
                key=3, rows_per_cluster=128, train_rows=2048, iters=6, outlier_frac=0.05
            )
        built[mode] = store
    return built, rows


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"R{s[0]}xb{s[1]}")
@pytest.mark.parametrize("mode", list(MODES))
def test_many_answers_each_request_as_the_batch_route_does(stores, mode, shape, monkeypatch):
    monkeypatch.setattr(vs_mod, "EXACT2_MIN_ROWS", 1024)
    monkeypatch.setattr(topk, "APPROX_BUCKET_MIN_ROWS", 1024)
    built, rows = stores
    store = built[mode]
    r_n, b = shape
    rng = np.random.default_rng(100 * r_n + b)
    picks = rows[rng.choice(N, r_n * b, replace=False)]
    qb = _clustered(rng, r_n * b) * 0.2 + picks
    qb = (qb / np.linalg.norm(qb, axis=1, keepdims=True)).reshape(r_n, b, D)
    routes = {}
    for fn in ("cosine_topk_exact2_hybrid", "cosine_topk_bucket"):

        def spy(*a, _real=getattr(topk, fn), _fn=fn, **kw):
            routes[_fn] = routes.get(_fn, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(topk, fn, spy)
    many = store.fuzzy_lookup_embeddings_many(qb, max_hits=K)
    assert len(many) == r_n and all(len(req) == b for req in many)
    for i in range(r_n):
        _assert_rows_match(many[i], store.fuzzy_lookup_embeddings_batch(qb[i], max_hits=K))
    # Each mode ran its own route, once for the group and once per request.
    want = {"hybrid_exact2": "cosine_topk_exact2_hybrid", "approx": "cosine_topk_bucket"}.get(mode)
    assert routes == ({want: 1 + r_n} if want else {})


@pytest.mark.parametrize("b", [1, 3, 8, 9, 64, 300])
def test_a_group_launches_the_smaller_of_its_flat_bucket_and_its_padded_batches(b, monkeypatch):
    store = _store(_clustered(np.random.default_rng(4), 200, 16))
    launched = []
    real = store._topk_dispatch

    def spy(q, *a, **kw):
        launched.append(q.shape[0])
        return real(q, *a, **kw)

    monkeypatch.setattr(store, "_topk_dispatch", spy)
    rng = np.random.default_rng(b)
    for r_n in range(1, 17):
        before = dict(METRICS.counters)
        store.fuzzy_lookup_embeddings_many(rng.standard_normal((r_n, b, 16)), max_hits=3)
        slots = _delta(before, "vectorstore.query_slots")
        assert _delta(before, "vectorstore.dispatches") == 1
        assert _delta(before, "vectorstore.queries") == r_n * b
        assert slots == min(_bucket(r_n * b), r_n * _bucket(b)) == launched[-1]
        assert slots <= r_n * _bucket(b)  # never more than a bucket per batch
    assert len(launched) == 16


@pytest.mark.parametrize("shape,miss", [((16, 1), (9, 0)), ((3, 3), (2, 1)), ((2, 9), (1, 8))])
def test_a_planted_certificate_miss_is_rerun_in_its_own_request_and_row(shape, miss, monkeypatch):
    monkeypatch.setattr(vs_mod, "EXACT2_MIN_ROWS", 1024)
    rng = np.random.default_rng(31)
    rows = _clustered(rng, N)
    store = _store(rows)
    r_n, b = shape
    i, j = miss
    flat = i * b + j
    qb = rows[rng.choice(N, r_n * b, replace=False)].reshape(r_n, b, D)
    real = store._topk_dispatch
    rerun = []

    def planted(q, k, *a):
        vals, idx, cert = real(q, k, *a)
        assert cert is not None  # the hybrid exact2 route
        cert = cert.clone()
        cert[flat] = False
        # A wrong answer in the planted row: only the rerun can right it.
        other = (flat + 1) % (r_n * b)
        vals, idx = vals.clone(), idx.clone()
        vals[flat], idx[flat] = vals[other], idx[other]
        return vals, idx, cert

    real_rerun = store._rerun_exact1

    def spy(q, *a):
        rerun.append(q[0, :D].numpy().copy())
        return real_rerun(q, *a)

    monkeypatch.setattr(store, "_topk_dispatch", planted)
    monkeypatch.setattr(store, "_rerun_exact1", spy)
    before = dict(METRICS.counters)
    many = store.fuzzy_lookup_embeddings_many(qb, max_hits=K)
    assert _delta(before, "vectorstore.cert_queries") == r_n * b
    assert _delta(before, "vectorstore.cert_misses") == 1
    assert len(rerun) == 1
    np.testing.assert_array_equal(rerun[0], qb[i, j])
    exact = rows @ qb[i, j]
    want = np.argsort(-exact, kind="stable")[:K]
    assert [x.item for x in many[i][j]] == want.tolist()
    np.testing.assert_allclose(
        [x.score for x in many[i][j]], np.clip((exact[want] + 1) / 2, 0, 1), atol=1e-6
    )
    monkeypatch.setattr(store, "_topk_dispatch", real)
    alone = [store.fuzzy_lookup_embeddings_batch(qb[r], max_hits=K) for r in range(r_n)]
    for r in range(r_n):
        _assert_rows_match(many[r], alone[r])
