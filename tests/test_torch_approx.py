"""Parity: the port's approximate search (``search_mode="approx"``) and its
kernel K2' (``bucket_argmax``) against the JAX package, on the same numpy
inputs.

The port runs the kernels' plain versions (CPU tensors); the JAX package
runs as its own CPU tests run it: ``_bucket_maxima_xla`` for the bucket
argmax, and ``lax.approx_max_k``, which is an exact top-k off the TPU, for
the approx store. Tolerances: f32 raw scores 1e-6, bf16 stores 1e-5
(exact bf16 products, f32 sums); argmax rows must be equal except where a
bucket's two best raw scores lie within the tolerance. The bucket route
has recall >= 0.99 against the exact answer (a hit is lost only when two
of the true top k share a 128-row bucket).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu import vectorstore as jvs
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu.ops import topk as jtopk
from typeagent_tpu.parallel import create_mesh
from typeagent_tpu.parallel.corpus import CorpusVectorStore as JaxCorpus
from typeagent_tpu.parallel.sharded import ShardedVectorStore as JaxSharded
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.parallel import CorpusVectorStore, ShardedVectorStore
from typeagent_tpu_torch.utils.metrics import METRICS
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

TOL = {"float32": 1e-6, "bfloat16": 1e-5}


def _normed(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _pad(m, n_pad, d_pad):
    out = np.zeros((n_pad, d_pad), np.float32)
    out[: m.shape[0], : m.shape[1]] = m
    return out


def _stores(m_pad, dtype):
    j, t = jnp.asarray(m_pad), torch.from_numpy(m_pad.copy())
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def _near_tie(raw_bucket, tol):
    """Whether a bucket's two best raw scores lie within ``tol``."""
    top2 = np.sort(raw_bucket)[-2:]
    return top2.size == 2 and top2[1] - top2[0] <= tol


# (n_pad, count): a ragged watermark, a store of one bucket, one live bucket.
ARGMAX_CASES = {"full": (2048, 2048), "ragged": (2048, 1987), "one_bucket": (128, 77),
                "one_live_bucket": (1024, 100)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_bucket_argmax_plain_matches_jax(dtype, case):
    n_pad, count = ARGMAX_CASES[case]
    rng = np.random.default_rng(1)
    d = 48
    m = _normed(rng, n_pad, d)  # rows past the watermark hold data: it must mask them
    q = _normed(rng, 6, d)
    if n_pad >= 1024:
        # Exact duplicates inside one bucket (300, 301, 383) and across a
        # bucket edge (511 | 512), and queries that hit them.
        m[[301, 383]] = m[300]
        m[512] = m[511]
        q[0], q[1] = m[300], m[511]
    q = _bf16_round(q)  # both packages score the same query
    jemb, temb = _stores(m, dtype)
    jv, ji = jtopk._bucket_maxima_xla(jemb, jnp.asarray(q), jnp.int32(count))
    tv, ti = topk.bucket_argmax_plain(temb, torch.from_numpy(q), count)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(tv, jv, atol=tol)
    assert ti.dtype == np.int32 and ti.shape == (q.shape[0], n_pad // 128)
    dead = np.arange(n_pad // 128) * 128 >= count
    assert (tv[:, dead] == -3.0).all() and (ti[:, dead] == -1).all()
    assert ((ti >= 0) & (ti < count))[:, ~dead].all()
    raw = (q @ temb.float().numpy().T).reshape(q.shape[0], -1, 128)
    for r, c in zip(*np.nonzero(ti != ji)):
        assert _near_tie(raw[r, c][: min(128, count - c * 128)], tol), (r, c)
    if count > 512:
        # The lowest row among duplicates, inside a bucket and across an edge.
        assert ti[0, 2] == 300 and ti[1, 3] == 511 and ti[1, 4] == 512


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_cosine_topk_bucket_matches_jax_composition(dtype, k):
    """K2' + exact top-k over the maxima + the argmax rows + score map, as
    the JAX ``_topk_bucket_pallas_impl`` composes them."""
    rng = np.random.default_rng(2)
    d, count = 64, 4000 - 57
    m = _pad(_normed(rng, count, d), 4096, d)
    q = _bf16_round(_normed(rng, 9, d))
    jemb, temb = _stores(m, dtype)
    jv, ji = jtopk._bucket_maxima_xla(jemb, jnp.asarray(q), jnp.int32(count))
    top_v, pos = jax.lax.top_k(jv, k)
    want_v, want_i = jtopk._raw_to_score(top_v, jnp.take_along_axis(ji, pos, axis=1))
    got_v, got_i = topk.cosine_topk_bucket(temb, torch.from_numpy(q), count, k)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=TOL[dtype])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32


def test_cosine_topk_bucket_caps_k_at_the_bucket_count():
    rng = np.random.default_rng(3)
    m = torch.from_numpy(_pad(_normed(rng, 300, 32), 384, 32))
    vals, idx = topk.cosine_topk_bucket(m, m[:2].contiguous(), 300, 10)
    assert tuple(vals.shape) == (2, 3)  # one hit per bucket
    assert idx[0, 0].item() == 0 and idx[1, 0].item() == 1


def test_approx_route_rule_and_its_metric(monkeypatch):
    counts = METRICS.counters
    before = (counts.get("topk.approx_route.bucket", 0), counts.get("topk.approx_route.exact", 0))
    rule = topk.approx_uses_buckets
    assert not rule(topk.APPROX_BUCKET_MIN_ROWS - 1, 10)
    assert rule(topk.APPROX_BUCKET_MIN_ROWS, 10)
    assert not rule(10**7, topk._PALLAS_MAX_K + 1)  # past the fused kernel's k
    assert counts["topk.approx_route.bucket"] == before[0] + 1
    assert counts["topk.approx_route.exact"] == before[1] + 2
    assert topk.APPROX_BUCKET_MIN_ROWS == jvs.EXACT2_MIN_ROWS
    # The route follows the rule: small stores never take the bucket route.
    calls = []
    monkeypatch.setattr(topk, "bucket_argmax", lambda *a: calls.append(1) or topk.bucket_argmax_plain(*a))
    m = torch.from_numpy(_pad(_normed(np.random.default_rng(4), 1000, 32), 1024, 32))
    topk.cosine_topk_approx(m, m[:8].contiguous(), 1000, 10)
    assert calls == []
    monkeypatch.setattr(topk, "APPROX_BUCKET_MIN_ROWS", 512)
    topk.cosine_topk_approx(m, m[:8].contiguous(), 1000, 10)
    assert calls == [1]


def _port_store(d, **kw):
    return VectorStore(TextEmbeddingIndexSettings(
        embedding_model=create_test_embedding_model(d), min_score=0.0, device="cpu", **kw
    ))


def _jax_store(d, **kw):
    return jvs.VectorStore(jvs.TextEmbeddingIndexSettings(embedding_model=jax_model(d), min_score=0.0, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_store_below_crossover_equals_jax_store(dtype):
    """Below the crossover the approx route is K1: the exact top-k that
    ``lax.approx_max_k`` gives off the TPU, so the answers are equal."""
    rng = np.random.default_rng(5)
    d = 40
    m = _normed(rng, 3000, d)
    q = _bf16_round(_normed(rng, 7, d))
    ps = _port_store(d, search_mode="approx", dtype=dtype, recall_target=0.9)
    js = _jax_store(d, search_mode="approx", dtype=dtype, recall_target=0.9)
    for s in (ps, js):
        s.add_embeddings(None, m)
    assert ps.settings.recall_target == js.settings.recall_target == 0.9
    got = ps.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    want = js.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    for a, b in zip(got, want):
        assert [x.item for x in a] == [x.item for x in b]
        np.testing.assert_allclose([x.score for x in a], [x.score for x in b], atol=TOL[dtype])
    routed = METRICS.counters.get("topk.approx_route.exact", 0)
    many = ps.fuzzy_lookup_embeddings_many(np.stack([q, q[::-1]]), max_hits=10)
    assert [[x.item for x in r] for r in many[0]] == [[x.item for x in r] for r in got]
    assert METRICS.counters.get("topk.approx_route.exact", 0) == routed + 1  # the approx route


@pytest.fixture(scope="module")
def crossover_stores():
    """A 131,072 x 16 store (the crossover itself) in the port and in JAX."""
    rng = np.random.default_rng(6)
    d = 16
    m = _normed(rng, topk.APPROX_BUCKET_MIN_ROWS, d)
    q = _normed(rng, 256, d)
    ps = _port_store(d, search_mode="approx")
    js = _jax_store(d, search_mode="approx")
    for s in (ps, js):
        s.add_embeddings(None, m)
    return ps, js, m, q


def _recall(got, want):
    return np.mean([len({x.item for x in a} & {x.item for x in b}) / len(b) for a, b in zip(got, want)])


def test_approx_store_at_crossover_rides_the_bucket_route(crossover_stores, monkeypatch):
    ps, js, m, q = crossover_stores
    calls = []
    real = topk.cosine_topk_bucket
    monkeypatch.setattr(topk, "cosine_topk_bucket", lambda *a: calls.append(1) or real(*a))
    got = ps.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    many = ps.fuzzy_lookup_embeddings_many(q.reshape(4, 64, -1), max_hits=10)
    assert calls == [1, 1]
    want = js.fuzzy_lookup_embeddings_batch(q, max_hits=10)  # exact off the TPU
    assert _recall(got, want) >= 0.99
    assert _recall([r for batch in many for r in batch], want) >= 0.99
    # Every answer is a real row with its true score, best first.
    for r, row in enumerate(got):
        assert len(row) == 10 and len({x.item for x in row}) == 10
        scores = np.array([x.score for x in row])
        np.testing.assert_allclose(scores, jvs.cosine_to_score(m[[x.item for x in row]] @ q[r]), atol=1e-6)
        assert (np.diff(scores) <= 0).all()
    # k past the fused kernel's range takes the exact route.
    big = ps.fuzzy_lookup_embeddings_batch(q[:2], max_hits=40)
    jbig = js.fuzzy_lookup_embeddings_batch(q[:2], max_hits=40)
    assert [[x.item for x in r] for r in big] == [[x.item for x in r] for r in jbig]
    assert calls == [1, 1]


@pytest.fixture(scope="module", params=["1x1", "4x2"])
def mesh(request):
    if request.param == "1x1":
        return create_mesh(n_shard=1, n_dp=1, devices=jax.devices()[:1])
    return create_mesh(n_shard=4, n_dp=2)


def _corpus_segments(seed=8):
    rng = np.random.default_rng(seed)
    return [(name, rng.standard_normal((70, 32)).astype(np.float32)) for _ in range(6)
            for name in ("podcast", "mailbox", "wiki")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_corpus_approx_matches_jax_corpus(mesh, dtype):
    """Global searches ride each shard's approx route (K1 at this size,
    exact in both packages); scoped searches stay exact."""
    q = _bf16_round(_normed(np.random.default_rng(9), 5, 32))
    port = CorpusVectorStore(32, device="cpu", dtype=dtype, search_mode="approx")
    ref = JaxCorpus(32, mesh=mesh, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32,
                    search_mode="approx")
    for name, rows in _corpus_segments():
        port.append(name, rows)
        ref.append(name, rows)
    for conversations in (None, ["wiki"], ["podcast", "mailbox"]):
        got = port.search(q, k=10, conversations=conversations)
        want = ref.search(q, k=10, conversations=conversations)
        for a, b in zip(got, want):
            assert [(h.conversation, h.local_ordinal) for h in a] == [(h.conversation, h.local_ordinal) for h in b]
            np.testing.assert_allclose([h.score for h in a], [h.score for h in b], atol=TOL[dtype])


def test_sharded_approx_bucket_route_and_min_score(monkeypatch):
    """With the crossover moved below the store, the sharded approx search
    rides the bucket argmax: recall against the JAX (exact) answers stays
    high, min_score applies on the device, ordinals stay global."""
    rng = np.random.default_rng(10)
    rows = _normed(rng, 6000, 32)
    q = _bf16_round(_normed(rng, 16, 32))
    port = ShardedVectorStore(32, search_mode="approx", recall_target=0.99, device="cpu")
    ref = JaxSharded(create_mesh(n_shard=1, n_dp=1, devices=jax.devices()[:1]), 32, search_mode="approx")
    for s in (port, ref):
        s.append(rows)
    monkeypatch.setattr(topk, "APPROX_BUCKET_MIN_ROWS", 1024)
    calls = []
    real = topk.bucket_argmax
    monkeypatch.setattr(topk, "bucket_argmax", lambda *a: calls.append(1) or real(*a))
    got = port.search(q, k=5)
    want = ref.search(q, k=5)
    assert calls == [1] and port.recall_target == 0.99
    hits = sum(len({i for i, _ in a} & {i for i, _ in b}) for a, b in zip(got, want))
    assert hits / (5 * len(q)) >= 0.9
    for r, row in enumerate(got):
        np.testing.assert_allclose([s for _, s in row], jvs.cosine_to_score(rows[[i for i, _ in row]] @ q[r]), atol=1e-6)
    assert all(s >= 0.6 for row in port.search(q, k=5, min_score=0.6) for _, s in row)


def test_topk_many_approx_matches_jax():
    rng = np.random.default_rng(11)
    m = _pad(_normed(rng, 2000, 48), 2048, 128)
    qs = np.stack([_pad(_normed(rng, 6, 48), 8, 128) for _ in range(3)])
    jv, ji = jtopk.topk_many(jnp.asarray(m), None, jnp.asarray(qs), jnp.int32(2000), k=10,
                             mode="approx", use_pallas=False, recall_target=0.95)
    tv, ti = topk.topk_many(torch.from_numpy(m), None, torch.from_numpy(qs), 2000, k=10,
                            mode="approx", recall_target=0.95)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    np.testing.assert_array_equal(ti[:, :6].numpy(), np.asarray(ji)[:, :6])
