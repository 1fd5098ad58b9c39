"""Parity: the port's row-sharded store on a (dp=2, shard=4) mesh of CPU
devices against the JAX package's on its 8 virtual CPU devices.

The same seed-made rows go into both stores in uneven batches (so the
capacity grows and rows move between shards), and the same queries come
out: scores must agree to 1e-6 (f32) or 1e-5 (bf16, int8), indices must
be equal except at score ties. Queries are sparse sign vectors of unit
norm, exact in bf16 (the port's kernels score bf16 queries for bf16 and
int8 stores, the JAX CPU route f32 ones for int8). The layout is held to
the JAX block layout shard by shard, a ragged store (the watermark inside
shard 1, shards 2-3 empty) to the same answers, and the sharded IVF search
to the JAX one on the JAX per-shard indexes carried across.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.parallel import create_mesh as jax_create_mesh
from typeagent_tpu.parallel.sharded import ShardedVectorStore as JaxSharded
from typeagent_tpu_torch.ops import ivf as port_ivf
from typeagent_tpu_torch.parallel import ShardedVectorStore, create_mesh
from typeagent_tpu_torch.parallel import sharded as port_sharded
from typeagent_tpu_torch.parallel.ivf import ShardedIVF

DIM = 32
TOL = {"float32": 1e-6, "bfloat16": 1e-5, "int8": 1e-5}
DTYPES = ("float32", "bfloat16", "int8")
BATCHES = (700, 1, 333, 1500, 90)  # 2624 rows: capacity 1024 -> 2048 -> 4096


def port_mesh(n_shard=4, n_dp=2):
    return create_mesh(n_shard=n_shard, n_dp=n_dp, devices=[torch.device("cpu")] * (n_shard * n_dp))


def jax_mesh(n_shard=4, n_dp=2):
    return jax_create_mesh(n_shard=n_shard, n_dp=n_dp, devices=jax.devices()[: n_shard * n_dp])


def rows(n, seed):
    r = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def sign_queries(n, seed=11):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, DIM), np.float32)
    for row in q:
        row[rng.choice(DIM, 16, replace=False)] = rng.choice([-0.25, 0.25], 16)
    return q


def assert_pairs_match(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=tol)
        kth = min(s for _, s in b) if b else 0.0
        keys = {j for j, _ in b}
        for i, s in a:
            assert i in keys or abs(s - kth) <= tol


_BUILT = {}


def stores(dtype, batches=BATCHES, seed=1, reserve=0):
    """(port, jax) stores over the same appends, built once per module."""
    key = (dtype, batches, seed, reserve)
    if key not in _BUILT:
        port = ShardedVectorStore(DIM, dtype=dtype, mesh=port_mesh())
        ref = JaxSharded(jax_mesh(), DIM, dtype=dtype)
        data = rows(sum(batches), seed)
        start = 0
        for s in (port, ref):
            if reserve:
                s.reserve(reserve)
        for n in batches:
            for s in (port, ref):
                s.append(data[start : start + n])
                s.search(data[start : start + 1], k=1)  # flush: grow per batch
            start += n
        _BUILT[key] = (port, ref, data)
    return _BUILT[key]


@pytest.mark.parametrize("dtype", DTYPES)
def test_block_layout_matches_jax(dtype):
    """Shard s holds the JAX shard s's rows, on every dp replica."""
    port, ref, _ = stores(dtype)
    assert port.capacity == ref.buf.shape[0] == 4096 and port.count == ref.count == 2624
    blocks = {}
    for sh in ref.buf.addressable_shards:
        blocks.setdefault(sh.index[0].start or 0, np.asarray(sh.data.astype(jnp.float32)))
    assert sorted(blocks) == [s * port.local_n for s in range(4)]
    for i in range(2):
        for s, shard in enumerate(port.shard_rows(i)):
            np.testing.assert_array_equal(shard.float().numpy(), blocks[s * port.local_n])
    if dtype == "int8":
        scales = np.asarray(ref._scales)
        for i in range(2):
            got = np.concatenate([t.numpy() for t in port.shard_scales(i)])
            np.testing.assert_array_equal(got, scales)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 13, 16])
def test_global_search_matches_jax(dtype, b):
    port, ref, _ = stores(dtype)
    q = sign_queries(b)
    for k, min_score in ((10, 0.0), (32, 0.55), (1, 0.0)):
        assert_pairs_match(port.search(q, k, min_score), ref.search(q, k, min_score), TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_scoped_routes_match_jax(dtype):
    port, ref, _ = stores(dtype)
    q = sign_queries(9)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    subset = rng.choice(2624, 300, replace=False)
    assert_pairs_match(port.search_subset(q, subset, 10), ref.search_subset(q, subset, 10), tol)
    mask = rng.random(2624) < 0.2
    assert_pairs_match(port.search_masked(q, mask, 10), ref.search_masked(q, mask, 10), tol)
    # Shard boundaries at 1024, 2048, 3072: tables that straddle them, a
    # table past K4's 8 rows, an interval over the empty tail.
    for table in (
        [(1000, 1100)],
        [(10, 20), (900, 2100), (2600, 4000)],
        [(i * 200, i * 200 + 70) for i in range(13)],
    ):
        iv = np.asarray(table)
        assert_pairs_match(port.search_intervals(q, iv, 10), ref.search_intervals(q, iv, 10), tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scores_rows_and_serialize_match_jax(dtype):
    port, ref, _ = stores(dtype)
    q = sign_queries(5)
    np.testing.assert_allclose(port.scores(q), np.asarray(ref.scores(q)), atol=TOL[dtype])
    np.testing.assert_array_equal(port.get_rows(1000, 1100), np.asarray(ref.get_rows(1000, 1100)))
    np.testing.assert_array_equal(port.serialize(), ref.serialize())


def test_approx_matches_jax():
    """Small shards take the exact route in both packages (the port's
    bucket argmax from 131,072 rows a shard, JAX's approx_max_k exact on
    the CPU)."""
    port = ShardedVectorStore(DIM, dtype="bfloat16", search_mode="approx", mesh=port_mesh())
    ref = JaxSharded(jax_mesh(), DIM, dtype="bfloat16", search_mode="approx")
    data = rows(1500, 21)
    for s in (port, ref):
        s.append(data)
    q = sign_queries(8)
    assert_pairs_match(port.search(q, 5), ref.search(q, 5), TOL["bfloat16"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_store_matches_jax_and_one_device(dtype):
    """1,300 rows over 4 x 1024: shard 1 holds the watermark, shards 2-3
    are empty and launch nothing; the answers are the JAX mesh's and the
    one-device store's."""
    port, ref, data = stores(dtype, batches=(1300,), seed=4, reserve=4096)
    one = ShardedVectorStore(DIM, dtype=dtype, device="cpu")
    one.append(data)
    q = sign_queries(7)
    want = ref.search(q, 12)
    assert_pairs_match(port.search(q, 12), want, TOL[dtype])
    assert port.search(q, 12) == one.search(q, 12)
    iv = np.asarray([(1200, 3000)])
    assert_pairs_match(port.search_intervals(q, iv, 12), ref.search_intervals(q, iv, 12), TOL[dtype])
    assert port._live_shards(port.count) == 2


def test_dp_split_equals_one_device_and_ties_go_low():
    """Duplicate rows in different shards tie: the lower global row wins,
    as on one device; an odd batch splits over the dp ranks."""
    data = rows(3000, 8)
    data[2900] = data[100]  # shard 0 and shard 2 (boundaries at 1024)
    data[1500] = data[100]
    mesh_store = ShardedVectorStore(DIM, mesh=port_mesh())
    one = ShardedVectorStore(DIM, device="cpu")
    for s in (mesh_store, one):
        s.reserve(4096)
        s.append(data)
    q = np.concatenate([data[100:101], sign_queries(10)])
    got = mesh_store.search(q, 5)
    assert got == one.search(q, 5)
    assert [i for i, _ in got[0][:3]] == [100, 1500, 2900]


def test_every_shard_launches_before_any_gather(monkeypatch):
    port, _, _ = stores("float32")
    events = []
    real_topk, real_gather = port_sharded._shard_topk, port_sharded.gather_winners
    monkeypatch.setattr(port_sharded, "_shard_topk", lambda *a: events.append("launch") or real_topk(*a))
    monkeypatch.setattr(port_sharded, "gather_winners", lambda *a: events.append("gather") or real_gather(*a))
    port.search(sign_queries(16), 10)
    assert events == ["launch"] * 6 + ["gather"] * 2  # 3 live shards x 2 dp ranks


def _jax_shard_states(ref):
    """The JAX snapshot's per-shard IVF states as the port's, on the CPU."""
    arrays = [np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
              for x in ref._ivf.device_arrays]
    n_shard = 4
    states = []
    for s in range(n_shard):
        parts = [a.reshape(n_shard, -1, *a.shape[1:])[s] for a in arrays]
        parts[5], parts[8] = parts[5].reshape(()), parts[8].reshape(())
        if int(parts[5]) + int(parts[8]) == 0:
            states.append(None)  # a dead shard
            continue
        states.append(port_ivf.adopt_ivf_state(parts, "cpu"))
    return states


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_ivf_on_the_jax_indexes_matches_jax(dtype):
    """Each shard searches the JAX build's index of that shard: the same
    answers and certificates, through the merge and the AND, before and
    after rows are appended past the snapshot; the empty tail shard is a
    dead index in both."""
    rng = np.random.default_rng(30)
    centers = rows(10, 31)
    data = centers[rng.integers(0, 10, 2900)] + 0.05 * rng.standard_normal((2900, DIM)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    port = ShardedVectorStore(DIM, dtype=dtype, search_mode="ivf", ivf_b=3, mesh=port_mesh())
    ref = JaxSharded(jax_mesh(), DIM, dtype=dtype, search_mode="ivf", ivf_b=3)
    for s in (port, ref):
        s.append(data)
        s.reserve(4096)
    ref.build_ivf(rows_per_cluster=128, outlier_frac=0.05, iters=3)
    port._flush()
    states = _jax_shard_states(ref)
    assert states[3] is None
    port._ivf = ShardedIVF((tuple(states), tuple(states)), ref._ivf.local_n, ref._ivf.built_count)
    q = sign_queries(12)
    for stage in ("snapshot", "suffix"):
        if stage == "suffix":
            extra = rows(40, 32)
            for s in (port, ref):
                s.append(extra)
        (got, gc), (want, wc) = port.search_ivf(q, 6), ref.search_ivf(q, 6)
        assert gc == wc
        assert_pairs_match(got, want, TOL[dtype])


def test_sharded_ivf_build_on_each_shard():
    """The port's own per-shard build: each live shard's index on its
    device holds exactly its rows; dp replicas share it on one device."""
    data = rows(2500, 40)
    store = ShardedVectorStore(DIM, search_mode="ivf", mesh=port_mesh())
    store.append(data)
    store.reserve(4096)
    store.build_ivf(rows_per_cluster=128, iters=2)
    snap = store._ivf
    assert snap.local_n == 1024 and snap.built_count == 2500
    assert snap.states[1][2] is snap.states[0][2] and snap.states[0][3] is None
    for s, n in enumerate((1024, 1024, 452)):
        st = snap.states[0][s]
        live = np.concatenate([st.perm.numpy(), st.out_perm.numpy()])
        assert np.array_equal(np.sort(live[live >= 0]), np.arange(n))
    res, certs = store.search_ivf(data[:6], 3)
    assert [r[0][0] for r in res] == list(range(6)) and len(certs) == 6


def test_vector_store_on_a_mesh_answers_as_on_one_device():
    """``TextEmbeddingIndexSettings(mesh=...)``: every lookup route of the
    store (batch, async, dispatch / collect, many, subset, predicate, rows
    and serialize) on a (2, 4) mesh answers as the one-device store; an IVF
    mesh store builds one index per shard and finds each row."""
    from typeagent_tpu_torch.models.adapters import create_test_embedding_model
    from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore
    import asyncio

    model = create_test_embedding_model(DIM)
    data = rows(1500, 50)
    q = sign_queries(6)
    stores = []
    for kw in ({"device": "cpu"}, {"mesh": port_mesh()}):
        s = VectorStore(TextEmbeddingIndexSettings(model, min_score=0.0, **kw))
        s.add_embeddings(None, data[:900])
        s.add_embeddings(None, data[900:])
        stores.append(s)
    one, sharded = stores
    assert sharded._sharded is not None or len(sharded) == 1500
    for s in stores:
        s._flush()
    assert sharded._sharded.n_shard == 4 and sharded._count == 1500
    assert sharded.fuzzy_lookup_embeddings_batch(q, 7) == one.fuzzy_lookup_embeddings_batch(q, 7)
    assert sharded.collect_lookup(sharded.dispatch_lookup(q, 5), 0.5) == one.collect_lookup(one.dispatch_lookup(q, 5), 0.5)
    many = np.stack([q, q[::-1]])
    assert sharded.fuzzy_lookup_embeddings_many(many, 4) == one.fuzzy_lookup_embeddings_many(many, 4)
    subset = list(range(3, 1500, 11))
    assert sharded.fuzzy_lookup_embedding_in_subset(q[0], subset, 5, 0.5) == \
        one.fuzzy_lookup_embedding_in_subset(q[0], subset, 5, 0.5)
    assert asyncio.run(sharded.fuzzy_lookup_embeddings_batch_async(q, 3)) == one.fuzzy_lookup_embeddings_batch(q, 3)
    even = lambda i: i % 2 == 0  # noqa: E731
    assert sharded.fuzzy_lookup_embeddings_batch(q, 5, predicate=even) == \
        one.fuzzy_lookup_embeddings_batch(q, 5, predicate=even)
    np.testing.assert_array_equal(sharded.serialize(), one.serialize())
    np.testing.assert_array_equal(sharded.get_embedding_at(1234), one.get_embedding_at(1234))
    ivf = VectorStore(TextEmbeddingIndexSettings(model, min_score=0.0, search_mode="ivf", mesh=port_mesh()))
    ivf.add_embeddings(None, data)
    ivf.build_ivf(rows_per_cluster=128, iters=2)
    assert ivf._sharded._ivf is not None and ivf._sharded._ivf.built_count == 1500
    found = ivf.fuzzy_lookup_embeddings_batch(data[:8], 3)
    assert [row[0].item for row in found] == list(range(8))
    assert ivf.collect_lookup(ivf.dispatch_lookup(data[:8], 3)) == found
