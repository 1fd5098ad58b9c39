"""Parity: the port's multi-conversation corpus store
(``typeagent_tpu_torch/parallel``) against the JAX package's
``CorpusVectorStore``, on a 1-shard mesh and on the 8 virtual CPU devices
(4 shards x 2 data-parallel), with the same appends; the port's corpus
runs on the same mesh shape of CPU devices.

The layout is the repo's 10M-fragment probe's fragmented one cut down: 24
interleaved segments of 64 rows over three conversations, dim 32. Scoping
to one conversation is 8 intervals (K4), to ``podcast`` and ``wiki`` 9
after adjacent segments merge (row mask + K5); an int8 corpus scopes
through the row mask and K7. Hits must agree as ``(conversation,
local_ordinal)`` except at score ties, scores within 1e-6 (f32) or 1e-5
(int8). int8 queries are sparse sign vectors that stay bf16-representable
after normalization: the port scores bf16 queries, the JAX CPU route f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.parallel import create_mesh
from typeagent_tpu.parallel.corpus import CorpusVectorStore as JaxCorpus
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.parallel import CorpusVectorStore, ShardedVectorStore
from typeagent_tpu_torch.parallel import create_mesh as port_create_mesh

DIM = 32
SEG_ROWS = 64
NAMES = ("podcast", "mailbox", "wiki")
LAYOUT = [(name, SEG_ROWS) for _ in range(8) for name in NAMES]
TOL = {"float32": 1e-6, "int8": 1e-5}
SCOPES = {"global": None, "one": ["podcast"], "two": ["podcast", "wiki"], "other_two": ["mailbox", "wiki"]}


def _mesh(name):
    if name == "1x1":
        return create_mesh(n_shard=1, n_dp=1, devices=jax.devices()[:1])
    return create_mesh(n_shard=4, n_dp=2)


def _port_mesh(name):
    if name == "1x1":
        return None  # the one-device corpus
    return port_create_mesh(n_shard=4, n_dp=2, devices=[torch.device("cpu")] * 8)


def _segments(seed=5):
    rng = np.random.default_rng(seed)
    return [(name, rng.standard_normal((n, DIM)).astype(np.float32) * 3.0) for name, n in LAYOUT]


def _queries(dtype, n=11, seed=6):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.standard_normal((n, DIM)).astype(np.float32)
    q = np.zeros((n, DIM), np.float32)  # 16 entries of +-0.25: unit norm, bf16-exact
    for row in q:
        pos = rng.choice(DIM, 16, replace=False)
        row[pos] = rng.choice([-0.25, 0.25], 16)
    return q


def _jax_dtype(dtype):
    return jnp.int8 if dtype == "int8" else jnp.float32


@pytest.fixture(scope="module", params=["1x1", "4x2"])
def mesh_name(request):
    return request.param


_BUILT = {}


def _corpora(mesh_name, dtype):
    """(port, jax) corpora over the same appends, built once per module."""
    key = (mesh_name, dtype)
    if key not in _BUILT:
        port = CorpusVectorStore(DIM, device="cpu", dtype=dtype, mesh=_port_mesh(mesh_name))
        ref = JaxCorpus(DIM, mesh=_mesh(mesh_name), dtype=_jax_dtype(dtype))
        for name, rows in _segments():
            port.append(name, rows)
            ref.append(name, rows)
        _BUILT[key] = (port, ref)
    return _BUILT[key]


def assert_hits_match(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        np.testing.assert_allclose([h.score for h in a], [h.score for h in b], atol=tol)
        keys = {(h.conversation, h.local_ordinal) for h in b}
        kth = min(h.score for h in b) if b else 0.0
        for h in a:
            if (h.conversation, h.local_ordinal) not in keys:
                assert abs(h.score - kth) <= tol
        assert len({h.global_ordinal for h in a}) == len(a)


def assert_pairs_match(got, want, tol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=tol)
        kth = min(s for _, s in b) if b else 0.0
        for i, s in a:
            if i not in {j for j, _ in b}:
                assert abs(s - kth) <= tol


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("scope", sorted(SCOPES))
def test_corpus_search_matches_jax(mesh_name, dtype, scope):
    port, ref = _corpora(mesh_name, dtype)
    q = _queries(dtype)
    conversations = SCOPES[scope]
    got = port.search(q, k=10, conversations=conversations)
    want = ref.search(q, k=10, conversations=conversations)
    assert_hits_match(got, want, TOL[dtype])
    if conversations is not None:
        assert all(h.conversation in conversations for row in got for h in row)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_search_subset_matches_jax(mesh_name, dtype):
    port, ref = _corpora(mesh_name, dtype)
    q = _queries(dtype)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ordinals = np.random.default_rng(7).choice(len(port), 300, replace=False)
    got = port._store.search_subset(q, ordinals, k=10)
    want = ref._store.search_subset(q, ordinals, k=10)
    assert_pairs_match(got, want, TOL[dtype])
    assert {i for row in got for i, _ in row} <= set(ordinals.tolist())


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_min_score_and_large_k_match_jax(dtype):
    port, ref = _corpora("1x1", dtype)
    q = _queries(dtype, n=4)
    for conversations in (None, ["wiki"]):
        got = port.search(q, k=40, conversations=conversations, min_score=0.55)
        want = ref.search(q, k=40, conversations=conversations, min_score=0.55)
        assert_hits_match(got, want, TOL[dtype])
        assert all(h.score >= 0.55 for row in got for h in row)


def test_segment_intervals_match_jax():
    port, ref = _corpora("1x1", "float32")
    for wanted in ({"podcast"}, {"podcast", "wiki"}, {"mailbox"}, set(NAMES), {"nobody"}):
        np.testing.assert_array_equal(port._segment_intervals(wanted), ref._segment_intervals(wanted))
    assert port._segment_intervals({"podcast"}).shape == (8, 2)
    assert port._segment_intervals({"podcast", "wiki"}).shape == (9, 2)  # wiki|podcast merge
    assert port.conversations == ref.conversations
    assert all(port.count_for(n) == ref.count_for(n) == 8 * SEG_ROWS for n in NAMES)


def _record(monkeypatch, names):
    calls = []
    for name in names:
        real = getattr(topk, name)
        monkeypatch.setattr(topk, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    return calls


def test_float_scopes_route_to_k1_k4_k5(monkeypatch):
    port, _ = _corpora("1x1", "float32")
    calls = _record(monkeypatch, ["fused_topk", "fused_topk_iv", "fused_topk_masked"])
    q = _queries("float32", n=3)
    port.search(q, k=10)
    port.search(q, k=10, conversations=["podcast"])  # 8 intervals
    port.search(q, k=10, conversations=["podcast", "wiki"])  # 9 intervals
    port._store.search_subset(q, np.arange(0, 1500, 7), k=10)
    assert calls == ["fused_topk", "fused_topk_iv", "fused_topk_masked", "fused_topk_masked"]


def test_int8_scopes_route_to_k6_k7(monkeypatch):
    port, _ = _corpora("1x1", "int8")
    calls = _record(monkeypatch, ["fused_topk_q", "fused_topk_mq", "fused_topk_iv", "fused_topk_masked"])
    q = _queries("int8", n=3)
    port.search(q, k=10)
    port.search(q, k=10, conversations=["podcast"])
    port.search(q, k=10, conversations=["podcast", "wiki"])
    port._store.search_subset(q, np.arange(0, 1500, 7), k=10)
    assert calls == ["fused_topk_q", "fused_topk_mq", "fused_topk_mq", "fused_topk_mq"]


def test_append_device_matches_append_and_finds_itself():
    host = CorpusVectorStore(DIM, device="cpu")
    dev = CorpusVectorStore(DIM, device="cpu")
    dev.reserve(len(LAYOUT) * SEG_ROWS)
    for name, rows in _segments():
        host.append(name, rows)
        dev.append_device(name, torch.from_numpy(rows))
    assert dev._store.buf.shape[0] == 2048 and len(dev) == len(host)
    np.testing.assert_allclose(dev._store.serialize(), host._store.serialize(), atol=1e-6)
    probes = _segments()[4][1][[3, 60]]  # rows of the second "mailbox" segment
    for store in (host, dev):
        hits = store.search(probes, k=3, conversations=["mailbox"])
        assert [(h[0].conversation, h[0].local_ordinal) for h in hits] == [("mailbox", 67), ("mailbox", 124)]
        assert all(abs(h[0].score - 1.0) < 1e-6 for h in hits)


def test_int8_state_carried_across_from_the_jax_corpus():
    ref = JaxCorpus(DIM, mesh=_mesh("1x1"), dtype=jnp.int8)
    for name, rows in _segments(seed=9):
        ref.append(name, rows)
    ref._store._flush()
    n = ref._store.count
    port = CorpusVectorStore(DIM, device="cpu", dtype="int8")
    port.adopt_quantized(
        np.asarray(ref._store.buf[:n, :DIM]),
        np.asarray(ref._store._scales[:n]),
        [(s.conversation, s.start, s.count, s.local_base) for s in ref._segments],
    )
    assert len(port) == n and port.conversations == ref.conversations
    np.testing.assert_array_equal(port._store.serialize(), ref._store.serialize())
    q = _queries("int8")
    for conversations in (None, ["podcast"], ["podcast", "wiki"]):
        assert_hits_match(port.search(q, k=10, conversations=conversations),
                          ref.search(q, k=10, conversations=conversations), TOL["int8"])


def test_empty_scopes_and_empty_store():
    port, _ = _corpora("1x1", "float32")
    q = _queries("float32", n=2)
    assert port.search(q, k=5, conversations=["nobody"]) == [[], []]
    assert port.search(q, k=5, conversations=[]) == [[], []]
    empty = CorpusVectorStore(DIM, device="cpu")
    assert empty.search(q, k=5) == [[], []]
    assert empty.search(q, k=5, conversations=["podcast"]) == [[], []]
    assert empty._store.search_subset(q, [1, 2], k=5) == [[], []]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_sharded_store_api_matches_jax(dtype):
    rng = np.random.default_rng(12)
    rows = rng.standard_normal((1500, DIM)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    q = _queries("int8", n=5)  # bf16-exact unit queries suit every dtype
    from typeagent_tpu.parallel.sharded import ShardedVectorStore as JaxStore

    port = ShardedVectorStore(DIM, dtype=dtype, device="cpu")
    ref = JaxStore(_mesh("1x1"), DIM, dtype=dtype)
    for s in (port, ref):
        s.append(rows[:1000])
        s.search(q, k=3)  # flush, then grow
        s.append(rows[1000:])
    tol = TOL["float32"] if dtype == "float32" else 1e-5
    assert len(port) == len(ref) == 1500
    assert_pairs_match(port.search(q, k=10), ref.search(q, k=10), tol)
    assert_pairs_match(port.collect_search(port.search_dispatch(q, k=7, min_score=0.5)),
                       ref.search(q, k=7, min_score=0.5), tol)
    mask = rng.random(1500) < 0.2
    assert_pairs_match(port.search_masked(q, mask, k=10), ref.search_masked(q, mask, k=10), tol)
    np.testing.assert_allclose(port.scores(q), ref.scores(q), atol=tol)
    np.testing.assert_array_equal(port.get_rows(100, 140), ref.get_rows(100, 140))
    np.testing.assert_array_equal(port.get_row(7), ref.get_row(7))
    np.testing.assert_array_equal(port.serialize(), ref.serialize())
    data = port.serialize()
    port.deserialize(data)
    ref.deserialize(data)
    assert len(port) == 1500
    assert_pairs_match(port.search(q, k=10), ref.search(q, k=10), tol)
    port.clear()
    assert len(port) == 0 and port.search(q, k=4) == [[]] * 5


def test_reserve_and_growth_pad_scales_with_one():
    store = ShardedVectorStore(DIM, dtype="int8", device="cpu")
    store.reserve(3000)
    assert store.buf.shape[0] == store._scales.shape[0] == 3072
    store.append_device(torch.ones((5000, DIM)))
    assert store.buf.shape[0] == store._scales.shape[0] == 6144
    assert bool((store._scales[5000:] == 1.0).all())


def test_unported_settings_name_their_roadmap_item(monkeypatch):
    """The settings ROADMAP.md Queue 1 item 9 ported (a mesh) are taken and
    only a non-mesh is refused; approx and IVF are taken, int8 refused as
    in JAX; the default device raises without a card."""
    mesh = port_create_mesh(n_shard=2, devices=[torch.device("cpu")] * 2)
    corpus = CorpusVectorStore(DIM, mesh=mesh)
    assert corpus.mesh is mesh and corpus._store.n_shard == 2 and corpus.device == torch.device("cpu")
    with pytest.raises(TypeError, match="Mesh"):
        CorpusVectorStore(DIM, device="cpu", mesh=object())
    for mode in ("approx", "ivf"):  # ported: accepted, int8 refused as in JAX
        assert CorpusVectorStore(DIM, device="cpu", search_mode=mode)._store.search_mode == mode
        with pytest.raises(ValueError):
            ShardedVectorStore(DIM, dtype="int8", search_mode=mode, device="cpu")
    CorpusVectorStore(DIM, device="cpu").build_ivf()  # an empty store: a no-op, as in JAX
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CorpusVectorStore(DIM)  # device="cuda" by default: no CPU fallback
