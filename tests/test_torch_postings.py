"""``typeagent_tpu_torch/ops/postings.py`` against ``typeagent_tpu/ops/postings.py``.

Seed-made numpy inputs (CSR postings, ops with exact, related and boost
kinds, knowledge-type gates, per-op scope rows, duplicate postings for
``dedup_related``) go through every public function of both packages, the
port's on CPU tensors, the JAX package's through XLA on the CPU. Sums are
held within 1e-6 (f32, relative and absolute), ``op_hit``, run keys, counts
and columns exactly. Beyond the JAX package's forms: a leaf wider than its
COO position field (8,192), where the JAX package takes its dense form and
the port's COO route answers alone; empty queries; and the same bits from
two runs of one call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.ops import postings as J
from typeagent_tpu_torch.native import PyInterner, create_interner
from typeagent_tpu_torch.ops import postings as T

TOL = 1e-6
SEEDS = (3, 17, 29)


def _csr(rng, n_terms=60, n_semrefs=3000, n_postings=9000, dup_share=0.05):
    """CSR arrays, some lists repeating a semref."""
    term_of = rng.integers(n_terms, size=n_postings)
    semrefs = rng.integers(n_semrefs, size=n_postings).astype(np.int32)
    dup = rng.random(n_postings) < dup_share
    semrefs[1:][dup[1:]] = semrefs[:-1][dup[1:]]
    term_of[1:][dup[1:]] = term_of[:-1][dup[1:]]
    order = np.argsort(term_of, kind="stable")
    offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(term_of, minlength=n_terms), out=offsets[1:])
    scores = rng.uniform(0.5, 1.0, n_postings).astype(np.float32)
    return offsets, semrefs[order], scores[order], n_semrefs


def _ops(rng, n_terms, n_ops, n_seg, n_scopes, wide=False):
    tids = rng.integers(-1, n_terms, size=n_ops).astype(np.int32)
    weights = rng.uniform(0.5, 10.0, n_ops).astype(np.float32)
    segs = rng.integers(n_seg, size=n_ops).astype(np.int32)
    kinds = rng.choice([T.OP_EXACT, T.OP_RELATED, T.OP_BOOST], p=[0.45, 0.45, 0.1], size=n_ops).astype(np.int8)
    positions = rng.permutation(n_ops).astype(np.int32)
    if wide:
        positions = positions + 9000  # past the JAX COO key's 8,192
    gates = np.where(rng.random(n_ops) < 0.2, rng.integers(4, size=n_ops), -1).astype(np.int8)
    scope_ids = rng.integers(n_scopes, size=n_ops).astype(np.int32)
    return tids, weights, segs, kinds, positions, gates, scope_ids


def _case(seed, n_ops=40, n_seg=5, n_scopes=3, wide=False):
    rng = np.random.default_rng(seed)
    offsets, semrefs, scores, n_semrefs = _csr(rng)
    cap = T.round_up(n_semrefs, 1024)
    ops = _ops(rng, len(offsets) - 1, n_ops, n_seg, n_scopes, wide)
    masks = rng.random((n_scopes, cap)) < 0.7
    masks[0] = True
    ktype = np.full(cap, -1, np.int8)
    ktype[:n_semrefs] = rng.integers(4, size=n_semrefs)
    return (offsets, semrefs, scores, *ops, masks, ktype), cap, n_seg


def _jax(arrays, boost):
    return (*(jnp.asarray(a) for a in arrays), jnp.float32(boost))


def _torch(arrays, boost):
    return (*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), boost)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=TOL, atol=TOL)


def _window(arrays):
    offsets, tids = arrays[0], arrays[3]
    known = tids[tids >= 0]
    return max(int((offsets[known + 1] - offsets[known]).max(initial=0)), 1)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_segmented_dense_matches_jax(seed, dedup):
    arrays, cap, n_seg = _case(seed)
    statics = dict(window=_window(arrays), semref_cap=cap, n_seg=n_seg, dedup_related=dedup)
    want = J.accumulate_postings_segmented(*_jax(arrays, 10.0), **statics)
    got = T.accumulate_postings_segmented(*_torch(arrays, 10.0), **statics)
    assert len(got) == len(want) == 5
    for g, w in zip(got[:4], want[:4]):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("seed", SEEDS)
def test_segmented_dense_window_cuts_like_jax(seed):
    """A window shorter than the longest list drops each list's tail in
    both packages."""
    arrays, cap, n_seg = _case(seed)
    statics = dict(window=64, semref_cap=cap, n_seg=n_seg)
    want = J.accumulate_postings_segmented(*_jax(arrays, 10.0), **statics)
    got = T.accumulate_postings_segmented(*_torch(arrays, 10.0), **statics)
    for g, w in zip(got[:4], want[:4]):
        _close(g.numpy(), w)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("cap_compact", [16, 64, 4096])
@pytest.mark.parametrize("seed", SEEDS)
def test_segmented_compact_matches_jax(seed, cap_compact):
    arrays, cap, n_seg = _case(seed)
    statics = dict(window=_window(arrays), semref_cap=cap, n_seg=n_seg, dedup_related=True)
    w_packed, w_hit, w_order, w_counts = J.accumulate_postings_segmented_compact(
        *_jax(arrays, 10.0), cap=cap_compact, **statics
    )
    g_packed, g_hit, g_order, g_counts = T.accumulate_postings_segmented_compact(
        *_torch(arrays, 10.0), cap=cap_compact, **statics
    )
    np.testing.assert_array_equal(g_counts.numpy(), np.asarray(w_counts))
    np.testing.assert_array_equal(g_hit.numpy(), np.asarray(w_hit))
    assert tuple(g_packed.shape) == w_packed.shape and tuple(g_order.shape) == w_order.shape
    for s, c in enumerate(np.minimum(np.asarray(w_counts), cap_compact)):
        np.testing.assert_array_equal(g_order.numpy()[s, :c], np.asarray(w_order)[s, :c])
        _close(g_packed.numpy()[:, s, :c], np.asarray(w_packed)[:, s, :c])


@pytest.mark.parametrize("e_cut", [False, True])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_coo_matches_jax(seed, dedup, e_cut):
    arrays, cap, n_seg = _case(seed)
    total = int(sum(
        arrays[0][t + 1] - arrays[0][t] for t in arrays[3] if t >= 0
    ))
    e_pad = total // 2 if e_cut else J._bucket(total, J._COO_E_BUCKETS)
    statics = dict(e_pad=e_pad, semref_cap=cap, n_seg=n_seg, dedup_related=dedup, r_max=1 << 20)
    w_keys, w_sums, w_n, w_hit = J.accumulate_postings_segmented_coo(*_jax(arrays, 10.0), **statics)
    g_keys, g_sums, g_n, g_hit = T.accumulate_postings_segmented_coo(*_torch(arrays, 10.0), **statics)
    n = int(w_n)
    assert int(g_n) == n > 0
    assert tuple(g_keys.shape) == w_keys.shape and tuple(g_sums.shape) == w_sums.shape
    np.testing.assert_array_equal(g_keys.numpy()[:n], np.asarray(w_keys)[:n])
    assert (g_keys.numpy()[n:] == 2**30).all()  # (the JAX tail holds other entries' keys)
    _close(g_sums.numpy()[:, :n], np.asarray(w_sums)[:, :n])
    np.testing.assert_array_equal(g_hit.numpy(), np.asarray(w_hit))


@pytest.mark.parametrize("scoped", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_accumulate_postings_matches_jax(seed, scoped):
    rng = np.random.default_rng(seed)
    offsets, semrefs, scores, n_semrefs = _csr(rng)
    cap = T.round_up(n_semrefs, 1024)
    tids = rng.integers(-1, len(offsets) - 1, size=24).astype(np.int32)
    weights = rng.uniform(0.5, 10.0, 24).astype(np.float32)
    exact = rng.random(24) < 0.5
    mask = rng.random(cap) < 0.6 if scoped else np.ones(cap, bool)
    arrays = (offsets, semrefs, scores, tids, weights, exact, mask)
    window = _window(arrays)
    want = J.accumulate_postings(*(jnp.asarray(a) for a in arrays), window=window, semref_cap=cap)
    got = T.accumulate_postings(*(torch.from_numpy(a) for a in arrays), window=window, semref_cap=cap)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g.numpy(), w)


def _indexes(seed, n_semrefs=5000):
    """The same postings in a JAX and a port index (cap past the JAX
    package's 2,048 so that its COO route answers too)."""
    rng = np.random.default_rng(seed)
    terms = [f"Term{i}" for i in range(80)]
    raw = [(terms[rng.integers(80)], int(rng.integers(n_semrefs)), float(rng.uniform(0.5, 1.0)))
           for _ in range(12000)]
    raw += [(t, s, sc) for t, s, sc in raw[:300]]  # duplicate postings
    jax_index, port_index = J.DevicePostingsIndex(), T.DevicePostingsIndex("cpu")
    for term, semref, score in raw:
        jax_index.add_term(term, semref, score)
    port_index.add_terms_batch(raw)
    jax_index.build()
    port_index.build()
    ktype = rng.integers(0, 4, size=n_semrefs).astype(np.int8)
    return rng, terms, jax_index, port_index, ktype


def _index_ops(rng, terms, index, n_ops, n_seg, wide=False):
    ops = []
    for i in range(n_ops):
        tid = index.lookup(terms[rng.integers(len(terms))]) if rng.random() > 0.05 else -1
        kind = int(rng.choice([T.OP_EXACT, T.OP_RELATED, T.OP_BOOST], p=[0.45, 0.45, 0.1]))
        gate = int(rng.integers(4)) if rng.random() < 0.2 else -1
        ops.append((tid, float(rng.uniform(0.5, 10.0)), int(rng.integers(n_seg)), kind,
                    i + (9000 if wide else 0), gate, int(rng.integers(2))))
    return ops


def test_index_build_matches_jax():
    _, terms, jax_index, port_index, _ = _indexes(5)
    assert len(port_index) == len(jax_index) and port_index.posting_count == jax_index.posting_count
    assert port_index._semref_cap == jax_index._semref_cap and port_index._n_semrefs == jax_index._n_semrefs
    n_terms = len(jax_index)
    np.testing.assert_array_equal(port_index._offsets_host, jax_index._offsets_host[: n_terms + 1])
    np.testing.assert_array_equal(port_index._semrefs_host, jax_index._semrefs_host[: port_index.posting_count])
    np.testing.assert_array_equal(port_index._term_has_dups, jax_index._term_has_dups)
    assert port_index._term_has_dups.any()
    for term in terms + ["missing"]:
        tid = jax_index.lookup(term)
        assert port_index.lookup(term.upper()) == tid
        assert port_index.posting_size(tid) == jax_index.posting_size(tid)
        np.testing.assert_array_equal(port_index.posting_semrefs(tid), jax_index.posting_semrefs(tid))


def test_interners_give_the_same_ids_and_csr():
    native, python = create_interner(), PyInterner()
    rng = np.random.default_rng(9)
    words = [f"W{int(i)}" for i in rng.integers(500, size=3000)] + ["Été", "ÉTÉ", "naïve"]
    scores = rng.random(1000)
    for interner in (native, python):
        ids = interner.intern_batch(words[:1000])
        interner.add_postings_batch(ids, np.arange(1000), scores)
        for i, w in enumerate(words[1000:]):
            interner.add_posting(interner.intern(w), i, 0.5)
    assert len(native) == len(python)
    assert all(native.lookup(w) == python.lookup(w) for w in words + ["nope"])
    for a, b in zip(native.build_csr(), python.build_csr()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("n_seg", [1, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_lookup_ops_matches_jax(seed, n_seg):
    rng, terms, jax_index, port_index, ktype = _indexes(seed)
    ops = _index_ops(rng, terms, jax_index, 30, n_seg)
    scope = rng.random(len(ktype)) < 0.5
    want = jax_index.lookup_ops(ops, n_seg, ktype, [None, scope], 10.0)
    got = port_index.lookup_ops(ops, n_seg, ktype, [None, scope], 10.0)
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == w.shape
        _close(g, w)
    np.testing.assert_array_equal(got[4], want[4])


@pytest.mark.parametrize("n_seg", [1, 6])
@pytest.mark.parametrize("seed", SEEDS)
def test_lookup_ops_sparse_matches_jax(seed, n_seg):
    rng, terms, jax_index, port_index, ktype = _indexes(seed)
    ops = _index_ops(rng, terms, jax_index, 30, n_seg)
    scope = rng.random(len(ktype)) < 0.5
    want = jax_index.lookup_ops_sparse(ops, n_seg, ktype, [None, scope], 10.0)
    got = port_index.lookup_ops_sparse(ops, n_seg, ktype, [None, scope], 10.0)
    assert want is not None and got is not None
    np.testing.assert_array_equal(got[2], want[2])  # counts
    np.testing.assert_array_equal(got[3], want[3])  # op_hit
    for s, c in enumerate(want[2]):
        np.testing.assert_array_equal(got[0][s, :c], want[0][s, :c])
        _close(got[1][:, s, :c], want[1][:, s, :c])


@pytest.mark.parametrize("seed", SEEDS)
def test_wide_leaf_past_the_jax_position_field(seed):
    """Positions past 8,192: the JAX COO route declines (its int32 key's
    position field) and its dense form answers; the port's COO route holds
    every position and answers the same."""
    rng, terms, jax_index, port_index, ktype = _indexes(seed)
    ops = _index_ops(rng, terms, jax_index, 30, 3, wide=True)
    scopes = [None, rng.random(len(ktype)) < 0.5]
    assert jax_index.lookup_ops_sparse(ops, 3, ktype, scopes, 10.0) is None
    cols, packed, counts, op_hit = port_index.lookup_ops_sparse(ops, 3, ktype, scopes, 10.0)
    es, eh, rs, rh, dense_hit = jax_index.lookup_ops(ops, 3, ktype, scopes, 10.0)
    np.testing.assert_array_equal(op_hit, dense_hit)
    for s in range(3):
        active = np.flatnonzero((eh[s] > 0) | (rh[s] > 0))
        np.testing.assert_array_equal(cols[s, : counts[s]], active)
        for a, block in enumerate((es, eh, rs, rh)):
            _close(packed[a, s, : counts[s]], block[s, active])


@pytest.mark.parametrize("scoped", [False, True])
@pytest.mark.parametrize("seed", SEEDS)
def test_lookup_terms_matches_jax(seed, scoped):
    rng, terms, jax_index, port_index, _ = _indexes(seed)
    query = [(terms[rng.integers(len(terms))], float(rng.uniform(1, 5)), bool(rng.random() < 0.5))
             for _ in range(12)] + [("missing", 2.0, True)]
    scope = rng.random(5000) < 0.5 if scoped else None
    for g, w in zip(port_index.lookup_terms(query, scope), jax_index.lookup_terms(query, scope)):
        assert g.shape == w.shape
        _close(g, w)


def test_empty_queries():
    _, _, jax_index, port_index, ktype = _indexes(3)
    for index in (jax_index, port_index):
        es, eh, rs, rh, op_hit = index.lookup_ops([], 2, ktype)
        assert es.shape == (2, index._n_semrefs) and not eh.any() and op_hit.size == 0
        cols, packed, counts, op_hit = index.lookup_ops_sparse([(-1, 1.0, 0, 0, 0, -1, 0)], 2, ktype)
        assert not counts.any() and op_hit.tolist() == [False]
    empty = T.DevicePostingsIndex("cpu")
    empty.build()
    total, exact_hits, related_hits = empty.lookup_terms([("anything", 1.0, True)])
    assert total.size == exact_hits.size == related_hits.size == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_same_bits_twice(seed):
    """The sums come from a fixed order: two runs of a call, the same bits."""
    arrays, cap, n_seg = _case(seed, n_ops=60)
    statics = dict(e_pad=1 << 20, semref_cap=cap, n_seg=n_seg, dedup_related=True, r_max=1 << 20)
    first = T.accumulate_postings_segmented_coo(*_torch(arrays, 10.0), **statics)
    again = T.accumulate_postings_segmented_coo(*_torch(arrays, 10.0), **statics)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_mesh_forms_raise_naming_item_9():
    """The data-parallel forms that ROADMAP.md Queue 1 item 9 ported:
    ``lookup_ops_sparse_dp`` on a (dp=4, shard=2) mesh of CPU devices
    against the JAX form on its 8 virtual CPU devices, and
    ``accumulate_postings_segmented_coo_dp`` against one call per rank."""
    from typeagent_tpu.parallel import create_mesh as jax_create_mesh
    from typeagent_tpu_torch.parallel import create_mesh

    rng, terms, jax_index, port_index, ktype = _indexes(3)
    ops = _index_ops(rng, terms, jax_index, 40, 6)
    scopes = [None, rng.random(len(ktype)) < 0.5]
    want = jax_index.lookup_ops_sparse_dp(ops, 6, ktype, scopes, 10.0, mesh=jax_create_mesh(n_shard=2, n_dp=4))
    got = port_index.lookup_ops_sparse_dp(
        ops, 6, ktype, scopes, 10.0, mesh=create_mesh(n_shard=2, n_dp=4, devices=[torch.device("cpu")] * 8)
    )
    assert want is not None and got is not None and port_index.dp_calls == 1
    np.testing.assert_array_equal(got[2], want[2])  # counts
    np.testing.assert_array_equal(got[3], want[3])  # op_hit
    for s, c in enumerate(want[2]):
        np.testing.assert_array_equal(got[0][s, :c], want[0][s, :c])
        _close(got[1][:, s, :c], want[1][:, s, :c])
    arrays, cap, n_seg = _case(3, n_ops=60)
    one = _torch(arrays, 10.0)
    statics = dict(semref_cap=cap, n_seg=n_seg, dedup_related=True)
    single = T._accumulate_runs(*one, **statics)
    keys, sums, hits = T.accumulate_postings_segmented_coo_dp([(one, statics)] * 2, [0, n_seg])
    shifted = single.keys + n_seg * (cap + 1)  # the second rank owns the next n_seg segments
    assert torch.equal(keys, torch.cat([single.keys, shifted]))
    assert torch.equal(sums, torch.cat([single.sums, single.sums], dim=1))
    assert all(torch.equal(h, single.op_hit) for h in hits)


def test_calls_past_the_key_run_field_refuse():
    """One call keys at most 2**30 (segment, semref) slots: the COO route
    declines past it and the forms raise rather than collide."""
    _, _, _, port_index, ktype = _indexes(3)
    n_seg = T._RUN_KEYS // (port_index._semref_cap + 1) + 1
    assert port_index.lookup_ops_sparse([(0, 1.0, 0, 0, 0, -1, 0)], n_seg, ktype) is None
    arrays, cap, _ = _case(3)
    with pytest.raises(ValueError, match="2\\*\\*30|1073741824"):
        T.accumulate_postings_segmented_coo(
            *_torch(arrays, 1.0), e_pad=64, semref_cap=cap, n_seg=T._RUN_KEYS // (cap + 1) + 1
        )
