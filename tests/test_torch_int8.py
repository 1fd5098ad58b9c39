"""Parity: the port's int8 store mode (per-row symmetric quantization, K6
and K7's plain versions, ``VectorStore(dtype="int8")``) against the JAX
package's, on the same numpy inputs.

Quantization must be bit-equal. Scores agree within 1e-5 for queries that
are bf16-representable: the port scores bf16 queries on every route, as
the JAX Pallas kernels do, while the JAX XLA route (what runs on the CPU)
scores f32 queries (ROADMAP.md Queue 3). Invalid slots are compared after
filtering to ``vals >= 0``.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu import vectorstore as jvs
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu.ops import topk as jtopk
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.serve import LookupBatcher
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

TOL = 1e-5


@pytest.fixture
def rng():
    return np.random.default_rng(88)


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


def assert_topk_equivalent(vals_a, idx_a, vals_b, idx_b, tol):
    for va, ia, vb, ib in zip(*(np.asarray(x) for x in (vals_a, idx_a, vals_b, idx_b))):
        ka, kb = va >= 0, vb >= 0
        va, ia, vb, ib = va[ka], ia[ka], vb[kb], ib[kb]
        assert va.shape == vb.shape
        np.testing.assert_allclose(va, vb, atol=tol)
        kth = vb.min() if vb.size else -1.0
        for pos, i in enumerate(ia):
            if int(i) not in set(ib.tolist()):
                assert abs(float(va[pos]) - float(kth)) <= tol, (i, va[pos], kth)
        assert len(set(ia.tolist())) == ia.size


def assert_rows_match(got, want, tol=TOL):
    """ScoredInt rows: same length, scores within tol, items equal except
    at score ties."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        sa = np.array([x.score for x in a])
        sb = np.array([x.score for x in b])
        np.testing.assert_allclose(sa, sb, atol=tol)
        ib = [x.item for x in b]
        kth = sb.min() if sb.size else 0.0
        for x in a:
            if x.item not in ib:
                assert abs(x.score - kth) <= tol


def _quantized_store(rng, n_pad=2048, count=1900, d=48):
    m = _pad(_normed(rng, count, d), n_pad, 128)
    q_rows, scales = jtopk.quantize_rows(m)
    scales[count:] = 1.0
    return m, q_rows, scales, count


def port_store(d, **kw):
    kw.setdefault("min_score", 0.0)
    return VectorStore(TextEmbeddingIndexSettings(
        embedding_model=create_test_embedding_model(d), device="cpu", dtype="int8", **kw
    ))


def jax_store(d, **kw):
    kw.setdefault("min_score", 0.0)
    return jvs.VectorStore(jvs.TextEmbeddingIndexSettings(embedding_model=jax_model(d), dtype="int8", **kw))


# ---------------------------------------------------------------- quantization


def _quant_inputs(rng):
    rows = rng.standard_normal((3000, 70)).astype(np.float32) * rng.uniform(0.01, 30, (3000, 1)).astype(np.float32)
    rows[3] = 0.0  # all-zero row: scale 1.0
    rows[4] = 0.0
    rows[4, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]  # scale 1.0, halves round to even
    rows[5, :4] = [-254.0, 1.0, 3.0, -5.0]  # scale 2.0: 0.5, 1.5, -2.5 round to even
    rows[5, 4:] = 0.0
    return rows


def test_quantize_rows_bit_equal_jax(rng):
    rows = _quant_inputs(rng)
    q, s = topk.quantize_rows(rows)
    jq, js = jtopk.quantize_rows(rows)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s.view(np.int32), js.view(np.int32))
    assert s[3] == 1.0 and (q[3] == 0).all()
    assert q[4, :6].tolist() == [127, 0, 2, 2, 0, -4]
    assert q[5, :4].tolist() == [-127, 0, 2, -2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_rows_device_bit_equal_jax(rng, dtype):
    rows = torch.from_numpy(_quant_inputs(rng)).to(dtype)
    q, s = topk.quantize_rows_device(rows)
    jrows = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    jq, js = jtopk.quantize_rows_device(jrows)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    # The host twin divides where XLA multiplies by the reciprocal: scales
    # may differ by one ulp, as they do between the two JAX twins.
    hq, hs = topk.quantize_rows(rows.float().numpy())
    np.testing.assert_array_max_ulp(s.numpy(), hs, maxulp=1)


# ---------------------------------------------------------------- routes (K6, K7)


@pytest.mark.parametrize("k", [1, 10, 32, 50])
@pytest.mark.parametrize("count", [1900, 30])
def test_topk_program_quantized_matches_jax(rng, k, count):
    m, q_rows, scales, _ = _quantized_store(rng, count=count)
    q = _pad(_bf16_round(_normed(rng, 8, 48)), 8, 128)
    jv, ji = jtopk.topk_program_quantized(
        jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q), jnp.int32(count), k, use_pallas=False
    )
    args = (torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count)
    tv, ti = topk.topk_program_quantized(*args, k)
    assert tuple(tv.shape) == tuple(jv.shape)
    assert_topk_equivalent(tv, ti, jv, ji, TOL)
    cv, ci = topk.cosine_topk_quantized(*args, k)  # the store-level name
    np.testing.assert_array_equal(ci.numpy(), ti.numpy())


@pytest.mark.parametrize("k", [1, 10, 32, 50])
@pytest.mark.parametrize("density", [0.01, 0.4])
def test_topk_program_masked_quantized_matches_jax(rng, k, density):
    m, q_rows, scales, count = _quantized_store(rng)
    q = _pad(_bf16_round(_normed(rng, 8, 48)), 8, 128)
    mask = (rng.random(m.shape[0]) < density).astype(np.int32)
    jv, ji = jtopk.topk_program_masked_quantized(
        jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q), jnp.int32(count), jnp.asarray(mask),
        k, use_pallas=False,
    )
    tv, ti = topk.topk_program_masked_quantized(
        torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count,
        torch.from_numpy(mask), k,
    )
    assert_topk_equivalent(tv, ti, jv, ji, TOL)


@pytest.mark.parametrize("n_iv", [1, 8, 9])
def test_topk_program_intervals_quantized_matches_jax(rng, n_iv, monkeypatch):
    m, q_rows, scales, count = _quantized_store(rng)
    q = _pad(_bf16_round(_normed(rng, 8, 48)), 8, 128)
    table = np.asarray([[i * 200, i * 200 + 120] for i in range(n_iv)], dtype=np.int32)
    jv, ji = jtopk.topk_program_intervals_quantized(
        jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q), jnp.int32(count), jnp.asarray(table),
        10, use_pallas=False,
    )
    calls = []
    real = topk.fused_topk_mq
    monkeypatch.setattr(topk, "fused_topk_mq", lambda *a: calls.append(1) or real(*a))
    tv, ti = topk.topk_program_intervals_quantized(
        torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count,
        torch.from_numpy(table), 10,
    )
    assert calls == [1]  # int8 interval scopes always take the row mask (K7)
    assert_topk_equivalent(tv, ti, jv, ji, TOL)


def test_plain_versions_tie_to_the_lowest_row(rng):
    m, q_rows, scales, count = _quantized_store(rng)
    dupes = [7, 8, 1000, 1899]
    q_rows[dupes] = q_rows[7]
    scales[dupes] = scales[7]
    q = np.zeros((8, 128), np.float32)
    q[0] = _bf16_round(m[7:8])[0]
    args = (torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count)
    _, idx = topk.topk_q_plain(*args, 4)
    assert idx[0].tolist() == dupes
    mask = torch.ones(m.shape[0], dtype=torch.int32)
    mask[8] = 0
    _, idx = topk.topk_mq_plain(*args, mask, 3)
    assert idx[0].tolist() == [7, 1000, 1899]


def test_cosine_scores_and_subset_quantized_match_jax(rng):
    m, q_rows, scales, count = _quantized_store(rng)
    q = _pad(_normed(rng, 8, 48), 8, 128)  # f32 queries: both score them in f32
    want = np.asarray(jtopk.cosine_scores_quantized(jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q), count))
    got = topk.cosine_scores_quantized(torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q), count)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    ords = np.zeros(64, np.int32)
    ords[:20] = rng.choice(count, 20, replace=False)
    valid = np.arange(64) < 20
    jv, ji = jtopk.subset_cosine_topk_quantized(
        jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(q[:1]), jnp.asarray(ords), jnp.asarray(valid), 10
    )
    tv, ti = topk.subset_cosine_topk_quantized(
        torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(q[:1]),
        torch.from_numpy(ords), torch.from_numpy(valid), 10,
    )
    assert_topk_equivalent(tv, ti, jv, ji, 1e-6)


def test_topk_many_quantized_matches_jax(rng):
    m, q_rows, scales, count = _quantized_store(rng)
    qs = np.stack([_pad(_bf16_round(_normed(rng, 5, 48)), 8, 128) for _ in range(3)])
    jout = jtopk.topk_many(
        jnp.asarray(q_rows), jnp.asarray(scales), jnp.asarray(qs), jnp.int32(count),
        k=10, mode="quantized", use_pallas=False,
    )
    tout = topk.topk_many(
        torch.from_numpy(q_rows), torch.from_numpy(scales), torch.from_numpy(qs), count, k=10, mode="quantized"
    )
    assert len(tout) == 2 and tuple(tout[0].shape) == (3, 8, 10)
    for r in range(3):
        assert_topk_equivalent(tout[0][r], tout[1][r], jout[0][r], jout[1][r], TOL)


# ---------------------------------------------------------------- the int8 store


@pytest.mark.parametrize("max_hits,min_score", [(10, 0.0), (3, 0.55), (40, 0.0)])
def test_int8_store_batch_lookup_matches_jax(rng, max_hits, min_score):
    d = 48
    m = _normed(rng, 3000, d)
    q = _bf16_round(_normed(rng, 7, d))
    ps, js = port_store(d), jax_store(d)
    for s in (ps, js):
        s.add_embeddings(None, m[:1700])
        s.fuzzy_lookup_embeddings_batch(q[:1], max_hits=3)  # flush, then grow
        s.add_embeddings(None, m[1700:])
    assert_rows_match(
        ps.fuzzy_lookup_embeddings_batch(q, max_hits=max_hits, min_score=min_score),
        js.fuzzy_lookup_embeddings_batch(q, max_hits=max_hits, min_score=min_score),
    )
    assert ps._scales.shape[0] == ps._buf.shape[0] == 4096
    assert bool((ps._scales[ps._count :] == 1.0).all())


def test_int8_store_routes_through_k6(rng, monkeypatch):
    ps = port_store(32)
    ps.add_embeddings(None, _normed(rng, 200, 32))
    calls = []
    real = topk.fused_topk_q
    monkeypatch.setattr(topk, "fused_topk_q", lambda *a: calls.append(1) or real(*a))
    ps.fuzzy_lookup_embeddings_batch(_normed(rng, 3, 32), max_hits=5)
    ps.fuzzy_lookup_embeddings_many(_normed(rng, 6, 32).reshape(2, 3, 32), max_hits=5)
    ps.collect_lookup(ps.dispatch_lookup(_normed(rng, 2, 32), max_hits=5))
    assert calls == [1, 1, 1]
    assert ps._engine_mode(5, ps._buf, ps._scales, ps._count)[0] == "quantized"


def test_int8_store_subset_and_predicate_match_jax(rng):
    d = 32
    m = _normed(rng, 900, d)
    q = _bf16_round(_normed(rng, 1, d))[0]
    ps, js = port_store(d), jax_store(d)
    for s in (ps, js):
        s.add_embeddings(None, m)
    subset = sorted(rng.choice(900, 70, replace=False).tolist())
    got = ps.fuzzy_lookup_embedding_in_subset(q, subset, max_hits=8)
    want = js.fuzzy_lookup_embedding_in_subset(q, subset, max_hits=8)
    assert_rows_match([got], [want], 1e-6)
    assert {x.item for x in got} <= set(subset)
    pred = lambda i: i % 3 == 0  # noqa: E731
    got = ps.fuzzy_lookup_embedding(q, max_hits=6, predicate=pred)
    want = js.fuzzy_lookup_embedding(q, max_hits=6, predicate=pred)
    assert_rows_match([got], [want], 1e-6)


def test_int8_store_lookup_many_and_batcher_match_sync(rng):
    d = 32
    ps = port_store(d)
    ps.add_embeddings(None, _normed(rng, 1500, d))
    qs = _bf16_round(_normed(rng, 12, d)).reshape(3, 4, d)
    many = ps.fuzzy_lookup_embeddings_many(qs, max_hits=7)
    for r in range(3):
        assert_rows_match(many[r], ps.fuzzy_lookup_embeddings_batch(qs[r], max_hits=7), 0.0)

    async def serve():
        batcher = LookupBatcher(ps, max_delay_ms=5.0)
        out = await asyncio.gather(*(batcher.lookup(qs[r], max_hits=7) for r in range(3)))
        await batcher.close()
        return out, batcher.stats()

    served, stats = asyncio.run(serve())
    assert stats["served"] == 3
    for r in range(3):
        assert_rows_match(served[r], many[r], 0.0)


def test_int8_store_serialize_and_raw_access_match_jax(rng):
    d = 40
    m = _normed(rng, 500, d)
    ps, js = port_store(d), jax_store(d)
    for s in (ps, js):
        s.add_embeddings(None, m[:400])
        s.fuzzy_lookup_embeddings_batch(m[:1], max_hits=1)
        s.add_embeddings(None, m[400:])  # still pending
    np.testing.assert_array_equal(ps.serialize(), js.serialize())
    np.testing.assert_array_equal(ps.get_embedding_at(17), js.get_embedding_at(17))
    np.testing.assert_array_equal(ps.get_embedding_at(450), m[450])  # pending row
    np.testing.assert_array_equal(ps.host_rows(10, 420), js.host_rows(10, 420))
    np.testing.assert_allclose(ps.serialize(), m, atol=1e-2)  # dequantized


def test_int8_load_device_rows_matches_jax(rng):
    """Device-resident ingest quantizes as the JAX store's does, bit for
    bit; host ingest gives the same int8 rows (scales within one ulp)."""
    d = 40
    m = _normed(rng, 700, d)
    dev_store, host_store, js = port_store(d), port_store(d), jax_store(d)
    dev_store.load_device_rows(torch.from_numpy(m))
    js.load_device_rows(jnp.asarray(m))
    np.testing.assert_array_equal(dev_store._buf[:700].numpy(), np.asarray(js._buf[:700]))
    np.testing.assert_array_equal(dev_store._scales.numpy(), np.asarray(js._scales))
    host_store.add_embeddings(None, m)
    host_store._flush()
    assert torch.equal(host_store._buf[:700], dev_store._buf[:700])
    np.testing.assert_array_max_ulp(host_store._scales.numpy(), dev_store._scales.numpy(), maxulp=1)


def test_int8_state_carried_across_from_the_jax_store(rng):
    """A JAX int8 store's quantized bytes adopted as they are (re-quantizing
    its dequantized serialize() is not guaranteed to round-trip) answer as
    the JAX store does."""
    d = 48
    m = _normed(rng, 2100, d)
    js = jax_store(d)
    js.add_embeddings(None, m)
    js._flush()
    count = js._count
    q_rows = np.asarray(js._buf[:count, :d])
    scales = np.asarray(js._scales[:count])
    ps = port_store(d)
    ps.adopt_quantized(q_rows, scales)
    assert len(ps) == count
    np.testing.assert_array_equal(ps._buf[:count, :d].numpy(), q_rows)
    np.testing.assert_array_equal(ps.serialize(), js.serialize())
    q = _bf16_round(_normed(rng, 9, d))
    assert_rows_match(ps.fuzzy_lookup_embeddings_batch(q, max_hits=10), js.fuzzy_lookup_embeddings_batch(q, max_hits=10))
    ps.add_embeddings(None, m[:5])  # appends continue after the adopted rows
    assert ps.fuzzy_lookup_embedding(m[2], max_hits=1)[0].item in (2, count + 2)
    f32_store = VectorStore(TextEmbeddingIndexSettings(embedding_model=create_test_embedding_model(d), device="cpu"))
    with pytest.raises(ValueError):
        f32_store.adopt_quantized(q_rows, scales)


def test_int8_recall_vs_f32(rng):
    """tests/test_quantized.py's bar: recall@10 >= 0.9 against the f32
    store, top-1 score within 5e-3."""
    dim = 96
    matrix = _normed(rng, 2000, dim)
    f32 = VectorStore(TextEmbeddingIndexSettings(
        embedding_model=create_test_embedding_model(dim), min_score=0.0, device="cpu"
    ))
    i8 = port_store(dim)
    f32.add_embeddings(None, matrix)
    i8.add_embeddings(None, matrix)
    queries = _normed(rng, 16, dim)
    exact = f32.fuzzy_lookup_embeddings_batch(queries, max_hits=10)
    quant = i8.fuzzy_lookup_embeddings_batch(queries, max_hits=10)
    recall = np.mean([len({r.item for r in e} & {r.item for r in q}) / 10 for e, q in zip(exact, quant)])
    assert recall >= 0.9
    for e, q in zip(exact, quant):
        assert q[0].score == pytest.approx(e[0].score, abs=5e-3)
