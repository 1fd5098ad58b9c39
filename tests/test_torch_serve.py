"""Parity: the port's LookupBatcher (typeagent_tpu_torch/serve.py) against
the JAX package's, serving the same rows and the same concurrent requests.

Pins what tests/test_serve.py pins for the JAX batcher: coalesced results
equal per-batch results (per-request min_score / max_hits honoured across a
shared dispatch), ragged sizes pad and slice, concurrent callers share
dispatches, close() drains, large-k requests ride alone.
"""

import asyncio
import threading
import time

import numpy as np
import pytest

from typeagent_tpu import serve as jserve
from typeagent_tpu import vectorstore as jvs
from typeagent_tpu.models.adapters import create_test_embedding_model as jax_model
from typeagent_tpu_torch import vectorstore as vs_mod
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.serve import LookupBatcher
from typeagent_tpu_torch.utils.metrics import METRICS
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

D = 32


def _rows():
    rng = np.random.default_rng(3)
    m = rng.standard_normal((600, D)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.fixture
def store():
    s = VectorStore(
        TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(D), min_score=0.0, device="cpu"
        )
    )
    s.add_embeddings(None, _rows())
    return s


@pytest.fixture
def jstore():
    s = jvs.VectorStore(jvs.TextEmbeddingIndexSettings(embedding_model=jax_model(D), min_score=0.0))
    s.add_embeddings(None, _rows())
    return s


def _queries(rng, b, d=D):
    q = rng.standard_normal((b, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _items(rows):
    return [[s.item for s in row] for row in rows]


async def _serve(batcher, requests):
    out = await asyncio.gather(*(batcher.lookup(q, max_hits=k, min_score=s) for q, k, s in requests))
    await batcher.close()
    return out


@pytest.mark.parametrize("exact2", [False, True])
def test_coalesced_serving_matches_jax_batcher(store, jstore, monkeypatch, exact2):
    if exact2:  # the 600-row store takes the hybrid exact2 route
        monkeypatch.setattr(vs_mod, "EXACT2_MIN_ROWS", 100)
        monkeypatch.setattr(jvs, "EXACT2_MIN_ROWS", 100)
    rng = np.random.default_rng(6)
    requests = [(_queries(rng, int(b)), int(k), float(s)) for b, k, s in zip(
        rng.integers(1, 9, 12), rng.integers(1, 12, 12), rng.choice([0.0, 0.5, 0.6], 12)
    )]
    batcher = LookupBatcher(store, max_delay_ms=5.0, max_coalesce=8)
    jbatcher = jserve.LookupBatcher(jstore, max_delay_ms=5.0, max_coalesce=8)
    got = asyncio.run(_serve(batcher, requests))
    want = asyncio.run(_serve(jbatcher, requests))
    assert batcher.served == jbatcher.served == 12
    assert batcher.dispatches < 12  # real coalescing happened
    for (q, _, _), a_rows, b_rows in zip(requests, got, want):
        assert len(a_rows) == q.shape[0]
        assert _items(a_rows) == _items(b_rows)
        for a, b in zip(a_rows, b_rows):
            np.testing.assert_allclose([s.score for s in a], [s.score for s in b], atol=1e-6)


def test_single_request_passthrough(store):
    rng = np.random.default_rng(5)
    q = _queries(rng, 4)
    batcher = LookupBatcher(store, max_delay_ms=0.0)
    res = asyncio.run(_serve(batcher, [(q, 5, 0.2)]))[0]
    assert _items(res) == _items(store.fuzzy_lookup_embeddings_batch(q, max_hits=5, min_score=0.2))
    assert batcher.stats() == {"dispatches": 1, "served": 1, "peak_inflight": 1}


def test_dispatch_metrics_recorded(store):
    rng = np.random.default_rng(15)
    before = METRICS.counters.get("serve.requests", 0)
    asyncio.run(_serve(LookupBatcher(store, max_delay_ms=2.0), [(_queries(rng, 2), 3, 0.0)] * 3))
    assert METRICS.counters["serve.requests"] - before == 3
    assert METRICS.stats("serve.dispatch").count >= 1


def test_ragged_sizes_and_per_request_params(store):
    rng = np.random.default_rng(7)
    q_small, q_big = _queries(rng, 2), _queries(rng, 7)
    r_small, r_big = asyncio.run(
        _serve(LookupBatcher(store, max_delay_ms=5.0), [(q_small, 3, 0.5), (q_big, 8, 0.0)])
    )
    assert len(r_small) == 2 and len(r_big) == 7
    assert _items(r_small) == _items(store.fuzzy_lookup_embeddings_batch(q_small, max_hits=3, min_score=0.5))
    assert _items(r_big) == _items(store.fuzzy_lookup_embeddings_batch(q_big, max_hits=8, min_score=0.0))


def test_mixed_dims_rejected(store):
    rng = np.random.default_rng(8)

    async def run():
        batcher = LookupBatcher(store, max_delay_ms=5.0)
        with pytest.raises(ValueError, match="Mixed embedding dims"):
            await asyncio.gather(
                batcher.lookup(_queries(rng, 2)),
                batcher.lookup(rng.standard_normal((2, 16)).astype(np.float32)),
            )
        await batcher.close()

    asyncio.run(run())


def test_closed_batcher_rejects(store):
    async def run():
        batcher = LookupBatcher(store)
        await batcher.close()
        with pytest.raises(RuntimeError, match="closed"):
            await batcher.lookup(np.zeros((1, D), np.float32))

    asyncio.run(run())


def test_unlimited_max_hits_rides_alone(store):
    rng = np.random.default_rng(21)
    small_qs = [_queries(rng, 4) for _ in range(4)]
    big_q = _queries(rng, 2)
    batcher = LookupBatcher(store, max_delay_ms=5.0, max_coalesce=8)
    outs = asyncio.run(
        _serve(batcher, [(q, 5, 0.2) for q in small_qs] + [(big_q, len(store), 0.0)])
    )
    assert batcher.dispatches >= 2
    for q, got in zip(small_qs, outs[:4]):
        assert _items(got) == _items(store.fuzzy_lookup_embeddings_batch(q, max_hits=5, min_score=0.2))
    want_big = store.fuzzy_lookup_embeddings_batch(big_q, max_hits=len(store), min_score=0.0)
    assert [len(r) for r in outs[4]] == [len(r) for r in want_big] == [600, 600]


def test_pipelined_dispatches_overlap(store, monkeypatch):
    live = peak = 0
    lock = threading.Lock()
    real = store.fuzzy_lookup_embeddings_batch

    def slow(*args, **kwargs):
        nonlocal live, peak
        with lock:
            live += 1
            peak = max(peak, live)
        time.sleep(0.1)
        try:
            return real(*args, **kwargs)
        finally:
            with lock:
                live -= 1

    monkeypatch.setattr(store, "fuzzy_lookup_embeddings_batch", slow)
    rng = np.random.default_rng(12)
    batches = [_queries(rng, 3) for _ in range(4)]
    batcher = LookupBatcher(store, max_delay_ms=0.0, max_coalesce=1, max_inflight=2)
    results = asyncio.run(_serve(batcher, [(q, 5, 0.0) for q in batches]))
    assert batcher.dispatches == 4 and peak >= 2 and batcher.peak_inflight >= 2
    for q, res in zip(batches, results):
        assert _items(res) == _items(real(q, max_hits=5))


def test_store_async_route_rebinds_per_loop(store):
    rng = np.random.default_rng(24)
    q = _queries(rng, 2)

    async def use_store():
        return await store.fuzzy_lookup_embeddings_batch_async(q, max_hits=3)

    loop1 = asyncio.new_event_loop()
    try:
        assert len(loop1.run_until_complete(use_store())) == 2
    finally:
        loop1.close()
    first = store._batcher
    loop2 = asyncio.new_event_loop()
    try:
        res = loop2.run_until_complete(use_store())
    finally:
        loop2.close()
    assert store._batcher is not first and first._closed
    assert _items(res) == _items(store.fuzzy_lookup_embeddings_batch(q, max_hits=3))
