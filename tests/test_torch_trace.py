"""The port's tracing (``typeagent_tpu_torch/utils/trace.py``) and the
spans and counters of the serving front, the store and the corpus.

Spans carry ids, parents and request ids; serving-path spans keep nothing
unless recording (a ``torch.profiler`` session, or ``trace.recording()``);
the store's spans on the batcher's executor thread are children of their
dispatch, which lists its requests; the counters add up what the benchmark's
per-layer metrics read.
"""

import asyncio
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.parallel import sharded
from typeagent_tpu_torch.parallel.corpus import CorpusVectorStore
from typeagent_tpu_torch.serve import LookupBatcher
from typeagent_tpu_torch.utils import trace
from typeagent_tpu_torch.utils.metrics import METRICS, MetricsRegistry
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

D = 16
STORE_SPANS = {"store.upload", "store.launch", "store.fetch", "store.materialize"}


def _unit(rng, n: int) -> np.ndarray:
    m = rng.standard_normal((n, D)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.fixture
def store():
    s = VectorStore(
        TextEmbeddingIndexSettings(create_test_embedding_model(D), min_score=0.0, device="cpu")
    )
    s.add_embeddings(None, _unit(np.random.default_rng(5), 400))
    return s


def _coalesced(store, n_requests: int = 8, b: int = 1):
    """``n_requests`` concurrent lookups of ``b`` queries each, which the
    batcher takes as one group (the worker lingers 50 ms)."""
    rng = np.random.default_rng(11)

    async def main():
        batcher = LookupBatcher(store, max_delay_ms=50.0, max_coalesce=16, max_inflight=1)
        try:
            return await asyncio.gather(
                *[batcher.lookup(_unit(rng, b), max_hits=5) for _ in range(n_requests)]
            )
        finally:
            await batcher.close()

    return asyncio.run(main())


def _new_spans(before: list) -> list:
    seen = {id(s) for s in before}
    return [s for s in trace.finished_spans() if id(s) not in seen]


def _counters() -> dict:
    return dict(METRICS.counters)


def _delta(before: dict, name: str) -> float:
    return METRICS.counters.get(name, 0.0) - before.get(name, 0.0)


def test_spans_get_ids_parents_and_request_ids():
    with trace.span("outer", conversation="x") as outer:
        assert trace.current_span() is outer
        with trace.span("inner") as inner:
            assert inner.parent is outer and inner.path == "outer/inner"
            inner.set(rows=3)
    assert trace.current_span() is None
    assert outer.parent_id is None and outer.request_id == outer.span_id
    assert inner.parent_id == outer.span_id and inner.request_id == outer.request_id
    assert inner.span_id != outer.span_id
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert inner.attributes == {"rows": 3} and outer.attributes == {"conversation": "x"}
    assert inner.duration_ms >= 0.0
    # The mirrored contract: every plain span records span.<path>.
    assert METRICS.stats("span.outer/inner").count >= 1
    with trace.span("other") as other:
        pass
    assert other.request_id != outer.request_id


def test_recorded_site_is_a_child_of_the_current_span():
    with trace.recording(), trace.span("caller") as caller:
        with trace.Site("unit.site", "unit.site_s")() as site:
            assert site is not None and trace.current_span() is site
        begun = trace.Site("unit.begun").begin()
        trace.end(begun)
    assert site.parent is caller and site.request_id == caller.request_id
    assert begun.parent_id == caller.span_id and begun.end_ns >= begun.start_ns
    assert trace.finished_spans()[-3:] == [site, begun, caller]


def test_recording_off_keeps_nothing_for_serving_spans(store):
    assert not trace.recording_on()
    ring = trace.finished_spans()
    keys = set(METRICS.latencies)
    before = _counters()
    with trace.Site("unit.off", "unit.off_s")() as site:
        assert site is None
    assert trace.Site("unit.off").begin() is None
    _coalesced(store)
    store.fuzzy_lookup_embeddings_batch(_unit(np.random.default_rng(1), 3), max_hits=5)
    assert trace.finished_spans() == ring
    assert set(METRICS.latencies) - keys <= {"serve.dispatch"}
    # The counters are kept all the same.
    assert _delta(before, "unit.off_s") > 0.0
    assert _delta(before, "serve.queue_wait_s") > 0.0
    assert _delta(before, "vectorstore.dispatches") == 2
    assert _delta(before, "vectorstore.host_s") > 0.0 and _delta(before, "vectorstore.fetch_s") > 0.0


@pytest.mark.parametrize("all_threads", [False, True], ids=["session_thread", "all_threads"])
def test_a_profiler_session_records_spans_without_recording(store, all_threads):
    before = trace.finished_spans()
    kwargs = {}
    if all_threads:
        kwargs["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True
        )
    loop_thread = threading.get_ident()
    threads = set()
    real = store.fuzzy_lookup_embeddings_many

    def many(*args, **kw):
        threads.add(threading.get_ident())
        return real(*args, **kw)

    store.fuzzy_lookup_embeddings_many = many
    with profile(activities=[ProfilerActivity.CPU], **kwargs) as prof:
        assert trace.recording_on()
        _coalesced(store)
    assert not trace.recording_on()
    assert threads and loop_thread not in threads  # the store ran on the executor
    recorded = {s.name for s in _new_spans(before)}
    assert {"serve.request", "serve.queue", "serve.dispatch", "serve.stack", "serve.split"} <= recorded
    assert STORE_SPANS <= recorded
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"serve.request", "serve.dispatch", "serve.stack", "serve.split"} <= events
    if all_threads:
        assert STORE_SPANS <= events


def test_store_spans_of_a_coalesced_dispatch_have_it_as_parent(store):
    before = trace.finished_spans()
    with trace.recording():
        _coalesced(store, n_requests=6)
    spans = _new_spans(before)
    dispatch = [s for s in spans if s.name == "serve.dispatch"]
    assert len(dispatch) == 1
    dispatch = dispatch[0]
    assert dispatch.parent_id is None
    requests = [s for s in spans if s.name == "serve.request"]
    assert len(requests) == 6
    assert sorted(dispatch.attributes["requests"]) == sorted(r.request_id for r in requests)
    by_id = {s.span_id: s for s in spans}
    for q in (s for s in spans if s.name == "serve.queue"):
        assert by_id[q.parent_id].name == "serve.request" and q.request_id == q.parent_id
        assert q.end_ns <= dispatch.start_ns  # the group was taken, then dispatched
    store_spans = [s for s in spans if s.name.startswith("store.")]
    assert {s.name for s in store_spans} == STORE_SPANS
    for s in store_spans + [x for x in spans if x.name in ("serve.stack", "serve.split")]:
        assert s.parent_id == dispatch.span_id and s.request_id == dispatch.request_id
        assert dispatch.start_ns <= s.start_ns <= s.end_ns <= dispatch.end_ns


@pytest.mark.parametrize("n_requests", [1, 6, 16])
def test_query_slots_less_queries_is_the_bucket_padding(store, n_requests):
    before = _counters()
    _coalesced(store, n_requests=n_requests)
    queries = _delta(before, "vectorstore.queries")
    slots = _delta(before, "vectorstore.query_slots")
    assert _delta(before, "vectorstore.dispatches") == 1
    assert queries == n_requests
    # One request rides the batch route, a group one flat batch: either way
    # the n queries are padded to the bucket of n.
    assert slots - queries == {1: 7, 6: 2, 16: 0}[n_requests]
    assert _delta(before, "serve.requests") == n_requests


def test_a_certificate_miss_is_a_span(store):
    from typeagent_tpu_torch import vectorstore

    store._flush()
    q = store._pad_queries(_unit(np.random.default_rng(2), 2))  # 2 queries in 8 slots
    vals, idx = vectorstore._fetch(*torch.topk(torch.rand(8, 5), 5))
    held = np.ones(8, dtype=bool)
    missed = held.copy()
    missed[1] = False
    before = trace.finished_spans()
    with trace.recording():
        store._resolve_cert_misses(vals, idx, held, q, 5, len(store), 2)
        assert _new_spans(before) == []
        store._resolve_cert_misses(vals, idx, missed, q, 5, len(store), 2)
    assert [s.name for s in _new_spans(before)] == ["store.cert_rerun"]


def _corpus(dtype: str = "float32") -> CorpusVectorStore:
    rng = np.random.default_rng(7)
    corpus = CorpusVectorStore(D, device="cpu", dtype=dtype)
    for name in ("a", "b", "c", "d"):
        corpus.append(name, _unit(rng, 50))
    return corpus


def test_a_scoped_corpus_search_adds_scope_time_and_an_unscoped_one_does_not():
    corpus = _corpus()
    q = _unit(np.random.default_rng(8), 1)
    before = _counters()
    corpus.search(q, 5)
    assert _delta(before, "corpus.searches") == 1
    assert _delta(before, "corpus.scope_s") == 0.0
    assert _delta(before, "corpus.host_s") > 0.0 and _delta(before, "corpus.fetch_s") > 0.0
    assert _delta(before, "corpus.resolve_s") > 0.0
    before = _counters()
    hits = corpus.search(q, 5, conversations=["b", "c"])
    assert {h.conversation for h in hits[0]} <= {"b", "c"}
    assert _delta(before, "corpus.searches") == 1
    assert _delta(before, "corpus.scope_s") > 0.0
    assert _delta(before, "corpus.host_s") >= _delta(before, "corpus.scope_s")


def test_corpus_spans_nest_under_the_query():
    corpus = _corpus()
    before = trace.finished_spans()
    with trace.recording():
        corpus.search(_unit(np.random.default_rng(9), 1), 5, conversations=["a"])
    spans = _new_spans(before)
    root = spans[-1]
    assert root.name == "corpus.query" and root.parent_id is None
    assert [s.name for s in spans[:-1]] == [
        "corpus.normalize", "corpus.scope", "corpus.launch", "corpus.fetch", "corpus.resolve",
    ]
    assert all(s.parent_id == root.span_id for s in spans[:-1])


def test_an_int8_scoped_search_counts_its_row_mask_under_the_launch():
    corpus = _corpus("int8")
    q = _unit(np.random.default_rng(9), 1)
    before, spans_before = _counters(), trace.finished_spans()
    with trace.recording():
        hits = corpus.search(q, 5, conversations=["b", "d"])
    assert {h.conversation for h in hits[0]} <= {"b", "d"}
    # One mask over the shard's whole capacity, however small the scope.
    assert _delta(before, "corpus.rowmask_rows") == corpus._store.local_n
    assert _delta(before, "corpus.rowmask_s") > 0.0
    spans = _new_spans(spans_before)
    launch = next(s for s in spans if s.name == "corpus.launch")
    (mask,) = [s for s in spans if s.name == "corpus.rowmask"]
    assert mask.parent_id == launch.span_id
    assert launch.start_ns <= mask.start_ns <= mask.end_ns <= launch.end_ns


@pytest.mark.parametrize("dtype,conversations", [
    ("int8", None), ("float32", None), ("float32", ["a", "c"]), ("bfloat16", ["b", "c", "d"]),
])
def test_no_row_mask_is_built_off_the_int8_scoped_route(dtype, conversations):
    corpus = _corpus(dtype)
    before = _counters()
    corpus.search(_unit(np.random.default_rng(9), 2), 5, conversations=conversations)
    assert _delta(before, "corpus.searches") == 1
    assert _delta(before, "corpus.rowmask_rows") == 0.0
    assert _delta(before, "corpus.rowmask_s") == 0.0


@pytest.mark.parametrize("on_device", [False, True])
def test_an_int8_append_counts_the_rows_it_quantizes(on_device):
    corpus = CorpusVectorStore(D, device="cpu", dtype="int8")
    rows = _unit(np.random.default_rng(3), 70)
    before, spans_before = _counters(), trace.finished_spans()
    with trace.recording():
        if on_device:
            corpus.append_device("a", torch.from_numpy(rows))
        else:
            corpus.append("a", rows)
            corpus.search(rows[:1], 1)  # the pending rows flush here
    assert _delta(before, "corpus.quantized_rows") == 70
    assert _delta(before, "corpus.quantize_s") > 0.0
    assert [s.name for s in _new_spans(spans_before)].count("corpus.quantize") == 1


def test_an_f32_append_quantizes_nothing():
    before = _counters()
    _corpus("float32").search(_unit(np.random.default_rng(9), 1), 5)
    assert _delta(before, "corpus.quantized_rows") == 0.0
    assert _delta(before, "corpus.quantize_s") == 0.0


@pytest.mark.parametrize("offset,table", [
    (0, [[100, 300]]),
    (0, [[0, 64], [256, 700], [900, 1024], [0, 0]]),
    (512, [[600, 800], [1000, 1400]]),  # one interval across the shard's first row
    (1024, [[0, 900], [2100, 2200]]),  # one interval before the shard, one past it
])
def test_the_int8_interval_route_answers_as_topk_program_intervals_quantized(offset, table):
    rng = np.random.default_rng(13)
    local_n, count, k = 1024, 900 + offset, 10
    rows = torch.from_numpy(_unit(rng, local_n))
    emb, scales = topk.quantize_rows_device(rows)
    q = torch.from_numpy(_unit(rng, 8)).to(torch.bfloat16).float()
    intervals = torch.tensor(table, dtype=torch.int32)
    got = sharded._shard_interval_topk(emb, scales, offset, intervals, q, count, k)
    local_iv = (intervals - offset).clamp(0, local_n)
    want = sharded._to_global(*topk.topk_program_intervals_quantized(
        emb, scales, q, sharded._local_count(count, offset, local_n), local_iv, k), offset)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_ring_stays_bounded():
    site = trace.Site("unit.ring")
    with trace.recording():
        for _ in range(trace.RING_SIZE + 100):
            with site():
                pass
    ring = trace.finished_spans()
    assert len(ring) == trace.RING_SIZE
    assert all(s.name == "unit.ring" for s in ring)
    ids = [s.span_id for s in ring]
    assert ids == sorted(ids)


def test_concurrent_incr_loses_no_count():
    registry = MetricsRegistry()
    n_threads, n_each = 16, 5000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [registry.incr("c", 1.0) for _ in range(n_each)])
            for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert registry.counters["c"] == n_threads * n_each


def test_latency_report_has_mean_and_no_qps():
    registry = MetricsRegistry()
    for ms in (1.0, 3.0):
        registry.observe("x", ms / 1000)
    entry = registry.report()["latency"]["x"]
    assert "qps" not in entry and entry["mean_ms"] == pytest.approx(2.0)
    assert not hasattr(registry.stats("x"), "qps")
