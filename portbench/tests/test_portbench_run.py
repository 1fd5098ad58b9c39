"""CPU rehearsals of whole runs at tiny sizes (the card check skipped: the
command itself refuses a machine without a card), the check's control,
and the faults the check must catch with the timed path broken
underneath."""

from __future__ import annotations

import asyncio
import json

import pytest
import torch

from portbench import check, run
from portbench.tests.tiny import CELLS, tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 77


@pytest.fixture(autouse=True)
def _small_store_takes_the_hybrid_route(monkeypatch):
    """At tiny sizes the store takes the route it takes at 5M rows."""
    from typeagent_tpu_torch import vectorstore

    monkeypatch.setattr(vectorstore, "EXACT2_MIN_ROWS", 2048)


def _run(name: str, traced: bool = False, control: bool = False, seconds: float = 1.0) -> dict:
    return asyncio.run(run.run_cell(tiny_cell(name), SEED, seconds, traced, CPU, control=control))


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_run_prints_the_contract_line_and_is_correct(name):
    out = _run(name)
    r = out["result"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in tiny_cell(name).end_to_end}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["check"]) == set(check.NUMBERS)
    assert out["checked"] > 0
    json.dumps(r)


@pytest.mark.parametrize("name", ["ada1536-5m.messages64", "cohere768-10m.filter1p"])
def test_a_traced_run_carries_per_layer_metrics_and_a_breakdown(name):
    r = _run(name, traced=True)["result"]
    assert set(r["metrics"]) <= {m["name"] for m in tiny_cell(name).per_layer}
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["correct"] is True


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_fails_the_check(name):
    out = _run(name, control=True)
    assert out["result"]["correct"] is True
    ok, _ = check.verdict(out["control"], tiny_cell(name).cfg["check"])
    assert not ok


def _fault(monkeypatch, fault: str) -> None:
    from typeagent_tpu_torch import vectorstore
    from typeagent_tpu_torch.parallel import corpus, sharded

    if fault == "answer_altered":
        real = vectorstore._materialize_rows

        def altered(vals, idx, b, min_score):
            rows = real(vals, idx, b, min_score)
            for row in rows[:1]:
                row[0] = vectorstore.ScoredInt(row[0].item + 1, row[0].score)
            return rows

        monkeypatch.setattr(vectorstore, "_materialize_rows", altered)
    elif fault == "half_the_rows":
        real_view = vectorstore.VectorStore._dispatch_view

        def half(self):
            with real_view(self) as (buf, scales, count):
                yield buf, scales, count // 2

        import contextlib

        monkeypatch.setattr(vectorstore.VectorStore, "_dispatch_view", contextlib.contextmanager(half))
    elif fault == "half_the_batch_dropped":
        real_many = vectorstore.VectorStore.fuzzy_lookup_embeddings_many

        def halved(self, query_batches, max_hits=None, min_score=None):
            out = real_many(self, query_batches, max_hits, min_score)
            return out[: (len(out) + 1) // 2] + [[[] for _ in rows] for rows in out[(len(out) + 1) // 2 :]]

        monkeypatch.setattr(vectorstore.VectorStore, "fuzzy_lookup_embeddings_many", halved)
    elif fault == "answers_of_another_request":
        real_many = vectorstore.VectorStore.fuzzy_lookup_embeddings_many

        def rotated(self, query_batches, max_hits=None, min_score=None):
            out = real_many(self, query_batches, max_hits, min_score)
            return out[1:] + out[:1]

        monkeypatch.setattr(vectorstore.VectorStore, "fuzzy_lookup_embeddings_many", rotated)
    elif fault == "scope_dropped":
        def everything(self, wanted):
            return torch.tensor([[0, len(self)]], dtype=torch.int32).numpy()

        monkeypatch.setattr(corpus.CorpusVectorStore, "_segment_intervals", everything)
    elif fault == "corpus_answer_altered":
        real_search = sharded.ShardedVectorStore.search

        def altered_search(self, *args, **kwargs):
            raw = real_search(self, *args, **kwargs)
            raw[0][0] = (raw[0][0][0] + 1, raw[0][0][1])
            return raw

        monkeypatch.setattr(sharded.ShardedVectorStore, "search", altered_search)
    elif fault == "ordinal_shifted":
        real_resolve = corpus.CorpusVectorStore._resolve

        def shifted(self, starts, g):
            conv, local = real_resolve(self, starts, g)
            return conv, local + 1

        monkeypatch.setattr(corpus.CorpusVectorStore, "_resolve", shifted)
    elif fault == "half_the_corpus":
        real_sview = sharded.ShardedVectorStore._view

        def half_corpus(self):
            with real_sview(self) as count:
                yield count // 2

        import contextlib

        monkeypatch.setattr(sharded.ShardedVectorStore, "_view", contextlib.contextmanager(half_corpus))


@pytest.mark.parametrize("name,fault", [
    ("ada1536-5m.messages64", "answer_altered"),
    ("ada1536-5m.messages64", "half_the_rows"),
    ("ada1536-5m.messages64", "half_the_batch_dropped"),
    ("ada1536-5m.messages64", "answers_of_another_request"),
    ("cohere768-10m.unfiltered", "corpus_answer_altered"),
    ("cohere768-10m.filter1p", "scope_dropped"),
    ("cohere768-10m.filter1p", "ordinal_shifted"),
    ("cohere768-10m.unfiltered", "half_the_corpus"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    _fault(monkeypatch, fault)
    cell = tiny_cell(name)
    if fault == "scope_dropped":
        # Half the ids out of scope, so that every search would show it,
        # however few a loaded test machine completes in the window.
        cell.mix["filter_rate"] = 0.5
    out = asyncio.run(run.run_cell(cell, SEED, 1.0, False, CPU))
    assert out["result"]["correct"] is False


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = asyncio.run(run.run_cell(tiny_cell("cohere768-10m.filter1p"), SEED, 1.0, True,
                                   torch.device("cuda", 0)))
    assert out["result"]["correct"] is True
