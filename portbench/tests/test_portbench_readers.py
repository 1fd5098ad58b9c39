"""The readers of the program's own spans and counters, on a fake
context: known counters give known numbers, a zero denominator or a
program without the counter (an older commit) gives None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import run


def _read(name: str, counters: dict[str, float]):
    return run.read_metric(name, SimpleNamespace(counters=counters))


def test_front_queue_wait_ms():
    name = "front.queue_wait_ms.messages64"
    assert _read(name, {"serve.queue_wait_s": 2.0, "serve.requests": 100.0}) == pytest.approx(20.0)
    assert _read(name, {"serve.queue_wait_s": 0.0, "serve.requests": 0.0}) is None
    assert _read(name, {"serve.requests": 100.0, "serve.dispatches": 7.0}) is None


def test_store_padded_slot_pct():
    name = "store.padded_slot_pct.messages64"
    # 16 one-query requests a dispatch, each padded to a bucket of 8.
    counters = {"vectorstore.query_slots": 10 * 128.0, "vectorstore.queries": 10 * 16.0}
    assert _read(name, counters) == pytest.approx(87.5)
    assert _read(name, {"vectorstore.query_slots": 0.0, "vectorstore.queries": 0.0}) is None
    assert _read(name, {"vectorstore.cert_queries": 16.0}) is None


def test_store_host_ms_per_dispatch():
    name = "store.host_ms_per_dispatch.messages64"
    assert _read(name, {"vectorstore.host_s": 0.5, "vectorstore.dispatches": 1000.0}) == pytest.approx(0.5)
    assert _read(name, {"vectorstore.host_s": 0.0, "vectorstore.dispatches": 0.0}) is None
    assert _read(name, {"vectorstore.cert_queries": 16.0}) is None


@pytest.mark.parametrize("cell", ["unfiltered", "filter1p"])
def test_corpus_host_ms_per_search(cell):
    name = f"corpus.host_ms_per_search.{cell}"
    assert run.reader_path(name).endswith("corpus.host_ms_per_search.py")
    assert _read(name, {"corpus.host_s": 0.75, "corpus.searches": 750.0}) == pytest.approx(1.0)
    assert _read(name, {"corpus.host_s": 0.0, "corpus.searches": 0.0}) is None
    assert _read(name, {"launch.K1": 750.0}) is None
