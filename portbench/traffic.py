"""The one generator of traffic: a mix file's parameters, drawn from the
seed, driven against the system for the window.

A mix file (``traffic/<mix>.json``) names:

- ``entry``: ``store_async`` (``VectorStore``'s async route, callers on
  one event loop) or ``corpus_sync`` (``CorpusVectorStore.search``,
  called in turn from one thread);
- ``clients`` (``store_async`` only): callers on the event loop, each
  sending its next request when its last is answered (``corpus_sync``
  has one);
- ``queries_per_request``: ``[low, high]``, drawn uniformly per request;
- ``filter_rate`` (``corpus_sync`` only; absent for the whole corpus): a
  search sees the ids ``filter_rate * rows`` and up, which must start a
  conversation, and is scoped to those conversations, as VectorDBBench's
  filtered cases keep the ids past that share;
- ``k``, ``min_score``; ``pool``, the queries the requests are cut from,
  each near a uniformly drawn topic; ``warm_seconds`` of the same traffic
  before the window; and the check's sample: ``check_share`` of the
  requests keep their answers, of which at most ``check_queries``
  queries are held to the reference.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from . import generate

# Requests drawn ahead; the window wraps around them if it outruns them.
PLANNED = 1 << 20


@dataclass
class Request:
    index: int
    queries: np.ndarray  # [n, dim] f32
    scope: tuple[int, int] | None  # conversations [lo, hi); None for the whole matrix
    keep: bool  # answers kept for the check


@dataclass
class Done:
    index: int
    n: int
    sent_ns: int
    done_ns: int
    result: object = None  # kept answers
    error: str | None = None


@dataclass
class Window:
    start_ns: int
    stop_ns: int
    done: list[Done] = field(default_factory=list)
    stretch: tuple[int, int] | None = None  # request indices inside the traced stretch

    @property
    def seconds(self) -> float:
        return (self.stop_ns - self.start_ns) * 1e-9


def scope_of(mix: dict, cfg: dict, layout) -> tuple[int, int] | None:
    """The conversations a mix's searches are scoped to, or None."""
    rate = mix.get("filter_rate")
    if rate is None:
        return None
    if layout is None:
        raise ValueError("a filter needs a corpus of conversations")
    return layout.conversations_from(int(round(rate * cfg["rows"])))


class Plan:
    """Every request of a mix, drawn from the seed; request ``i`` is the
    same for one seed whatever the run's length or speed. The seed orders
    the work but does not change how much there is: each run of
    ``high - low + 1`` requests holds every size once, every query is near
    one topic and sees the same scope."""

    def __init__(self, mix: dict, cfg: dict, system, seed: int):
        self.mix = mix
        self.k, self.min_score = mix["k"], mix["min_score"]
        rng = generate.host_rng(seed, generate.STREAM_TRAFFIC)
        lo, hi = mix["queries_per_request"]
        span = hi - lo + 1
        runs = np.argsort(rng.random((PLANNED // span + 1, span)), axis=1)
        self.sizes = lo + runs.reshape(-1)[:PLANNED]
        self.keep = rng.random(PLANNED) < mix["check_share"]
        self.scope = scope_of(mix, cfg, getattr(system, "layout", None))
        n = mix["pool"]
        topics = rng.integers(0, cfg["topics"], n)
        self.pool = generate.queries_near(system.centers, topics, cfg["sigma"], seed, 0)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]]) % n

    def request(self, i: int) -> Request:
        j = i % PLANNED
        n, o = int(self.sizes[j]), int(self.offsets[j])
        take = np.arange(o, o + n) % self.pool.shape[0]
        return Request(i, self.pool[take], self.scope, bool(self.keep[j]))


class Stretch:
    """The traced part of the window, ``[start, stop)`` seconds from its
    start, with the tracer and the host spans it records."""

    def __init__(self, start: float, stop: float, tracer, spans):
        self.start, self.stop = start, stop
        self.tracer, self.spans = tracer, spans

    def begin(self) -> None:
        self.tracer.start()
        self.spans.on = True

    def end(self) -> None:
        self.spans.on = False
        self.tracer.stop()


async def drive_async(system, plan: Plan, seconds: float, start_index: int,
                      stretch: Stretch | None = None) -> Window:
    """The ``store_async`` entry: ``clients`` closed-loop callers on the
    running loop."""
    start = time.perf_counter_ns()
    window = Window(start, start + int(seconds * 1e9))
    spans = stretch.spans if stretch is not None else None

    async def one(req: Request) -> None:
        sent = time.perf_counter_ns()
        result, error = None, None
        try:
            result = await system.lookup(req.queries, plan.k, plan.min_score, req.scope)
        except Exception as exc:  # a failed request counts against the run
            error = repr(exc)
        done = time.perf_counter_ns()
        if spans is not None:
            spans.add("front.lookup", sent, done)
        window.done.append(Done(req.index, req.queries.shape[0], sent, done,
                                result if req.keep else None, error))

    tracing = None
    if stretch is not None:
        tracing = asyncio.create_task(_trace_async(stretch, start, window.stop_ns))
    counter = itertools.count(start_index)

    async def client() -> None:
        while time.perf_counter_ns() < window.stop_ns:
            await one(plan.request(next(counter)))

    await asyncio.gather(*[client() for _ in range(plan.mix["clients"])])
    if tracing is not None:
        await tracing
    return window


async def _trace_async(stretch: Stretch, start_ns: int, stop_ns: int) -> None:
    """Open the stretch at its start and keep it open for its length from
    when the profiler is running, but not past the window."""
    await asyncio.sleep(max(0.0, start_ns * 1e-9 + stretch.start - time.perf_counter()))
    stretch.begin()
    until = min(time.perf_counter() + stretch.stop - stretch.start, stop_ns * 1e-9)
    await asyncio.sleep(max(0.0, until - time.perf_counter()))
    stretch.end()


def drive_sync(system, plan: Plan, seconds: float, start_index: int,
               stretch: Stretch | None = None) -> Window:
    """The ``corpus_sync`` entry: one caller, requests in turn. The traced
    stretch opens and closes between requests, so the requests inside it
    are known whole."""
    start = time.perf_counter_ns()
    window = Window(start, start + int(seconds * 1e9))
    spans = stretch.spans if stretch is not None else None
    tracing, first_traced, traced_from = False, None, 0.0
    i = start_index
    while (now := time.perf_counter_ns()) < window.stop_ns:
        if stretch is not None:
            elapsed = (now - start) * 1e-9
            if not tracing and first_traced is None and elapsed >= stretch.start:
                stretch.begin()
                tracing, first_traced, traced_from = True, i, time.perf_counter()
            elif tracing and time.perf_counter() - traced_from >= stretch.stop - stretch.start:
                stretch.end()
                tracing, window.stretch = False, (first_traced, i)
        req = plan.request(i)
        sent = time.perf_counter_ns()
        result, error = None, None
        try:
            result = system.search(req.queries, plan.k, plan.min_score, req.scope)
        except Exception as exc:  # a failed request counts against the run
            error = repr(exc)
        done = time.perf_counter_ns()
        if spans is not None:
            spans.add("corpus.search", sent, done)
        window.done.append(Done(i, req.queries.shape[0], sent, done,
                                result if req.keep else None, error))
        i += 1
    if tracing:
        stretch.end()
        window.stretch = (first_traced, i)
    return window
