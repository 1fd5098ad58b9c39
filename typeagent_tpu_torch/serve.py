"""Adaptive micro-batching for served lookups.

Each dispatch pays a fixed cost (query upload, kernel launches, one
synchronisation and result copy) whatever its batch size, so a loaded
server coalesces: N callers' query batches ride ONE dispatch
(``VectorStore.fuzzy_lookup_embeddings_many``). Under light load requests
go straight through; under heavy load throughput approaches the device
rate. Behaviour is that of the JAX package's ``typeagent_tpu/serve.py``.

Usage::

    q = LookupBatcher(store, max_delay_ms=2.0, max_coalesce=16)
    results = await q.lookup(queries)        # [b, d] -> list[list[ScoredInt]]
    ...
    await q.close()
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

import numpy as np

from .utils.metrics import METRICS
from .vectorstore import ScoredInt, VectorStore

__all__ = ["LookupBatcher"]

# Requests asking for more hits than this never coalesce: one "give me
# everything" request (max_hits = len(store), the default when settings
# set no limit) would otherwise force k_max = count onto every top-10
# neighbor in its group — a full-store sort plus a count-wide fetch per
# coalesced request. Past the fused kernel's k range they ride alone.
_COALESCE_K_CAP = 128


@dataclass
class _Pending:
    queries: np.ndarray  # [b, d]
    max_hits: int
    min_score: float
    future: asyncio.Future = field(default_factory=lambda: None)


class LookupBatcher:
    """Coalesces concurrent fuzzy-lookup calls into single device dispatches.

    Requests arriving while a dispatch is in flight accumulate; the next
    dispatch takes up to ``max_coalesce`` of them at once. Up to
    ``max_inflight`` dispatches run concurrently (double-buffering by
    default): the device serializes their compute, but one dispatch's
    result download and host-side materialization overlap the next one's
    query upload and launches.
    An idle request waits at most ``max_delay_ms`` for company before
    dispatching alone.
    Batches with identical (b, max_hits, min_score) shapes ride the
    multi-batch program; ragged ones are padded to the largest b in the
    group (results are sliced back).
    """

    def __init__(
        self,
        store: VectorStore,
        *,
        max_delay_ms: float = 2.0,
        max_coalesce: int = 16,
        max_inflight: int = 2,
    ):
        self._store = store
        self._max_delay = max_delay_ms / 1000.0
        self._max_coalesce = max(1, max_coalesce)
        self._max_inflight = max(1, max_inflight)
        self._queue: list[_Pending] = []
        self._wakeup: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._inflight: asyncio.Semaphore | None = None
        self._dispatch_tasks: set[asyncio.Task] = set()
        self._closed = False
        self.dispatches = 0  # observability: device dispatches issued
        self.served = 0  # batches served
        self.peak_inflight = 0  # max concurrent dispatches observed
        self._cur_inflight = 0

    def stats(self) -> dict[str, int]:
        """Snapshot of the batcher's dispatch counters (plain ints).

        Dispatch latency/QPS distributions live in the process-wide
        ``utils.metrics.METRICS`` registry; this view carries only the
        coalescing-efficiency counters owned by this batcher instance.
        """
        return {
            "dispatches": self.dispatches,
            "served": self.served,
            "peak_inflight": self.peak_inflight,
        }

    async def lookup(
        self,
        queries: np.ndarray,
        max_hits: int = 10,
        min_score: float = 0.0,
    ) -> list[list[ScoredInt]]:
        """Lookup one query batch; may be coalesced with concurrent callers."""
        if self._closed:
            raise RuntimeError("LookupBatcher is closed")
        self._ensure_worker()
        item = _Pending(
            np.asarray(queries, dtype=np.float32), max_hits, float(min_score)
        )
        item.future = asyncio.get_running_loop().create_future()
        self._queue.append(item)
        self._wakeup.set()
        return await item.future

    async def close(self) -> None:
        self._closed = True
        if self._task is not None:
            self._wakeup.set()
            await self._task
            self._task = None
        if self._dispatch_tasks:  # drain in-flight dispatches
            await asyncio.gather(
                *list(self._dispatch_tasks), return_exceptions=True
            )

    def close_nowait(self) -> None:
        """Mark closed and wake the worker without awaiting the drain.

        For callers NOT on this batcher's event loop (e.g. a store being
        re-bound to a new loop): schedule via the owning loop's
        ``call_soon_threadsafe`` when that loop is alive; call directly
        when it is already closed (nothing runs concurrently then)."""
        self._closed = True
        if self._wakeup is not None:
            try:
                self._wakeup.set()
            except RuntimeError:
                # Waking a waiter schedules a callback on the owning loop;
                # if that loop is already closed the worker can never
                # resume anyway — marking _closed is all that matters.
                pass

    def _ensure_worker(self) -> None:
        if self._task is None or self._task.done():
            self._wakeup = asyncio.Event()
            if self._inflight is None:
                # Created once for the batcher's lifetime: dispatches still
                # in flight from a dead worker release the SAME semaphore
                # they acquired — replacing it here would let those releases
                # over-credit the new one and break the inflight cap.
                self._inflight = asyncio.Semaphore(self._max_inflight)
            self._task = asyncio.get_running_loop().create_task(self._worker())

    # Consecutive idle poll timeouts before the worker exits (respawned by
    # the next lookup): an idle server must not pay per-store 0.5 s wakeups
    # forever.
    _IDLE_EXIT_POLLS = 2

    async def _worker(self) -> None:
        idle_polls = 0
        while True:
            if not self._queue:
                if self._closed:
                    return
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.5)
                    idle_polls = 0
                except TimeoutError:
                    if not self._queue:
                        idle_polls += 1
                        if idle_polls >= self._IDLE_EXIT_POLLS:
                            return  # _ensure_worker respawns on demand
                if self._closed and not self._queue:
                    return
                continue  # re-check the queue under the non-empty branch
            idle_polls = 0
            # Linger briefly so concurrent callers can pile on.
            if len(self._queue) < self._max_coalesce and self._max_delay > 0:
                await asyncio.sleep(self._max_delay)
            # Pipelined dispatch: up to max_inflight groups run at once
            # (each on an executor thread). The device serializes their
            # compute, but batch N's result download and materialization
            # overlap batch N+1's query upload and launches.
            await self._inflight.acquire()
            group: list[_Pending] = []
            while self._queue and len(group) < self._max_coalesce:
                if self._queue[0].max_hits > _COALESCE_K_CAP:
                    if group:
                        break  # flush the small-k group; big one next round
                    group.append(self._queue.pop(0))
                    break  # full-store-k requests dispatch alone
                group.append(self._queue.pop(0))
            if not group:
                self._inflight.release()
                continue
            task = asyncio.get_running_loop().create_task(
                self._dispatch_guarded(group, self._inflight)
            )
            self._dispatch_tasks.add(task)
            task.add_done_callback(self._dispatch_tasks.discard)

    async def _dispatch_guarded(
        self, group: list[_Pending], sem: asyncio.Semaphore
    ) -> None:
        self._cur_inflight += 1
        self.peak_inflight = max(self.peak_inflight, self._cur_inflight)
        try:
            await self._dispatch_group(group)
        except Exception as exc:  # propagate to all waiters
            for item in group:
                if not item.future.done():
                    item.future.set_exception(exc)
        finally:
            self._cur_inflight -= 1
            sem.release()

    async def _dispatch_group(self, group: list[_Pending]) -> None:
        # The device wait blocks — run it in a thread so the event
        # loop keeps accepting lookups meanwhile
        # (that accumulation is what the next dispatch coalesces).
        loop = asyncio.get_running_loop()
        self.dispatches += 1
        self.served += len(group)
        METRICS.incr("serve.requests", len(group))
        METRICS.incr("serve.dispatches")
        t_dispatch = time.perf_counter()
        if len(group) == 1:
            item = group[0]
            result = await loop.run_in_executor(
                None,
                lambda: self._store.fuzzy_lookup_embeddings_batch(
                    item.queries, max_hits=item.max_hits, min_score=item.min_score
                ),
            )
            if not item.future.done():  # caller may have been cancelled
                item.future.set_result(result)
            METRICS.observe("serve.dispatch", time.perf_counter() - t_dispatch)
            return
        b_max = max(item.queries.shape[0] for item in group)
        d = group[0].queries.shape[1]
        k_max = max(item.max_hits for item in group)
        stacked = np.zeros((len(group), b_max, d), dtype=np.float32)
        for i, item in enumerate(group):
            if item.queries.shape[1] != d:
                raise ValueError(
                    f"Mixed embedding dims in one batcher: {item.queries.shape[1]} vs {d}"
                )
            stacked[i, : item.queries.shape[0]] = item.queries
        # One dispatch; per-request min_score/max_hits applied on the slice.
        many = await loop.run_in_executor(
            None,
            lambda: self._store.fuzzy_lookup_embeddings_many(
                stacked, max_hits=k_max, min_score=0.0
            ),
        )
        METRICS.observe("serve.dispatch", time.perf_counter() - t_dispatch)
        for i, item in enumerate(group):
            rows = many[i][: item.queries.shape[0]]
            if item.min_score <= 0.0 and item.max_hits >= k_max:
                # Scores are clipped to [0, 1] and the shared dispatch used
                # k_max, so the per-record refilter would be a no-op — skip
                # re-walking every record (2,560/batch at b=256, k=10).
                out = rows
            else:
                out = [
                    [s for s in row if s.score >= item.min_score][: item.max_hits]
                    for row in rows
                ]
            if not item.future.done():  # caller may have been cancelled
                item.future.set_result(out)


