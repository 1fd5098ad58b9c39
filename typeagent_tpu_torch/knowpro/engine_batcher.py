"""Cross-call coalescing for the device query engine.

The port of ``typeagent_tpu/knowpro/engine_batcher.py``. N concurrent
``query()`` pipelines each execute 1-2 compiled stage-3 queries (reference
semantics: one ``select_expression`` per query plus the verb-scope
fallback, reference ``knowpro/searchlang.py:149-192``). This batcher
queues compiled queries from concurrent callers and dispatches them
through ONE ``DeviceQueryExecutor.execute_batch`` call, whose plan packing
fuses them into as few device calls as the memory guard allows.

Exactly one dispatch is in flight at a time, as in the JAX package: the
win comes from fewer, bigger dispatches. Requests arriving while a
dispatch runs simply accumulate for the next one — a lone caller therefore
dispatches immediately with zero added latency, and coalescing emerges
only under real concurrency.

Results are identical to un-coalesced execution: ``execute_batch``
evaluates each query against its own scope/when-filter, and the batcher
preserves per-call result order.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Any, Awaitable, Callable

logger = logging.getLogger(__name__)

__all__ = ["EngineBatcher"]


@dataclasses.dataclass
class _Pending:
    query: Any
    future: asyncio.Future = dataclasses.field(init=False)


class EngineBatcher:
    """Coalesces concurrent device-engine executions for one conversation.

    ``get_executor`` is an async callable returning a live
    ``(DeviceQueryExecutor, QueryEvalContext)`` pair (it re-syncs the
    executor when semrefs were appended); it is resolved per dispatch so
    the batcher always runs against current index state.
    """

    def __init__(
        self,
        conversation: Any,
        get_executor: Callable[[Any], Awaitable[tuple[Any, Any]]],
        *,
        max_coalesce: int = 64,
    ):
        self._conv = conversation
        self._get_executor = get_executor
        self._max_coalesce = max(1, max_coalesce)
        self._queue: list[_Pending] = []
        self._wakeup: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self.loop: asyncio.AbstractEventLoop | None = None
        self.dispatches = 0  # device execute_batch calls issued
        self.served = 0  # queries served
        self.peak_batch = 0  # largest coalesced dispatch observed

    def stats(self) -> dict[str, int]:
        return {
            "dispatches": self.dispatches,
            "served": self.served,
            "peak_batch": self.peak_batch,
        }

    async def execute_batch(self, compiled: list[Any]) -> list[Any]:
        """Execute compiled stage-3 queries; may coalesce with concurrent
        callers. A dispatch failure reaches every waiter as a RuntimeError
        (``knowpro/search.py`` lets it propagate: no host answer in its
        place)."""
        self._ensure_worker()
        loop = asyncio.get_running_loop()
        items = []
        for query in compiled:
            item = _Pending(query)
            item.future = loop.create_future()
            items.append(item)
        self._queue.extend(items)
        self._wakeup.set()
        return list(await asyncio.gather(*[it.future for it in items]))

    def _ensure_worker(self) -> None:
        loop = asyncio.get_running_loop()
        if self._task is None or self._task.done() or self.loop is not loop:
            # A worker from a previous (now-dead) event loop can never run
            # again; abandon it and serve this loop. knowpro/search.py keys
            # cached batchers by loop so live loops never collide here.
            self.loop = loop
            self._wakeup = asyncio.Event()
            self._task = loop.create_task(self._worker())

    # Consecutive idle poll timeouts before the worker exits (respawned by
    # the next call): an idle conversation must not pay 0.5 s wakeups
    # forever.
    _IDLE_EXIT_POLLS = 2

    async def _worker(self) -> None:
        idle_polls = 0
        while True:
            if not self._queue:
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.5)
                    idle_polls = 0
                except TimeoutError:
                    if not self._queue:
                        idle_polls += 1
                        if idle_polls >= self._IDLE_EXIT_POLLS:
                            return
                continue
            take = self._queue[: self._max_coalesce]
            del self._queue[: len(take)]
            self.dispatches += 1
            self.served += len(take)
            self.peak_batch = max(self.peak_batch, len(take))
            try:
                executor, context = await self._get_executor(self._conv)
                results = await executor.execute_batch(
                    [it.query for it in take], context
                )
            except Exception as exc:  # noqa: BLE001 — delivered to waiters
                logger.exception("coalesced engine dispatch failed")
                for it in take:
                    if not it.future.done():
                        it.future.set_exception(
                            RuntimeError(f"coalesced engine dispatch failed: {exc!r}")
                        )
                continue
            for it, result in zip(take, results):
                if not it.future.done():  # caller may have been cancelled
                    it.future.set_result(result)
