"""Structured tracing: nestable spans, counters at the serving path's
boundaries, and, while recording, the spans on the profiler's timeline.

The port of ``typeagent_tpu/utils/trace.py``, extended. Two kinds of span:

* :func:`span` (the query pipeline, ingest, the SQLite loads): always a
  :class:`Span`, the current span inside its block, its latency recorded
  under ``span.<path>`` in the port's ``METRICS``.
* :class:`Site`, a boundary of the serving path (the batcher, the store, the
  corpus). While not recording it costs one flag check, and for each counter
  it names two clock reads and one ``METRICS.incr`` of its duration; it keeps
  nothing and adds no latency sample. While recording it is a span too.

Recording is on while a ``torch.profiler`` session runs (the profiler's own
process-wide flag) and inside :func:`recording`. A recorded span opens a
profiler range of its name, so the profiler's timeline (and its chrome
trace) carries it beside the kernels: on the session's own thread by
default, on every thread with ``experimental_config=
torch._C._profiler._ExperimentalConfig(profile_all_threads=True)``. Finished
recorded spans go to a bounded ring that :func:`finished_spans` reads.

Every span has an id, its parent's id and a request id: a root span's own
id, inherited by every span under it. Times are ``time.perf_counter_ns()``.
Debug output: ``logging.getLogger("typeagent_tpu_torch.trace").setLevel(logging.DEBUG)``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import logging
import threading
import time
from collections.abc import Iterator
from typing import Any

import torch

from .metrics import METRICS

logger = logging.getLogger("typeagent_tpu_torch.trace")

RING_SIZE = 65536

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "_current_span", default=None
)
_ids = itertools.count(1)
_finished: collections.deque["Span"] = collections.deque(maxlen=RING_SIZE)
_forced = 0  # open recording() blocks
_forced_lock = threading.Lock()
# True while a torch.profiler session runs, in every thread.
_profiler = torch.autograd.profiler
# A profiler range of a given name; the C++ fast path where torch has it.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)


class Span:
    """One timed block: name, ids, parent, attributes, start and end."""

    __slots__ = (
        "name", "parent", "attributes", "span_id", "parent_id", "request_id",
        "start_ns", "end_ns", "_range",
    )

    def __init__(self, name: str, parent: "Span | None" = None, attributes: dict | None = None):
        self.name = name
        self.parent = parent
        self.attributes = {} if attributes is None else attributes
        self.span_id = next(_ids)
        self.parent_id = None if parent is None else parent.span_id
        self.request_id = self.span_id if parent is None else parent.request_id
        self.start_ns = time.perf_counter_ns()
        self.end_ns: int | None = None
        self._range = None

    @property
    def path(self) -> str:
        return f"{self.parent.path}/{self.name}" if self.parent else self.name

    @property
    def duration_ms(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.perf_counter_ns()
        return (end - self.start_ns) * 1e-6

    def set(self, **attributes: Any) -> None:
        self.attributes.update(attributes)


def recording_on() -> bool:
    """Spans are recorded: a profiler session runs, or :func:`recording` is open."""
    return bool(_forced) or _profiler._is_profiler_enabled


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans inside the block, in every thread, with no profiler."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


def finished_spans() -> list[Span]:
    """The recorded spans, oldest first: the last :data:`RING_SIZE` to end."""
    return list(_finished)


def _begin(name: str, parent: Span | None, attributes: dict | None, recorded: bool) -> Span:
    current = Span(name, parent, attributes)
    if recorded:
        current._range = _Range(name)
        current._range.__enter__()
    return current


def end(current: Span | None, end_ns: int | None = None) -> None:
    """End a span begun by :meth:`Site.begin` (None: nothing was begun)."""
    if current is None:
        return
    current.end_ns = time.perf_counter_ns() if end_ns is None else end_ns
    if current._range is not None:
        current._range.__exit__(None, None, None)
        current._range = None
        _finished.append(current)
    if logger.isEnabledFor(logging.DEBUG):
        attrs = "".join(f" {k}={v}" for k, v in current.attributes.items())
        logger.debug("%s %.2fms%s", current.path, current.duration_ms, attrs)


class _Block:
    """A span's ``with`` block: the span is current inside it."""

    __slots__ = ("name", "attributes", "counters", "observe", "recorded", "current", "token")

    def __init__(self, name, attributes, counters, observe: bool, recorded: bool):
        self.name = name
        self.attributes = attributes
        self.counters = counters
        self.observe = observe
        self.recorded = recorded

    def __enter__(self) -> Span:
        self.current = _begin(self.name, _current_span.get(), self.attributes, self.recorded)
        self.token = _current_span.set(self.current)
        return self.current

    def __exit__(self, *exc) -> bool:
        current = self.current
        _current_span.reset(self.token)
        end(current)
        seconds = (current.end_ns - current.start_ns) * 1e-9
        for counter in self.counters:
            METRICS.incr(counter, seconds)
        if self.observe:
            METRICS.observe(f"span.{current.path}", seconds)
        return False


class _Timed:
    """A site's block while not recording: its time goes to its counters."""

    __slots__ = ("counters", "start_ns")

    def __init__(self, counters: tuple[str, ...]):
        self.counters = counters

    def __enter__(self) -> None:
        self.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        seconds = (time.perf_counter_ns() - self.start_ns) * 1e-9
        for counter in self.counters:
            METRICS.incr(counter, seconds)
        return False


class _Untimed:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_UNTIMED = _Untimed()


def span(name: str, **attributes: Any) -> _Block:
    """Open a nested span; records its latency into the metrics registry."""
    return _Block(name, attributes, (), True, recording_on())


class Site:
    """A boundary of the serving path: a span name and the counters (in
    seconds) its duration adds to, recording or not.

    ``with site() as current:`` yields the :class:`Span` while recording,
    else None; :meth:`begin` starts a span that ends elsewhere."""

    __slots__ = ("name", "counters")

    def __init__(self, name: str, *counters: str):
        self.name = name
        self.counters = counters

    def __call__(self) -> _Block | _Timed | _Untimed:
        if _forced or _profiler._is_profiler_enabled:
            return _Block(self.name, None, self.counters, False, True)
        return _Timed(self.counters) if self.counters else _UNTIMED

    def begin(self) -> Span | None:
        """While recording, a span under the current one, not made current:
        pass it to :func:`end`. Its counters are the caller's to add."""
        if _forced or _profiler._is_profiler_enabled:
            return _begin(self.name, _current_span.get(), None, True)
        return None


def current_span() -> Span | None:
    return _current_span.get()
