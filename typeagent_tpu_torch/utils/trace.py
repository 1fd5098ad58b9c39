"""Lightweight structured tracing: nestable spans -> logging + metrics.

The port of ``typeagent_tpu/utils/trace.py``. Each span records its latency
under ``span.<path>`` in the port's ``METRICS``; enable debug output with
``logging.getLogger("typeagent_tpu_torch.trace").setLevel(logging.DEBUG)``.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import time
from collections.abc import Iterator
from dataclasses import dataclass, field
from typing import Any

from .metrics import METRICS

logger = logging.getLogger("typeagent_tpu_torch.trace")

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "_current_span", default=None
)


@dataclass
class Span:
    name: str
    parent: "Span | None" = None
    attributes: dict = field(default_factory=dict)
    start: float = field(default_factory=time.perf_counter)
    end: float | None = None

    @property
    def path(self) -> str:
        return f"{self.parent.path}/{self.name}" if self.parent else self.name

    @property
    def duration_ms(self) -> float:
        end = self.end if self.end is not None else time.perf_counter()
        return (end - self.start) * 1000

    def set(self, **attributes: Any) -> None:
        self.attributes.update(attributes)


@contextlib.contextmanager
def span(name: str, **attributes: Any) -> Iterator[Span]:
    """Open a nested span; records latency into the metrics registry."""
    parent = _current_span.get()
    current = Span(name=name, parent=parent, attributes=dict(attributes))
    token = _current_span.set(current)
    try:
        yield current
    finally:
        current.end = time.perf_counter()
        _current_span.reset(token)
        METRICS.observe(f"span.{current.path}", (current.end - current.start))
        if logger.isEnabledFor(logging.DEBUG):
            attrs = (
                " " + " ".join(f"{k}={v}" for k, v in current.attributes.items())
                if current.attributes
                else ""
            )
            logger.debug("%s %.2fms%s", current.path, current.duration_ms, attrs)


def current_span() -> Span | None:
    return _current_span.get()
