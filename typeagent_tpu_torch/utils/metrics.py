"""First-class metrics: counters, latency percentiles, recall@k.

The reference has only print-based timing (SURVEY.md §5); this registry is a
lightweight process-local metrics layer for the serving/bench paths.
Counters are added to from the serving path's executor threads, so
:meth:`MetricsRegistry.incr` holds a lock.
"""

from __future__ import annotations

import math
import threading
import time
from collections.abc import Iterator
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class LatencyStats:
    count: int
    total_s: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    max_ms: float

    @property
    def mean_ms(self) -> float:
        return self.total_s / self.count * 1000 if self.count else 0.0


@dataclass
class MetricsRegistry:
    """Records named counters and latency samples."""

    counters: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    latencies: dict[str, list[float]] = field(default_factory=lambda: defaultdict(list))
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:  # a read-modify-write, from several threads
            self.counters[name] += value

    def observe(self, name: str, seconds: float) -> None:
        self.latencies[name].append(seconds)

    @contextmanager
    def timer(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - start)

    def stats(self, name: str) -> LatencyStats | None:
        samples = self.latencies.get(name)
        if not samples:
            return None
        ordered = sorted(samples)

        def pct(p: float) -> float:
            idx = min(len(ordered) - 1, max(0, math.ceil(p * len(ordered)) - 1))
            return ordered[idx] * 1000

        return LatencyStats(
            count=len(ordered),
            total_s=sum(ordered),
            p50_ms=pct(0.50),
            p90_ms=pct(0.90),
            p99_ms=pct(0.99),
            max_ms=ordered[-1] * 1000,
        )

    def report(self) -> dict:
        out: dict = {"counters": dict(self.counters), "latency": {}}
        for name in self.latencies:
            s = self.stats(name)
            if s:
                out["latency"][name] = {
                    "count": s.count,
                    "mean_ms": round(s.mean_ms, 3),
                    "p50_ms": round(s.p50_ms, 3),
                    "p90_ms": round(s.p90_ms, 3),
                    "p99_ms": round(s.p99_ms, 3),
                    "max_ms": round(s.max_ms, 3),
                }
        return out


def recall_at_k(
    retrieved: list[int], relevant: set[int] | list[int], k: int
) -> float:
    """|top-k retrieved ∩ relevant| / min(k, |relevant|)."""
    relevant_set = set(relevant)
    if not relevant_set:
        return 0.0
    hits = sum(1 for r in retrieved[:k] if r in relevant_set)
    return hits / min(k, len(relevant_set))


def mrr(retrieved: list[int], relevant: set[int] | list[int]) -> float:
    """Mean reciprocal rank of the first relevant result."""
    relevant_set = set(relevant)
    for rank, item in enumerate(retrieved, 1):
        if item in relevant_set:
            return 1.0 / rank
    return 0.0


# Process-wide default registry.
METRICS = MetricsRegistry()
