"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA) around a steady part of the window, reduced to device time per
kernel, the device's busy seconds, and its idle gaps named by the
benchmark's host span that was open at the time.

Host spans are the benchmark's own (``Spans``): each call into a layer of
the program, recorded on the host clock and placed on the profiler's
timeline through one marker event taken when the stretch starts.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import time
from dataclasses import dataclass, field

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
MARK = "portbench.mark"
LOOK_BACK = 64


def kernel_table() -> list[tuple[str, re.Pattern]]:
    with open(os.path.join(_HERE, "roofline", "kernels.json")) as f:
        table = json.load(f)["kernels"]
    return [(k["label"], re.compile(k["pattern"])) for k in table]


def label_of(name: str, table: list[tuple[str, re.Pattern]]) -> str:
    for label, pattern in table:
        if pattern.search(name):
            return label
    return name if len(name) <= 80 else name[:77] + "..."


class Spans:
    """Host spans ``(name, start_ns, stop_ns)`` on ``time.perf_counter_ns``,
    kept only while ``on``."""

    def __init__(self):
        self.on = False
        self.items: list[tuple[str, int, int]] = []

    def add(self, name: str, start_ns: int, stop_ns: int) -> None:
        if self.on:
            self.items.append((name, start_ns, stop_ns))


@dataclass
class DeviceEvent:
    label: str
    start_ns: int  # on the host's perf_counter_ns clock
    dur_ns: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    events: list[DeviceEvent]  # device operations in time order
    by_label: dict[str, list[float]] = field(default_factory=dict)  # label -> [count, seconds]
    idle_gaps: list[tuple[str, float]] = field(default_factory=list)

    def seconds(self, label: str) -> float:
        return self.by_label.get(label, [0, 0.0])[1]

    def count(self, label: str) -> int:
        return int(self.by_label.get(label, [0, 0.0])[0])

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.by_label.items(), key=lambda kv: -kv[1][1])[:n]
        return {
            "device_ops": [[label, secs] for label, (_count, secs) in ops],
            "idle_gaps": [[name, secs] for name, secs in self.idle_gaps[:n]],
        }


def warm_profiler() -> None:
    """Start and stop the profiler once, so that the stretch's own start
    does not pay the profiler's first initialisation."""
    t = Tracer()
    t.start()
    t.stop()


class Tracer:
    """Start and stop the profiler around the stretch; :meth:`summary`
    reduces what it recorded."""

    def __init__(self):
        self.prof = None
        self.mark_ns = 0
        self.t0 = self.t1 = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        with record_function(MARK):
            self.mark_ns = time.perf_counter_ns()
        self.t0 = self.mark_ns

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self.prof.stop()

    def summary(self, spans: Spans) -> TraceSummary:
        events = self.prof.profiler.kineto_results.events()
        mark = next(e for e in events if e.name() == MARK)
        offset = mark.start_ns() - self.mark_ns  # profiler clock - host clock
        table = kernel_table()
        device = []
        for e in events:
            if e.device_type() != torch._C._autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() - offset
            stop = start + e.duration_ns()
            start, stop = max(start, self.t0), min(stop, self.t1)
            if stop > start:
                device.append(DeviceEvent(label_of(e.name(), table), start, stop - start))
        device.sort(key=lambda d: d.start_ns)
        by_label: dict[str, list[float]] = {}
        for d in device:
            entry = by_label.setdefault(d.label, [0, 0.0])
            entry[0] += 1
            entry[1] += d.dur_ns * 1e-9
        busy, gaps = _union(device, self.t0, self.t1)
        return TraceSummary(
            window_s=(self.t1 - self.t0) * 1e-9,
            busy_s=busy * 1e-9,
            events=device,
            by_label=by_label,
            idle_gaps=_name_gaps(gaps, spans.items),
        )


def _union(events: list[DeviceEvent], t0: int, t1: int) -> tuple[int, list[tuple[int, int]]]:
    """Busy nanoseconds of the union of ``events`` (sorted by start) and
    the idle gaps between ``t0`` and ``t1``."""
    busy, gaps, cursor = 0, [], t0
    for e in events:
        s, f = e.start_ns, e.start_ns + e.dur_ns
        if s > cursor:
            gaps.append((cursor, s))
        if f > cursor:
            busy += f - max(s, cursor)
            cursor = f
    if t1 > cursor:
        gaps.append((cursor, t1))
    return busy, gaps


def _name_gaps(
    gaps: list[tuple[int, int]], spans: list[tuple[str, int, int]]
) -> list[tuple[str, float]]:
    """Idle seconds by the host span open at each gap's middle (of those
    open, the latest started, looking back over at most ``LOOK_BACK``
    spans), largest first."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = [s[1] for s in spans]
    totals: dict[str, float] = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        name = "no benchmark span open"
        last = bisect.bisect_right(starts, mid) - 1
        for i in range(last, max(last - LOOK_BACK, -1), -1):
            if spans[i][2] >= mid:
                name = spans[i][0]
                break
        totals[name] = totals.get(name, 0.0) + (g1 - g0) * 1e-9
    return sorted(totals.items(), key=lambda kv: -kv[1])
