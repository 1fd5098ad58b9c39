#!/usr/bin/env python3
"""Split a benchmark cell's device idle time by the port's own spans.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> [--seconds 10]
    python3 tools/idle_by_span.py --workload <cell> --seed <n> --record

Without ``--record``: one ``--trace 1`` run of the cell (``portbench/run.py``'s
``run_cell``), its profiler session opened with ``profile_all_threads`` so
that the spans the program opens on the batcher's executor threads land on
the profiler's timeline too. From the profiler's own events it reports the
device's idle time in the traced stretch by program span: each idle gap is
cut where a span starts or ends, and each piece goes to the innermost span
open over it (of the spans open on any thread, the latest started that is
not a whole request, dispatch or search; failing that, the latest started;
failing that, none open). It also reports the host seconds in each span, the
operations that took most of each span's time (the profiler's CPU events
on the span's thread inside it), the threads the spans ran on, and how far
the profiler's span times
lie from the same spans' ``time.perf_counter_ns()`` times in
``trace.finished_spans()`` (the clock the benchmark maps device events onto).

With ``--record``: one untraced run with ``trace.recording()`` open from
start to end, for the cost of recording (compare its ``qps`` with a plain
``portbench/run.py --trace 0`` run in the same call).

Prints one JSON line. Needs a CUDA card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import asyncio
import bisect
import heapq
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402  (first: its clock starts at its import)
from portbench import trace as bench_trace  # noqa: E402

import torch  # noqa: E402

from typeagent_tpu_torch.utils import trace  # noqa: E402

PREFIXES = ("serve.", "store.", "corpus.")
# Spans that cover a whole request, dispatch or search: a gap is named by
# one only when no span inside one is open.
WHOLE = ("serve.request", "serve.queue", "serve.dispatch", "corpus.query")
NONE_OPEN = "no program span open"


def _start_on_all_threads(self) -> None:
    """``portbench.trace.Tracer.start`` with every thread's ranges kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    self.prof = profile(activities=acts, experimental_config=config)
    self.prof.start()
    with record_function(bench_trace.MARK):
        self.mark_ns = time.perf_counter_ns()
    self.t0 = self.mark_ns
    TRACERS.append(self)


TRACERS: list = []


def cpu_events(tracer) -> tuple[list, list]:
    """``(name, start_ns, stop_ns, thread)`` of the program's spans and of
    the other CPU events among the profiler's, on the host clock."""
    events = tracer.prof.profiler.kineto_results.events()
    mark = next(e for e in events if e.name() == bench_trace.MARK)
    offset = mark.start_ns() - tracer.mark_ns
    spans, others = [], []
    for e in events:
        if e.device_type() != torch._C._autograd.DeviceType.CPU or e.name() == bench_trace.MARK:
            continue
        start = e.start_ns() - offset
        row = (e.name(), start, start + e.duration_ns(), e.start_thread_id())
        (spans if e.name().startswith(PREFIXES) else others).append(row)
    return spans, others


def ops_in_spans(spans, others, top: int = 5) -> dict[str, list]:
    """For each span name, the CPU events on the span's thread that start
    inside it, by total seconds (nested events each count), largest first."""
    by_thread: dict[int, list] = {}
    for row in sorted(others, key=lambda r: r[1]):
        by_thread.setdefault(row[3], []).append(row)
    starts = {t: [r[1] for r in rows] for t, rows in by_thread.items()}
    totals: dict[str, dict[str, list]] = {}
    for name, s0, s1, thread in spans:
        rows = by_thread.get(thread, [])
        i = bisect.bisect_left(starts.get(thread, []), s0)
        per = totals.setdefault(name, {})
        while i < len(rows) and rows[i][1] < s1:
            entry = per.setdefault(rows[i][0], [0, 0.0])
            entry[0] += 1
            entry[1] += (min(rows[i][2], s1) - rows[i][1]) * 1e-9
            i += 1
    return {name: [[op, n, secs] for op, (n, secs) in sorted(per.items(), key=lambda kv: -kv[1][1])[:top]]
            for name, per in totals.items()}


def innermost(spans, at: int) -> str:
    covering = [s for s in spans if s[1] <= at < s[2]]
    inner = [s for s in covering if s[0] not in WHOLE] or covering
    return max(inner, key=lambda s: s[1])[0] if inner else NONE_OPEN


def split_gaps(gaps, spans) -> dict[str, float]:
    """Idle seconds by span: a sweep over the gaps in time order with the
    spans that overlap each, the gap cut at their starts and ends."""
    spans = sorted(spans, key=lambda s: s[1])
    totals: dict[str, float] = {}
    live: dict[int, tuple] = {}
    ends: list[tuple[int, int]] = []
    j = 0
    for g0, g1 in sorted(gaps):
        while j < len(spans) and spans[j][1] < g1:
            live[j] = spans[j]
            heapq.heappush(ends, (spans[j][2], j))
            j += 1
        while ends and ends[0][0] <= g0:
            live.pop(heapq.heappop(ends)[1])
        over = list(live.values())
        cuts = sorted({g0, g1} | {t for s in over for t in (s[1], s[2]) if g0 < t < g1})
        for a, b in zip(cuts, cuts[1:]):
            name = innermost(over, (a + b) // 2)
            totals[name] = totals.get(name, 0.0) + (b - a) * 1e-9
    return dict(sorted(totals.items(), key=lambda kv: -kv[1]))


def clock_agreement(spans, t0: int, t1: int) -> dict:
    """Distance between each profiler span's start and the nearest start of
    a recorded span of the same name, in microseconds."""
    ring: dict[str, list[int]] = {}
    for s in trace.finished_spans():
        if s.end_ns is not None and t0 <= s.start_ns <= t1:
            ring.setdefault(s.name, []).append(s.start_ns)
    for starts in ring.values():
        starts.sort()
    dist = []
    for name, start, _stop, _thread in spans:
        starts = ring.get(name)
        if not starts:
            continue
        i = bisect.bisect_left(starts, start)
        near = [starts[j] for j in (i - 1, i) if 0 <= j < len(starts)]
        dist.append(min(abs(start - n) for n in near) * 1e-3)
    if not dist:
        return {"matched": 0}
    dist.sort()
    return {"matched": len(dist), "median_us": statistics.median(dist),
            "p99_us": dist[min(len(dist) - 1, int(0.99 * len(dist)))], "max_us": dist[-1]}


def traced(cell, seed: int, seconds: float, device) -> dict:
    bench_trace.Tracer.start = _start_on_all_threads
    out = asyncio.run(run.run_cell(cell, seed, seconds, True, device))
    tracer = TRACERS[-1]
    summary = tracer.summary(bench_trace.Spans())
    spans, others = cpu_events(tracer)
    _busy, gaps = bench_trace._union(summary.events, tracer.t0, tracer.t1)
    idle = sum(g1 - g0 for g0, g1 in gaps) * 1e-9
    host: dict[str, list[float]] = {}
    threads: dict[str, set[int]] = {}
    for name, s0, s1, thread in spans:
        entry = host.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (min(s1, tracer.t1) - max(s0, tracer.t0)) * 1e-9
        threads.setdefault(name, set()).add(thread)
    loop_threads = threads.get("serve.request", set()) | threads.get("corpus.query", set())
    return {
        "workload": cell.name, "seed": seed, "correct": out["result"]["correct"],
        "metrics": {k: v["value"] for k, v in out["result"]["metrics"].items()},
        "window_s": summary.window_s, "busy_s": summary.busy_s, "idle_s": idle,
        "idle_by_program_span": split_gaps(gaps, spans),
        "idle_by_benchmark_span": dict(out["result"]["breakdown"]["idle_gaps"]),
        "host_s_by_span": {k: {"count": v[0], "seconds": v[1]} for k, v in sorted(host.items())},
        "ops_by_span": ops_in_spans(spans, others),
        "spans_off_the_loop_thread": sorted(n for n, t in threads.items() if t - loop_threads),
        "clock_agreement": clock_agreement(spans, tracer.t0, tracer.t1),
    }


def recorded(cell, seed: int, seconds: float, device) -> dict:
    with trace.recording():
        out = asyncio.run(run.run_cell(cell, seed, seconds, False, device))
    r = out["result"]
    return {"workload": cell.name, "seed": seed, "record": True, "correct": r["correct"],
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "spans_in_ring": len(trace.finished_spans())}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    try:
        device = run.require_devices(cell.chips)
    except run.NoDevice as exc:
        print(f"idle_by_span: {exc}", file=sys.stderr)
        return 2
    measure = recorded if args.record else traced
    result = measure(cell, args.seed, args.seconds, device)
    result["card"] = run.power_limit()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
