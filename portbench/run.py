"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It reads the cell from ``BENCHMARK.json``, its configuration from
``configs/`` and its traffic mix from ``traffic/``; makes the data on the
card from the seed and feeds the program (``system.py``); warms up on the
same traffic; measures for ``--seconds``; holds a sample of the window's
answers to the plain reference (``check.py``; the module the configuration
names under ``"reference"``, ``reference.py`` unless it names another); and
prints one JSON line last on standard output. With ``--trace 1`` a
stretch of the window runs under ``torch.profiler`` and the line carries
the per-layer metrics (readers in ``metrics/``), else the end-to-end
ones. Without a CUDA card, or with fewer than the cell asks for, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import time

T0_NS = time.perf_counter_ns()  # process start, before the heavy imports

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, generate, trace, traffic  # noqa: E402

T_IMPORTED_NS = time.perf_counter_ns()  # Python, numpy, torch and the harness loaded

FORBIDDEN = ("jax", "jaxlib", "flax", "typeagent_tpu")
# The plain reference of a configuration that names none (``reference.py``).
REFERENCE = "reference"
# The traced stretch: from this share of the window, for this share of it
# and at most STRETCH_MAX_S seconds.
STRETCH_AT, STRETCH_SHARE, STRETCH_MAX_S = 0.3, 0.4, 3.0


class NoDevice(RuntimeError):
    pass


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    chips: int
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def load_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = load_json(os.path.join(root, entry["file"]))
    reference_module(cfg)  # a reference that is missing fails here, before set-up
    mix = load_json(os.path.join(root, "portbench", "traffic", f"{work['traffic']}.json"))

    def mine(metrics: list[dict]) -> list[dict]:
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, cfg, mix, work["chips"], mine(bench["end_to_end"]), mine(bench["per_layer"]))


def reference_module(cfg: dict):
    """The plain reference a configuration names under ``"reference"``: a
    module of ``portbench/`` with a ``Reference``, ``Scope`` and
    ``resolve`` as ``reference.py`` has them; ``reference.py`` where the
    configuration names none."""
    name = cfg.get("reference", REFERENCE)
    found = isinstance(name, str) and name.isidentifier() and (
        importlib.util.find_spec(f"portbench.{name}") is not None)
    if not found:
        raise SystemExit(f"the configuration's reference {name!r} is no module portbench/{name}.py")
    mod = importlib.import_module(f"portbench.{name}")
    missing = [a for a in ("Reference", "Scope", "resolve") if not hasattr(mod, a)]
    if missing:
        raise SystemExit(f"the reference module portbench/{name}.py lacks {missing}")
    return mod


def require_devices(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise NoDevice("no CUDA device: the benchmark measures the card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell needs {chips} cards, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def refuse_jax(when: str) -> None:
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded {when}: {found}")


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


@dataclass
class Context:
    """What a metric reader may read."""

    cell: Cell
    window: traffic.Window
    setup_s: float
    counters: dict[str, float]
    trace: trace.TraceSummary | None
    stretch_requests: list[traffic.Request]
    scope_rows: object  # a request's scope -> rows in scope


def reader_path(name: str, root: str = HERE) -> str | None:
    """``metrics/<name>.py``, or failing that the reader of ``name`` with
    its last dotted part dropped, and so on: ``qps.<cell>`` is read by
    ``qps.py`` unless the cell brings a reader of its own."""
    parts = name.split(".")
    while parts:
        path = os.path.join(root, "metrics", ".".join(parts) + ".py")
        if os.path.exists(path):
            return path
        parts.pop()
    return None


def read_metric(name: str, ctx: Context) -> float | None:
    path = reader_path(name)
    if path is None:
        raise SystemExit(f"no reader for the metric {name!r} in portbench/metrics/")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def scope_rows_of(system, cfg: dict):
    """Rows a request's scope holds: the conversations ``[lo, hi)``, or
    every row."""
    layout = getattr(system, "layout", None)
    return lambda scope: cfg["rows"] if scope is None else layout.rows_in(*scope)


def checked_sample(window: traffic.Window, plan: traffic.Plan, cap: int, seed: int):
    """The kept requests that were answered: the longest, then the rest in
    a seeded order, up to ``cap`` queries."""
    kept = [d for d in window.done if d.result is not None and d.error is None]
    if not kept:
        return []
    longest = max(range(len(kept)), key=lambda i: kept[i].n)
    rng = generate.host_rng(seed, generate.STREAM_TRAFFIC, 2)
    order = [longest] + [i for i in rng.permutation(len(kept)).tolist() if i != longest]
    picked, total = [], 0
    for i in order:
        if total + kept[i].n <= cap:
            picked.append(kept[i])
            total += kept[i].n
    return [(plan.request(d.index), d.result) for d in picked]


def reference_blocks(cfg: dict, seed: int, device: torch.device, layout=None):
    """``(start, rows, conversations or None)`` of every block, made again
    from the seed."""
    centers = generate.topic_centers(cfg["topics"], cfg["dim"], seed, device)
    for block in generate.even_blocks(cfg["rows"], cfg["block_rows"]):
        conv = None
        if layout is not None:
            conv = generate.row_conversations(layout, block.start, block.stop, device)
        yield block.start, generate.rows_block(cfg, centers, seed, block), conv


def hold_to_reference(sample, system_hits, cfg: dict, mix: dict, seed: int, device,
                      layout=None, control: bool = False):
    """The reference over the sampled requests; returns ``(numbers,
    control_numbers or None, queries checked)``."""
    reference = reference_module(cfg)
    queries = np.concatenate([req.queries for req, _ in sample])
    answers = [system_hits(result) for _, result in sample]
    k = answers[0]["items"].shape[1]
    items = np.concatenate([a["items"] for a in answers])
    scores = np.concatenate([a["scores"] for a in answers])
    scope = None
    if layout is not None:
        whole = (0, layout.n_conversations)
        lo, hi = np.concatenate([
            np.tile(np.asarray(req.scope or whole)[:, None], req.queries.shape[0])
            for req, _ in sample
        ], axis=1)
        scope = reference.Scope(torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))
    ref = reference.Reference(torch.from_numpy(queries).to(device), k, items, scope, control=control)
    for start, rows, conv in reference_blocks(cfg, seed, device, layout):
        ref.add_block(start, rows, conv)
        del rows
    resolved = None
    if layout is not None:
        seg = np.asarray(layout.segments, dtype=np.int64)
        conv, local = reference.resolve(seg, items)
        prog_conv = np.concatenate([a["conv"] for a in answers])
        prog_local = np.concatenate([a["local"] for a in answers])
        resolved = (conv == prog_conv) & (local == prog_local)
    cut = {"min_score": mix["min_score"], "margin": cfg["check"]["score_err"]}
    numbers = check.judge(ref.result(), items, scores, resolved, **cut)
    ctl = None
    if control:
        c = ref.control_result()
        ctl = check.judge(c, c.items, c.scores, **cut)
    return numbers, ctl, queries.shape[0]


async def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
                   device: torch.device, t0_ns: int = T0_NS, control: bool = False) -> dict:
    """One run of ``cell``: the result's fields, and ``check`` / ``control``."""
    from portbench import system as system_mod

    cfg, mix = cell.cfg, cell.mix
    phases = {"imports": T_IMPORTED_NS} if T_IMPORTED_NS > t0_ns else {}
    if device.type == "cuda":
        torch.cuda.init()
    phases["cuda"] = time.perf_counter_ns()
    system = system_mod.build(cfg, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    phases["system"] = time.perf_counter_ns()
    plan = traffic.Plan(mix, cfg, system, seed)
    phases["traffic"] = time.perf_counter_ns()
    is_async = mix["entry"] == "store_async"

    async def drive(secs: float, start_index: int, stretch=None) -> traffic.Window:
        if is_async:
            return await traffic.drive_async(system, plan, secs, start_index, stretch)
        return traffic.drive_sync(system, plan, secs, start_index, stretch)

    await drive(mix["warm_seconds"], traffic.PLANNED // 2)
    phases["warm-up"] = time.perf_counter_ns()
    if traced:
        trace.warm_profiler()
    if device.type == "cuda":
        torch.cuda.synchronize()
    # What set-up made lives to the end: out of the collector's full passes,
    # so that none lands in the window for objects that cannot be freed.
    gc.collect()
    gc.freeze()
    refuse_jax("after set-up")
    before = system_mod.counters()
    setup_s = (time.perf_counter_ns() - t0_ns) * 1e-9
    stretch = None
    if traced:
        at = STRETCH_AT * seconds
        stretch = traffic.Stretch(at, at + min(STRETCH_MAX_S, STRETCH_SHARE * seconds),
                                  trace.Tracer(), trace.Spans())
    window = await drive(seconds, 0, stretch)
    after = system_mod.counters()
    counters = {k: v - before.get(k, 0.0) for k, v in after.items()}
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    refuse_jax("once the window has closed")
    summary = stretch.tracer.summary(stretch.spans) if stretch is not None else None
    stretch_requests = []
    if window.stretch is not None:
        stretch_requests = [plan.request(i) for i in range(*window.stretch)]
    ctx = Context(cell, window, setup_s, counters, summary, stretch_requests,
                  scope_rows_of(system, cfg))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sample = checked_sample(window, plan, mix["check_queries"], seed)
    layout = getattr(system, "layout", None)
    system_hits = system.hits
    await system.close()
    del system, plan
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    failed = sum(d.error is not None for d in window.done)
    if sample:
        bound_hits = lambda result: system_hits(result, mix["k"])  # noqa: E731
        numbers, ctl, n_checked = hold_to_reference(sample, bound_hits, cfg, mix, seed, device,
                                                    layout, control)
    else:
        numbers, ctl, n_checked = None, None, 0
    if numbers is None:
        ok, table = False, {name: {"value": None, "limit": cfg["check"][name]}
                            for name in check.NUMBERS}
    else:
        ok, table = check.verdict(numbers, cfg["check"])
    result = {
        "correct": bool(ok and failed == 0),
        "attempted": len(window.done),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = summary.breakdown()
    result["check"] = table
    marks = [("start", t0_ns)] + list(phases.items())
    setup_split = {b[0]: (b[1] - a[1]) * 1e-9 for a, b in zip(marks, marks[1:])}
    return {"result": result, "detail": None if numbers is None else numbers["detail"],
            "setup_split": setup_split,
            "checked": n_checked, "control": ctl, "window": window}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    try:
        device = require_devices(cell.chips)
    except NoDevice as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    out = asyncio.run(run_cell(cell, args.seed, args.seconds, bool(args.trace), device))
    result, window = out["result"], out["window"]
    print(f"portbench: {cell.name} seed {args.seed}: {len(window.done)} requests, "
          f"{out['checked']} queries checked, card {power_limit()}", file=sys.stderr)
    print("portbench: set-up by phase (s) " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["setup_split"].items()), file=sys.stderr)
    if out["detail"] is not None:
        print(f"portbench: bad hits by kind {out['detail']}", file=sys.stderr)
    for name, entry in result["check"].items():
        print(f"check {name}: {entry['value']} (limit {entry['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
