"""Tiny cells for the CPU rehearsals: the benchmark's own configurations
and mixes, cut to a size a test run holds."""

from __future__ import annotations

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


CELLS = {w["name"]: (w["config"], w["traffic"]) for w in load("BENCHMARK.json")["workloads"]}


def tiny_cell(name: str):
    from portbench import run

    config, mix_name = CELLS[name]
    cfg = load(f"portbench/configs/{config}.json")
    mix = load(f"portbench/traffic/{mix_name}.json")
    if cfg["system"] == "vector_store":
        cfg.update(rows=20_000, dim=64, topics=200, block_rows=4096)
    else:
        # 100 conversations of 400 rows, so that 1% and 99% of the ids
        # are whole conversations, as at 10M.
        cfg.update(rows=40_000, dim=64, topics=320, block_rows=8000, layout={"conversation_rows": 400})
    mix.update(warm_seconds=0.2, check_share=1.0, check_queries=256, pool=1024)
    if "clients" in mix:
        mix["clients"] = 4
    bench = load("BENCHMARK.json")

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return run.Cell(name, cfg, mix, 1, mine(bench["end_to_end"]), mine(bench["per_layer"]))
