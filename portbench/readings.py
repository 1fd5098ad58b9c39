"""The readings that set a cell's check limits: the program's numbers and
the control's on many seeds, in one process (one kernel build, one CUDA
context), each seed with a short window at the cell's own load.

    python3 portbench/readings.py --workload <cell> --seconds 4 --seeds 101 102 ...

Prints one JSON line per seed: the program's ``score_err``, ``rank_gap``
and ``bad_hits``, and the control's (the reference at TF32 in the
program's place, ``reference.py``).
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = run.load_cell(args.workload)
    device = run.require_devices(cell.chips)
    for seed in args.seeds:
        t0 = time.perf_counter_ns()
        out = asyncio.run(run.run_cell(cell, seed, args.seconds, False, device, t0, control=True))
        r = out["result"]
        print(json.dumps({
            "workload": cell.name, "seed": seed, "correct": r["correct"],
            "attempted": r["attempted"], "failed": r["failed"], "checked": out["checked"],
            "program": {k: v["value"] for k, v in r["check"].items()},
            "detail": out["detail"],
            "control": {k: out["control"][k] for k in ("score_err", "rank_gap", "bad_hits")}
            if out["control"] else None,
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "peak_gb": r["device"]["memory_peak_bytes"] / 1e9,
        }), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
