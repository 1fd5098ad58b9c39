"""Compare batch-eval result files side by side.

(Parity role: reference tools/vizcmp.py — a per-question score grid across
eval runs with ANSI coloring and a footer legend.) Inputs here are the JSON
files written by ``tat-query --batch questions.txt --output run.json``:
``[{"question", "answer", "hasNoAnswer"}, ...]``. Cells show answered (✓),
no-answer (✗), or N/A, plus a marker when a run's answer text changed vs the
first file. Run: ``python -m typeagent_tpu_torch.tools.compare_evals run1.json
run2.json``. The port of ``typeagent_tpu/tools/compare_evals.py``; it
touches no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import TextIO

GREEN = "\x1b[32m"
RED = "\x1b[31m"
YELLOW = "\x1b[33m"
BLUE = "\x1b[34m"
RESET = "\x1b[0m"


def _paint(text: str, color: str, enabled: bool) -> str:
    return f"{color}{text}{RESET}" if enabled else text


def load_results(path: str) -> dict[str, dict]:
    with open(path) as f:
        entries = json.load(f)
    return {e["question"]: e for e in entries}


def compare(files: list[str], color: bool, out: TextIO = sys.stdout) -> int:
    tables = {f: load_results(f) for f in files}
    questions: list[str] = []
    for table in tables.values():
        for q in table:
            if q not in questions:
                questions.append(q)

    width = 8
    print("    " + "".join(f"{chr(65 + i):>{width}}" for i in range(len(files))),
          file=out)
    all_good: list[int] = []
    for i, question in enumerate(questions):
        cells = []
        good = True
        base_answer = None
        for j, f in enumerate(files):
            entry = tables[f].get(question)
            if entry is None:
                cells.append(_paint(f"{'N/A':>{width}}", YELLOW, color))
                good = False
                continue
            if j == 0:
                base_answer = entry["answer"]
            changed = j > 0 and entry["answer"] != base_answer
            if entry.get("hasNoAnswer"):
                cells.append(_paint(f"{'no-ans':>{width}}", RED, color))
                good = False
            elif changed:
                cells.append(_paint(f"{'✓ diff':>{width}}", BLUE, color))
            else:
                cells.append(_paint(f"{'✓':>{width}}", GREEN, color))
        print(f"{i:>3}:" + "".join(cells) + f"  {question[:60]}", file=out)
        if good:
            all_good.append(i)
    for i, f in reversed(list(enumerate(files))):
        print("    " + f"{'|':>{width}}" * i + f"  {chr(65 + i)} = {os.path.basename(f)}",
              file=out)
    print(f"all-answered rows: {','.join(map(str, all_good)) or '(none)'}", file=out)
    return 0


def main() -> None:
    parser = argparse.ArgumentParser(description="Compare batch eval runs")
    parser.add_argument("files", nargs="*", help="batch --output JSON files")
    parser.add_argument(
        "--color", choices=["auto", "always", "never"], default="auto"
    )
    args = parser.parse_args()
    files = args.files or sorted(glob.glob("evals/*.json"))
    if len(files) < 1:
        parser.error("no eval files given or found under evals/")
    color = args.color == "always" or (
        args.color == "auto" and sys.stdout.isatty()
    )
    sys.exit(compare(files, color))


if __name__ == "__main__":
    main()
