"""``BENCHMARK.json`` against the benchmark's contract, and the command's
behaviour where it must not measure."""

from __future__ import annotations

import asyncio
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench import run
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATHS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"] and bench["paths"] == ["portbench"]
    assert all(PATHS.match(p) and not p.startswith("/") and ".." not in p for p in bench["paths"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1 and w["config"] in {c["name"] for c in bench["configs"]}
        assert os.path.exists(os.path.join(ROOT, "portbench", "traffic", f"{w['traffic']}.json"))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert run.reader_path(m["name"]) is not None
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    setup = next(m for m in bench["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_reports_what_the_contract_asks(bench):
    cells = [w["name"] for w in bench["workloads"]]

    def reported(m, cell):
        return cell in m.get("workloads", cells)

    for cell in cells:
        e2e = [m["name"] for m in bench["end_to_end"] if reported(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reported(m, cell) for m in bench["per_layer"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and reported(e2e[m["moves"]], cell)


def test_run_seconds_fit_a_full_check(bench):
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _cpu_env():
    env = dict(os.environ)
    env.pop("BENCH_RUN", None)
    return env


def test_the_command_fails_as_a_measurement_without_a_card(bench):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present, so the command measures")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", bench["workloads"][0]["name"],
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=_cpu_env(),
    )
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_a_checkout_of_the_benchmark_alone_cannot_run(tmp_path, bench):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    # Past the card check (this image has none), the program is missing.
    code = (
        "import asyncio, torch; from portbench import run; "
        f"asyncio.run(run.run_cell(run.load_cell({bench['workloads'][0]['name']!r}), 1, 1.0, "
        "False, torch.device('cpu')))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=_cpu_env())
    assert proc.returncode != 0 and proc.stdout == ""
    assert "typeagent_tpu_torch" in proc.stderr


def test_a_metric_is_read_by_its_own_reader_or_its_name_less_its_last_part(tmp_path):
    (tmp_path / "metrics").mkdir()
    for name in ("qps", "qps.cell_a"):
        (tmp_path / "metrics" / f"{name}.py").write_text("def read(ctx):\n    return 1.0\n")
    path = lambda name: os.path.basename(run.reader_path(name, str(tmp_path)) or "")  # noqa: E731
    assert path("qps.cell_a") == "qps.cell_a.py"
    assert path("qps.cell_b") == "qps.py" and path("qps.x.y") == "qps.py"
    assert path("p95_ms") == ""
