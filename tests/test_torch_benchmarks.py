"""The port's benchmark tools (``typeagent_tpu_torch/tools/benchmark_*.py``).

``tests/test_benchmarks.py`` runs on the port through
``test_torch_query_suites.mirror``, its tests under
``test_benchmarks__<name>`` (``test_load_json_to_sqlite`` skips without
the reference fixture, as in JAX). The tools build their stores and
conversations on the port's default device, the card, so the rewrite
names the CPU in the three calls that build them (``run_benchmark``,
``evaluate``, ``build_conversation``).

Beside the mirror: each tool's command line runs to its end with
``--device cpu`` at a tiny size, and the shared fixtures and the pipeline
benchmark's contexts equal the JAX package's on the same seeds.
"""

import asyncio
import os
import random
import subprocess
import sys

import pytest

from test_torch_query_suites import check_mirrored, mirror

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITES = ("test_benchmarks.py",)
EXCLUDED: dict = {}
REWRITE = {
    "test_benchmarks.py": (
        ("iterations=2, batch=4)", 'iterations=2, batch=4, device="cpu")'),
        ("limit=None,", 'limit=None, device="cpu",'),
        ("await build_conversation(40, rng)", 'await build_conversation(40, rng, device="cpu")'),
    ),
}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)


def test_every_benchmark_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


TOOLS = {
    "benchmark_vectorstore": (["--sizes", "600", "--dim", "16", "--iterations", "2", "--batch", "1", "8"],
                              "600"),
    "benchmark_serve": (["--rows", "3000", "--dim", "32", "--batch", "8", "--r", "3", "--wire", "int8"],
                        "stream:"),
    "benchmark_semref_writes": (["--count", "200"], "native:"),
    "benchmark_query": (["--messages", "60", "--iterations", "5"], "lookup_term (scoped) over 60 messages"),
    "benchmark_engine": (["--messages", "40", "--queries", "8", "--batch", "4"], "speedup:"),
    "benchmark_pipeline": (["--messages", "40", "--queries", "6"], "[host] full pipeline"),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_command_line_runs_on_the_cpu(tool):
    args, marker = TOOLS[tool]
    proc = subprocess.run(
        [sys.executable, "-m", f"typeagent_tpu_torch.tools.{tool}", *args, "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert marker in proc.stdout, proc.stdout[-2000:]


def test_benchmark_embeddings_command_line_runs_on_the_cpu(tmp_path):
    """Ingest a transcript with the port's CLI, then sweep it."""
    db = str(tmp_path / "t.db")
    vtt = os.path.join(REPO, "tests", "testdata", "mini.vtt")
    common = ["--embedding-model", "test:8", "--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "typeagent_tpu_torch.tools.ingest_vtt", vtt, "-d", db, *common],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    proc = subprocess.run(
        [sys.executable, "-m", "typeagent_tpu_torch.tools.benchmark_embeddings", "-d", db,
         "--min-scores", "0.0", "--max-hits", "3", *common],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Evaluating self-retrieval over 3 messages" in proc.stdout
    row = [line for line in proc.stdout.splitlines() if line.strip().startswith("0.00")][0]
    assert row.split()[:2] == ["0.00", "3"]


def test_tool_without_a_card_refuses():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "typeagent_tpu_torch.tools.benchmark_vectorstore", "--sizes", "100"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert proc.returncode != 0 and "no CUDA device is available" in proc.stderr


def test_semref_fixture_matches_jax():
    from typeagent_tpu.tools import benchmark_semref_writes as jax_tool
    from typeagent_tpu_torch.tools import benchmark_semref_writes as port_tool

    refs, terms = port_tool.make_refs(300)
    jrefs, jterms = jax_tool.make_refs(300)
    assert terms == jterms
    assert [(r.semantic_ref_ordinal, r.knowledge.name, r.knowledge.type) for r in refs] == [
        (r.semantic_ref_ordinal, r.knowledge.name, r.knowledge.type) for r in jrefs
    ]


def test_pipeline_contexts_match_jax():
    """The same seeded conversation and stage-1 queries through both
    packages' pipeline benchmark, on the host VM and the device engine:
    the same number of answer-context items."""
    from typeagent_tpu.tools import benchmark_engine as jax_engine
    from typeagent_tpu.tools import benchmark_pipeline as jax_pipeline
    from typeagent_tpu.utils.metrics import MetricsRegistry as JaxRegistry
    from typeagent_tpu_torch.tools import benchmark_engine, benchmark_pipeline
    from typeagent_tpu_torch.utils.metrics import MetricsRegistry

    async def port_run():
        rng = random.Random(7)
        conv = await benchmark_engine.build_conversation(60, rng, device="cpu")
        queries = benchmark_pipeline.make_search_queries(9, rng)
        return [await benchmark_pipeline.run_pipeline(conv, queries, use_device=d, reg=MetricsRegistry())
                for d in (False, True)]

    async def jax_run():
        rng = random.Random(7)
        conv = await jax_engine.build_conversation(60, rng)
        queries = jax_pipeline.make_search_queries(9, rng)
        return [await jax_pipeline.run_pipeline(conv, queries, use_device=d, reg=JaxRegistry())
                for d in (False, True)]

    port = asyncio.run(port_run())
    assert port == asyncio.run(jax_run())
    assert port[0] == port[1] > 0
