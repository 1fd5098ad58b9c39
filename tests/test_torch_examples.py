"""The port's examples (``examples/torch_*.py``) run end to end offline on
the CPU (``--device cpu``), each printing its marker, as
``tests/test_examples.py`` runs the JAX ones: one as a standalone
subprocess (import paths, the ``sys.path`` bootstrap, the command line),
the rest in a second subprocess through ``runpy``, each as ``__main__``.
Without ``--device cpu`` they take the card, and without one they refuse.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = [
    ("torch_simple_query_demo.py", ["bach"]),
    ("torch_batch_query_demo.py", ["corpus global"]),
    ("torch_sharded_corpus_demo.py", ["self-match ok"]),
    ("torch_serving_demo.py", ["serving demo ok"]),
    ("torch_ivf_demo.py", ["ivf demo ok"]),
]


def _offline_env() -> dict[str, str]:
    env = dict(os.environ)
    # Hermetic: no accidental network keys.
    env.pop("OPENAI_API_KEY", None)
    env.pop("AZURE_OPENAI_API_KEY", None)
    return env


def test_example_standalone_subprocess():
    script, markers = EXAMPLES[0]
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", script), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_offline_env(),
    )
    assert result.returncode == 0, result.stderr[-2000:]
    out = result.stdout.lower()
    for marker in markers:
        assert marker in out, (marker, result.stdout[-2000:])


def test_remaining_examples_run_offline():
    runner = (
        "import runpy, sys\n"
        "for script in sys.argv[1:]:\n"
        "    print('=== RUNNING', script, flush=True)\n"
        "    sys.argv = [script, '--device', 'cpu']\n"
        "    runpy.run_path(script, run_name='__main__')\n"
        "    print('=== DONE', script, flush=True)\n"
    )
    scripts = [os.path.join(REPO, "examples", s) for s, _ in EXAMPLES[1:]]
    result = subprocess.run(
        [sys.executable, "-c", runner, *scripts],
        capture_output=True, text=True, timeout=600, cwd=REPO, env=_offline_env(),
    )
    assert result.returncode == 0, result.stderr[-2000:]
    out = result.stdout.lower()
    for script, markers in EXAMPLES[1:]:
        assert f"=== done {os.path.join(REPO, 'examples', script)}".lower() in out
        for marker in markers:
            assert marker in out, (marker, result.stdout[-2000:])


def test_examples_import_only_the_port():
    import ast

    for script, _ in EXAMPLES:
        tree = ast.parse(open(os.path.join(REPO, "examples", script)).read())
        roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        roots |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
        assert not roots & {"jax", "jaxlib", "typeagent_tpu", "httpx", "pydantic"}, (script, roots)


def test_example_without_a_card_refuses():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_serving_demo.py")],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_offline_env(),
    )
    assert result.returncode != 0 and "no CUDA device is available" in result.stderr
