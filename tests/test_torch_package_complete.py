"""The port is complete: every ``.py``, ``.json`` and ``.txt`` file of the
JAX package has its counterpart at the same path under
``typeagent_tpu_torch/``. There is no exception list. (The port may hold
files the JAX package lacks: its CUDA sources, their loader, the REST
client of the cloud tools.)
"""

import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "typeagent_tpu"
PORT = ROOT / "typeagent_tpu_torch"


def _files(pkg: pathlib.Path) -> set[pathlib.Path]:
    return {
        p.relative_to(pkg)
        for p in pkg.rglob("*")
        if p.suffix in (".py", ".json", ".txt") and "__pycache__" not in p.parts
    }


def test_every_jax_file_has_its_port():
    missing = sorted(str(p) for p in _files(JAX_PKG) - _files(PORT))
    assert not missing, f"not ported: {missing}"


def test_the_jax_package_is_there_to_compare():
    assert len(_files(JAX_PKG)) > 100


def test_ported_json_files_equal_the_jax_ones():
    """Data files (schemas, configs) are copies: the same JSON."""
    import json

    for rel in sorted(p for p in _files(JAX_PKG) if p.suffix == ".json"):
        assert json.loads((PORT / rel).read_text()) == json.loads((JAX_PKG / rel).read_text()), rel
