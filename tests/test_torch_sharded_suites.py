"""The JAX suites ``test_sharded.py`` and ``test_sharded_ivf.py``, run on
the port's row-sharded store through ``test_torch_query_suites.mirror()``.

Their ``create_mesh`` takes the port's CPU devices (the JAX package's 8
virtual CPU devices become ``[cpu] * 8``), and their
``ShardedVectorStore(mesh, dim, ...)`` calls are given as keywords, since
the port's store takes ``dim`` first and the mesh by name.
"""

import functools
import sys

import torch

from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu_torch.parallel import create_mesh

cpu_mesh = functools.partial(create_mesh, devices=[torch.device("cpu")] * 8)

SUITES = ("test_sharded.py", "test_sharded_ivf.py")
EXCLUDED: dict = {}
KEYWORDS = (
    ("ShardedVectorStore(mesh8, ", "ShardedVectorStore(mesh=mesh8, dim="),
    ("ShardedVectorStore(mesh, ", "ShardedVectorStore(mesh=mesh, dim="),
)
REWRITE = {
    "test_sharded.py": KEYWORDS + (
        ("ShardedVectorStore(\n        mesh, 16,", "ShardedVectorStore(\n        mesh=mesh, dim=16,"),
    ),
    "test_sharded_ivf.py": KEYWORDS[1:] + (
        ('devices=jax.devices("cpu")[:8]', 'devices=[__import__("torch").device("cpu")] * 8'),
    ),
}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)
sys.modules["port_mirror_test_sharded"].create_mesh = cpu_mesh


def test_every_sharded_suite_test_is_mirrored_or_excluded():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)
