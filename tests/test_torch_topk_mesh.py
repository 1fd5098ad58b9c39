"""The mesh tests of the JAX suite ``test_topk_many_matrix.py`` (interval
tables that overlap, straddle shard boundaries or pass K4's 8-interval
table, min_score, reserve, and their int8 forms), run on the port's
row-sharded store on a (dp=2, shard=4) mesh of CPU devices through
``test_torch_query_suites.mirror()``.
"""

import pytest
import torch

from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu_torch.parallel import create_mesh

SUITES = ("test_topk_many_matrix.py",)
_ONE_DEVICE = (
    "holds ops/topk's one-device programs on jnp arrays, not a mesh; "
    "test_torch_topk.py holds the port's programs to the JAX ones"
)
EXCLUDED = {
    ("test_topk_many_matrix.py", name): _ONE_DEVICE
    for name in (
        "test_topk_many_exact1_matches_per_batch",
        "test_topk_many_exact2_stacks_certificates",
        "test_topk_many_hybrid_mode",
        "test_topk_many_quantized_mode",
        "test_topk_many_approx_mode",
        "test_topk_many_unknown_mode_raises",
        "test_intervals_to_rowmask_matches_union_oracle",
        "test_topk_program_masked_matches_oracle",
        "test_topk_program_masked_all_masked_out",
    )
}
REWRITE = {"test_topk_many_matrix.py": (("ShardedVectorStore(mesh, ", "ShardedVectorStore(mesh=mesh, dim="),)}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)


@pytest.fixture(scope="module")
def mesh():
    """The suite's (dp=2, shard=4) mesh, on the CPU."""
    return create_mesh(n_shard=4, n_dp=2, devices=[torch.device("cpu")] * 8)


def test_every_mesh_test_is_mirrored_or_excluded():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)
