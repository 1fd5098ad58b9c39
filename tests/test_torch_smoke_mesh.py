"""A CPU rehearsal of ``chip_smoke.py``'s phase 17 (the multi-device
layer) at a small size.

``chip_smoke.mesh_phase`` runs its six stages with every mesh on CPU
devices (``[cpu] * n``) and the plain versions in place of the kernels:
the corpus of phase 6's layout on (1, 4) against a one-device corpus and
the plain top-k shard by shard; a store on (2, 2) against one device; a
bf16 store saved from (1, 4) and restored on (2, 2) and (1, 1); a
``ConversationCorpus`` on the mesh with a refresh and save / load; the
engine's dp = 2 dispatch on a conversation's 16 questions; sharded IVF
beside the one-device IVF. Its checks are the card's; only the launch
requirements are the card's alone (the wrappers count launches of the
kernels, which do not run here).
"""

import asyncio
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {
    "corpus_seg_rows": 1_000, "corpus_chunk": 600, "corpus_b": 8,
    "store_rows": 6_000, "store_b": 16,
    "conv_messages": 120, "conv_more": 30, "conv_searches": 4,
    "ivf_rows": 8_192, "ivf_topics": 8, "ivf_queries": 256, "ivf_rows_per_cluster": 256,
    "engine_messages": 300,
}


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def test_phase17_rehearsal_on_the_cpu(chip_smoke):
    torch.manual_seed(0)
    out, counts = asyncio.run(chip_smoke.mesh_phase(torch.device("cpu"), SMALL))
    assert out["phase"] == 17 and out["ok"] and out["cards"] == 0
    assert out["a_corpus"]["rows"] == 24 * 1_000 and out["a_corpus"]["mesh"]["shard"] == 4
    assert out["b_store"]["mesh"]["dp"] == 2
    assert set(out["c_checkpoint"]["restored"]) == {"2x2", "1x1"}
    assert out["c_checkpoint"]["state_bytes"] >= 6_000 * 384 * 2
    assert out["d_conversation_corpus"]["refresh_rows"] == 30
    assert out["e_engine"]["dp_calls"] > 0 and out["e_engine"]["stage3_equal"]
    ivf = out["f_sharded_ivf"]
    assert ivf["mesh"]["shard"] == 4 and ivf["one_device"]["recall"] > 0.5 and ivf["sharded"]["recall"] > 0.5
    assert not any(counts.get(name, 0) for name in chip_smoke.KERNELS)  # plain versions launch nothing
