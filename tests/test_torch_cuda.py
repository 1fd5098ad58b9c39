"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and the CUDA toolkit; elsewhere they skip.
On the card (where jax is not installed, so the repo's conftest cannot
load):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances: raw f32 scores 2e-6 (summation order differs, no TF32);
bf16 stores 1e-5 (exact bf16 products, f32 sums).
"""

import numpy as np
import pytest
import torch

from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _queries(rng, b, d, dev):
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)  # the tolerances assume unit rows
    return torch.from_numpy(q).to(dev)


def _store(rng, n_pad, count, d, dtype, dev):
    m = rng.standard_normal((count, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    buf = torch.zeros((n_pad, d), dtype=dtype, device=dev)
    buf[:count] = torch.from_numpy(m).to(dev)
    return buf


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k", [(1, 1), (8, 10), (40, 32)])
def test_fused_topk_matches_plain(dev, dtype, b, k):
    rng = np.random.default_rng(1)
    count = 9000 - 45
    emb = _store(rng, 9216, count, 256, dtype, dev)
    q = _queries(rng, b, 256, dev)
    topk.reset_launch_counts()
    gv, gi = topk.fused_topk(emb, q, count, k)
    pv, pi = topk.topk_plain(emb, q, count, k)
    torch.cuda.synchronize()
    assert topk.launch_counts()["topk"] == 1
    assert (gv - pv).abs().max().item() <= TOL[dtype]
    true = topk._raw_scores(emb, q, count).gather(1, gi.long())
    assert bool((true >= pv[:, k - 1 : k] - TOL[dtype]).all())
    assert bool((gi < count).all()) and bool((gi >= 0).all())


def test_fused_topk_ties_to_lowest_row(dev):
    rng = np.random.default_rng(2)
    emb = _store(rng, 8192, 8000, 128, torch.float32, dev)
    dupes = [5, 1300, 2601, 4000, 7999]
    emb[dupes] = emb[5].clone()
    vals, idx = topk.fused_topk(emb, emb[5:6].contiguous(), 8000, 4)
    assert idx[0].tolist() == dupes[:4]
    vals, idx = topk.fused_topk(emb, emb[5:6].contiguous(), 3000, 4)  # watermark
    assert idx[0, :3].tolist() == dupes[:3] and 4000 not in idx[0].tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_maxima_matches_plain(dev, dtype):
    rng = np.random.default_rng(3)
    count = 5000
    emb = _store(rng, 6144, count, 384, dtype, dev)
    q = _queries(rng, 37, 384, dev)
    got = topk.bucket_maxima(emb, q, count)
    ref = topk.bucket_maxima_plain(emb, q, count)
    assert (got - ref).abs().max().item() <= TOL[dtype]
    assert bool((got[:, -(6144 - 5120) // 128 :] == -3.0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rescore_matches_plain(dev, dtype):
    rng = np.random.default_rng(4)
    emb = _store(rng, 4096, 4096, 384, dtype, dev)
    q = _queries(rng, 9, 384, dev)
    ids = torch.stack([torch.randperm(32, device=dev)[:30] for _ in range(9)]).to(torch.int32)
    got = topk.rescore_selected(emb, q, ids.contiguous())
    ref = topk.rescore_selected_plain(emb, q, ids)
    assert (got - ref).abs().max().item() <= 2e-6


def test_store_on_cuda_matches_cpu_store(dev):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((3000, 64)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = m[:6] + 0.05
    out = {}
    for device in ("cpu", "cuda"):
        s = VectorStore(TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(64), min_score=0.0,
            search_mode="exact2", device=device,
        ))
        s.add_embeddings(None, m)
        out[device] = s.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert [x.item for x in a] == [x.item for x in b]
        np.testing.assert_allclose([x.score for x in a], [x.score for x in b], atol=2e-6)


def test_wrapper_rejects_bad_operands(dev):
    emb = torch.zeros((1024, 128), device=dev)
    with pytest.raises(ValueError):
        topk.fused_topk(emb, torch.zeros((4, 64), device=dev), 10, 5)
    with pytest.raises(TypeError):
        topk.fused_topk(emb, torch.zeros((4, 128), device=dev, dtype=torch.float64), 10, 5)
    with pytest.raises(ValueError):
        topk.fused_topk(emb, torch.zeros((4, 128), device=dev), 10, 33)
