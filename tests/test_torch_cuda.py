"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and the CUDA toolkit; elsewhere they skip.
On the card (where jax is not installed, so the repo's conftest cannot
load):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py -q

Tolerances: raw f32 scores 2e-6 (summation order differs, no TF32);
bf16 stores and the int8 and int4 shadows 1e-5 (exact bf16 products, f32
sums, times the row's scale).
"""

import functools

import numpy as np
import pytest
import torch

from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.ops import int4, topk
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

from test_torch_scope_tiles import CASES as SCOPE_CASES
from test_torch_scope_tiles import INTERVAL_CASES
from test_torch_scope_tiles import _case as scope_case
from test_torch_scope_tiles import _store_rows as store_rows

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-6, torch.bfloat16: 1e-5}
# The listed K4/K5 scope cases: f32 1e-6 (unit rows, 384 deep: the FFMA
# and cuBLAS sums differ by a few ulps of 1.0), bf16 1e-5.
SCOPE_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-5}


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


def _check_topk(emb, q, count, k, got, ref, tol):
    """K1 against its plain version: values within tol, as many filled
    slots, distinct live picks each scoring what the kernel reported, and
    no pick below the plain k-th value beyond tol."""
    (gv, gi), (pv, pi) = got, ref
    assert (gv - pv).abs().max().item() <= tol
    filled = gi >= 0
    assert bool((filled.sum(1) == (pi >= 0).sum(1)).all())
    assert bool((gi < count).all())
    assert bool((gv[~filled] == -3.0).all())
    raw = topk._raw_scores(emb, q, count).gather(1, gi.clamp(min=0).long())
    assert bool(((raw - gv).abs() <= tol)[filled].all())
    kth = torch.where(pi >= 0, pv, 3.0).min(dim=1, keepdim=True).values
    assert bool((gv >= kth - tol)[filled].all())
    for row in gi.cpu().numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == live.size


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 384])
@pytest.mark.parametrize("b", [1, 7, 16, 30, 63, 64, 65, 257])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_fused_topk_query_blocks(dev, dtype, d, b, k):
    """Every query block (8, 16, 32, 64) and a partial last one, with a count
    that ends inside a tile; rows past it hold data."""
    rng = np.random.default_rng(20)
    n_pad, count = 1 << 14, (1 << 14) - 1000 - 45
    emb = _store(rng, n_pad, n_pad, d, dtype, dev)
    q = _queries(rng, b, d, dev)
    topk.reset_launch_counts()
    got = topk.fused_topk(emb, q, count, k)
    ref = topk.topk_plain(emb, q, count, k)
    torch.cuda.synchronize()
    assert topk.launch_counts()["topk"] == 1
    _check_topk(emb, q, count, k, got, ref, TOL[dtype])


@pytest.mark.parametrize("b", [1, 64, 257])
def test_fused_topk_dead_store(dev, b):
    emb = _store(np.random.default_rng(21), 1024, 1024, 128, torch.float32, dev)
    q = _queries(np.random.default_rng(22), b, 128, dev)
    vals, idx = topk.fused_topk(emb, q, 0, 10)
    assert bool((vals == -3.0).all()) and bool((idx == -1).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 64, 256])
def test_fused_topk_ties_across_tile_and_split_edges(dev, dtype, b):
    """Exact duplicates on both sides of a tile edge and of this card's split
    edge keep ascending rows; a row equal to them over the first depth chunk
    only (32 columns) ranks below them."""
    rng = np.random.default_rng(23)
    n_pad, count, d = 1 << 16, (1 << 16) - 77, 384
    emb = _store(rng, n_pad, count, d, dtype, dev)
    rows_per_split, _ = topk.scan_geometry(
        count, n_pad, b, topk._sm_count(0), topk.topk_query_block(b))
    edge = rows_per_split  # first row of split 1
    dupes = [127, 128, edge - 1, edge, edge + 127, count - 1]
    emb[dupes] = emb[dupes[0]].clone()
    near = 5000  # the duplicate's first chunk, then another unit row
    emb[near, :32] = emb[dupes[0], :32]
    q = _queries(rng, b, d, dev)
    q[0] = emb[dupes[0]].float()
    vals, idx = topk.fused_topk(emb, q, count, 8)
    assert idx[0, : len(dupes)].tolist() == dupes
    assert near not in idx[0, : len(dupes)].tolist()
    _check_topk(emb, q, count, 8, (vals, idx), topk.topk_plain(emb, q, count, 8), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 384, 1536])
@pytest.mark.parametrize("b", [1, 64, 65, 256])
@pytest.mark.parametrize("n_pad,count", [(1 << 16, 40_000), (384, 300)])
def test_bucket_kernels_persistent_ranges(dev, dtype, d, b, n_pad, count):
    """K2 and K2' over persistent bucket ranges: a watermark inside a bucket
    at the end of the live ranges (313 live buckets of 512, the dead ones
    strided over the CTAs) and a store of three buckets, fewer than the
    CTAs of a wave; d = 1536 bf16 streams its query strips."""
    rng = np.random.default_rng(24)
    emb = _store(rng, n_pad, n_pad, d, dtype, dev)
    q = _queries(rng, b, d, dev)
    topk.reset_launch_counts()
    maxima = topk.bucket_maxima(emb, q, count)
    gv, gi = topk.bucket_argmax(emb, q, count)
    torch.cuda.synchronize()
    counts = topk.launch_counts()
    assert counts["bucket_maxima"] == 1 and counts["bucket_argmax"] == 1
    tol = TOL[dtype]
    assert (maxima - topk.bucket_maxima_plain(emb, q, count)).abs().max().item() <= tol
    assert torch.equal(maxima, gv)
    pv, pi = topk.bucket_argmax_plain(emb, q, count)
    dead = torch.arange(n_pad // 128, device=dev) * 128 >= count
    assert bool((gv[:, dead] == -3.0).all()) and bool((gi[:, dead] == -1).all())
    raw = topk._raw_scores(emb, q, count).view(b, -1, 128)
    assert bool(_near_tie(raw, tol)[gi != pi].all())
    picked = raw.reshape(b, -1).gather(1, gi.clamp(min=0).long())
    assert bool(((picked - gv).abs() <= tol)[~dead.expand_as(gi)].all())


def test_wrapper_rejects_misaligned_operands(dev):
    """The kernels stage 16-byte pieces with cp.async and vector loads."""
    emb = torch.zeros((1024, 128), device=dev)
    q = torch.zeros((4 * 128 + 1,), device=dev)[1:].view(4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        topk.fused_topk(emb, q, 10, 5)
    with pytest.raises(ValueError, match="16-byte aligned"):
        topk.bucket_maxima(emb, q, 10)


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


def _near_tie(raw, tol):
    """[..., 128] raw bucket scores -> whether the two best lie within tol."""
    top2 = raw.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_pad,count,b", [(6144, 5000 - 37, 37), (6144, 6144, 64), (128, 77, 5)])
def test_bucket_argmax_matches_plain(dev, dtype, n_pad, count, b):
    rng = np.random.default_rng(13)
    d = 384
    emb = _store(rng, n_pad, min(count + 200, n_pad), d, dtype, dev)  # data past the watermark
    q = _queries(rng, b, d, dev)
    if n_pad > 1024:
        # Duplicates inside a bucket (300, 301, 383) and across an edge (511 | 512).
        emb[[301, 383]] = emb[300].clone()
        emb[512] = emb[511].clone()
        q[0], q[1] = emb[300].float(), emb[511].float()
    topk.reset_launch_counts()
    gv, gi = topk.bucket_argmax(emb, q, count)
    pv, pi = topk.bucket_argmax_plain(emb, q, count)
    torch.cuda.synchronize()
    counts = topk.launch_counts()
    assert counts["bucket_argmax"] == 1 and counts["bucket_maxima"] == 0
    tol = TOL[dtype]
    assert (gv - pv).abs().max().item() <= tol
    assert gi.dtype == torch.int32 and tuple(gi.shape) == (b, n_pad // 128)
    dead = torch.arange(n_pad // 128, device=dev) * 128 >= count
    assert bool((gv[:, dead] == -3.0).all()) and bool((gi[:, dead] == -1).all())
    raw = topk._raw_scores(emb, q, count).view(b, -1, 128)
    differ = gi != pi
    assert bool(_near_tie(raw, tol)[differ].all())
    # The kernel's row scores what it reported.
    picked = raw.reshape(b, -1).gather(1, gi.clamp(min=0).long())
    assert bool(((picked - gv).abs() <= tol)[~dead.expand_as(gi)].all())
    if n_pad > 1024:
        assert gi[0, 2].item() == 300 and gi[1, 3].item() == 511 and gi[1, 4].item() == 512


def test_bucket_maxima_and_argmax_agree(dev):
    """K2 and K2' are one template: the same maxima from either form."""
    rng = np.random.default_rng(14)
    for dtype in (torch.float32, torch.bfloat16):
        emb = _store(rng, 4096, 4000, 384, dtype, dev)
        q = _queries(rng, 70, 384, dev)
        vals, idx = topk.bucket_argmax(emb, q, 4000)
        assert torch.equal(vals, topk.bucket_maxima(emb, q, 4000))


@pytest.mark.parametrize("mode", ["approx", "ivf"])
def test_approx_and_ivf_stores_on_cuda_match_cpu_stores(dev, mode):
    """approx at the crossover (the K2' bucket route) and certified IVF (K3
    for phase 2, K2 + K3 for the tail): the card answers as the CPU does."""
    rng = np.random.default_rng(15)
    n = topk.APPROX_BUCKET_MIN_ROWS if mode == "approx" else 3000
    m = rng.standard_normal((n, 64)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = m[:6] + 0.05
    out = {}
    topk.reset_launch_counts()
    for device in ("cpu", "cuda"):
        s = VectorStore(TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(64), min_score=0.0,
            search_mode=mode, device=device,
        ))
        s.settings.ivf_certified = True
        s.add_embeddings(None, m)
        if mode == "ivf":
            s.build_ivf(rows_per_cluster=128, train_rows=1024, iters=3)
        out[device] = s.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    counts = topk.launch_counts()
    if mode == "approx":
        assert counts["bucket_argmax"] == 1
    else:
        assert counts["rescore"] >= 1 and counts["bucket_maxima"] >= 1
    for a, b in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose([x.score for x in a], [x.score for x in b], atol=2e-6)
        kth = a[-1].score
        assert all(x.item in {y.item for y in a} or abs(x.score - kth) <= 2e-6 for x in b)


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


def _check_scan(got, ref, raw_full, tol):
    """A scan's (vals, idx) against its plain version's: values within tol,
    the same number of filled slots, distinct picks each scoring (in the
    plain version's masked raw matrix) what the kernel reported."""
    (gv, gi), (pv, pi) = got, ref
    assert (gv - pv).abs().max().item() <= tol
    assert bool(((gi >= 0).sum(1) == (pi >= 0).sum(1)).all())
    filled = gi >= 0
    true = raw_full.gather(1, gi.clamp(min=0).long())
    assert bool(((true - gv).abs() <= tol)[filled].all())
    assert bool((true > -2.0)[filled].all())  # every pick in scope and live
    for row in gi.cpu().numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == live.size


def _scoped_case(dev, dtype, rng):
    n_pad, count, d = 9216, 9000 - 45, 384
    emb = _store(rng, n_pad, count, d, dtype, dev)
    # Duplicates on both sides of interval edges (tie rule across a filter
    # boundary and across row splits).
    dupes = [99, 100, 2047, 2048, 5000, 8954]
    emb[dupes] = emb[dupes[0]].clone()
    q = _queries(rng, 40, d, dev)
    q[0] = emb[dupes[0]].float()
    return emb, q, count, dupes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "table",
    [
        [[100, 2048]],
        # 8 rows: overlapping, unsorted, (0, 0) padding, one reaching past
        # the count watermark (8955).
        [[5000, 5100], [0, 50], [40, 120], [2000, 2100], [8900, 9216], [0, 0], [0, 0], [7000, 7001]],
    ],
)
@pytest.mark.parametrize("k", [1, 10, 32])
def test_fused_topk_iv_matches_plain(dev, dtype, table, k):
    rng = np.random.default_rng(6)
    emb, q, count, _ = _scoped_case(dev, dtype, rng)
    iv = torch.tensor(table, dtype=torch.int32, device=dev)
    topk.reset_launch_counts()
    got = topk.fused_topk_iv(emb, q, count, iv, k)
    ref = topk.topk_iv_plain(emb, q, count, iv, k)
    torch.cuda.synchronize()
    assert topk.launch_counts()["topk_iv"] == 1
    ids = torch.arange(emb.shape[0], device=dev)
    raw = topk._raw_scores(emb, q, count).masked_fill(~topk._in_intervals(ids, iv)[None, :], -3.0)
    _check_scan(got, ref, raw, TOL[dtype])
    assert got[1][0].tolist() == ref[1][0].tolist()  # lowest-row ties, query 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_fused_topk_masked_matches_plain(dev, dtype, k):
    rng = np.random.default_rng(7)
    emb, q, count, _ = _scoped_case(dev, dtype, rng)
    mask = torch.from_numpy((rng.random(emb.shape[0]) < 0.3).astype(np.int32)).to(dev)
    mask[[99, 2048, 8954]] = 1
    mask[[100, 2047]] = -1  # not > 0: out of scope, as in the JAX kernel
    topk.reset_launch_counts()
    got = topk.fused_topk_masked(emb, q, count, mask, k)
    ref = topk.topk_masked_plain(emb, q, count, mask, k)
    torch.cuda.synchronize()
    assert topk.launch_counts()["topk_mask"] == 1
    raw = topk._raw_scores(emb, q, count).masked_fill(~(mask > 0)[None, :], -3.0)
    _check_scan(got, ref, raw, TOL[dtype])
    assert got[1][0].tolist() == ref[1][0].tolist()


def _int8_case(dev, rng):
    n_pad, count, d = 9216, 9000 - 45, 384
    m = rng.standard_normal((count, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    m[[99, 2048, 8954]] = m[99]
    q_rows, scales = topk.quantize_rows(m)
    emb = torch.zeros((n_pad, d), dtype=torch.int8, device=dev)
    emb[:count] = torch.from_numpy(q_rows).to(dev)
    sc = torch.ones((n_pad,), device=dev)
    sc[:count] = torch.from_numpy(scales).to(dev)
    q = _queries(rng, 40, d, dev)
    q[0] = torch.from_numpy(m[99]).to(dev)
    return emb, sc, q, count


@pytest.mark.parametrize("k", [1, 10, 32])
def test_fused_topk_q_matches_plain(dev, k):
    rng = np.random.default_rng(8)
    emb, sc, q, count = _int8_case(dev, rng)
    topk.reset_launch_counts()
    got = topk.fused_topk_q(emb, sc, q, count, k)
    ref = topk.topk_q_plain(emb, sc, q, count, k)
    torch.cuda.synchronize()
    assert topk.launch_counts()["topk_q"] == 1
    _check_scan(got, ref, topk._raw_scores_q(emb, sc, q, count), 1e-5)
    assert got[1][0, :3].tolist() == [99, 2048, 8954][:k]


@pytest.mark.parametrize("k", [1, 10, 32])
def test_fused_topk_mq_matches_plain(dev, k):
    rng = np.random.default_rng(9)
    emb, sc, q, count = _int8_case(dev, rng)
    mask = topk.intervals_to_rowmask(
        emb.shape[0], torch.tensor([[0, 1000], [2048, 2049], [8000, 9216]], dtype=torch.int32, device=dev)
    )
    topk.reset_launch_counts()
    got = topk.fused_topk_mq(emb, sc, q, count, mask, k)
    ref = topk.topk_mq_plain(emb, sc, q, count, mask, k)
    torch.cuda.synchronize()
    assert topk.launch_counts()["topk_mq"] == 1
    raw = topk._raw_scores_q(emb, sc, q, count).masked_fill(~(mask > 0), -3.0)
    _check_scan(got, ref, raw, 1e-5)
    assert got[1][0, :3].tolist() == [99, 2048, 8954][:k]


# K6 and K7 on the tensor-core loop: a store of 256 tiles whose count ends
# inside tile 253 (rows past it hold data), and scopes that skip tiles.
_I8_N, _I8_COUNT = 1 << 15, (1 << 15) - 333


def _int8_scope(name, edge):
    """(row spans in scope or None for K6, duplicates of row dupes[0]);
    ``edge`` is the first row of K6's split 1 at the batch."""
    t = 128
    return {
        "global": (None, [127, 128, edge - 1, edge, _I8_COUNT - 1, _I8_COUNT + 5]),
        # In-scope tiles 3, 7-8, 20 and 200, wholly out-of-scope tiles
        # between them; one duplicate out of scope (tile 150).
        "gaps": ([(3 * t + 5, 3 * t + 60), (7 * t, 9 * t), (20 * t + 100, 20 * t + 101), (200 * t, 201 * t)],
                 [3 * t + 10, 7 * t + 127, 8 * t, 20 * t + 100, 200 * t + 1, 150 * t]),
        # In-scope rows only in the last tile of one split and the first of
        # the next; their two tiles fall to two CTAs of the list too.
        "split_edge": ([(edge - 64, edge + 64)], [edge - 1, edge]),
        # Duplicates on both sides of a skipped tile (11), one inside it.
        "skipped_dupes": ([(10 * t, 11 * t), (12 * t, 13 * t)], [10 * t + 127, 11 * t + 50, 12 * t]),
        "all": ([(0, _I8_N)], [0, 127, edge, _I8_COUNT - 1]),
        "empty": ([], [5, 6]),
        "past_count": ([(_I8_COUNT, _I8_N)], [_I8_COUNT, _I8_COUNT + 1]),
    }[name]


@functools.lru_cache(maxsize=None)
def _int8_rows(d):
    m = np.random.default_rng(30 + d).standard_normal((_I8_N, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _int8_route_moved(b, d, scoped):
    """The launch counters of one K6 or K7 search at batch b over a store d
    wide: the kind's counter once, and its narrow counter once where the
    route takes the narrow kernel (up to 16 queries, a plan for d)."""
    counts = topk.launch_counts()
    kind = "topk_mq" if scoped else "topk_q"
    narrow = topk.int8_query_block(b, d) < 64
    assert counts[kind] == 1 and counts["topk_q" if scoped else "topk_mq"] == 0
    assert counts[kind + "_narrow"] == int(narrow)
    assert counts[("topk_q" if scoped else "topk_mq") + "_narrow"] == 0


@pytest.mark.parametrize("scope", ["global", "gaps", "split_edge", "skipped_dupes", "all", "empty", "past_count"])
@pytest.mark.parametrize("k", [1, 10, 32])
@pytest.mark.parametrize("b,d", [(b, d) for d in (384, 768) for b in (1, 3, 8, 9, 16, 17, 64, 256)]
                         + [(b, d) for d in (3072, 4096) for b in (8, 16)])
def test_int8_scans_match_plain(dev, scope, b, k, d):
    """K6 and K7 on both routes (the narrow kernel up to 16 queries where
    its plan fits the width, the 64-query loop above and at rows too wide),
    with the split edge of the route's own grid."""
    rng = np.random.default_rng(30)
    edge, _ = topk.int8_scan_geometry(_I8_COUNT, _I8_N, b, topk._sm_count(0), d)
    spans, dupes = _int8_scope(scope, edge)
    dupes = sorted(set(dupes))  # the split edge may be a tile edge listed already
    m = _int8_rows(d).copy()
    m[dupes] = m[dupes[0]]
    q_rows, scales = topk.quantize_rows(m)
    emb, sc = torch.from_numpy(q_rows).to(dev), torch.from_numpy(scales).to(dev)
    q = _queries(rng, b, d, dev)
    q[0] = torch.from_numpy(m[dupes[0]]).to(dev)
    topk.reset_launch_counts()
    if spans is None:
        mask = torch.ones(_I8_N, dtype=torch.int32, device=dev)
        got = topk.fused_topk_q(emb, sc, q, _I8_COUNT, k)
        ref = topk.topk_q_plain(emb, sc, q, _I8_COUNT, k)
    else:
        mask = torch.zeros(_I8_N, dtype=torch.int32, device=dev)
        for lo, hi in spans:
            mask[lo:hi] = 1
        got = topk.fused_topk_mq(emb, sc, q, _I8_COUNT, mask, k)
        ref = topk.topk_mq_plain(emb, sc, q, _I8_COUNT, mask, k)
    torch.cuda.synchronize()
    _int8_route_moved(b, d, spans is not None)
    raw = topk._raw_scores_q(emb, sc, q, _I8_COUNT).masked_fill(~(mask > 0), -3.0)
    _check_scan(got, ref, raw, 1e-5)
    want = [r for r in dupes if r < _I8_COUNT and mask[r].item() > 0][:k]
    assert got[1][0, : len(want)].tolist() == want  # lowest-row ties through skips and splits
    if scope in ("empty", "past_count"):
        assert bool((got[0] == -3.0).all()) and bool((got[1] == -1).all())


@pytest.mark.parametrize("d", [128, 512, 1536])
@pytest.mark.parametrize("b", [8, 64, 257])
def test_int8_scans_resident_and_streamed_queries(dev, d, b):
    """The 64-query loop (b = 64, 257): d = 128, resident queries, scores
    folded in two passes; d = 512 and 1536, streamed query strips, one
    pass. The narrow kernel (b = 8): 8 consumer warps of two or more slabs
    each, and at d = 1536 four warps of two."""
    rng = np.random.default_rng(31)
    n_pad, count = 9216, 9000 - 45
    m = rng.standard_normal((n_pad, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q_rows, scales = topk.quantize_rows(m)
    emb, sc = torch.from_numpy(q_rows).to(dev), torch.from_numpy(scales).to(dev)
    q = _queries(rng, b, d, dev)
    mask = torch.from_numpy((rng.random(n_pad) < 0.2).astype(np.int32)).to(dev)
    got = topk.fused_topk_q(emb, sc, q, count, 10)
    _check_scan(got, topk.topk_q_plain(emb, sc, q, count, 10), topk._raw_scores_q(emb, sc, q, count), 1e-5)
    got = topk.fused_topk_mq(emb, sc, q, count, mask, 10)
    raw = topk._raw_scores_q(emb, sc, q, count).masked_fill(~(mask > 0), -3.0)
    _check_scan(got, topk.topk_mq_plain(emb, sc, q, count, mask, 10), raw, 1e-5)


@pytest.mark.parametrize("b", [8, 40])
def test_fused_topk_mq_does_not_synchronize(dev, b):
    """The scope's tile list is built on the device, as the narrow route's
    query block: K7 never waits on the host (a LookupBatcher pipelines
    batches through it)."""
    rng = np.random.default_rng(32)
    emb, sc, q, count = _int8_case(dev, rng)
    q = q[:b].contiguous()
    mask = topk.intervals_to_rowmask(
        emb.shape[0], torch.tensor([[0, 1000], [2048, 2049], [8000, 9216]], dtype=torch.int32, device=dev)
    )[0].contiguous()
    ref = topk.fused_topk_mq(emb, sc, q, count, mask, 10)  # builds the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = topk.fused_topk_mq(emb, sc, q, count, mask, 10)
        tiles, n_tiles = topk.scope_tiles(mask, count)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    cpu_tiles, cpu_n = topk.scope_tiles(mask.cpu(), count)
    assert torch.equal(tiles.cpu(), cpu_tiles) and torch.equal(n_tiles.cpu(), cpu_n)


@pytest.mark.parametrize("scoped", [False, True])
@pytest.mark.parametrize("d", [384, 768])
def test_int8_scans_with_the_corpus_padding(dev, scoped, d):
    """One caller's query padded to 8 with 7 zero queries, as the corpus
    sends it: the narrow kernel, the zero queries' lists included."""
    rng = np.random.default_rng(33)
    n_pad, count = 9216, 9000 - 45
    m = rng.standard_normal((n_pad, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q_rows, scales = topk.quantize_rows(m)
    emb, sc = torch.from_numpy(q_rows).to(dev), torch.from_numpy(scales).to(dev)
    q = torch.zeros((8, d), device=dev)
    q[0] = _queries(rng, 1, d, dev)[0]
    mask = torch.from_numpy((rng.random(n_pad) < 0.5).astype(np.int32)).to(dev)
    raw = topk._raw_scores_q(emb, sc, q, count)
    topk.reset_launch_counts()
    if scoped:
        got = topk.fused_topk_mq(emb, sc, q, count, mask, 10)
        ref = topk.topk_mq_plain(emb, sc, q, count, mask, 10)
        raw = raw.masked_fill(~(mask > 0), -3.0)
    else:
        got = topk.fused_topk_q(emb, sc, q, count, 10)
        ref = topk.topk_q_plain(emb, sc, q, count, 10)
    torch.cuda.synchronize()
    _int8_route_moved(8, d, scoped)
    _check_scan(got, ref, raw, 1e-5)
    # A zero query scores 0 everywhere: its ten lowest live (in-scope) rows.
    live = [r for r in range(count) if not scoped or mask[r].item() > 0][:10]
    assert got[1][1:].tolist() == [live] * 7 and bool((got[0][1:] == 0).all())


@pytest.mark.parametrize("b", [1, 8, 16, 64])
def test_int8_scans_take_every_code(dev, b):
    """Rows that hold all 256 codes (-128 and 127 included), each code in
    every column somewhere, scaled by one: the kernel's conversion against
    the plain version's exact upcast."""
    rng = np.random.default_rng(34)
    n_pad, d = 4096, 768
    codes = (np.arange(n_pad)[:, None] * 7 + np.arange(d)[None, :] * 13) % 256 - 128
    emb = torch.from_numpy(codes.astype(np.int8)).to(dev)
    sc = torch.full((n_pad,), 1.0 / 4096, device=dev)
    q = _queries(rng, b, d, dev)
    topk.reset_launch_counts()
    got = topk.fused_topk_q(emb, sc, q, n_pad - 5, 32)
    ref = topk.topk_q_plain(emb, sc, q, n_pad - 5, 32)
    torch.cuda.synchronize()
    _int8_route_moved(b, d, False)
    _check_scan(got, ref, topk._raw_scores_q(emb, sc, q, n_pad - 5), 1e-5)
    # Row r repeats row r + 256: the best pattern's 15 live copies, lowest first.
    assert got[1][:, :15].tolist() == ref[1][:, :15].tolist()


def test_narrow_plan_mirrors_the_kernel(dev):
    """ops/topk.py narrow_plan, which picks the route, gives the plan the
    kernel launches with (tat_topk_narrow_plan) at every width up to 8192."""
    import ctypes

    from typeagent_tpu_torch.ops import _build

    lib = _build.kernels()
    for width in range(64, 8193, 64):
        for query_block in (8, 16):
            warps, stages = ctypes.c_int(0), ctypes.c_int(0)
            smem = lib.tat_topk_narrow_plan(width, query_block, ctypes.byref(warps), ctypes.byref(stages))
            plan = (warps.value, stages.value) if smem >= 0 else None
            assert plan == topk.narrow_plan(width, query_block), (width, query_block)


def test_narrow_int8_scans_reject_unaligned_scales(dev):
    emb = torch.zeros((1024, 128), dtype=torch.int8, device=dev)
    scales = torch.ones(1028, device=dev)[4:]  # 16-byte aligned
    topk.fused_topk_q(emb, scales, torch.ones((8, 128), device=dev), 1000, 5)
    with pytest.raises(ValueError):
        topk.fused_topk_q(emb, torch.ones(1025, device=dev)[1:], torch.ones((8, 128), device=dev), 1000, 5)


def _float_scope(name, edge):
    """(row spans in scope, duplicates of row dupes[0]) of K4 and K5 over
    the int8 scans' store shape; ``edge`` is the first row of K1's split 1
    at the batch. Duplicates sit in listed tiles and in skipped ones."""
    t = 128
    return {
        "empty": ([], [5, 6, 3 * t]),
        # One listed tile (40); duplicates in it, past its span, and in the
        # skipped tiles 2 and 41.
        "one_tile": ([(40 * t + 3, 40 * t + 90)], [2 * t + 7, 40 * t + 3, 40 * t + 89, 40 * t + 100, 41 * t]),
        # In-scope rows only in the last tile of one split and the first of
        # the next; the two listed tiles fall to two CTAs.
        "split_edge": ([(edge - 64, edge + 64)], [edge - 1, edge]),
        # Listed tiles 3, 7-8, 20 and 200; duplicates in the skipped tiles
        # 1, 11 and 150 too.
        "gaps": ([(3 * t + 5, 3 * t + 60), (7 * t, 9 * t), (20 * t + 100, 20 * t + 101), (200 * t, 201 * t)],
                 [t + 1, 3 * t + 10, 7 * t + 127, 8 * t, 11 * t + 64, 20 * t + 100, 150 * t, 200 * t + 1]),
        "past_count": ([(_I8_COUNT, _I8_N)], [_I8_COUNT, _I8_COUNT + 1]),
        "whole": ([(0, _I8_N)], [0, 127, edge, _I8_COUNT - 1, _I8_COUNT + 5]),
    }[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("scope", ["empty", "one_tile", "split_edge", "gaps", "past_count", "whole"])
@pytest.mark.parametrize("b", [1, 8, 9, 16, 33, 64, 256])
@pytest.mark.parametrize("k", [1, 10, 32])
def test_scoped_float_scans_read_listed_tiles(dev, dtype, scope, b, k):
    """K4 (interval table) and K5 (row mask) read only the tiles their
    scope lists, at every FFMA query block: each matches its plain version
    and keeps ties at the lowest row across skipped tiles and list shares;
    a scope with no live row gives only (-3, -1)."""
    edge, _ = topk.scan_geometry(_I8_COUNT, _I8_N, b, topk._sm_count(0), topk.topk_query_block(b))
    spans, dupes = _float_scope(scope, edge)
    dupes = sorted(set(dupes))
    gen = torch.Generator(device=dev)
    gen.manual_seed(33)
    m = torch.nn.functional.normalize(torch.randn((_I8_N, 384), generator=gen, device=dev), dim=1)
    m[dupes] = m[dupes[0]].clone()
    emb = m.to(dtype)
    q = torch.nn.functional.normalize(torch.randn((b, 384), generator=gen, device=dev), dim=1)
    q[0] = m[dupes[0]]
    table = torch.tensor(spans, dtype=torch.int32, device=dev).reshape(-1, 2)
    mask = torch.zeros(_I8_N, dtype=torch.int32, device=dev)
    for lo, hi in spans:
        mask[lo:hi] = 1
    topk.reset_launch_counts()
    got_iv = topk.fused_topk_iv(emb, q, _I8_COUNT, table, k)
    got_m = topk.fused_topk_masked(emb, q, _I8_COUNT, mask, k)
    ref = topk.topk_iv_plain(emb, q, _I8_COUNT, table, k)
    torch.cuda.synchronize()
    counts = topk.launch_counts()
    assert counts["topk_iv"] == 1 and counts["topk_mask"] == 1
    assert counts["interval_tiles"] == 1 and counts["scope_tiles"] == 1
    raw = topk._raw_scores(emb, q, _I8_COUNT).masked_fill(~(mask > 0), -3.0)
    want = [r for r in dupes if r < _I8_COUNT and mask[r].item() > 0][:k]
    for got in (got_iv, got_m):
        _check_scan(got, ref, raw, SCOPE_TOL[dtype])
        assert got[1][0, : len(want)].tolist() == want
        if not want:
            assert bool((got[0] == -3.0).all()) and bool((got[1] == -1).all())


def test_scoped_float_scans_do_not_synchronize(dev):
    """K4 lists its tiles from the interval table and K5 from the mask on
    the device: neither waits on the host."""
    rng = np.random.default_rng(34)
    emb, q, count, _ = _scoped_case(dev, torch.float32, rng)
    table = torch.tensor([[100, 2048], [5000, 5100], [0, 0]], dtype=torch.int32, device=dev)
    mask = topk.intervals_to_rowmask(emb.shape[0], table)[0].contiguous()
    ref_iv = topk.fused_topk_iv(emb, q, count, table, 10)  # builds the kernels first
    ref_m = topk.fused_topk_masked(emb, q, count, mask, 10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_iv = topk.fused_topk_iv(emb, q, count, table, 10)
        got_m = topk.fused_topk_masked(emb, q, count, mask, 10)
        tiles, n_tiles = topk.interval_tiles(table, count, emb.shape[0])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for got, ref in ((got_iv, ref_iv), (got_m, ref_m)):
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert torch.equal(got_iv[1], got_m[1])
    cpu_tiles, cpu_n = topk.interval_tiles(table.cpu(), count, emb.shape[0])
    assert torch.equal(tiles.cpu(), cpu_tiles) and torch.equal(n_tiles.cpu(), cpu_n)


@pytest.mark.parametrize("case", SCOPE_CASES)
def test_scope_tiles_kernel_matches_plain(dev, case):
    """csrc/tile_list.cu's row-mask list is its plain version's, entry for
    entry: counts inside a tile, past the count, signed entries, a dead
    store, the corpus layouts."""
    mask, count = scope_case(case)
    m = torch.from_numpy(mask)
    topk.reset_launch_counts()
    got = topk.scope_tiles(m.to(dev), count)
    torch.cuda.synchronize()
    assert topk.launch_counts()["scope_tiles"] == 1
    want = topk.scope_tiles_plain(m, count)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_interval_tiles_kernel_matches_plain(dev, case):
    """csrc/tile_list.cu's list from an interval table is its plain
    version's: padding, overlapping and unsorted rows, empty spans, spans
    past the count, the corpus layouts and an IVF suffix."""
    table, count = INTERVAL_CASES[case]
    iv = torch.tensor(table, dtype=torch.int32).reshape(-1, 2)
    topk.reset_launch_counts()
    got = topk.interval_tiles(iv.to(dev), count, store_rows(count))
    torch.cuda.synchronize()
    assert topk.launch_counts()["interval_tiles"] == 1
    want = topk.interval_tiles_plain(iv, count, store_rows(count))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("convs", [(0,), (0, 2)])
def test_tile_lists_of_a_30m_row_corpus(dev, convs):
    """The int8 corpus's layout at full size (234,375 live tiles, over 200
    per thread of the one-CTA compaction): both kernels give the plain
    lists, from the row mask and from the merged interval table."""
    n_rows, seg = 30_000_000, 1_250_000
    table = []
    for i in range(24):
        if i % 3 in convs:
            if table and table[-1][1] == i * seg:
                table[-1][1] = (i + 1) * seg
            else:
                table.append([i * seg, (i + 1) * seg])
    iv = torch.tensor(table, dtype=torch.int32, device=dev)
    mask = topk.intervals_to_rowmask(n_rows, iv)[0].contiguous()
    count = n_rows - 77
    from_mask, from_table = topk.scope_tiles(mask, count), topk.interval_tiles(iv, count, n_rows)
    want = topk.scope_tiles_plain(mask, count)
    for got in (from_mask, from_table, topk.interval_tiles_plain(iv, count, n_rows)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0 < want[1].item() < -(-count // 128)


def test_scope_tiles_kernel_reads_an_unaligned_mask(dev):
    """A mask that starts 4 bytes into its storage takes the kernel's
    row-by-row reads; the list is the plain version's."""
    mask, count = scope_case("random_sparse")
    backing = torch.zeros(mask.size + 1, dtype=torch.int32, device=dev)
    backing[1:] = torch.from_numpy(mask).to(dev)
    got = topk.scope_tiles(backing[1:], count)
    want = topk.scope_tiles_plain(torch.from_numpy(mask), count)
    assert backing[1:].data_ptr() % 16 and want[1].item() > 0
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_scope_tiles_kernel_refuses_other_masks(dev):
    with pytest.raises(ValueError):
        topk.scope_tiles(torch.ones(1024, dtype=torch.int64, device=dev), 1000)
    with pytest.raises(ValueError):
        topk.scope_tiles(torch.ones(2048, dtype=torch.int32, device=dev)[::2], 1000)
    with pytest.raises(ValueError):
        topk.interval_tiles(torch.ones((3, 2), dtype=torch.int64, device=dev), 1000, 1024)


def test_scoped_routes_count_their_kernels(dev):
    rng = np.random.default_rng(10)
    emb, q, count, _ = _scoped_case(dev, torch.float32, rng)
    small = torch.tensor([[0, 500]] * 8, dtype=torch.int32, device=dev)
    large = torch.tensor([[i * 900, i * 900 + 100] for i in range(9)], dtype=torch.int32, device=dev)
    topk.reset_launch_counts()
    topk.topk_program_intervals(emb, q, count, small, 10)
    topk.topk_program_intervals(emb, q, count, large, 10)
    counts = topk.launch_counts()
    assert counts["topk_iv"] == 1 and counts["topk_mask"] == 1 and counts["materialized_topk"] == 0


def test_int8_store_on_cuda_matches_cpu_store(dev):
    rng = np.random.default_rng(11)
    m = rng.standard_normal((3000, 64)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    q = torch.from_numpy(m[:6] + 0.05).bfloat16().float().numpy()
    out = {}
    for device in ("cpu", "cuda"):
        s = VectorStore(TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(64), min_score=0.0,
            dtype="int8", device=device,
        ))
        s.add_embeddings(None, m)
        out[device] = s.fuzzy_lookup_embeddings_batch(q, max_hits=10)
    for a, b in zip(out["cpu"], out["cuda"]):
        assert [x.item for x in a] == [x.item for x in b]
        np.testing.assert_allclose([x.score for x in a], [x.score for x in b], atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_corpus_on_cuda_matches_cpu_corpus(dev, dtype):
    from typeagent_tpu_torch.parallel import CorpusVectorStore

    rng = np.random.default_rng(12)
    # 8 rounds of a|b|c: "a" is 8 intervals (K4), "a"+"c" 9 after c|a
    # segments merge (row mask, K5); int8 scopes always take K7.
    segs = [(name, rng.standard_normal((150, 64)).astype(np.float32))
            for _ in range(8) for name in ("a", "b", "c")]
    q = np.zeros((9, 64), np.float32)  # unit +-0.25 rows: bf16-exact after normalizing
    for row in q:
        row[rng.choice(64, 16, replace=False)] = rng.choice([-0.25, 0.25], 16)
    out = {}
    topk.reset_launch_counts()
    for device in ("cpu", "cuda"):
        corpus = CorpusVectorStore(64, device=device, dtype=dtype)
        for name, rows in segs:
            corpus.append(name, rows)
        out[device] = [corpus.search(q, k=10, conversations=c) for c in (None, ["a"], ["a", "c"])]
    counts = topk.launch_counts()
    if dtype == "int8":  # 9 queries, padded to 16: the narrow route
        assert counts["topk_q"] == 1 and counts["topk_mq"] == 2
        assert counts["topk_q_narrow"] == 1 and counts["topk_mq_narrow"] == 2
    else:
        assert counts["topk"] == 1 and counts["topk_iv"] == 1 and counts["topk_mask"] == 1
    for got, want in zip(out["cuda"], out["cpu"]):
        for a, b in zip(got, want):
            assert [(h.conversation, h.local_ordinal) for h in a] == [(h.conversation, h.local_ordinal) for h in b]
            np.testing.assert_allclose([h.score for h in a], [h.score for h in b], atol=1e-5)


def _unit_rows(rng, n, d, dev):
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return torch.from_numpy(m).to(dev)


# K8 and K9 at query widths that stay resident in shared memory (K8 d <=
# 384, K9 d <= 384) and that stream through the ring (K8 d = 1024, K9 d =
# 2048): ragged and full watermarks, a one-bucket store and a dead store.
SELECTION_STORES = [(9216, 9000 - 45), (9216, 9216), (128, 77), (256, 0)]
SELECTION_BATCHES = [1, 8, 37, 65, 256]


@pytest.mark.parametrize("d", [64, 128, 384, 1024])
@pytest.mark.parametrize("n_pad,count", SELECTION_STORES)
@pytest.mark.parametrize("b", SELECTION_BATCHES)
def test_bucket_maxima_q_matches_plain(dev, d, n_pad, count, b):
    """K8 over an int8 shadow (every bucket of a dead store -3)."""
    rng = np.random.default_rng(16)
    emb_q, scales = topk.quantize_rows_device(_unit_rows(rng, n_pad, d, dev))
    q = _queries(rng, b, d, dev)
    topk.reset_launch_counts()
    got = topk.bucket_maxima_q(emb_q, scales, q, count)
    ref = topk.bucket_maxima_q_plain(emb_q, scales, q, count)
    torch.cuda.synchronize()
    assert topk.launch_counts()["bucket_maxima_q"] == 1
    assert tuple(got.shape) == (b, n_pad // 128)
    assert (got - ref).abs().max().item() <= 1e-5
    dead = torch.arange(n_pad // 128, device=dev) * 128 >= count
    assert bool((got[:, dead] == -3.0).all()) and bool((got[:, ~dead] > -2.0).all())


@pytest.mark.parametrize("d", [100, 128, 256, 384, 2048])
@pytest.mark.parametrize("n_pad,count", SELECTION_STORES)
@pytest.mark.parametrize("b", SELECTION_BATCHES)
def test_bucket_maxima_q4_matches_plain(dev, d, n_pad, count, b):
    """K9 over a packed int4 shadow (d = 100: halves of 50, dh 128), over
    the live depth of rows of width d as the int4 search calls it; codes
    of both signs in both nibbles."""
    rng = np.random.default_rng(17)
    packed, scales = int4.quantize_rows_int4_device(_unit_rows(rng, n_pad, d, dev))
    qs = int4.split_pad_queries(_queries(rng, b, d, dev), d)
    topk.reset_launch_counts()
    got = int4.bucket_maxima_q4(packed, scales, qs, count, d=d)
    ref = int4.bucket_maxima_q4_plain(packed, scales, qs, count, d=d)
    torch.cuda.synchronize()
    assert topk.launch_counts()["bucket_maxima_q4"] == 1
    assert tuple(got.shape) == (b, n_pad // 128)
    assert (got - ref).abs().max().item() <= 1e-5
    dead = torch.arange(n_pad // 128, device=dev) * 128 >= count
    assert bool((got[:, dead] == -3.0).all()) and bool((got[:, ~dead] > -2.0).all())


@pytest.mark.parametrize("d", [100, 256, 384, 2048])
@pytest.mark.parametrize("b", [8, 256])
def test_bucket_maxima_q4_live_depth_keeps_the_bits(dev, d, b):
    """K9 over the live depth gives the whole width's bits, also when the
    packed bytes past the live depth hold random codes (they meet zero
    query columns)."""
    rng = np.random.default_rng(20)
    n_pad, count = 4096, 4000
    packed, scales = int4.quantize_rows_int4_device(_unit_rows(rng, n_pad, d, dev))
    qs = int4.split_pad_queries(_queries(rng, b, d, dev), d)
    noisy = packed.clone()
    live = int4.live_depth(d)
    noisy[:, live:] = torch.randint(-128, 128, noisy[:, live:].shape, dtype=torch.int8, device=dev)
    whole = int4.bucket_maxima_q4(packed, scales, qs, count)
    for got in (int4.bucket_maxima_q4(packed, scales, qs, count, d=d),
                int4.bucket_maxima_q4(noisy, scales, qs, count, d=d)):
        assert torch.equal(got.view(torch.int32), whole.view(torch.int32))


def test_selection_wrappers_reject_bad_operands(dev):
    emb_q = torch.zeros((1024, 96), dtype=torch.int8, device=dev)  # 96 % 64 != 0
    with pytest.raises(ValueError, match="width % 64"):
        topk.bucket_maxima_q(emb_q, torch.ones(1024, device=dev), torch.zeros((4, 96), device=dev), 10)
    packed = torch.zeros((1024, 128), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="queries_split"):
        int4.bucket_maxima_q4(packed, torch.ones(1024, device=dev), torch.zeros((4, 256), device=dev), 10)


@pytest.mark.parametrize("search", ["hybrid_i8", "i4_f32", "i4_bf16"])
def test_selection_searches_on_cuda_match_cpu(dev, search):
    """The int8-selection hybrid and int4 selection (f32 and bf16 rescore
    buffers) on the card against the same search on the CPU: K8 or K9 and
    K3 launched, certificates equal, scores within 2e-6 (1e-5 for bf16),
    indices equal except at ties."""
    rng = np.random.default_rng(18)
    n_pad, count, d, k = 8192, 8000, 128, 10
    m = _unit_rows(rng, n_pad, d, torch.device("cpu"))
    q = _queries(rng, 24, d, "cpu").bfloat16().float()
    out = {}
    topk.reset_launch_counts()
    for device in ("cpu", "cuda"):
        emb, qd = m.to(device), q.to(device)
        if search == "hybrid_i8":
            emb_q, scales = topk.quantize_rows_device(emb)
            out[device] = topk.cosine_topk_exact2_hybrid_i8(emb, emb_q, scales, qd, count, k)
        else:
            packed, scales = int4.quantize_rows_int4_device(emb)
            buf = emb.bfloat16() if search == "i4_bf16" else emb
            out[device] = int4.cosine_topk_exact2_i4(buf, packed, scales, qd, count, k)
    counts = topk.launch_counts()
    assert counts["bucket_maxima_q" if search == "hybrid_i8" else "bucket_maxima_q4"] == 1
    assert counts["rescore"] == 1
    tol = 1e-5 if search == "i4_bf16" else 2e-6
    (cv, ci, cc), (gv, gi, gc) = out["cpu"], (t.cpu() for t in out["cuda"])
    assert torch.equal(cc, gc)
    assert (cv - gv).abs().max().item() <= tol
    for a, b, va, vb in zip(ci.tolist(), gi.tolist(), cv.tolist(), gv.tolist()):
        for i, v in zip(b, vb):
            assert i in a or abs(v - va[-1]) <= tol


def test_conversation_on_cuda_matches_cpu(dev, monkeypatch):
    """A 2,000-message conversation built through create_conversation and
    add_messages_with_indexing on the card, with EXACT2_MIN_ROWS lowered so
    that its message index takes the hybrid route (K2 + K3), against the
    same conversation with device="cpu": the same semrefs, and lookups with
    scores within 2e-6 and ordinals equal except at ties. A plain function
    that runs its own event loop: the card's tests run without the repo's
    conftest."""
    import asyncio

    from typeagent_tpu_torch import vectorstore

    from test_torch_conv_corpus import make_corpus, port_conversation

    monkeypatch.setattr(vectorstore, "EXACT2_MIN_ROWS", 1024)
    raw = make_corpus(5, 2000, vocab=500, speakers=20)
    texts = [raw[i]["text"] for i in (0, 999, 1999)] + ["word7 word70 word300", "speaker3 word1"]

    async def build_and_ask(device):
        conv, _ = await port_conversation(raw, 2, d=384, device=device)
        index = conv.secondary_indexes.message_index
        hits = [await index.lookup_messages(t, max_matches=10, threshold_score=0.0) for t in texts]
        return [r.serialize() for r in conv.semantic_refs.items], hits

    cpu_refs, cpu_hits = asyncio.run(build_and_ask("cpu"))
    topk.reset_launch_counts()
    card_refs, card_hits = asyncio.run(build_and_ask("cuda"))
    counts = topk.launch_counts()
    assert counts["bucket_maxima"] >= len(texts) and counts["rescore"] >= len(texts), counts
    assert card_refs == cpu_refs
    tol = 2e-6
    for got, want in zip(card_hits, cpu_hits):
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            assert abs(g.score - w.score) <= tol
            assert g.message_ordinal in {x.message_ordinal for x in want} or abs(g.score - want[-1].score) <= tol


def _postings_case(rng, n_postings=1_000_000, n_terms=2_000, n_semrefs=300_000, n_ops=2_000):
    """1M postings in CSR and ops (exact, related, boost; gates; two scope
    rows) that read every one of them."""
    from typeagent_tpu_torch.ops import postings as P

    term_of = np.sort(rng.integers(n_terms, size=n_postings))
    offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(np.bincount(term_of, minlength=n_terms), out=offsets[1:])
    semrefs = rng.integers(n_semrefs, size=n_postings).astype(np.int32)
    scores = rng.uniform(0.5, 1.0, n_postings).astype(np.float32)
    cap = P.round_up(n_semrefs, 1024)
    ops = (
        rng.permutation(n_terms)[:n_ops].astype(np.int64),
        rng.uniform(0.5, 100.0, n_ops).astype(np.float32),
        rng.integers(40, size=n_ops),
        rng.choice([P.OP_EXACT, P.OP_RELATED, P.OP_BOOST], p=[0.45, 0.45, 0.1], size=n_ops),
        rng.permutation(n_ops),
        np.where(rng.random(n_ops) < 0.1, rng.integers(4, size=n_ops), -1),
        rng.integers(2, size=n_ops),
    )
    masks = np.stack([np.ones(cap, bool), rng.random(cap) < 0.5])
    ktype = rng.integers(4, size=cap).astype(np.int8)
    return (offsets, semrefs, scores, *ops, masks, ktype), cap


def test_postings_core_on_cuda_matches_cpu_and_repeats_bits(dev):
    """The sorted core (COO form) at 1M postings: the same runs and op hits
    on the card as on the CPU, sums within 1e-6, and the same bits from two
    runs on the card (no atomic float sums)."""
    from typeagent_tpu_torch.ops import postings as P

    arrays, cap = _postings_case(np.random.default_rng(13))
    statics = dict(e_pad=1 << 21, semref_cap=cap, n_seg=40, dedup_related=True, r_max=1 << 21)
    out = {}
    for device in ("cpu", dev):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
        out[str(device)] = [P.accumulate_postings_segmented_coo(*args, 10.0, **statics) for _ in range(2)]
    (c_keys, c_sums, c_n, c_hit), _ = out["cpu"]
    (g_keys, g_sums, g_n, g_hit), again = out[str(dev)]
    for a, b in zip((g_keys, g_sums, g_n, g_hit), again):
        assert torch.equal(a, b)
    n = int(c_n)
    assert int(g_n) == n > 500_000
    assert torch.equal(g_keys.cpu(), c_keys) and torch.equal(g_hit.cpu(), c_hit)
    torch.testing.assert_close(g_sums.cpu()[:, :n], c_sums[:, :n], rtol=1e-6, atol=1e-6)


def test_query_engine_on_cuda_matches_cpu(dev):
    """query() on a 600-message conversation with stage 3 on the device
    engine, on the card and on the CPU: route "device" for every question,
    the same answers, stage-3 ordinals equal and scores within 1e-5."""
    import asyncio

    from typeagent_tpu_torch.knowpro import answers, searchlang
    from typeagent_tpu_torch.models.canned import CannedChatModel

    from test_torch_conv_corpus import make_corpus, make_questions, port_conversation

    raw = make_corpus(7, 600, vocab=400, speakers=12)
    questions = make_questions(raw, 8)

    async def ask(device):
        conv, _ = await port_conversation(raw, 1, d=64, device=device)
        model = CannedChatModel(questions)
        conv._query_translator = searchlang.create_search_query_translator(model)
        conv._answer_translator = answers.create_answer_translator(model)
        out = []
        for q in questions:
            debug = searchlang.LanguageSearchDebugContext()
            answer = await conv.query(q, debug_context=debug)
            out.append((answer, conv._last_engine_route, [
                {k: [(m.semantic_ref_ordinal, m.score) for m in r.semantic_ref_matches]
                 for k, r in res.knowledge_matches.items()}
                for res in debug.search_results
            ]))
        assert conv._device_executor._postings._offsets.device.type == torch.device(device).type
        return out

    cpu, card = asyncio.run(ask("cpu")), asyncio.run(ask("cuda"))
    for (a_cpu, r_cpu, s_cpu), (a_card, r_card, s_card) in zip(cpu, card):
        assert r_cpu == r_card == "device"
        assert a_cpu == a_card
        for x, y in zip(s_cpu, s_card):
            assert x.keys() == y.keys()
            for k in x:
                assert [o for o, _ in x[k]] == [o for o, _ in y[k]]
                assert max((abs(p - q) for (_, p), (_, q) in zip(x[k], y[k])), default=0.0) <= 1e-5


def test_sqlite_conversation_reopened_on_cuda_finds_its_messages(dev, monkeypatch, tmp_path):
    """A 2,000-message SQLite conversation built on the card, closed and
    reopened on the card (its message index loaded from the file's BLOBs),
    with EXACT2_MIN_ROWS lowered so the reopened index takes the hybrid
    route (K2 + K3): each probe message's own text finds that message
    first, at a cosine within 2e-6 of 1."""
    import asyncio

    from typeagent_tpu_torch import create_conversation, vectorstore
    from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage

    from test_torch_conv_corpus import make_corpus, port_conversation, port_settings

    monkeypatch.setattr(vectorstore, "EXACT2_MIN_ROWS", 1024)
    raw = make_corpus(9, 2000, vocab=500, speakers=20)
    db = str(tmp_path / "conv.db")
    probes = (0, 1, 500, 1234, 1999)

    async def build_reopen_and_ask():
        conv, _ = await port_conversation(raw, 2, d=384, device="cuda", dbname=db)
        await conv.settings.storage_provider.close()
        again = await create_conversation(db, ConversationMessage, settings=port_settings(384, "cuda"))
        index = again.secondary_indexes.message_index
        assert len(index._vectorbase) == 2000
        topk.reset_launch_counts()
        hits = [await index.lookup_messages(raw[i]["text"], max_matches=5) for i in probes]
        counts = topk.launch_counts()
        await again.settings.storage_provider.close()
        return hits, counts

    hits, counts = asyncio.run(build_reopen_and_ask())
    assert counts["bucket_maxima"] >= len(probes) and counts["rescore"] >= len(probes), counts
    for i, got in zip(probes, hits):
        assert got[0].message_ordinal == i and abs(got[0].score - 1.0) <= 2e-6


def _chip_smoke():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke


def test_golden_eval_on_cuda(dev):
    """``eval_golden.run_eval`` on the card against the committed goldens,
    on the device engine, the host VM and approx lookups (phase 18 (a))."""
    import asyncio

    routes = asyncio.run(_chip_smoke().golden_eval_routes("cuda"))
    assert {name: run["rc"] for name, run in routes.items()} == {"engine": 0, "host_vm": 0, "approx": 0}, routes


def test_int8_wire_through_batcher_on_cuda(dev):
    """The int8 query wire on a 262,144-row bf16 store (past
    EXACT2_MIN_ROWS: K2 + K3), sync and through ``LookupBatcher``, against
    the float wire and the plain f32 top-k of the dequantized queries
    (phase 18 (b) at a quarter of its rows; it fails inside on any miss)."""
    import asyncio

    out, launches = asyncio.run(_chip_smoke().int8_wire_check(dev, n_rows=262_144))
    assert out["recall_at_k_int8_vs_float"] >= 0.95
    assert launches["bucket_maxima"] > 0 and launches["rescore"] > 0
    assert out["upload_bytes_per_batch"] == {"float": 393_216, "int8": 98_304 + 1_024}
