"""Parity: the port's scoped top-k routes (K4 interval table, K5 row mask,
``intervals_to_rowmask``) against the JAX package's
``topk_program_intervals`` / ``topk_program_masked(use_pallas=False)`` and
``intervals_to_rowmask``, on the same numpy inputs.

The port runs its kernels' plain versions (CPU tensors). Tolerances: f32
scores 1e-6, bf16 stores 1e-5 with bf16-representable queries. Invalid
slots are compared after filtering to ``vals >= 0``: the JAX XLA interval
route points them at masked rows, the port returns -1. The row mask must
match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from typeagent_tpu.ops import topk as jtopk
from typeagent_tpu_torch.ops import topk

F32_TOL = 1e-6
BF16_TOL = 1e-5

TABLES = {
    "one": [[100, 900]],
    "sorted": [[0, 64], [128, 300], [512, 513], [1000, 1500]],
    "unsorted_overlapping": [[700, 900], [0, 50], [40, 120], [800, 1200], [600, 650]],
    "padded": [[300, 400], [0, 0], [0, 0], [0, 0], [5, 6], [0, 0], [0, 0], [0, 0]],
    "eight": [[i * 250, i * 250 + 100] for i in range(8)],
    "nine": [[i * 220, i * 220 + 90] for i in range(9)],
    "nested": [[0, 2048], [100, 200], [150, 160]],
    "past_count": [[1900, 2048], [10, 20]],
    "empty": [[0, 0], [7, 7]],
    "thirty_two": [[i * 60, i * 60 + 30] for i in range(20)] + [[0, 0]] * 12,
}


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def _normed(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


def _pad(m, n_pad, d_pad):
    out = np.zeros((n_pad, d_pad), np.float32)
    out[: m.shape[0], : m.shape[1]] = m
    return out


def _bf16_round(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _stores(m_pad, dtype):
    j = jnp.asarray(m_pad)
    t = torch.from_numpy(m_pad.copy())
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.bfloat16()
    return j, t


def assert_topk_equivalent(vals_a, idx_a, vals_b, idx_b, tol):
    """Same top-k up to score ties within ``tol``, after dropping invalid
    slots (vals < 0)."""
    for va, ia, vb, ib in zip(*(np.asarray(x) for x in (vals_a, idx_a, vals_b, idx_b))):
        ka, kb = va >= 0, vb >= 0
        va, ia, vb, ib = va[ka], ia[ka], vb[kb], ib[kb]
        assert va.shape == vb.shape
        np.testing.assert_allclose(va, vb, atol=tol)
        kth = vb.min() if vb.size else -1.0
        for pos, i in enumerate(ia):
            if int(i) not in set(ib.tolist()):
                assert abs(float(va[pos]) - float(kth)) <= tol, (i, va[pos], kth)
        assert len(set(ia.tolist())) == ia.size


def _case(rng, dtype, n_pad=2048, count=1950, d=48):
    m = _pad(_normed(rng, count, d), n_pad, 128)
    q = _pad(_bf16_round(_normed(rng, 8, d)), 8, 128)
    return m, q, count


def test_constants_match_jax():
    assert topk._PALLAS_MAX_INTERVALS == jtopk._PALLAS_MAX_INTERVALS


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("n", [1, 2048, 5000])
def test_intervals_to_rowmask_matches_jax(name, n):
    table = np.asarray(TABLES[name], dtype=np.int32)
    want = np.asarray(jtopk.intervals_to_rowmask(n, jnp.asarray(table)))
    got = topk.intervals_to_rowmask(n, torch.from_numpy(table))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape == (1, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["one", "unsorted_overlapping", "padded", "eight", "nine", "past_count", "thirty_two"])
@pytest.mark.parametrize("k", [1, 10, 32, 50])
def test_topk_program_intervals_matches_jax(rng, dtype, name, k):
    m, q, count = _case(rng, dtype)
    table = np.asarray(TABLES[name], dtype=np.int32)
    jemb, temb = _stores(m, dtype)
    jv, ji = jtopk.topk_program_intervals(
        jemb, jnp.asarray(q), jnp.int32(count), jnp.asarray(table), k, use_pallas=False
    )
    tv, ti = topk.topk_program_intervals(temb, torch.from_numpy(q), count, torch.from_numpy(table), k)
    assert tuple(tv.shape) == tuple(jv.shape)
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL if dtype == "float32" else BF16_TOL)
    in_scope = topk.intervals_to_rowmask(m.shape[0], torch.from_numpy(table))[0]
    picked = ti[tv >= 0].long()
    assert bool((in_scope[picked] > 0).all()) and bool((picked < count).all())
    assert bool((ti[tv < 0] == -1).all())  # the port's invalid slots


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("density", [0.0, 0.003, 0.3, 1.0])
@pytest.mark.parametrize("k", [1, 10, 32, 50])
def test_topk_program_masked_matches_jax(rng, dtype, density, k):
    m, q, count = _case(rng, dtype)
    mask = (rng.random(m.shape[0]) < density).astype(np.int32)
    jemb, temb = _stores(m, dtype)
    jv, ji = jtopk.topk_program_masked(
        jemb, jnp.asarray(q), jnp.int32(count), jnp.asarray(mask), k, use_pallas=False
    )
    tv, ti = topk.topk_program_masked(temb, torch.from_numpy(q), count, torch.from_numpy(mask), k)
    assert_topk_equivalent(tv, ti, jv, ji, F32_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_array_equal(ti.numpy()[tv.numpy() < 0], -1)


def test_masked_plain_reads_mask_as_jax_does(rng):
    """Only entries > 0 are searchable (a negative entry is not)."""
    m, q, count = _case(rng, "float32")
    mask = np.zeros(m.shape[0], np.int32)
    mask[[5, 6, 7]] = [1, -1, 2]
    tv, ti = topk.topk_program_masked(torch.from_numpy(m), torch.from_numpy(q), count, torch.from_numpy(mask), 3)
    assert set(ti[0][tv[0] >= 0].tolist()) == {5, 7}


def test_routes_by_table_size(rng, monkeypatch):
    """<= 8 intervals reach K4's wrapper; more expand to a mask for K5's;
    k > 32 materializes."""
    m, q, count = _case(rng, "float32")
    emb, qt = torch.from_numpy(m), torch.from_numpy(q)
    calls = []
    for name in ("fused_topk_iv", "fused_topk_masked"):
        real = getattr(topk, name)
        monkeypatch.setattr(topk, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    topk.topk_program_intervals(emb, qt, count, torch.tensor(TABLES["eight"], dtype=torch.int32), 10)
    topk.topk_program_intervals(emb, qt, count, torch.tensor(TABLES["nine"], dtype=torch.int32), 10)
    assert calls == ["fused_topk_iv", "fused_topk_masked"]
    before = topk.MATERIALIZED_CALLS.count
    topk.topk_program_intervals(emb, qt, count, torch.tensor(TABLES["one"], dtype=torch.int32), 33)
    assert topk.MATERIALIZED_CALLS.count == before + 1 and len(calls) == 2


def test_ties_go_to_the_lowest_row_across_interval_edges(rng):
    m, _, count = _case(rng, "float32")
    dupes = [99, 100, 640, 641, 1300]
    m[dupes] = m[99]
    q = m[99:100].copy()
    q = np.concatenate([q, np.zeros((7, 128), np.float32)])
    table = torch.tensor([[100, 641], [1300, 1301], [0, 50]], dtype=torch.int32)
    vals, idx = topk.topk_iv_plain(torch.from_numpy(m), torch.from_numpy(q), count, table, 3)
    assert idx[0].tolist() == [100, 640, 1300]
    vals, idx = topk.topk_masked_plain(
        torch.from_numpy(m), torch.from_numpy(q), count,
        topk.intervals_to_rowmask(m.shape[0], table), 2,
    )
    assert idx[0].tolist() == [100, 640]


def _listed_walk(emb, q, count, tiles, n_tiles, in_scope, k, splits):
    """The listed scans' walk (K4, K5) in plain torch: CTA ``s`` of
    ``splits`` scores only the rows of its share of the tile list
    (``scope_share``), offers rows past the count or out of scope as -3,
    keeps its top-k with ties at the lowest row, and the merge folds the
    CTAs' lists in split order (a stable sort), as ``csrc/topk.cu`` does."""
    n = int(n_tiles.item())
    parts_v, parts_i = [], []
    for s in range(splits):
        first, last = topk.scope_share(n, splits, s)
        rows = (tiles[first:last, None].long() * 128 + torch.arange(128)).reshape(-1)
        raw = q.to(emb.dtype).float() @ emb[rows].float().T
        raw = torch.where(((rows < count) & in_scope[rows])[None, :], raw, -3.0)
        v, p = topk._select_topk(raw, min(k, rows.shape[0]))
        parts_v.append(v)
        parts_i.append(rows[p])
    vals = torch.cat(parts_v + [torch.full((q.shape[0], k), -3.0)], dim=1)
    idx = torch.cat(parts_i + [torch.full((q.shape[0], k), -1)], dim=1)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices[:, :k]
    return topk._raw_to_score(vals.gather(1, order), idx.gather(1, order))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["intervals", "mask"])
@pytest.mark.parametrize("splits", [1, 3, 16])
def test_listed_walk_matches_jax_with_duplicates_in_skipped_tiles(rng, dtype, route, splits):
    """Duplicates of query 0's row sit in listed tiles (in and out of the
    scope) and in tiles the list skips. The JAX routes, the port's routes
    and a walk over the listed tiles alone (K4's list from the table, K5's
    from the row mask) agree, and query 0's top-k holds the in-scope
    duplicates in ascending rows."""
    m, q, count = _case(rng, dtype)
    table = np.asarray([[130, 200], [640, 900], [1800, 1900], [0, 0]], dtype=np.int32)
    # Tiles 1, 5-7 and 14 are listed. Duplicates in skipped tiles: 5 (tile
    # 0), 400 (3), 1300 (10), 1949 (15); in a listed tile out of scope: 250
    # (1); past the count: 1960.
    dupes = [5, 140, 199, 250, 400, 640, 899, 1300, 1850, 1949, 1960]
    m[dupes] = m[dupes[0]]
    if dtype == "bfloat16":
        m = _bf16_round(m)
    q[0] = m[dupes[0]]
    jemb, temb = _stores(m, dtype)
    tq, ttable = torch.from_numpy(q), torch.from_numpy(table)
    mask = topk.intervals_to_rowmask(m.shape[0], ttable)[0]
    if route == "intervals":
        jv, ji = jtopk.topk_program_intervals(
            jemb, jnp.asarray(q), jnp.int32(count), jnp.asarray(table), 10, use_pallas=False)
        tv, ti = topk.topk_program_intervals(temb, tq, count, ttable, 10)
        tiles, n_tiles = topk.interval_tiles(ttable, count, m.shape[0])
    else:
        jv, ji = jtopk.topk_program_masked(
            jemb, jnp.asarray(q), jnp.int32(count), jnp.asarray(mask.numpy()), 10, use_pallas=False)
        tv, ti = topk.topk_program_masked(temb, tq, count, mask, 10)
        tiles, n_tiles = topk.scope_tiles(mask, count)
    assert tiles[: n_tiles.item()].tolist() == [1, 5, 6, 7, 14]
    wv, wi = _listed_walk(temb, tq, count, tiles, n_tiles, mask > 0, 10, splits)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert_topk_equivalent(tv, ti, jv, ji, tol)
    assert_topk_equivalent(wv, wi, jv, ji, tol)
    want = [140, 199, 640, 899, 1850]
    assert ti[0, :5].tolist() == want and wi[0, :5].tolist() == want


def test_count_watermark_inside_an_interval(rng):
    m, q, _ = _case(rng, "float32")
    table = torch.tensor([[1000, 1100]], dtype=torch.int32)
    vals, idx = topk.topk_iv_plain(torch.from_numpy(m), torch.from_numpy(q), 1040, table, 50)
    live = idx[vals > -2]
    assert bool(((live >= 1000) & (live < 1040)).all())
    assert bool(((vals > -2).sum(1) == 40).all())  # 40 live rows, 10 unfilled
    assert bool((idx[vals <= -2] == -1).all())


@pytest.mark.parametrize("plain", ["topk_plain", "topk_iv_plain", "topk_masked_plain"])
def test_chunked_plain_equals_one_piece(rng, monkeypatch, plain):
    """The plain versions score rows in chunks; chunk boundaries change
    nothing, ties across them included."""
    m, q, count = _case(rng, "float32")
    m[[255, 256, 511, 1024]] = m[255]
    q[0, :] = m[255]
    emb, qt = torch.from_numpy(m), torch.from_numpy(q)
    extra = {
        "topk_plain": (),
        "topk_iv_plain": (torch.tensor(TABLES["unsorted_overlapping"] + [[250, 1100]], dtype=torch.int32),),
        "topk_masked_plain": (torch.from_numpy((rng.random(2048) < 0.5).astype(np.int32) | (np.arange(2048) % 256 < 2)),),
    }[plain]
    fn = getattr(topk, plain)
    whole = fn(emb, qt, count, *extra, 20)
    monkeypatch.setattr(topk, "_PLAIN_TOPK_CHUNK", 256)
    chunked = fn(emb, qt, count, *extra, 20)
    np.testing.assert_array_equal(chunked[0].numpy(), whole[0].numpy())
    np.testing.assert_array_equal(chunked[1].numpy(), whole[1].numpy())
