"""The reference and the generator at tiny sizes on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, generate, reference
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")


def _store_cfg():
    return tiny_cell("ada1536-5m.messages64").cfg


def _corpus_cfg():
    return tiny_cell("cohere768-10m.filter1p").cfg


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_blocks_are_deterministic_per_seed_and_block(seed):
    cfg = _store_cfg()
    centers = generate.topic_centers(cfg["topics"], cfg["dim"], seed, CPU)
    blocks = generate.even_blocks(cfg["rows"], cfg["block_rows"])
    late_first = generate.rows_block(cfg, centers, seed, blocks[3])
    in_order = [generate.rows_block(cfg, centers, seed, b) for b in blocks]
    assert torch.equal(late_first, in_order[3])
    assert not torch.equal(in_order[0][: in_order[1].shape[0]], in_order[1])
    again = generate.topic_centers(cfg["topics"], cfg["dim"], seed, CPU)
    assert torch.equal(again, centers)
    norms = torch.linalg.vector_norm(in_order[2], dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-5)
    other = generate.rows_block(cfg, centers, seed + 1, blocks[3])
    assert not torch.equal(other, late_first)


@pytest.mark.parametrize("block_rows", [8000, 7000])
def test_corpus_layout_cuts_the_ids_into_conversations_appended_by_block(block_rows):
    cfg = dict(_corpus_cfg(), block_rows=block_rows)
    layout = generate.corpus_layout(cfg)
    per = cfg["layout"]["conversation_rows"]
    assert layout.n_conversations == cfg["rows"] // per and (layout.conv_rows == per).all()
    seg = np.asarray(layout.segments)
    assert seg[0, 1] == 0 and int(seg[:, 2].sum()) == cfg["rows"]
    assert np.array_equal(seg[1:, 1], seg[:-1, 1] + seg[:-1, 2])  # contiguous
    assert np.array_equal(seg[:, 0], seg[:, 1] // per) and np.array_equal(seg[:, 3], seg[:, 1] % per)
    ends = {b.stop for b in generate.even_blocks(cfg["rows"], block_rows)}
    # A conversation is one segment unless a block's end cuts it.
    assert len(seg) == layout.n_conversations + len(ends - set(range(0, cfg["rows"] + 1, per)))
    assert layout.conversations_from(39_600) == (99, 100)
    assert layout.conversations_from(400) == (1, 100) and layout.rows_in(1, 100) == 39_600
    with pytest.raises(ValueError):
        layout.conversations_from(401)
    conv = generate.row_conversations(layout, 7_900, 8_500, CPU).numpy()
    assert np.array_equal(conv, np.arange(7_900, 8_500) // per)


def test_resolve_matches_brute_force_membership():
    layout = generate.corpus_layout(dict(_corpus_cfg(), block_rows=7000))
    seg = np.asarray(layout.segments, dtype=np.int64)
    ordinals = np.array([-1, 0, 1, 399, 400, 6_999, 7_000, 20_000, 39_999, 40_000, 123_456])
    conv, local = reference.resolve(seg, ordinals)
    for g, c, l in zip(ordinals, conv, local):
        hit = [s for s in layout.segments if s[1] <= g < s[1] + s[2]]
        if not hit:
            assert (c, l) == (-1, -1)
        else:
            s = hit[0]
            assert (c, l) == (s[0], s[3] + g - s[1])


def _numpy_topk(q, rows, k, allowed=None):
    s = np.clip((q.astype(np.float64) @ rows.T.astype(np.float64) + 1) / 2, 0, 1)
    if allowed is not None:
        s = np.where(allowed, s, -np.inf)
    return -np.sort(-s, axis=1)[:, :k], s


@pytest.mark.parametrize("scoped", [False, True])
def test_reference_agrees_with_numpy_topk_on_the_same_blocks(scoped):
    cfg = _corpus_cfg()
    seed, k, m = 3, 10, 24
    layout = generate.corpus_layout(cfg)
    centers = generate.topic_centers(cfg["topics"], cfg["dim"], seed, CPU)
    blocks = generate.even_blocks(cfg["rows"], cfg["block_rows"])
    parts = [generate.rows_block(cfg, centers, seed, b) for b in blocks]
    rows = torch.cat(parts).numpy()
    conv = np.arange(cfg["rows"]) // cfg["layout"]["conversation_rows"]
    rng = np.random.default_rng(0)
    q = generate.queries_near(centers, rng.integers(0, cfg["topics"], m), cfg["sigma"], seed, 0)
    items = rng.integers(0, cfg["rows"], (m, k))
    items[0, :3] = -1
    scope = allowed = None
    if scoped:
        lo = rng.integers(0, layout.n_conversations, m)
        hi = np.minimum(lo + rng.integers(1, 30, m), layout.n_conversations)
        lo[::3], hi[::3] = 0, layout.n_conversations
        scope = reference.Scope(torch.from_numpy(lo), torch.from_numpy(hi))
        allowed = np.array([[lo[i] <= c < hi[i] for c in conv] for i in range(m)])
    ref = reference.Reference(torch.from_numpy(q), k, items, scope)
    for b, part in zip(blocks, parts):
        ref.add_block(b.start, part, generate.row_conversations(layout, b.start, b.stop, CPU))
    ans = ref.result()
    best, full = _numpy_topk(q, rows, k, allowed)
    assert np.allclose(ans.best, best, atol=2e-6)
    valid = items >= 0
    want = np.take_along_axis(full if allowed is None else np.clip((q @ rows.T + 1) / 2, 0, 1),
                              np.clip(items, 0, None), axis=1)
    assert np.allclose(ans.item_ref[valid], want[valid], atol=2e-6)
    assert np.isnan(ans.item_ref[~valid]).all()
    in_scope = np.ones_like(valid) if allowed is None else np.take_along_axis(allowed, np.clip(items, 0, None), 1)
    assert np.array_equal(ans.in_scope, valid & in_scope)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.14159, 0.0])
    r = reference.round_tf32(x)
    assert (r.view(torch.int32) & 0x1FFF == 0).all()
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10 and r[2] == 1.0 + 2**-10
    assert torch.allclose(r, x, rtol=2**-11)


def test_judge_counts_each_kind_of_bad_hit():
    best = np.array([[0.9, 0.8, 0.7], [0.95, 0.6, -np.inf]])
    ans = reference.Answers(
        best=best,
        item_ref=np.array([[0.9, 0.8, 0.7], [0.95, 0.6, np.nan]]),
        in_scope=np.array([[True, True, False], [True, True, False]]),
    )
    items = np.array([[1, 2, 3], [4, 4, -1]])
    scores = np.array([[0.9, 0.8000001, 0.7], [0.95, 0.6, np.nan]])
    n = check.judge(ans, items, scores)
    assert n["detail"] == {"missing": 1, "out_of_scope": 1, "repeated": 1,
                           "below_min_score": 0, "unresolved": 0}
    assert n["bad_hits"] == 3
    assert n["score_err"] == pytest.approx(1e-7, abs=1e-9)
    ok, table = check.verdict(n, {"score_err": 1e-6, "rank_gap": 1e-6, "bad_hits": 0})
    assert not ok and list(table) == ["score_err", "rank_gap", "bad_hits"]


def test_judge_cuts_expected_hits_at_min_score_with_a_margin():
    best = np.array([[0.9, 0.7000001, 0.69], [0.9, 0.8, 0.75]])
    ans = reference.Answers(best=best, item_ref=np.array([[0.9, np.nan, np.nan], [0.9, 0.8, 0.6]]),
                            in_scope=np.array([[True, False, False], [True, True, True]]))
    items = np.array([[1, -1, -1], [2, 3, 4]])
    scores = np.array([[0.9, np.nan, np.nan], [0.9, 0.8, 0.6]])
    # Row 0 may stop where the reference sits within the margin of the cut;
    # row 1's third hit lies below the cut.
    n = check.judge(ans, items, scores, min_score=0.7, margin=1e-6)
    assert n["detail"]["missing"] == 0 and n["detail"]["below_min_score"] == 1
    assert check.judge(ans, items, scores, min_score=0.7, margin=0.0)["detail"]["missing"] == 1
