"""The int8 store's plain reference (``reference_int8.py``) against the
port's int8 ``CorpusVectorStore`` on its CPU path: 8 conversations of 512
seed-made rows, 768 wide, k 10, searched over every row and scoped to a
range of conversations. The program's answers pass; the fp8 control and
three planted faults do not."""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from portbench import check, generate, reference_int8, run
from portbench.reference import to_score
from portbench.system import CorpusSystem
from portbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 4242
K = 10
CFG = {
    "system": "corpus_store", "rows": 4096, "dim": 768, "dtype": "int8", "search_mode": "exact",
    "topics": 64, "sigma": 0.35, "background": 0.02, "block_rows": 1024,
    "layout": {"conversation_rows": 512}, "reference": "reference_int8",
}
# The limits the int8 configuration takes (PERF.md section 7, item 1).
LIMITS = {"score_err": 2e-5, "rank_gap": 2e-5, "bad_hits": 0}
SCOPES = {"unscoped": None, "scoped": (2, 6)}


def _blocks():
    return generate.even_blocks(CFG["rows"], CFG["block_rows"])


def _reference(system, queries, items, scope, control=False):
    sc = None
    if scope is not None:
        m = queries.shape[0]
        sc = reference_int8.Scope(torch.full((m,), scope[0]), torch.full((m,), scope[1]))
    ref = reference_int8.Reference(torch.from_numpy(queries), K, items, sc, control=control)
    for b in _blocks():
        ref.add_block(b.start, generate.rows_block(CFG, system.centers, SEED, b),
                      generate.row_conversations(system.layout, b.start, b.stop, CPU))
    return ref


def _f32_answers(system, queries, scope):
    """Exact top-k over the f32 unit rows, the codes ignored."""
    rows = torch.cat([generate.rows_block(CFG, system.centers, SEED, b) for b in _blocks()])
    score = to_score(torch.from_numpy(queries) @ rows.T)
    if scope is not None:
        conv = generate.row_conversations(system.layout, 0, CFG["rows"], CPU)
        score = score.masked_fill(~((conv >= scope[0]) & (conv < scope[1]))[None, :], -float("inf"))
    v, i = score.topk(K, dim=1)
    return i.numpy(), v.double().numpy()


@pytest.fixture(scope="module")
def corpus():
    system = CorpusSystem(CFG, SEED, CPU)
    rng = generate.host_rng(SEED, generate.STREAM_TRAFFIC)
    queries = generate.queries_near(system.centers, rng.integers(0, CFG["topics"], 24),
                                    CFG["sigma"], SEED, 0)
    answers, bf16 = {}, {}
    for name, scope in SCOPES.items():
        answers[name] = system.hits(system.search(queries, K, 0.0, scope), K)
    scales = system.store._store.shard_scales()[0]
    kept = scales.clone()
    scales.copy_(scales.bfloat16().float())
    for name, scope in SCOPES.items():
        bf16[name] = system.hits(system.search(queries, K, 0.0, scope), K)
    scales.copy_(kept)
    return system, queries, answers, bf16


def test_the_store_keeps_the_codes_and_scales_the_reference_works_out(corpus):
    system = corpus[0]
    store = system.store._store
    codes_held = store.buf[: CFG["rows"], : CFG["dim"]]
    scales_held = store._scales[: CFG["rows"]]
    for b in _blocks():
        codes, scales = reference_int8.quantize(generate.rows_block(CFG, system.centers, SEED, b))
        assert torch.equal(codes, codes_held[b.start : b.stop].float())
        assert torch.equal(scales, scales_held[b.start : b.stop])


def _numbers(corpus, case, scope_name):
    system, queries, answers, bf16 = corpus
    scope = SCOPES[scope_name]
    prog = answers[scope_name]
    items, scores = prog["items"].copy(), prog["scores"].copy()
    resolved = None
    if case == "f32_answers":
        items, scores = _f32_answers(system, queries, scope)
    elif case == "bf16_scales":
        items, scores = bf16[scope_name]["items"], bf16[scope_name]["scores"]
    elif case == "row_outside_scope":
        # Query 0's last hit replaced by a row the scope does not hold, with
        # that row's own reference score: only the scope can tell.
        outside = 0 if scope is not None else CFG["rows"]
        items[0, -1] = outside
        if scope is not None:
            ref = _reference(system, queries, items, None)
            scores[0, -1] = ref.result().item_ref[0, -1]
    ref = _reference(system, queries, items, scope, control=case == "control")
    if case == "control":
        c = ref.control_result()
        return check.judge(c, c.items, c.scores)
    if case == "program":
        seg = np.asarray(system.layout.segments, dtype=np.int64)
        conv, local = reference_int8.resolve(seg, items)
        resolved = (conv == prog["conv"]) & (local == prog["local"])
    return check.judge(ref.result(), items, scores, resolved)


@pytest.mark.parametrize("scope_name", sorted(SCOPES))
def test_the_program_passes(corpus, scope_name):
    n = _numbers(corpus, "program", scope_name)
    ok, table = check.verdict(n, LIMITS)
    assert ok, table
    assert n["bad_hits"] == 0


@pytest.mark.parametrize("scope_name", sorted(SCOPES))
@pytest.mark.parametrize("case", ["control", "f32_answers", "bf16_scales", "row_outside_scope"])
def test_the_control_and_each_fault_fail(corpus, case, scope_name):
    n = _numbers(corpus, case, scope_name)
    ok, table = check.verdict(n, LIMITS)
    assert not ok, table
    if case == "row_outside_scope":
        assert n["detail"]["out_of_scope"] == 1


def test_the_fp8_control_rounds_each_query_to_three_mantissa_bits():
    q = torch.tensor([[0.5, -0.3, 0.01, 0.0], [1e-3, 2e-3, -4e-3, 3e-3]])
    r = reference_int8.round_fp8(q)
    assert torch.equal(r.abs().amax(dim=1), q.abs().amax(dim=1))  # the largest lands on 448
    assert torch.allclose(r, q, rtol=2**-4, atol=0) and not torch.equal(r, q)


def _int8_tiny_cell(name: str):
    cell = tiny_cell(name)
    cell.cfg.update(dtype="int8", reference="reference_int8", check=dict(LIMITS))
    return cell


@pytest.mark.parametrize("name", ["cohere768-10m.unfiltered", "cohere768-10m.filter1p"])
def test_a_run_of_an_int8_corpus_is_held_to_the_reference_its_configuration_names(name):
    out = asyncio.run(run.run_cell(_int8_tiny_cell(name), SEED, 2.0, False, CPU, control=True))
    assert out["result"]["correct"] is True, out["result"]["check"]
    ok, _ = check.verdict(out["control"], LIMITS)
    assert not ok


def test_the_f32_reference_would_refuse_the_int8_store_at_the_f32_limits():
    cell = _int8_tiny_cell("cohere768-10m.unfiltered")
    del cell.cfg["reference"]
    cell.cfg["check"] = tiny_cell("cohere768-10m.unfiltered").cfg["check"]
    out = asyncio.run(run.run_cell(cell, SEED, 2.0, False, CPU))
    assert out["result"]["correct"] is False
    assert out["result"]["check"]["score_err"]["value"] > 10 * cell.cfg["check"]["score_err"]
