"""The port's int8 ``CorpusVectorStore`` held to the int8 store's plain
reference (``portbench/reference_int8.py``) through the benchmark's check
(``portbench/check.py``), at the limits of the 100M int8 configuration
(``portbench/configs/cohere768-100m-int8.json``).

8 conversations of 512 seed-made rows (``portbench/generate.py``), 768
wide, k 10, on the CPU path: searched over every row, over a contiguous
range of conversations, and over a scattered set of them. The program's
answers pass; the fp8 control, the f32 answers, scales rounded to bf16
and a row from outside the scope each fail.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import check, generate, reference_int8
from portbench.reference import to_score
from portbench.system import CorpusSystem

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 2**31 + 2323
K = 10
CFG = {
    "system": "corpus_store", "rows": 4096, "dim": 768, "dtype": "int8", "search_mode": "exact",
    "topics": 64, "sigma": 0.35, "background": 0.02, "block_rows": 1024,
    "layout": {"conversation_rows": 512}, "reference": "reference_int8",
}
# None: every row; a tuple: the conversations [lo, hi); a frozenset: those.
SCOPES = {"unscoped": None, "contiguous": (2, 6), "scattered": frozenset({1, 4, 6})}
FAULTS = ["control", "f32_answers", "bf16_scales", "row_outside_scope"]


def _limits() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "cohere768-100m-int8.json")) as f:
        return json.load(f)["check"]


def _blocks():
    return generate.even_blocks(CFG["rows"], CFG["block_rows"])


def _wanted(scope) -> list[int] | None:
    if scope is None:
        return None
    return list(range(*scope)) if isinstance(scope, tuple) else sorted(scope)


class _SetReference(reference_int8.Reference):
    """``reference_int8.Reference`` scoped to a set of conversations, which
    its ``Scope`` (a range per query) cannot name."""

    def __init__(self, queries, k, items, wanted: list[int], control: bool = False):
        super().__init__(queries, k, items, None, control)
        self.wanted = torch.tensor(wanted)

    def _allowed(self, conv):
        return torch.isin(conv, self.wanted)[None, :].expand(self.q.shape[0], -1)


def _reference(system, queries, items, scope, control=False):
    q = torch.from_numpy(queries)
    if isinstance(scope, frozenset):
        ref = _SetReference(q, K, items, _wanted(scope), control=control)
    else:
        sc = None
        if scope is not None:
            m = queries.shape[0]
            sc = reference_int8.Scope(torch.full((m,), scope[0]), torch.full((m,), scope[1]))
        ref = reference_int8.Reference(q, K, items, sc, control=control)
    for b in _blocks():
        ref.add_block(b.start, generate.rows_block(CFG, system.centers, SEED, b),
                      generate.row_conversations(system.layout, b.start, b.stop, CPU))
    return ref


def _search(system, queries, scope):
    wanted = _wanted(scope)
    names = None if wanted is None else [system.names[c] for c in wanted]
    return system.hits(system.store.search(queries, K, conversations=names, min_score=0.0), K)


def _f32_answers(system, queries, scope):
    """Exact top-k over the f32 unit rows, the codes ignored."""
    rows = torch.cat([generate.rows_block(CFG, system.centers, SEED, b) for b in _blocks()])
    score = to_score(torch.from_numpy(queries) @ rows.T)
    if scope is not None:
        conv = generate.row_conversations(system.layout, 0, CFG["rows"], CPU)
        inside = torch.isin(conv, torch.tensor(_wanted(scope)))
        score = score.masked_fill(~inside[None, :], -float("inf"))
    v, i = score.topk(K, dim=1)
    return i.numpy(), v.double().numpy()


@pytest.fixture(scope="module")
def corpus():
    system = CorpusSystem(CFG, SEED, CPU)
    rng = generate.host_rng(SEED, generate.STREAM_TRAFFIC)
    queries = generate.queries_near(system.centers, rng.integers(0, CFG["topics"], 24),
                                    CFG["sigma"], SEED, 0)
    answers = {name: _search(system, queries, scope) for name, scope in SCOPES.items()}
    scales = system.store._store.shard_scales()[0]
    kept = scales.clone()
    scales.copy_(scales.bfloat16().float())
    bf16 = {name: _search(system, queries, scope) for name, scope in SCOPES.items()}
    scales.copy_(kept)
    return system, queries, answers, bf16


def _numbers(corpus, case: str, scope_name: str) -> dict:
    system, queries, answers, bf16 = corpus
    scope = SCOPES[scope_name]
    prog = answers[scope_name]
    items, scores = prog["items"].copy(), prog["scores"].copy()
    if case == "f32_answers":
        items, scores = _f32_answers(system, queries, scope)
    elif case == "bf16_scales":
        items, scores = bf16[scope_name]["items"], bf16[scope_name]["scores"]
    elif case == "row_outside_scope":
        # Query 0's last hit replaced by row 0 (conversation 0, outside every
        # scope here) with its own reference score, or past the rows unscoped.
        items[0, -1] = 0 if scope is not None else CFG["rows"]
        if scope is not None:
            scores[0, -1] = _reference(system, queries, items, None).result().item_ref[0, -1]
    ref = _reference(system, queries, items, scope, control=case == "control")
    if case == "control":
        c = ref.control_result()
        return check.judge(c, c.items, c.scores)
    resolved = None
    if case == "program":
        seg = np.asarray(system.layout.segments, dtype=np.int64)
        conv, local = reference_int8.resolve(seg, items)
        resolved = (conv == prog["conv"]) & (local == prog["local"])
    return check.judge(ref.result(), items, scores, resolved)


@pytest.mark.parametrize("scope_name", list(SCOPES))
def test_the_int8_corpus_passes_the_check(corpus, scope_name):
    n = _numbers(corpus, "program", scope_name)
    ok, table = check.verdict(n, _limits())
    assert ok, table
    assert n["bad_hits"] == 0
    if SCOPES[scope_name] is not None:
        wanted = {corpus[0].names[c] for c in _wanted(SCOPES[scope_name])}
        conv = corpus[2][scope_name]["conv"]
        assert {corpus[0].names[c] for c in conv[conv >= 0]} <= wanted


@pytest.mark.parametrize("scope_name", list(SCOPES))
@pytest.mark.parametrize("case", FAULTS)
def test_the_control_and_each_fault_fail_the_check(corpus, case, scope_name):
    n = _numbers(corpus, case, scope_name)
    ok, table = check.verdict(n, _limits())
    assert not ok, table
    if case == "row_outside_scope":
        assert n["detail"]["out_of_scope"] == 1
