"""The cells of the 100M int8 configuration (``configs/cohere768-100m-int8.json``)
on the CPU: the configuration against the 10M one it derives from, a tiny
run of each cell held to the reference it names with the fp8 control on,
and the readers of its per-layer metrics on hand-made contexts."""

from __future__ import annotations

import asyncio
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from portbench import check, run
from portbench.roofline import counts
from portbench.tests.tiny import load, tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 5353
CELLS = ["cohere768-100m-int8.unfiltered", "cohere768-100m-int8.filter1p"]
LIMITS = {"score_err": 2e-5, "rank_gap": 2e-5, "bad_hits": 0}


def test_the_int8_configuration_is_the_10m_one_at_100m_rows_as_int8():
    int8 = load("portbench/configs/cohere768-100m-int8.json")
    f32 = load("portbench/configs/cohere768-10m.json")
    changed = {"rows", "dtype", "reference", "source", "deployment", "assumed", "check"}
    assert {k for k in set(int8) | set(f32) if int8.get(k) != f32.get(k)} == changed
    assert (int8["rows"], int8["dtype"], int8["reference"]) == (100_000_000, "int8", "reference_int8")
    assert int8["check"] == LIMITS and int8["reduced"] == []


@pytest.mark.parametrize("name", CELLS)
def test_a_run_of_an_int8_corpus_is_held_to_the_reference_its_configuration_names(name):
    out = asyncio.run(run.run_cell(tiny_cell(name), SEED, 2.0, False, CPU, control=True))
    assert out["result"]["correct"] is True, out["result"]["check"]
    ok, _ = check.verdict(out["control"], LIMITS)
    assert not ok


def test_a_traced_run_of_the_scoped_cell_reads_the_row_mask_per_search():
    cell = tiny_cell("cohere768-100m-int8.filter1p")
    r = asyncio.run(run.run_cell(cell, SEED, 1.0, True, CPU))["result"]
    assert r["correct"] is True
    assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    # 40,000 rows reserved: one mask over the capacity, 40,960 rows, a search.
    assert r["metrics"]["corpus.rowmask_rows_per_search.int8_filter1p"]["value"] == 40_960
    assert r["metrics"]["corpus.host_ms_per_search.int8_filter1p"]["value"] > 0


def _read(name: str, counters: dict[str, float]):
    return run.read_metric(name, NS(counters=counters))


def test_corpus_rowmask_rows_per_search():
    name = "corpus.rowmask_rows_per_search.int8_filter1p"
    assert run.reader_path(name).endswith("corpus.rowmask_rows_per_search.py")
    counters = {"corpus.rowmask_rows": 750 * 100_000_768.0, "corpus.searches": 750.0}
    assert _read(name, counters) == pytest.approx(100_000_768.0)
    assert _read(name, {"corpus.rowmask_rows": 0.0, "corpus.searches": 0.0}) is None
    # An older program, or an f32 corpus: no such counter.
    assert _read(name, {"corpus.host_s": 0.75, "corpus.searches": 750.0}) is None


def _int8_ctx(events):
    """A stretch of one-query searches of the 100M int8 corpus, scoped to
    the conversations [200, 20000) and not, with the given launches."""
    one = np.zeros((1, 768), np.float32)
    rows = {None: 100_000_000, (200, 20_000): 99_000_000}
    reqs = [NS(queries=one, scope=(200, 20_000)), NS(queries=one, scope=None)]
    return NS(trace=NS(events=events), stretch_requests=reqs, scope_rows=lambda s: rows[s],
              cell=NS(cfg={"dim": 768, "rows": 100_000_000}, mix={"k": 10}))


@pytest.mark.parametrize("label,rows,mask", [("K6", 100_000_000, False), ("K7", 99_000_000, True)])
def test_k6_and_k7_roofline_read_the_share_scan_int8_predicts(label, rows, mask):
    bound = counts.scan_int8(1, rows, 768, 10, mask=mask).bound_s(counts.peaks())
    # Two launches of the kernel at 2.5 times its bound, the merge beside them.
    events = [NS(label=label, dur_ns=int(2.5 * bound * 1e9)), NS(label="merge", dur_ns=10**5),
              NS(label=label, dur_ns=int(2.5 * bound * 1e9))]
    name = label.lower() + "_roofline"
    assert run.read_metric(name, _int8_ctx(events)) == pytest.approx(40.0, rel=1e-6)
    other = {"K6": "K7", "K7": "K6"}[label]
    assert run.read_metric(other.lower() + "_roofline", _int8_ctx(events)) is None
    assert run.read_metric(name, NS(trace=None)) is None


@pytest.mark.parametrize("label", ["K6", "K7"])
def test_an_int8_share_needs_a_request_of_its_kind(label):
    ctx = _int8_ctx([NS(label=label, dur_ns=10**7)])
    ctx.stretch_requests = [r for r in ctx.stretch_requests if (r.scope is None) == (label == "K7")]
    assert run.read_metric(label.lower() + "_roofline", ctx) is None
