"""A configuration names its plain reference: the hook in ``run.py``, and
the f32 configurations' check unchanged by it."""

from __future__ import annotations

import asyncio
import json
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import check, reference, reference_int8, run
from portbench.tests.tiny import CELLS, ROOT, tiny_cell

CPU = torch.device("cpu")
SEED = 2**31 + 311


def _root_with_reference(tmp_path, value) -> str:
    """A checkout whose ``cohere768-10m`` configuration names ``value`` as
    its reference."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench", "traffic"), tmp_path / "portbench" / "traffic")
    (tmp_path / "portbench" / "configs").mkdir()
    with open(os.path.join(ROOT, "portbench", "configs", "cohere768-10m.json")) as f:
        cfg = json.load(f)
    cfg["reference"] = value
    (tmp_path / "portbench" / "configs" / "cohere768-10m.json").write_text(json.dumps(cfg))
    for name in ("ada1536-5m.json",):
        shutil.copy(os.path.join(ROOT, "portbench", "configs", name), tmp_path / "portbench" / "configs")
    return str(tmp_path)


@pytest.mark.parametrize("value", ["no_such_reference", "reference.missing", "../reference", "run_"])
def test_an_unknown_reference_fails_in_load_cell_and_names_the_module(tmp_path, value):
    root = _root_with_reference(tmp_path, value)
    with pytest.raises(SystemExit) as err:
        run.load_cell("cohere768-10m.unfiltered", root)
    assert repr(value) in str(err.value)


def test_a_module_that_is_no_reference_is_refused(tmp_path):
    root = _root_with_reference(tmp_path, "traffic")
    with pytest.raises(SystemExit, match="lacks"):
        run.load_cell("cohere768-10m.unfiltered", root)


@pytest.mark.parametrize("value,module", [(None, reference), ("reference", reference),
                                          ("reference_int8", reference_int8)])
def test_the_key_selects_the_module_and_its_absence_selects_reference_py(tmp_path, value, module):
    if value is None:
        cell = run.load_cell("cohere768-10m.unfiltered")
        assert "reference" not in cell.cfg
    else:
        cell = run.load_cell("cohere768-10m.unfiltered", _root_with_reference(tmp_path, value))
    assert run.reference_module(cell.cfg) is module


class _ReferenceBeforeTheHook(reference.Reference):
    """``reference.Reference`` as it stood before the int8 reference shared
    its fold (``_merge``)."""

    def _add_chunk(self, start, rows, conv):
        n = rows.shape[0]
        score = reference.to_score(self.q @ rows.T)  # [m, n]
        allowed = self._allowed(conv)
        masked = score if allowed is None else score.masked_fill(~allowed, -float("inf"))
        kk = min(self.k, n)
        both = torch.cat([self.best, masked.topk(kk, dim=1).values], dim=1)
        self.best = both.topk(self.k, dim=1).values
        local = self.items - start
        hit = (local >= 0) & (local < n)
        safe = local.clamp(0, n - 1)
        self.item_ref = torch.where(hit, score.gather(1, safe), self.item_ref)
        if allowed is None:
            self.in_scope |= hit
        else:
            self.in_scope |= hit & allowed.gather(1, safe)
        if self.control:
            c = reference.to_score(self.q_tf32 @ reference.round_tf32(rows).T)
            if allowed is not None:
                c = c.masked_fill(~allowed, -float("inf"))
            v, pos = c.topk(kk, dim=1)
            vals = torch.cat([self.c_vals, v], dim=1)
            refs = torch.cat([self.c_ref, score.gather(1, pos)], dim=1)
            idx = torch.cat([self.c_idx, pos + start], dim=1)
            order = vals.topk(self.k, dim=1).indices
            self.c_vals, self.c_ref, self.c_idx = (
                vals.gather(1, order), refs.gather(1, order), idx.gather(1, order)
            )


def _hold_to_reference_before_the_hook(sample, system_hits, cfg, mix, seed, device,
                                       layout=None, control=False):
    """``run.hold_to_reference`` as it stood before a configuration could
    name its reference: ``reference.py``'s ``Reference`` always."""
    queries = np.concatenate([req.queries for req, _ in sample])
    answers = [system_hits(result) for _, result in sample]
    k = answers[0]["items"].shape[1]
    items = np.concatenate([a["items"] for a in answers])
    scores = np.concatenate([a["scores"] for a in answers])
    scope = None
    if layout is not None:
        whole = (0, layout.n_conversations)
        lo, hi = np.concatenate([
            np.tile(np.asarray(req.scope or whole)[:, None], req.queries.shape[0])
            for req, _ in sample
        ], axis=1)
        scope = reference.Scope(torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device))
    ref = _ReferenceBeforeTheHook(torch.from_numpy(queries).to(device), k, items, scope,
                                  control=control)
    for start, rows, conv in run.reference_blocks(cfg, seed, device, layout):
        ref.add_block(start, rows, conv)
        del rows
    resolved = None
    if layout is not None:
        seg = np.asarray(layout.segments, dtype=np.int64)
        conv, local = reference.resolve(seg, items)
        prog_conv = np.concatenate([a["conv"] for a in answers])
        prog_local = np.concatenate([a["local"] for a in answers])
        resolved = (conv == prog_conv) & (local == prog_local)
    cut = {"min_score": mix["min_score"], "margin": cfg["check"]["score_err"]}
    numbers = check.judge(ref.result(), items, scores, resolved, **cut)
    ctl = None
    if control:
        c = ref.control_result()
        ctl = check.judge(c, c.items, c.scores, **cut)
    return numbers, ctl, queries.shape[0]


@pytest.fixture
def _small_store_takes_the_hybrid_route(monkeypatch):
    from typeagent_tpu_torch import vectorstore

    monkeypatch.setattr(vectorstore, "EXACT2_MIN_ROWS", 2048)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_configuration_without_the_key_reads_the_numbers_the_old_code_gave(
    monkeypatch, _small_store_takes_the_hybrid_route, name
):
    """Every f32 cell's sample, judged by the hook and by the code before
    it, with the control on: the same numbers, bit for bit."""
    new = run.hold_to_reference
    seen = []

    def both(*args, **kwargs):
        out = new(*args, **kwargs)
        seen.append((out, _hold_to_reference_before_the_hook(*args, **kwargs)))
        return out

    monkeypatch.setattr(run, "hold_to_reference", both)
    cell = tiny_cell(name)
    assert "reference" not in cell.cfg
    asyncio.run(run.run_cell(cell, SEED, 2.0, False, CPU, control=True))
    assert len(seen) == 1
    (numbers, ctl, n), (old_numbers, old_ctl, old_n) = seen[0]
    assert n == old_n > 0
    assert numbers == old_numbers and ctl == old_ctl
