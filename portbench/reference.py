"""The plain reference: exact cosine top-k in f32, by blocks of rows.

Plain PyTorch, with TF32 switched off. It imports nothing of the program:
the rows come from the benchmark's generator (``generate.py``), block by
block as the program was fed them, and scopes and ordinals come from the
benchmark's own layout record. For each checked query it works out the
best ``k`` public scores ``clip((cos + 1) / 2, 0, 1)`` among the rows in
the query's scope, and the reference score of every row the program
returned, with whether that row is in scope (a range of conversations,
as a filter on ids keeps them).

With ``control=True`` it also computes, in the same pass, the answers of
the reference itself at TF32 (each operand rounded to a 10-bit mantissa,
then multiplied and summed in f32), the nearest precision below the
configuration's f32: the control that the comparison must refuse.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Rows per product: a [queries, CHUNK] f32 score matrix at a time.
CHUNK = 32_768


def exact_f32() -> None:
    """Products in full f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10-bit mantissa, half away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def to_score(raw: torch.Tensor) -> torch.Tensor:
    return ((raw + 1.0) * 0.5).clamp(0.0, 1.0)


@dataclass
class Scope:
    """Which rows each checked query may see: query ``i`` sees the rows of
    conversations ``[lo[i], hi[i])``, by the per-row conversations handed
    to :meth:`Reference.add_block`."""

    lo: torch.Tensor  # [m] int64
    hi: torch.Tensor  # [m] int64


@dataclass
class Answers:
    """Per checked query: the reference's best scores and, for a set of
    answers judged, each returned row's reference score and scope."""

    best: np.ndarray  # [m, k] descending; -inf past the rows in scope
    item_ref: np.ndarray  # [m, k] reference score of each returned row; nan if none
    in_scope: np.ndarray  # [m, k] bool
    items: np.ndarray | None = None  # the control's rows [m, k] (control only)
    scores: np.ndarray | None = None  # the control's own scores [m, k]


class Reference:
    """Feed blocks with :meth:`add_block`, then read :meth:`result`."""

    def __init__(
        self, queries: torch.Tensor, k: int, items: np.ndarray, scope: Scope | None = None,
        control: bool = False,
    ):
        exact_f32()
        self.q = queries.float().contiguous()
        self.k = k
        m = self.q.shape[0]
        dev = self.q.device
        self.items = torch.from_numpy(np.asarray(items, dtype=np.int64)).to(dev)  # [m, k], -1 none
        self.scope = scope
        self.best = torch.full((m, k), -float("inf"), device=dev)
        self.item_ref = torch.full(self.items.shape, float("nan"), device=dev)
        self.in_scope = torch.zeros(self.items.shape, dtype=torch.bool, device=dev)
        self.control = control
        if control:
            self.q_tf32 = round_tf32(self.q)
            self.c_vals = torch.full((m, k), -float("inf"), device=dev)
            self.c_ref = torch.full((m, k), -float("inf"), device=dev)
            self.c_idx = torch.full((m, k), -1, dtype=torch.int64, device=dev)

    def _allowed(self, conv: torch.Tensor | None) -> torch.Tensor | None:
        if self.scope is None:
            return None
        return (conv[None, :] >= self.scope.lo[:, None]) & (conv[None, :] < self.scope.hi[:, None])

    def add_block(self, start: int, rows: torch.Tensor, conv: torch.Tensor | None = None) -> None:
        """Rows ``[start, start + n)`` of the matrix (unit f32 ``[n, d]``),
        with each row's conversation where queries are scoped."""
        for lo in range(0, rows.shape[0], CHUNK):
            part = rows[lo : lo + CHUNK]
            self._add_chunk(start + lo, part, None if conv is None else conv[lo : lo + CHUNK])

    def _add_chunk(self, start: int, rows: torch.Tensor, conv: torch.Tensor | None) -> None:
        score = to_score(self.q @ rows.T)  # [m, n]
        control = to_score(self.q_tf32 @ round_tf32(rows).T) if self.control else None
        self._merge(start, score, control, self._allowed(conv))

    def _merge(self, start: int, score: torch.Tensor, control: torch.Tensor | None,
               allowed: torch.Tensor | None) -> None:
        """Fold the scores of rows ``[start, start + n)`` (``[m, n]``; the
        control's too, where it is on) into the running answers."""
        n = score.shape[1]
        masked = score if allowed is None else score.masked_fill(~allowed, -float("inf"))
        kk = min(self.k, n)
        both = torch.cat([self.best, masked.topk(kk, dim=1).values], dim=1)
        self.best = both.topk(self.k, dim=1).values
        # The judged rows that fall in this chunk.
        local = self.items - start
        hit = (local >= 0) & (local < n)
        safe = local.clamp(0, n - 1)
        self.item_ref = torch.where(hit, score.gather(1, safe), self.item_ref)
        if allowed is None:
            self.in_scope |= hit
        else:
            self.in_scope |= hit & allowed.gather(1, safe)
        if control is not None:
            if allowed is not None:
                control = control.masked_fill(~allowed, -float("inf"))
            v, pos = control.topk(kk, dim=1)
            vals = torch.cat([self.c_vals, v], dim=1)
            refs = torch.cat([self.c_ref, score.gather(1, pos)], dim=1)
            idx = torch.cat([self.c_idx, pos + start], dim=1)
            order = vals.topk(self.k, dim=1).indices
            self.c_vals, self.c_ref, self.c_idx = (
                vals.gather(1, order), refs.gather(1, order), idx.gather(1, order)
            )

    def result(self) -> Answers:
        return Answers(self.best.cpu().numpy(), self.item_ref.cpu().numpy(),
                       self.in_scope.cpu().numpy())

    def control_result(self) -> Answers:
        """The control's answers, judged as the program's are."""
        valid = torch.isfinite(self.c_vals)
        return Answers(
            self.best.cpu().numpy(),
            torch.where(valid, self.c_ref, float("nan")).cpu().numpy(),
            valid.cpu().numpy(),
            items=torch.where(valid, self.c_idx, -1).cpu().numpy(),
            scores=torch.where(valid, self.c_vals, float("nan")).cpu().numpy(),
        )


def resolve(segments: np.ndarray, ordinals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(conversation, local ordinal) of each global ordinal, from the
    layout's ``[S, 4]`` segments ``(conversation, start, count,
    local_base)`` in append order; -1 for an ordinal outside every segment."""
    seg = np.asarray(segments, dtype=np.int64).reshape(-1, 4)
    g = np.asarray(ordinals, dtype=np.int64)
    pos = np.searchsorted(seg[:, 1], g, side="right") - 1
    ok = (pos >= 0) & (g >= 0)
    pos = np.clip(pos, 0, None)
    ok &= g < seg[pos, 1] + seg[pos, 2]
    conv = np.where(ok, seg[pos, 0], -1)
    local = np.where(ok, seg[pos, 3] + g - seg[pos, 1], -1)
    return conv, local
