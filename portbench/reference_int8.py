"""The int8 store's plain reference: exact top-k over the codes an int8
``CorpusVectorStore`` holds, by blocks of rows.

Plain PyTorch in f32, with TF32 switched off (``reference.exact_f32``).
It imports nothing of the program: the rows come from the benchmark's
generator, as ``reference.py`` takes them, and this module works out
again what an int8 store keeps of them. The semantics it holds the
program to, each where the program documents it:

- every appended row is first made a unit row in f32,
  ``row / ||row||`` (``CorpusVectorStore.append_device``,
  ``typeagent_tpu_torch/parallel/corpus.py:115-124``);
- it is then quantized per row and symmetrically: ``scale = max|x| *
  f32(1/127)``, 1.0 for an all-zero row, and ``code = round(x / scale)``,
  half to even, clamped to +-127 (``quantize_rows_device``,
  ``typeagent_tpu_torch/ops/topk.py:1087-1101``; the store calls it on
  every append, ``parallel/sharded.py:357-367``);
- a query is made a unit row in f32 on the host
  (``CorpusVectorStore.search``, ``parallel/corpus.py:185-187``) and
  scored as bf16, since K6 and K7 take it so for k <= 32
  (``ops/topk.py:373-384``, ``:578-591`` and ``:609-626``;
  ``ROADMAP.md``'s known parity difference "Query rounding"):
  ``raw = (bf16(q) . codes) * scale`` and
  ``score = clip((raw + 1) / 2, 0, 1)`` (``ops/topk.py:190-195``);
- a query scoped to conversations sees their rows alone, as in
  ``reference.py``.

With ``control=True`` it also computes, in the same pass, the answers
one precision below: each query scaled by ``448 / max|q|``, cast to
``float8_e4m3fn`` and scaled back, against the same codes. That is the
cheaper tensor-core input a faster kernel could be tempted to take; the
comparison must refuse it.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import Scope, resolve, to_score
from portbench.reference import Reference as _F32Reference

# What the harness takes from a reference module; ``Scope`` and ``resolve``
# are ``reference.py``'s.
__all__ = ["Reference", "Scope", "resolve"]

INV_127 = float(np.float32(1.0 / 127.0))
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def quantize(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(codes [n, d] f32 holding whole numbers in [-127, 127], scales
    [n] f32)`` of the rows as an int8 store keeps them: each row made a
    unit row, then quantized per row."""
    rows = rows.float()
    norms = torch.linalg.vector_norm(rows, dim=1, keepdim=True)
    unit = rows / torch.where(norms > 0, norms, 1.0)
    scales = unit.abs().amax(dim=1) * INV_127
    scales = torch.where(scales > 0, scales, 1.0)
    codes = torch.round(unit / scales[:, None]).clamp(-127.0, 127.0)
    return codes, scales


def unit_queries(queries: torch.Tensor) -> torch.Tensor:
    """The queries made unit rows in f32 on the host, as the store's search
    does, back on their device."""
    q = queries.float().cpu().numpy()
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    q = q / np.where(norms > 0, norms, 1.0)
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(queries.device)


def round_fp8(q: torch.Tensor) -> torch.Tensor:
    """The control's queries: each scaled to the fp8 range, rounded to
    ``float8_e4m3fn`` and scaled back, in f32."""
    scale = FP8_MAX / q.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
    return (q * scale).to(torch.float8_e4m3fn).float() / scale


class Reference(_F32Reference):
    """Feed blocks with :meth:`add_block` (rows as generated, f32 ``[n,
    d]``; quantized here, ``CHUNK`` rows at a time), then read
    :meth:`result`: ``reference.Reference`` over the int8 store's codes."""

    def __init__(
        self, queries: torch.Tensor, k: int, items: np.ndarray, scope: Scope | None = None,
        control: bool = False,
    ):
        super().__init__(queries, k, items, scope, control)  # sets TF32 off
        unit = unit_queries(self.q)
        self.q = unit.to(torch.bfloat16).float()
        if control:
            self.q_fp8 = round_fp8(unit)

    def _add_chunk(self, start: int, rows: torch.Tensor, conv: torch.Tensor | None) -> None:
        codes, scales = quantize(rows)
        score = to_score((self.q @ codes.T) * scales[None, :])  # [m, n]
        control = to_score((self.q_fp8 @ codes.T) * scales[None, :]) if self.control else None
        self._merge(start, score, control, self._allowed(conv))
