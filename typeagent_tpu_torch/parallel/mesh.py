"""Device meshes: a ``[n_dp, n_shard]`` grid of ``torch.device``s.

Axes, as in the JAX package (``typeagent_tpu/parallel/mesh.py``):

  * ``dp``    - data parallel over query batches: each dp rank holds a
                full replica of the rows and answers its slice of a batch;
  * ``shard`` - the fragment axis: the embedding rows are split into
                contiguous blocks, one per device of a dp rank.

One process drives every device of a mesh, as one JAX controller drives
its local devices; ``torch.distributed`` joins processes only in
``parallel/multislice.py``. A grid may name one device more than once
(``[cpu] * 8`` in the CPU tests, four shards on ``cuda:0`` on a machine
with one card): each cell still holds its own tensors, so the layout and
the answers are those of a mesh of distinct devices.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

AXIS_DP = "dp"
AXIS_SHARD = "shard"

__all__ = ["AXIS_DP", "AXIS_SHARD", "Mesh", "create_mesh", "default_mesh"]


def _resolve(device: str | torch.device) -> torch.device:
    """A concrete device: ``cuda`` gets the current card's index, and a
    card the machine does not have raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu")
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"mesh device {device} but no CUDA device is available; "
            "pass CPU devices to run the plain PyTorch versions"
        )
    index = torch.cuda.current_device() if device.index is None else device.index
    if not 0 <= index < torch.cuda.device_count():
        raise RuntimeError(f"mesh device cuda:{index}: this machine has {torch.cuda.device_count()} card(s)")
    return torch.device("cuda", index)


class Mesh:
    """A ``[n_dp, n_shard]`` grid of devices.

    ``devices`` is the grid as a numpy object array, ``shape`` maps each
    axis name to its size and ``axis_names`` is ``("dp", "shard")``, as on
    a ``jax.sharding.Mesh``.
    """

    axis_names = (AXIS_DP, AXIS_SHARD)

    def __init__(self, grid: Sequence[Sequence[str | torch.device]]) -> None:
        rows = [[_resolve(d) for d in row] for row in grid]
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.devices = np.empty((len(rows), len(rows[0])), dtype=object)
        for i, row in enumerate(rows):
            for s, device in enumerate(row):
                self.devices[i, s] = device
        types = {d.type for d in self.devices.flat}
        if len(types) != 1:
            raise ValueError(f"a mesh spans one device type, got {sorted(types)}")
        self.shape = {AXIS_DP: len(rows), AXIS_SHARD: len(rows[0])}

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        return list(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        grid = [[str(d) for d in row] for row in self.devices.tolist()]
        return f"Mesh(dp={self.shape[AXIS_DP]}, shard={self.shape[AXIS_SHARD]}, devices={grid})"


def create_mesh(
    n_shard: int | None = None, n_dp: int = 1, devices: list | None = None
) -> Mesh:
    """A (dp, shard) mesh over the first ``n_dp * n_shard`` of ``devices``
    (default: every card of the machine; the CPU only when the caller
    names it)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "create_mesh() defaults to the machine's cards and none is available; "
                "pass devices=[torch.device('cpu')] * n for a CPU mesh"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_dp < 1:
        raise ValueError(f"n_dp must be >= 1, got {n_dp}")
    if n_shard is None:
        n_shard = len(devices) // n_dp
    n = n_dp * n_shard
    if n_shard < 1 or n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh([devices[i * n_shard : (i + 1) * n_shard] for i in range(n_dp)])


def default_mesh() -> Mesh:
    """All of the machine's cards on the shard axis, dp = 1."""
    return create_mesh()


def single_device_mesh(device: str | torch.device) -> Mesh:
    """The mesh of one device: a store without a mesh is one shard there."""
    return Mesh([[device]])
