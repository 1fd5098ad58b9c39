"""The row-sharded search across processes, on ``torch.distributed``.

Port of ``typeagent_tpu/parallel/multislice.py``. Within one process a
mesh's shards merge their winners on a dp rank's device
(``parallel/sharded.py``). Across processes, each process holds a
contiguous block of the global rows as the shards of its own local mesh,
answers every query over them with global ordinals, and the k winners of
every process are exchanged with one ``all_gather`` (gloo on the CPU,
NCCL on cards) and merged the same way, ties to the lowest global row.
Only the bootstrap (``init_process_group`` at ``tcp://coordinator``, with
the world size and rank given, since nothing on the machine announces a
cluster) and the final exchange differ from a one-process search.

``run_multislice_dryrun`` is the runnable proof: every process builds the
same seeded rows, keeps its block, searches, gathers, and checks the merged
answer against a numpy oracle. Run it as N processes::

    python -m typeagent_tpu_torch.parallel.multislice HOST:PORT N RANK [DEVICES_PER_PROCESS] [cuda|cpu]

The platform defaults to ``cuda``; ``cpu`` (gloo) runs only when named. On
``cuda`` each process takes its own cards (``RANK * DEVICES_PER_PROCESS``
on), so N processes need N * DEVICES_PER_PROCESS cards: NCCL does not let
two processes share one card.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from .mesh import create_mesh
from .sharded import ShardedVectorStore, _merge_shard_winners


def _local_mesh(platform: str, process_id: int, devices_per_process: int):
    if platform == "cpu":
        devices = [torch.device("cpu")] * devices_per_process
    else:
        first = process_id * devices_per_process
        devices = [torch.device("cuda", first + j) for j in range(devices_per_process)]
    n_dp = 2 if devices_per_process % 2 == 0 else 1
    return create_mesh(n_shard=devices_per_process // n_dp, n_dp=n_dp, devices=devices)


def run_multislice_dryrun(
    coordinator: str,
    num_processes: int,
    process_id: int,
    devices_per_process: int = 4,
    platform: str = "cuda",
    n_rows: int = 512,
    dim: int = 64,
    n_queries: int = 16,
    k: int = 5,
) -> None:
    """One process's share of the dry run; raises on a mismatch."""
    if platform not in ("cpu", "cuda"):
        raise ValueError(f"platform must be cpu or cuda, got {platform!r}")
    mesh = _local_mesh(platform, process_id, devices_per_process)
    home = mesh.devices[0, 0]
    if platform == "cuda":
        torch.cuda.set_device(home)
    dist.init_process_group(
        "gloo" if platform == "cpu" else "nccl",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
    )
    try:
        # The same seeded rows in every process; each keeps its block.
        rng = np.random.default_rng(0)
        rows = rng.standard_normal((n_rows, dim)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        queries = rows[:n_queries]
        per = -(-n_rows // num_processes)
        lo, hi = process_id * per, min(n_rows, (process_id + 1) * per)
        store = ShardedVectorStore(dim, mesh=mesh)
        store.append(rows[lo:hi])

        vals, idx, _b = store.search_dispatch(queries, k)
        idx = torch.where(idx >= 0, idx + lo, -1)
        gathered_v = [torch.empty_like(vals) for _ in range(num_processes)]
        gathered_i = [torch.empty_like(idx) for _ in range(num_processes)]
        dist.all_gather(gathered_v, vals)
        dist.all_gather(gathered_i, idx)
        merged_v, merged_i = _merge_shard_winners(
            torch.cat(gathered_v, dim=1), torch.cat(gathered_i, dim=1), k, 0.0
        )
        got_v = merged_v[:n_queries].cpu().numpy()
        got_i = merged_i[:n_queries].cpu().numpy()

        scores = np.clip((queries @ rows.T + 1) / 2, 0, 1)  # [n_queries, n_rows]
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        np.testing.assert_allclose(got_v, np.take_along_axis(scores, order, axis=1), atol=2e-5)
        for row_got, row_want in zip(got_i, order):
            assert set(row_got.tolist()) == set(row_want.tolist()), (row_got, row_want)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print(
        f"multislice dryrun OK: process {process_id}/{num_processes}, local "
        f"mesh(dp={mesh.shape['dp']}, shard={mesh.shape['shard']}) on {platform}, "
        f"{num_processes * mesh.shape['shard']} shards in all",
        flush=True,
    )


def main() -> None:
    coordinator, num, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    devices_per_process = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    platform = sys.argv[5] if len(sys.argv) > 5 else "cuda"
    run_multislice_dryrun(coordinator, num, pid, devices_per_process, platform)


if __name__ == "__main__":
    main()
