"""Serving demo on the PyTorch port: coalesced lookups with LookupBatcher.

Simulates N concurrent clients hammering one VectorStore. The batcher
coalesces their requests into shared device dispatches: one host-to-card
round trip per BATCH of requests instead of one per request. The port of
``serving_demo.py``.

Run: ``python examples/torch_serving_demo.py [--device cpu]``
"""

import argparse
import asyncio
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.serve import LookupBatcher
from typeagent_tpu_torch.tools import add_device_argument
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

DIM = 64
N_ROWS = 50_000
CLIENTS = 24
REQUESTS_PER_CLIENT = 4


async def main(device: str) -> None:
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((N_ROWS, DIM)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)

    store = VectorStore(
        TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(DIM),
            min_score=0.0,
            dtype="bfloat16",
            device=device,
        )
    )
    store.add_embeddings(None, rows)
    store.fuzzy_lookup_embeddings_batch(rows[:1], max_hits=1)  # warm (kernel build)

    batcher = LookupBatcher(store, max_delay_ms=2.0, max_coalesce=16)

    async def client(cid: int):
        hits = []
        for r in range(REQUESTS_PER_CLIENT):
            want = (cid * 977 + r * 131) % N_ROWS
            q = rows[want : want + 1]
            res = await batcher.lookup(q, max_hits=3)
            assert res[0][0].item == want, (cid, r, res[0][0])
            hits.append(res[0][0])
            await asyncio.sleep(0)  # interleave clients
        return hits

    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in range(CLIENTS)))
    elapsed = time.perf_counter() - t0
    await batcher.close()

    total = CLIENTS * REQUESTS_PER_CLIENT
    print(
        f"{total} requests from {CLIENTS} clients in {elapsed * 1000:.0f} ms "
        f"over {batcher.dispatches} device dispatches "
        f"(coalescing {total / batcher.dispatches:.1f} requests/dispatch)"
    )
    assert batcher.dispatches < total, "no coalescing happened"
    print("every client got its exact self-match back — serving demo OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(parser)
    asyncio.run(main(parser.parse_args().device))
