"""Vector store top-k microbenchmark.

(Parity role: reference tools/benchmark_vectorbase.py:130-163 — 1k/10k
vectors, dim 384, max_hits=10, min/mean/median/max per-call times.) Extended
with larger sizes and a batched-query mode showing the fused-kernel win.

The port of ``typeagent_tpu/tools/benchmark_vectorstore.py``; the store
lives on ``--device`` (the card unless ``cpu`` is named).
Run: ``python -m typeagent_tpu_torch.tools.benchmark_vectorstore``.
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np

from ..models.adapters import create_test_embedding_model
from ..vectorstore import TextEmbeddingIndexSettings, VectorStore
from . import add_device_argument


def run_benchmark(
    n_vectors: int,
    dim: int,
    max_hits: int,
    iterations: int,
    batch: int,
    device: str = "cuda",
) -> dict:
    rng = np.random.default_rng(42)
    matrix = rng.standard_normal((n_vectors, dim)).astype(np.float32)
    matrix /= np.linalg.norm(matrix, axis=1, keepdims=True)
    store = VectorStore(
        TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(dim), min_score=0.0, device=device
        )
    )
    store.add_embeddings(None, matrix)
    queries = rng.standard_normal((batch, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)

    # Warmup (compile)
    store.fuzzy_lookup_embeddings_batch(queries, max_hits=max_hits)

    times = []
    for _ in range(iterations):
        t0 = time.perf_counter()
        store.fuzzy_lookup_embeddings_batch(queries, max_hits=max_hits)
        times.append(time.perf_counter() - t0)

    per_query_us = [t / batch * 1e6 for t in times]
    return {
        "n_vectors": n_vectors,
        "dim": dim,
        "batch": batch,
        "max_hits": max_hits,
        "min_us": min(per_query_us),
        "mean_us": statistics.mean(per_query_us),
        "median_us": statistics.median(per_query_us),
        "max_us": max(per_query_us),
        "qps": batch * iterations / sum(times),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description="Vector store top-k microbenchmark")
    parser.add_argument(
        "--sizes", type=int, nargs="+", default=[1_000, 10_000, 100_000]
    )
    parser.add_argument("--dim", type=int, default=384)
    parser.add_argument("--max-hits", type=int, default=10)
    parser.add_argument("--iterations", type=int, default=20)
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 64])
    add_device_argument(parser)
    args = parser.parse_args()

    print(
        f"{'n':>10} {'batch':>6} {'min µs':>10} {'mean µs':>10} "
        f"{'median µs':>10} {'max µs':>10} {'QPS':>12}"
    )
    for n in args.sizes:
        for b in args.batch:
            r = run_benchmark(n, args.dim, args.max_hits, args.iterations, b, args.device)
            print(
                f"{r['n_vectors']:>10} {r['batch']:>6} {r['min_us']:>10.1f} "
                f"{r['mean_us']:>10.1f} {r['median_us']:>10.1f} "
                f"{r['max_us']:>10.1f} {r['qps']:>12.0f}"
            )


if __name__ == "__main__":
    main()
