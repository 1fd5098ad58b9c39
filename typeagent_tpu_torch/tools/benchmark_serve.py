"""Serving-path benchmark: the ladder a loaded server climbs.

Measures, on the card (or the CPU when ``--device cpu`` is named):

  sync       — one blocking lookup per batch (pays a full host<->device
               round trip each; what a naive server gets)
  pipelined  — LookupBatcher with coalescing off, 2 dispatches in flight
               (one batch's result download overlaps the next's upload)
  coalesced  — R waiting batches in ONE dispatch (fuzzy_lookup_embeddings_many)
  stream     — a sustained request stream through the batcher with BOTH
               levers on (coalesce x inflight); the steady-state number

The store is built ON DEVICE (no host detour for the matrix: a seeded
``torch.Generator`` there); wire format follows the store settings (f32
queries, cast to the store's dtype by the kernels, and ``--wire int8``
opts into the quarter-byte int8 wire).

The port of ``typeagent_tpu/tools/benchmark_serve.py``.
Run: ``python -m typeagent_tpu_torch.tools.benchmark_serve [--rows 1000000]
[--batch 256] [--dtype bfloat16] [--wire auto|int8] [--device cpu]``
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np

from . import add_device_argument


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=384)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--r", type=int, default=20, help="batches per coalesced dispatch")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--wire", default="auto", choices=["auto", "int8"])
    ap.add_argument("--coalesce", type=int, default=8)
    ap.add_argument("--inflight", type=int, default=3)
    add_device_argument(ap)
    args = ap.parse_args()

    import torch

    from ..models.adapters import create_test_embedding_model
    from ..serve import LookupBatcher
    from ..vectorstore import TextEmbeddingIndexSettings, VectorStore

    settings = TextEmbeddingIndexSettings(
        create_test_embedding_model(args.dim),
        min_score=0.0,
        dtype=args.dtype,
        query_wire=args.wire,
        device=args.device,
    )
    dev = settings.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({name})", flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def unit(t):
        return t / torch.linalg.norm(t, dim=-1, keepdim=True)

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = unit(torch.randn((args.rows, args.dim), generator=gen, device=dev))
    qs_dev = unit(torch.randn((args.r, args.batch, args.dim), generator=gen, device=dev))
    sync()
    print(f"on-device data gen: {time.perf_counter() - t0:.1f}s", flush=True)

    store = VectorStore(settings)
    store.load_device_rows(rows)
    del rows
    many_host = qs_dev.cpu().numpy()
    batch_host = many_host[0]
    n_stream = 3 * args.r

    def timed(fn, iters=3):
        fn()  # warm (trace/compile)
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    sync_s = timed(
        lambda: store.fuzzy_lookup_embeddings_batch(batch_host, max_hits=args.k),
        iters=5,
    )
    sync_qps = args.batch / sync_s
    print(
        f"sync:      {sync_s * 1000:7.2f} ms/batch-{args.batch}  "
        f"{sync_qps:8.0f} QPS  1.0x",
        flush=True,
    )

    def run_batcher(n_req, coalesce, inflight):
        async def run():
            b = LookupBatcher(
                store, max_delay_ms=0.0, max_coalesce=coalesce, max_inflight=inflight
            )
            sem = asyncio.Semaphore(24)

            async def one(i):
                async with sem:
                    return await b.lookup(
                        many_host[i % args.r], max_hits=args.k
                    )

            await asyncio.gather(*(one(i) for i in range(n_req)))
            await b.close()

        asyncio.run(run())

    pipe_s = timed(lambda: run_batcher(args.r, 1, 2)) / args.r
    print(
        f"pipelined: {pipe_s * 1000:7.2f} ms/batch-{args.batch}  "
        f"{args.batch / pipe_s:8.0f} QPS  {sync_s / pipe_s:.1f}x",
        flush=True,
    )

    coal_s = timed(
        lambda: store.fuzzy_lookup_embeddings_many(many_host, max_hits=args.k)
    ) / args.r
    print(
        f"coalesced: {coal_s * 1000:7.2f} ms/batch-{args.batch}  "
        f"{args.batch / coal_s:8.0f} QPS  {sync_s / coal_s:.1f}x",
        flush=True,
    )

    stream_s = timed(
        lambda: run_batcher(n_stream, args.coalesce, args.inflight)
    ) / n_stream
    print(
        f"stream:    {stream_s * 1000:7.2f} ms/batch-{args.batch}  "
        f"{args.batch / stream_s:8.0f} QPS  {sync_s / stream_s:.1f}x  "
        f"(coalesce {args.coalesce}, inflight {args.inflight})",
        flush=True,
    )


if __name__ == "__main__":
    main()
