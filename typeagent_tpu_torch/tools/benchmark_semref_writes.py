"""Semantic-ref insert throughput benchmark.

(Parity role: reference tools/benchmark_semref_writes.py.) Measures bulk
semref + term-posting writes against both storage backends and the native
interner path.

The port of ``typeagent_tpu/tools/benchmark_semref_writes.py``; the
settings' embedding indexes live on ``--device`` (the card unless ``cpu``
is named).
Run: ``python -m typeagent_tpu_torch.tools.benchmark_semref_writes``.
"""

from __future__ import annotations

import argparse
import asyncio
import time

from ..knowpro import kplib
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import SemanticRef, TextLocation, TextRange
from ..knowpro.universal_message import ConversationMessage
from ..models.adapters import create_test_embedding_model
from ..native import create_interner
from ..storage.utils import create_storage_provider
from . import add_device_argument

WORDS = "alpha bravo charlie delta echo foxtrot golf hotel india juliet".split()


def make_refs(n: int) -> tuple[list[SemanticRef], list[tuple[str, int]]]:
    refs = []
    terms = []
    for i in range(n):
        entity = kplib.ConcreteEntity(
            f"{WORDS[i % len(WORDS)]}-{i % 997}", ["thing", WORDS[(i + 3) % len(WORDS)]]
        )
        refs.append(SemanticRef(i, TextRange(TextLocation(i % 1000, 0)), entity))
        terms.append((entity.name, i))
        for t in entity.type:
            terms.append((t, i))
    return refs, terms


async def bench_backend(backend: str, n: int, device: str = "cuda") -> None:
    settings = ConversationSettings(model=create_test_embedding_model(8), device=device)
    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        ":memory:" if backend == "sqlite" else None,
        ConversationMessage,
    )
    refs, terms = make_refs(n)
    t0 = time.perf_counter()
    async with provider:
        await provider.semantic_refs.extend(refs)
        await provider.semantic_ref_index.add_terms_batch(terms)
    dt = time.perf_counter() - t0
    print(
        f"{backend:>7}: {n} semrefs + {len(terms)} terms in {dt * 1000:.1f} ms "
        f"({n / dt:.0f} semrefs/s)"
    )


def bench_native(n: int) -> None:
    refs, terms = make_refs(n)
    interner = create_interner()
    t0 = time.perf_counter()
    ids = interner.intern_batch([t for t, _ in terms])
    import numpy as np

    interner.add_postings_batch(
        ids,
        np.array([s for _, s in terms], dtype=np.int32),
        np.ones(len(terms), dtype=np.float32),
    )
    offsets, semrefs, scores = interner.build_csr()
    dt = time.perf_counter() - t0
    print(
        f"{'native':>7}: {len(terms)} term postings -> CSR in {dt * 1000:.1f} ms "
        f"({type(interner).__name__}, {len(interner)} unique terms)"
    )


def main() -> None:
    parser = argparse.ArgumentParser(description="Semref write throughput")
    parser.add_argument("--count", type=int, default=10_000)
    add_device_argument(parser)
    args = parser.parse_args()
    asyncio.run(bench_backend("memory", args.count, args.device))
    asyncio.run(bench_backend("sqlite", args.count, args.device))
    bench_native(args.count)


if __name__ == "__main__":
    main()
