"""Full 4-stage query() pipeline benchmark with a deterministic stage 1.

The kernel (bench.py) and the stage-3 engine (benchmark_engine) are
measured; this tool times the COMPLETE query path the way ``query()`` runs
it — stage 2 compile (searchlang), stage 3 execution (device engine or
host VM, incl. related-term resolution and the verb-scope fallback),
message matching, and stage 4 answer-context construction — with stage 1
replaced by deterministic SearchQuery objects injected through
``LanguageSearchDebugContext.use_search_query`` (the LLM translation is
network-bound and benchmarked nowhere: it would only hide the framework's
own costs). Stage 4 stops at the context (the answer LLM is likewise
network).

Reports end-to-end queries/sec plus a per-stage latency breakdown from the
metrics registry, and ``--profile`` writes a cProfile dump of the hot host
path.

The port of ``typeagent_tpu/tools/benchmark_pipeline.py``; the
conversation's indexes and the device engine run on ``--device`` (the
card unless ``cpu`` is named).
Run: ``python -m typeagent_tpu_torch.tools.benchmark_pipeline [--messages 2000]
[--queries 48] [--engine device|host|both] [--profile out.prof] [--device cpu]``
"""

from __future__ import annotations

import argparse
import asyncio
import json
from typing import TYPE_CHECKING
import random
import time

from ..knowpro import answers, searchlang
from ..knowpro.search_query_schema import (
    EntityTerm,
    SearchExpr,
    SearchFilter,
    SearchQuery,
)
from ..utils.metrics import MetricsRegistry

if TYPE_CHECKING:
    from ..knowpro.conversation_base import ConversationBase
from . import add_device_argument
from .benchmark_engine import VOCAB, build_conversation


def make_search_queries(n: int, rng: random.Random) -> list[SearchQuery]:
    """Deterministic stage-1 outputs shaped like real LLM translations:
    entity terms (name/type/facets), free search terms, and a rewritten
    query string for the message re-rank stage."""
    out = []
    for i in range(n):
        w1, w2, w3 = (rng.choice(VOCAB) for _ in range(3))
        filters = [
            SearchFilter(
                entity_search_terms=[
                    EntityTerm(name=w1, is_name_pronoun=False, type=["thing"]),
                    EntityTerm(name=f"{w2} {w3}", is_name_pronoun=False),
                ],
                search_terms=[w2],
            )
        ]
        if i % 3 == 0:
            filters.append(SearchFilter(search_terms=[w3, w1]))
        out.append(
            SearchQuery(
                search_expressions=[
                    SearchExpr(
                        rewritten_query=f"what about {w1} and {w2}?",
                        filters=filters,
                    )
                ]
            )
        )
    return out


def _make_options(use_device: bool) -> searchlang.LanguageSearchOptions:
    options = searchlang.LanguageSearchOptions(
        compile_options=searchlang.LanguageQueryCompileOptions(),
        exact_match=False,
        max_message_matches=25,
    )
    options.use_device_executor = use_device
    return options


async def _one_query(conv, sq, options, reg: MetricsRegistry) -> int:
    """Stages 2-4 for one deterministic stage-1 SearchQuery."""
    debug = searchlang.LanguageSearchDebugContext(use_search_query=sq)
    with reg.timer("stage2+3.search"):
        result = await searchlang.search_conversation_with_language(
            conv, None, sq.search_expressions[0].rewritten_query,
            options, debug_context=debug,
        )
    assert not isinstance(result, type(None))
    search_results = result.value
    contexts = 0
    with reg.timer("stage4.context"):
        for sr in search_results:
            ctx = await answers.make_context(sr, conv)
            contexts += len(ctx.entities) + len(ctx.topics) + len(ctx.messages)
    return contexts


async def run_pipeline(
    conv: "ConversationBase",
    queries: list[SearchQuery],
    use_device: bool,
    reg: MetricsRegistry,
) -> int:
    options = _make_options(use_device)
    contexts = 0
    for sq in queries:
        contexts += await _one_query(conv, sq, options, reg)
    return contexts


async def run_pipeline_concurrent(
    conv: "ConversationBase",
    queries: list[SearchQuery],
    use_device: bool,
    reg: MetricsRegistry,
    concurrency: int,
) -> int:
    """N worker tasks pull queries off a shared list (a loaded server):
    one query's host VM / answer-context work overlaps the others' device
    round trips, and the batched fuzzy lookups coalesce in the store's
    LookupBatcher. Results are identical to the sequential path."""
    options = _make_options(use_device)
    it = iter(queries)
    contexts = 0

    async def worker():
        nonlocal contexts
        while True:
            try:
                sq = next(it)
            except StopIteration:
                return
            got = await _one_query(conv, sq, options, reg)
            # `contexts += await ...` would read `contexts` BEFORE the
            # suspension point and lose concurrent workers' updates.
            contexts += got

    await asyncio.gather(*[worker() for _ in range(concurrency)])
    return contexts


async def amain() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--messages", type=int, default=2000)
    parser.add_argument("--queries", type=int, default=48)
    parser.add_argument(
        "--engine", choices=("device", "host", "both"), default="both"
    )
    parser.add_argument(
        "--concurrency",
        type=int,
        nargs="*",
        default=None,
        help="also run a concurrent ladder at these worker counts "
        "(e.g. --concurrency 4 16 64)",
    )
    parser.add_argument("--profile", help="write a cProfile dump here")
    parser.add_argument("--seed", type=int, default=11)
    add_device_argument(parser)
    args = parser.parse_args()

    rng = random.Random(args.seed)
    t0 = time.perf_counter()
    conv = await build_conversation(args.messages, rng, args.device)
    n_semrefs = await conv.semantic_refs.size()
    print(
        f"conversation: {args.messages} messages, {n_semrefs} semrefs "
        f"({time.perf_counter() - t0:.1f}s build)"
    )
    queries = make_search_queries(args.queries, rng)

    engines = (
        ["device", "host"] if args.engine == "both" else [args.engine]
    )
    for engine in engines:
        use_device = engine == "device"
        reg = MetricsRegistry()
        await run_pipeline(conv, queries[:4], use_device, reg)  # warm
        reg.latencies.clear()

        if args.profile and engine == engines[-1]:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
        t0 = time.perf_counter()
        await run_pipeline(conv, queries, use_device, reg)
        elapsed = time.perf_counter() - t0
        if args.profile and engine == engines[-1]:
            prof.disable()
            prof.dump_stats(args.profile)
            print(f"profile written to {args.profile}")
        qps = args.queries / elapsed
        print(
            f"[{engine}] full pipeline (stage 2-4, stage 1 deterministic): "
            f"{elapsed / args.queries * 1000:.2f} ms/query ({qps:.1f} QPS)"
        )
        print(json.dumps(reg.report()["latency"], indent=2))

        for conc in args.concurrency or []:
            creg = MetricsRegistry()
            t0 = time.perf_counter()
            await run_pipeline_concurrent(conv, queries, use_device, creg, conc)
            celapsed = time.perf_counter() - t0
            cqps = args.queries / celapsed
            print(
                f"[{engine}] concurrent x{conc}: {cqps:.1f} QPS "
                f"({cqps / qps:.1f}x sequential, "
                f"{celapsed / args.queries * 1000:.2f} ms/query amortized)"
            )


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
