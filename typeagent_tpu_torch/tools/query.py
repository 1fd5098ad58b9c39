"""Interactive + batch query CLI.

(Parity role: reference tools/query.py — REPL with @-commands, per-stage
debugging (@search no-LLM term search, @translate stage 1, @compile stages
1+2), conversation history for pronoun resolution, batch mode over a
questions file that also accepts @-commands.)
The port of ``typeagent_tpu/tools/query.py``. ``--device {cuda,cpu}``
names where the conversation's embedding indexes live, so the JAX CLI's
``--device`` switch (``@search`` through the device executor in
exact-match mode) is ``--device-executor`` here.
Run: ``python -m typeagent_tpu_torch.tools.query --database conv.db``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from dataclasses import dataclass, field

from ..knowpro import answers, searchlang
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import SearchTerm, SearchTermGroup, Term
from ..knowpro.search import SearchOptions, search_conversation
from ..knowpro.universal_message import ConversationMessage
from ..models.structured import PromptSection
from ..podcasts.podcast import Podcast
from ..storage.utils import create_storage_provider
from ..utils.metrics import METRICS
from ..utils.misc import load_dotenv
from . import add_device_argument


@dataclass
class HistoryEntry:
    question: str
    answer: str
    had_answer: bool


@dataclass
class ConversationHistory:
    """Recent Q&A pairs, fed to the query LLM to resolve pronouns."""

    entries: list[HistoryEntry] = field(default_factory=list)
    max_size: int = 5

    def add(self, question: str, answer: str, had_answer: bool) -> None:
        self.entries.append(HistoryEntry(question, answer, had_answer))
        del self.entries[: -self.max_size]

    def clear(self) -> None:
        self.entries.clear()

    def to_prompt_section(self) -> PromptSection | None:
        if not self.entries:
            return None
        lines = ["Recent conversation history (for resolving references):"]
        for e in self.entries:
            lines.append(f"Q: {e.question}")
            lines.append(f"A: {e.answer}")
        return PromptSection(role="system", content="\n".join(lines))


class QueryContext:
    def __init__(
        self, conversation: object, verbose: bool = False, device: bool = False
    ):
        self.conversation = conversation
        self.history = ConversationHistory()
        self.verbose = verbose
        self.device = device  # route flat term groups to the device executor


def settings_from_spec(
    embedding_model_spec: str | None, device: str = "cuda"
) -> ConversationSettings:
    if embedding_model_spec:
        from ..models.adapters import create_embedding_model

        return ConversationSettings(
            model=create_embedding_model(embedding_model_spec), device=device
        )
    return ConversationSettings(device=device)


async def load_conversation(args: argparse.Namespace) -> object:
    settings = settings_from_spec(
        getattr(args, "embedding_model", None), getattr(args, "device", "cuda")
    )
    if args.index_path:
        # JSON + embeddings snapshot.
        return await Podcast.read_from_file(args.index_path, settings)
    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        args.database,
        ConversationMessage,
    )
    settings.storage_provider = provider
    from ..knowpro.conversation_base import ConversationBase

    return await ConversationBase.create(settings, name=args.database or "memory")


async def print_stats(conversation: object) -> None:
    print(f"Conversation: {conversation.name_tag}")
    print(f"  messages:      {await conversation.messages.size()}")
    print(f"  semantic refs: {await conversation.semantic_refs.size()}")
    print(f"  terms:         {await conversation.semantic_ref_index.size()}")
    sec = conversation.secondary_indexes
    if sec:
        if sec.property_to_semantic_ref_index:
            print(f"  properties:    {await sec.property_to_semantic_ref_index.size()}")
        if sec.message_index:
            print(f"  text chunks:   {await sec.message_index.size()}")
        fuzzy = (
            sec.term_to_related_terms_index.fuzzy_index
            if sec.term_to_related_terms_index
            else None
        )
        if fuzzy:
            print(f"  fuzzy terms:   {await fuzzy.size()}")


async def do_term_search(context: QueryContext, terms: list[str]) -> None:
    """No-LLM search: terms -> knowledge + message matches."""
    group = SearchTermGroup(
        boolean_op="or", terms=[SearchTerm(Term(t)) for t in terms]
    )
    options = (
        SearchOptions(
            exact_match=True, max_message_matches=10, use_device_executor=True
        )
        if context.device
        else SearchOptions(exact_match=False, max_message_matches=10)
    )
    with METRICS.timer("term_search"):
        result = await search_conversation(
            context.conversation,
            group,
            options=options,
            raw_search_query=" ".join(terms),
        )
    if result is None:
        print("(conversation not searchable)")
        return
    for ktype, matches in result.knowledge_matches.items():
        print(f"{ktype}: {len(matches.semantic_ref_matches)} matches "
              f"(terms: {sorted(matches.term_matches)})")
        for scored in matches.semantic_ref_matches[:5]:
            sr = await context.conversation.semantic_refs.get_item(
                scored.semantic_ref_ordinal
            )
            print(f"  [{scored.score:8.2f}] {sr.knowledge}")
    print(f"messages: {len(result.message_matches)}")
    for scored in result.message_matches[:5]:
        m = await context.conversation.messages.get_item(scored.message_ordinal)
        text = " ".join(m.text_chunks)[:100]
        print(f"  [{scored.score:8.3f}] #{scored.message_ordinal}: {text}")


def _get_query_translator(context: QueryContext):
    conv = context.conversation
    if getattr(conv, "_query_translator", None) is None:
        from ..models.adapters import create_chat_model

        model = create_chat_model(retrier=conv.settings.chat_retrier)
        conv._query_translator = searchlang.create_search_query_translator(model)
    return conv._query_translator


async def do_stage_debug(
    context: QueryContext, question: str, compile_also: bool
) -> None:
    """Pipeline-stage debugging: stage 1 (NL -> SearchQuery JSON) and,
    for @compile, stage 2 (SearchQuery -> compiled expression tree)."""
    from ..knowpro.fields import serialize_object
    from ..models.result import Failure

    conv = context.conversation
    translator = _get_query_translator(context)
    result = await searchlang.search_query_from_language(conv, translator, question)
    if isinstance(result, Failure):
        print(f"Translation failed: {result.message}")
        return
    query = result.value
    print(json.dumps(serialize_object(query), indent=2))
    if compile_also:
        exprs = searchlang.compile_search_query(conv, query)
        for i, expr in enumerate(exprs):
            for j, select in enumerate(expr.select_expressions):
                print(f"-- expr {i} select {j} --")
                print(f"terms: {select.search_term_group}")
                if select.when is not None:
                    print(f"when:  {select.when}")


async def do_stage(context: QueryContext, count: int, question: str) -> None:
    """Run only the first ``count`` pipeline stages and show their state.

    (Parity-plus role: the reference's @stage command, reference
    tools/query.py:332-408, which steps stages 1-4; here stage 3 adds the
    engine's introspection — engine route taken + latency-router EMA
    state — and stage 4 prints the answer-context JSON without needing an
    answer model.)
    """
    if count <= 2:
        await do_stage_debug(context, question, compile_also=count == 2)
        return

    from ..knowpro import answers
    from ..knowpro.fields import serialize_object
    from ..models.result import Failure

    conv = context.conversation
    translator = _get_query_translator(context)
    debug_context = searchlang.LanguageSearchDebugContext()
    history_section = context.history.to_prompt_section()
    options = searchlang.LanguageSearchOptions(
        compile_options=searchlang.LanguageQueryCompileOptions(),
        exact_match=False,
        max_message_matches=25,
        model_instructions=[history_section] if history_section else None,
    )
    result = await searchlang.search_conversation_with_language(
        conv, translator, question, options, debug_context=debug_context
    )
    if isinstance(result, Failure):
        print(f"Search failed: {result.message}")
        return

    # Stage 1+2 recap (compact).
    if debug_context.search_query is not None:
        print("-- stage 1: SearchQuery --")
        print(json.dumps(serialize_object(debug_context.search_query), indent=2))
    for i, expr in enumerate(debug_context.search_query_expr or []):
        for j, select in enumerate(expr.select_expressions):
            print(f"-- stage 2: expr {i} select {j} --")
            print(f"terms: {select.search_term_group}")
            if select.when is not None:
                print(f"when:  {select.when}")

    # Stage 3: materialized accumulators + engine route.
    print("-- stage 3: search results --")
    route = getattr(conv, "_last_engine_route", None)
    router = getattr(conv, "_engine_router", None)
    if route is not None:
        print(f"engine route: {route}")
    if router is not None:
        ms = {k: (f"{v:.1f} ms" if v is not None else "unsampled")
              for k, v in router.ms.items()}
        print(f"router EMA: {ms} over {router.calls} calls")
    for ri, sr in enumerate(result.value):
        print(f"result {ri}:")
        for ktype, km in sorted(sr.knowledge_matches.items()):
            print(
                f"  {ktype}: {len(km.semantic_ref_matches)} semref matches, "
                f"matched terms: {sorted(km.term_matches)}"
            )
            for scored in km.semantic_ref_matches[:8]:
                semref = await conv.semantic_refs.get_item(
                    scored.semantic_ref_ordinal
                )
                rng = semref.range.start.message_ordinal
                print(
                    f"    [{scored.score:8.2f}] #{scored.semantic_ref_ordinal}"
                    f" @msg{rng}: {semref.knowledge}"
                )
        print(f"  messages: {len(sr.message_matches)}")
        for scored in sr.message_matches[:8]:
            m = await conv.messages.get_item(scored.message_ordinal)
            text = " ".join(m.text_chunks)[:90]
            print(f"    [{scored.score:8.3f}] #{scored.message_ordinal}: {text}")
    if count == 3:
        return

    # Stage 4: answer context (the JSON the answer LLM would receive).
    print("-- stage 4: answer context --")
    for ri, sr in enumerate(result.value):
        ctx = await answers.make_context(sr, conv)
        print(f"result {ri} context:")
        print(json.dumps(answers.dictify(ctx), indent=2, default=str))


async def process_query(
    context: QueryContext,
    query_text: str,
    debug_context: searchlang.LanguageSearchDebugContext | None = None,
) -> str:
    history_section = context.history.to_prompt_section()
    options = searchlang.LanguageSearchOptions(
        compile_options=searchlang.LanguageQueryCompileOptions(),
        exact_match=False,
        max_message_matches=25,
        model_instructions=[history_section] if history_section else None,
    )
    with METRICS.timer("query"):
        answer = await context.conversation.query(
            query_text, options, debug_context=debug_context
        )
    context.history.add(
        query_text, answer, had_answer=not answer.startswith("No answer")
    )
    return answer


HELP = """Commands:
  @help                 show this help
  @stats                conversation statistics
  @search TERM...       no-LLM term search over the indexes
  @history [--clear]    show/clear conversation history
  @metrics              show latency metrics
  @translate QUESTION   stage 1 only: show the LLM-translated SearchQuery JSON
  @compile QUESTION     stages 1+2: also show the compiled expression tree
  @stage N QUESTION     run stages 1..N (N=3: search results, accumulator
                        contents, engine route + router EMA; N=4: + the
                        answer-context JSON the answer LLM would receive)
  exit / quit           leave
Anything else is treated as a natural-language question (requires LLM keys).
"""


async def handle_command(context: QueryContext, line: str) -> None:
    parts = line.split()
    cmd, args = parts[0], parts[1:]
    match cmd:
        case "@help":
            print(HELP)
        case "@stats":
            await print_stats(context.conversation)
        case "@search":
            if not args:
                print("usage: @search TERM...")
            else:
                await do_term_search(context, args)
        case "@history":
            if args and args[0] == "--clear":
                context.history.clear()
                print("history cleared")
            else:
                for e in context.history.entries:
                    print(f"Q: {e.question}\nA: {e.answer}")
        case "@metrics":
            print(json.dumps(METRICS.report(), indent=2))
        case "@translate" | "@compile":
            if not args:
                print(f"usage: {cmd} QUESTION")
            else:
                await do_stage_debug(
                    context, " ".join(args), compile_also=cmd == "@compile"
                )
        case "@stage":
            if len(args) < 2 or args[0] not in ("1", "2", "3", "4"):
                print("usage: @stage N QUESTION  (N in 1..4)")
            else:
                await do_stage(context, int(args[0]), " ".join(args[1:]))
        case _:
            print(f"Unknown command {cmd!r}; try @help")


async def interactive_loop(context: QueryContext) -> None:
    print("typeagent-tpu query REPL. @help for commands.")
    while True:
        try:
            line = input("> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if not line:
            continue
        if line in ("exit", "quit"):
            break
        if line.startswith("@"):
            await handle_command(context, line)
        else:
            t0 = time.perf_counter()
            answer = await process_query(context, line)
            print(answer)
            print(f"[{time.perf_counter() - t0:.1f}s]")


def compare_results(results: list[dict], golden_file: str) -> int:
    """Diff batch answers against a golden file; returns the mismatch count.

    (Parity role: the reference driver's batch compare against
    Episode_53_Answer_results.json with per-question diff output.) Golden
    format: a JSON list of {"question", "answer"} objects — exactly what
    ``--output`` writes, so a reviewed run becomes the next golden.
    """
    import difflib

    with open(golden_file) as f:
        golden = json.load(f)
    by_question = {g["question"]: g for g in golden}
    mismatches = 0
    seen = set()
    for result in results:
        question = result["question"]
        seen.add(question)
        expected = by_question.get(question)
        if expected is None:
            mismatches += 1
            print(f"EXTRA (not in golden): {question!r}")
            continue
        got_answer = " ".join(str(result.get("answer", "")).split())
        want_answer = " ".join(str(expected.get("answer", "")).split())
        if got_answer == want_answer:
            print(f"ok: {question}")
            continue
        mismatches += 1
        print(f"MISMATCH: {question}")
        diff = difflib.unified_diff(
            want_answer.splitlines() or [want_answer],
            got_answer.splitlines() or [got_answer],
            fromfile="golden",
            tofile="got",
            lineterm="",
        )
        for line in diff:
            print(f"  {line}")
    for question in by_question:
        if question not in seen:
            mismatches += 1
            print(f"MISSING (in golden, not answered): {question!r}")
    status = "all match" if not mismatches else f"{mismatches} mismatches"
    print(f"golden compare: {len(results)} answers vs {golden_file}: {status}")
    return mismatches


def _search_record(debug_context) -> list[dict]:
    """Per-result knowledge/message ordinals from a captured debug context.

    (Parity role: the reference driver's RawSearchResultData records —
    tools/query.py there, entityMatches/topicMatches/actionMatches/
    messageMatches keyed per search result.)
    """
    records = []
    for r in debug_context.search_results or []:
        rec: dict = {
            "messageMatches": [m.message_ordinal for m in r.message_matches]
        }
        for ktype, res in sorted(r.knowledge_matches.items()):
            rec[f"{ktype}Matches"] = [
                m.semantic_ref_ordinal for m in res.semantic_ref_matches
            ]
        records.append(rec)
    return records


def compare_search_results(results: list[dict], golden_file: str) -> int:
    """Diff recorded search ordinals against a golden recording.

    Knowledge ordinals compare as sorted sets and messages as sets — the
    reference's comparison semantics (its compare_semantic_ref_ordinals /
    compare_message_ordinals) — with list diffs on mismatch.
    """
    with open(golden_file) as f:
        golden = json.load(f)
    by_question = {g["question"]: g for g in golden}
    mismatches = 0
    for result in results:
        question = result["question"]
        expected = by_question.get(question)
        if expected is None:
            mismatches += 1
            print(f"EXTRA (not in golden): {question!r}")
            continue
        got_sets = result.get("searchResults", [])
        want_sets = expected.get("searchResults", [])
        if len(got_sets) != len(want_sets):
            mismatches += 1
            print(
                f"MISMATCH {question!r}: {len(got_sets)} result sets, "
                f"golden has {len(want_sets)}"
            )
            continue
        ok = True
        for got, want in zip(got_sets, want_sets):
            for key in sorted(set(got) | set(want)):
                a = sorted(got.get(key, []))
                b = sorted(want.get(key, []))
                if a != b:
                    ok = False
                    extra = sorted(set(a) - set(b))[:12]
                    missing = sorted(set(b) - set(a))[:12]
                    print(
                        f"MISMATCH {question!r} {key}: "
                        f"+{extra} -{missing} (got {len(a)}, want {len(b)})"
                    )
        if ok:
            print(f"ok: {question}")
        else:
            mismatches += 1
    status = "all match" if not mismatches else f"{mismatches} mismatches"
    print(f"search compare: {len(results)} questions vs {golden_file}: {status}")
    return mismatches


async def batch_loop(
    context: QueryContext,
    batch_file: str,
    out_file: str | None,
    compare_file: str | None = None,
    search_results_file: str | None = None,
    compare_search_file: str | None = None,
) -> int:
    from ..knowpro.serialization import serialize_object

    with open(batch_file) as f:
        questions = [q.strip() for q in f if q.strip() and not q.startswith("#")]
    results = []
    record_search = bool(search_results_file or compare_search_file)
    for i, question in enumerate(questions, 1):
        print(f"[{i}/{len(questions)}] {question}")
        if question.startswith("@"):
            await handle_command(context, question)
            continue
        debug_context = (
            searchlang.LanguageSearchDebugContext() if record_search else None
        )
        answer = await process_query(context, question, debug_context)
        print(answer)
        entry = {
            "question": question,
            "answer": answer,
            "hasNoAnswer": answer.startswith("No answer"),
        }
        if debug_context is not None:
            entry["searchResults"] = _search_record(debug_context)
            if debug_context.search_query is not None:
                entry["searchQuery"] = serialize_object(debug_context.search_query)
        results.append(entry)
    if out_file:
        with open(out_file, "w") as f:
            json.dump(results, f, indent=2)
        print(f"Wrote {len(results)} answers to {out_file}")
    if search_results_file:
        with open(search_results_file, "w") as f:
            json.dump(
                [
                    {k: r[k] for k in ("question", "searchResults", "searchQuery") if k in r}
                    for r in results
                ],
                f,
                indent=2,
            )
        print(f"Wrote search recordings to {search_results_file}")
    print(json.dumps(METRICS.report(), indent=2))
    failures = 0
    if compare_file:
        failures += compare_results(results, compare_file)
    if compare_search_file:
        failures += compare_search_results(results, compare_search_file)
    return failures


def make_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Query a typeagent-tpu conversation")
    parser.add_argument("--database", "-d", help="SQLite database path")
    parser.add_argument(
        "--index-path", "-i", help="JSON index path prefix (<prefix>_data.json)"
    )
    parser.add_argument("--batch", "-b", help="Batch file of questions")
    parser.add_argument("--output", "-o", help="Batch output JSON file")
    parser.add_argument(
        "--compare",
        help="Golden answers JSON (an earlier --output) to diff against; "
        "exits nonzero on mismatches",
    )
    parser.add_argument(
        "--search-results",
        help="Record per-question stage-3 search ordinals (+ the stage-1 "
        "SearchQuery) to this JSON file",
    )
    parser.add_argument(
        "--compare-search",
        help="Golden search recording (an earlier --search-results) to diff "
        "against with set semantics; exits nonzero on mismatches",
    )
    parser.add_argument("--verbose", "-v", action="store_true")
    parser.add_argument(
        "--search", nargs="+", help="Run one no-LLM term search and exit"
    )
    parser.add_argument(
        "--embedding-model",
        help="provider:model embedding spec (use 'test' for offline fake)",
    )
    add_device_argument(parser)
    parser.add_argument(
        "--device-executor",
        action="store_true",
        help="run @search term queries through the fused device executor "
        "(exact-match mode; complex groups fall back to the host VM)",
    )
    return parser


async def amain() -> None:
    load_dotenv()
    args = make_arg_parser().parse_args()
    conversation = await load_conversation(args)
    context = QueryContext(conversation, args.verbose, device=args.device_executor)
    await print_stats(conversation)
    if args.search:
        await do_term_search(context, args.search)
    elif args.batch:
        mismatches = await batch_loop(
            context,
            args.batch,
            args.output,
            args.compare,
            args.search_results,
            args.compare_search,
        )
        if mismatches:
            raise SystemExit(1)
    else:
        await interactive_loop(context)


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
