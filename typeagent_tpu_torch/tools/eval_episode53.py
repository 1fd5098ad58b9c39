"""Episode-53 batch search eval: replay the reference's real query corpus.

(Parity role: reference ``make eval`` / ``tools/query.py --batch
--search-results`` — reference `Makefile:38-42`, `tools/query.py:1275-1347`.)

The reference ships ``Episode_53_Search_results.json``: 67 real queries with
their LLM stage-1 translations AND the fully compiled stage-2/3 expression
trees, including the real embedding model's related-term weights, or_max
entity groups, property terms, scope-defining term groups, and date ranges.
Those compiled trees are replayed here — hermetically, no LLM — against the
reference's own Episode-53 index snapshot, through BOTH query engines (host
VM and device executor), and diffed per query against committed goldens.

Note the reference's recorded result ordinals do NOT correspond to the
snapshot shipped next to them (its golden was recorded against an older
index build: e.g. its ``entityMatches`` for "List all book titles" map to
actions/topics in today's snapshot), so this driver pins its own goldens —
regenerate with ``--update`` — and uses the reference corpus for its query
*inputs*, which are real LLM output and exercise every compiled-tree shape
the production pipeline emits.

The port of ``typeagent_tpu/tools/eval_episode53.py``, held to the same
committed goldens. The reference corpus is read only from the directory
that ``--reference`` or ``$TYPEAGENT_REFERENCE_TESTDATA`` names (the
reference repository's ``tests/testdata``); there is no default, and
without that setting ``corpus_available()`` is false and the eval reports
so. ``--device {cuda,cpu}`` names where the conversation's indexes and
the device engine run (the card unless ``cpu`` is named).

Run: ``python -m typeagent_tpu_torch.tools.eval_episode53 --reference DIR
[--update] [--engine both]``
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from datetime import datetime

from ..knowpro.answers import AnswerContextOptions, dictify, make_context
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import (
    DateRange,
    PropertySearchTerm,
    SearchSelectExpr,
    SearchTerm,
    SearchTermGroup,
    Term,
    WhenFilter,
)
from ..knowpro.query import to_required_search_term
from ..knowpro.search import SearchOptions, SearchQueryExpr, run_search_query
from ..models.adapters import create_test_embedding_model
from ..podcasts.podcast import Podcast
from . import add_device_argument

REFERENCE_ENV = "TYPEAGENT_REFERENCE_TESTDATA"
FIXTURE_NAME = "Episode_53_AdrianTchaikovsky_index"
QUERY_CORPUS_NAME = "Episode_53_Search_results.json"
GOLDEN_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "tests",
    "testdata",
    "golden_episode53_search.json",
)


def reference_testdata() -> str | None:
    """The reference repository's ``tests/testdata`` as
    ``$TYPEAGENT_REFERENCE_TESTDATA`` names it, or None when it is unset."""
    return os.environ.get(REFERENCE_ENV) or None


def reference_file(name: str) -> str | None:
    root = reference_testdata()
    return None if root is None else os.path.join(root, name)


def corpus_available() -> bool:
    fixture, corpus = reference_file(FIXTURE_NAME), reference_file(QUERY_CORPUS_NAME)
    return (
        fixture is not None
        and os.path.exists(fixture + "_data.json")
        and os.path.exists(corpus)
    )


# ---------------------------------------------------------------------------
# Compiled-expression JSON -> search expression tree
# (wire format: the reference's serialized SearchQueryExpr, camelCase)
# ---------------------------------------------------------------------------


def _load_term(d: dict) -> Term:
    return Term(d["text"], d.get("weight"))


def _load_search_term(d: dict) -> SearchTerm:
    # Absent relatedTerms means "already resolved to nothing": pin [] so the
    # compiler never re-resolves through the (fake) fuzzy index.
    related = [_load_term(t) for t in d.get("relatedTerms") or []]
    st = SearchTerm(_load_term(d["term"]), related)
    if d.get("relatedTermsRequired"):
        st = to_required_search_term(st)
    return st


def _load_group_member(d: dict):
    if "booleanOp" in d:
        return load_term_group(d)
    if "propertyName" in d:
        name = d["propertyName"]
        if isinstance(name, dict):
            name = _load_search_term(name)
        return PropertySearchTerm(name, _load_search_term(d["propertyValue"]))
    return _load_search_term(d)


def load_term_group(d: dict) -> SearchTermGroup:
    return SearchTermGroup(
        d["booleanOp"], [_load_group_member(t) for t in d["terms"]]
    )


def _parse_dt(s: str) -> datetime:
    return datetime.fromisoformat(s.replace("Z", "+00:00"))


def _load_when(d: dict | None) -> WhenFilter | None:
    if d is None:
        return None
    when = WhenFilter()
    if "knowledgeType" in d:
        when.knowledge_type = d["knowledgeType"]
    if "dateRange" in d:
        dr = d["dateRange"]
        when.date_range = DateRange(
            _parse_dt(dr["start"]), _parse_dt(dr["end"]) if dr.get("end") else None
        )
    if "scopeDefiningTerms" in d:
        when.scope_defining_terms = load_term_group(d["scopeDefiningTerms"])
    if "tags" in d:
        when.tags = d["tags"]
    return when


def load_compiled_query_expr(d: dict) -> SearchQueryExpr:
    """Deserialize one entry of ``compiledQueryExpr`` into a SearchQueryExpr."""
    selects = [
        SearchSelectExpr(load_term_group(se["searchTermGroup"]), _load_when(se.get("when")))
        for se in d["selectExpressions"]
    ]
    return SearchQueryExpr(selects, d.get("rawQuery"))


def load_query_corpus() -> list[dict]:
    with open(reference_file(QUERY_CORPUS_NAME)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Replay + golden compare
# ---------------------------------------------------------------------------


async def load_episode53_conversation(device: str = "cuda") -> Podcast:
    settings = ConversationSettings(
        model=create_test_embedding_model(1536), device=device
    )
    return await Podcast.read_from_file(reference_file(FIXTURE_NAME), settings)


def _result_record(results) -> list[dict]:
    out = []
    for r in results:
        knowledge = {}
        for ktype, res in sorted(r.knowledge_matches.items()):
            knowledge[ktype] = {
                "semrefs": [
                    [m.semantic_ref_ordinal, round(float(m.score), 4)]
                    for m in res.semantic_ref_matches
                ],
                "termMatches": sorted(res.term_matches),
            }
        out.append(
            {
                "knowledge": knowledge,
                "messages": [
                    [m.message_ordinal, round(float(m.score), 4)]
                    for m in r.message_matches
                ],
            }
        )
    return out


async def _context_record(conversation, results) -> list[dict]:
    """Stage-4 deterministic half: answer-context construction digests.

    Uses the reference batch driver's context options (entities/topics
    top-50, reference tools/query.py:631-633). The LLM answer itself is not
    replayable offline; the context merge/enrichment semantics are.
    """
    options = AnswerContextOptions(entities_top_k=50, topics_top_k=50)
    out = []
    for r in results:
        context = await make_context(r, conversation, options)
        # json round-trip: dictify keeps datetimes; goldens are plain JSON.
        jsonify = lambda obj: json.loads(json.dumps(dictify(obj), default=str))
        out.append(
            {
                "entities": jsonify(context.entities),
                "topics": jsonify(context.topics),
                "messageOrdinals": [
                    m.message_ordinal for m in r.message_matches
                ],
                "messageChars": sum(
                    len(m.message_text)
                    if isinstance(m.message_text, str)
                    else sum(len(c) for c in m.message_text or [])
                    for m in context.messages
                ),
            }
        )
    return out


async def replay_corpus(
    conversation: Podcast, corpus: list[dict], use_device_executor: bool
) -> list[dict]:
    records = []
    for entry in corpus:
        options = SearchOptions(exact_match=False, max_message_matches=25)
        options.use_device_executor = use_device_executor
        results = []
        for compiled in entry["compiledQueryExpr"]:
            expr = load_compiled_query_expr(compiled)
            results.extend(
                await run_search_query(
                    conversation, expr, options, entry["searchText"]
                )
            )
        records.append(
            {
                "searchText": entry["searchText"],
                "results": _result_record(results),
                "answerContext": await _context_record(conversation, results),
            }
        )
    return records


# ---------------------------------------------------------------------------
# Full 4-stage answer replay (hermetic: recorded stage-1 + crafted stage-4)
# ---------------------------------------------------------------------------

ANSWERS_GOLDEN_FILE = os.path.join(
    os.path.dirname(GOLDEN_FILE), "golden_episode53_answers.json"
)


async def replay_answers(
    conversation: Podcast, corpus: list[dict], use_device_executor: bool
) -> list[dict]:
    """Replay all 4 stages per query, no network (parity role: the answer
    half of reference ``make eval`` — reference `Makefile:38-42`,
    `tools/query.py` --answer-results batch compare).

    Stage 1 returns each query's RECORDED LLM translation verbatim
    (models/canned.py); stages 2/3 compile+execute it for real (the fallback
    re-run included); stage 4 runs the real answer machinery — context
    build, per-result generation, ``combine_answers`` blending — over
    crafted deterministic completions. The trailing record pins the chat
    call counts, proving the combine path actually executed.

    Host engine only: the device executor accumulates scores in f32, and
    ~1e-9 relative score noise flips ties exactly at the answer context's
    top-50 entity boundary (8/67 queries) — the engines agree to 4 decimals
    on every semref/message score (enforced by the search replay above,
    both engines), so one host-pinned answer golden is the meaningful
    contract.
    """
    from ..knowpro import answers as answers_mod
    from ..knowpro import searchlang
    from ..models.canned import CannedChatModel
    from ..models.result import Success

    model = CannedChatModel({e["searchText"]: e["searchQueryExpr"] for e in corpus})
    query_translator = searchlang.create_search_query_translator(model)
    answer_translator = answers_mod.create_answer_translator(model)
    records: list[dict] = []
    first_results: list = []  # search results of the first 2 queries
    for entry in corpus:
        # Same defaults ConversationBase.query() uses.
        options = searchlang.LanguageSearchOptions(
            compile_options=searchlang.LanguageQueryCompileOptions(
                exact_scope=False,
                verb_scope=True,
                term_filter=None,
                apply_scope=True,
            ),
            exact_match=False,
            max_message_matches=25,
        )
        options.use_device_executor = use_device_executor
        result = await searchlang.search_conversation_with_language(
            conversation, query_translator, entry["searchText"], options
        )
        if not isinstance(result, Success):
            records.append(
                {"searchText": entry["searchText"], "error": result.message}
            )
            continue
        if len(first_results) < 2:
            first_results.append((entry["searchText"], result.value))
        all_answers, combined = await answers_mod.generate_answers(
            answer_translator,
            result.value,
            conversation,
            entry["searchText"],
            options=answers_mod.AnswerContextOptions(
                entities_top_k=50, topics_top_k=50, messages_top_k=None, chunking=None
            ),
            settings=answers_mod.AnswerGeneratorSettings(
                concurrency=2, fast_stop=False
            ),
        )

        records.append(
            {
                "searchText": entry["searchText"],
                "answers": [_answer_rec(a) for a in all_answers],
                "combined": _answer_rec(combined),
            }
        )

    # Combine-path coverage: every recorded translation compiles to a single
    # search expression, so no per-query replay reaches combine_answers
    # (generate_answers early-returns on one result). Blend the first two
    # queries' results through the SAME generate_answers call a fanned-out
    # translation would take, pinning the multi-answer merge + LLM combine.
    if len(first_results) == 2:
        blend_question = " AND ALSO ".join(q for q, _ in first_results)
        all_answers, combined = await answers_mod.generate_answers(
            answer_translator,
            [r for _, rs in first_results for r in rs],
            conversation,
            blend_question,
            options=answers_mod.AnswerContextOptions(
                entities_top_k=50, topics_top_k=50, messages_top_k=None, chunking=None
            ),
            settings=answers_mod.AnswerGeneratorSettings(
                concurrency=2, fast_stop=False
            ),
        )
        records.append(
            {
                "searchText": blend_question,
                "answers": [_answer_rec(a) for a in all_answers],
                "combined": _answer_rec(combined),
            }
        )
    records.append({"callCounts": dict(model.calls)})
    return records


def _answer_rec(a) -> dict:
    out: dict = {"type": a.type}
    if a.answer is not None:
        out["answer"] = a.answer
    if a.why_no_answer is not None:
        out["whyNoAnswer"] = a.why_no_answer
    return out


def diff_answer_records(got: list[dict], golden: list[dict]) -> int:
    failures = 0
    for g, e in zip(got, golden):
        if g == e:
            continue
        failures += 1
        label = g.get("searchText") or "callCounts"
        print(f"ANSWER MISMATCH: {label!r}")
        for key in sorted(set(g) | set(e)):
            if g.get(key) != e.get(key):
                print(f"    {key}: expected {e.get(key)!r}")
                print(f"    {key}: actual   {g.get(key)!r}")
    if len(got) != len(golden):
        failures += 1
        print(f"Answer record count mismatch: {len(got)} != {len(golden)}")
    return failures


def _list_diff(label: str, expected: list, actual: list, max_items: int = 12) -> None:
    exp_set = {tuple(e) if isinstance(e, list) else e for e in expected}
    act_set = {tuple(a) if isinstance(a, list) else a for a in actual}
    missing = sorted(exp_set - act_set)[:max_items]
    extra = sorted(act_set - exp_set)[:max_items]
    print(f"    {label}: expected {len(expected)}, actual {len(actual)}")
    if missing:
        print(f"      missing: {missing}")
    if extra:
        print(f"      extra:   {extra}")


def diff_records(got: list[dict], golden: list[dict]) -> int:
    """Reference-style per-query diff (tools/query.py:1275-1347 ergonomics).

    Returns the number of mismatched queries.
    """
    failures = 0
    for g, e in zip(got, golden):
        if g == e:
            continue
        failures += 1
        print(f"MISMATCH: {g['searchText']!r}")
        if len(g["results"]) != len(e["results"]):
            print(
                f"    result-set count: expected {len(e['results'])},"
                f" actual {len(g['results'])}"
            )
            continue
        for gr, er in zip(g["results"], e["results"]):
            for ktype in sorted(set(gr["knowledge"]) | set(er["knowledge"])):
                gk = gr["knowledge"].get(ktype, {"semrefs": [], "termMatches": []})
                ek = er["knowledge"].get(ktype, {"semrefs": [], "termMatches": []})
                if gk["semrefs"] != ek["semrefs"]:
                    _list_diff(f"{ktype} semrefs", ek["semrefs"], gk["semrefs"])
                if gk["termMatches"] != ek["termMatches"]:
                    _list_diff(
                        f"{ktype} termMatches", ek["termMatches"], gk["termMatches"]
                    )
            if gr["messages"] != er["messages"]:
                _list_diff("messages", er["messages"], gr["messages"])
        if g.get("answerContext") != e.get("answerContext"):
            print("    answerContext digests differ")
    if len(got) != len(golden):
        failures += 1
        print(f"Query count mismatch: {len(got)} != {len(golden)}")
    return failures


async def run_eval(update: bool, engine: str, device: str = "cuda") -> int:
    if not corpus_available():
        print(f"Reference corpus not available (${REFERENCE_ENV}={reference_testdata()})")
        return 2
    conversation = await load_episode53_conversation(device)
    corpus = load_query_corpus()

    if update:
        records = await replay_corpus(conversation, corpus, use_device_executor=False)
        with open(GOLDEN_FILE, "w") as f:
            json.dump(records, f, indent=1)
        print(f"Wrote {len(records)} golden query results to {GOLDEN_FILE}")
        answer_records = await replay_answers(
            conversation, corpus, use_device_executor=False
        )
        with open(ANSWERS_GOLDEN_FILE, "w") as f:
            json.dump(answer_records, f, indent=1)
        print(
            f"Wrote {len(answer_records)} golden answer records to "
            f"{ANSWERS_GOLDEN_FILE}"
        )
        return 0

    with open(GOLDEN_FILE) as f:
        golden = json.load(f)
    with open(ANSWERS_GOLDEN_FILE) as f:
        answers_golden = json.load(f)
    total_failures = 0
    engines = {"host": [False], "device": [True], "both": [False, True]}[engine]
    for use_device in engines:
        name = "device" if use_device else "host"
        records = await replay_corpus(conversation, corpus, use_device)
        failures = diff_records(records, golden)
        status = "all match" if not failures else f"{failures} mismatches"
        print(f"[{name}] {len(records)} queries: {status}")
        total_failures += failures
    # Answers replay runs once on the host engine (see replay_answers
    # docstring for why it is host-pinned).
    answer_records = await replay_answers(conversation, corpus, False)
    failures = diff_answer_records(answer_records, answers_golden)
    status = "all match" if not failures else f"{failures} mismatches"
    print(f"[answers/host] {len(answer_records) - 1} answer replays: {status}")
    total_failures += failures
    return 1 if total_failures else 0


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Replay the reference's Episode-53 query corpus vs goldens"
    )
    parser.add_argument("--update", action="store_true", help="Rewrite goldens")
    parser.add_argument(
        "--engine",
        choices=["host", "device", "both"],
        default="both",
        help="Which query engine(s) to run",
    )
    parser.add_argument(
        "--reference",
        help=f"The reference repository's tests/testdata (default: ${REFERENCE_ENV})",
    )
    add_device_argument(parser)
    args = parser.parse_args()
    if args.reference:
        os.environ[REFERENCE_ENV] = args.reference
    sys.exit(asyncio.run(run_eval(args.update, args.engine, args.device)))


if __name__ == "__main__":
    main()
