"""Golden-result evaluation: deterministic queries vs committed goldens.

(Parity role: reference `make eval` comparing Episode-53 batch results against
Episode_53_Search_results.json / Answer_results.json.) Builds the bundled
fixture conversation with the offline deterministic extractor + embedder,
runs fixed search queries through stages 2-3 (no LLM: translated queries are
pinned via the debug override), and diffs against tests/testdata/golden
files. ``--update`` regenerates them.

The port of ``typeagent_tpu/tools/eval_golden.py``, held to the goldens
the JAX package wrote. ``--device {cuda,cpu}`` names where the fixture's
embedding indexes and the device query engine run (the card unless
``cpu`` is named).
Run: ``python -m typeagent_tpu_torch.tools.eval_golden [--host-vm] [--device cpu]``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
from datetime import datetime, timezone

from ..knowpro import kplib
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.searchlang import (
    LanguageQueryCompileOptions,
    LanguageSearchOptions,
    compile_search_query,
)
from ..knowpro.search import run_search_query
from ..knowpro.search_query_schema import SearchQuery
from ..knowpro.serialization import deserialize_object
from ..models.adapters import create_test_embedding_model
from ..models.result import Result, Success
from ..podcasts.podcast import Podcast
from ..podcasts.podcast_ingest import ingest_podcast
from . import add_device_argument

GOLDEN_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
    "tests",
    "testdata",
    "golden_eval.json",
)
FIXTURE = os.path.join(
    os.path.dirname(GOLDEN_FILE), "mini_podcast.txt"
)

# Pinned stage-1 outputs (what the LLM would translate these questions to).
PINNED_QUERIES: list[tuple[str, dict]] = [
    (
        "What do we know about Bach?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "What do we know about Bach?",
                    "filters": [
                        {
                            "entitySearchTerms": [
                                {"name": "Bach", "isNamePronoun": False}
                            ]
                        }
                    ],
                }
            ]
        },
    ),
    (
        "Who recorded the Goldberg Variations?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Who recorded the Goldberg Variations?",
                    "filters": [
                        {"searchTerms": ["recorded", "Goldberg", "Variations"]}
                    ],
                }
            ]
        },
    ),
    (
        "Summarize the conversation",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Summarize the conversation",
                    # No searchTerms key at all -> topic-* summary wildcard.
                    "filters": [{}],
                }
            ]
        },
    ),
    (
        # Parity quirk worth pinning: an explicitly EMPTY searchTerms list is
        # NOT a summary request (reference searchlang.py:318-322 checks
        # `is not None`), so it matches nothing.
        "Empty search terms match nothing",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Empty search terms match nothing",
                    "filters": [{"searchTerms": []}],
                }
            ]
        },
    ),
    (
        "What did Bob say about the commission?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "What did Bob say about the commission?",
                    "filters": [
                        {
                            "actionSearchTerm": {
                                "actorEntities": [
                                    {"name": "Bob", "isNamePronoun": False}
                                ],
                                "isInformational": False,
                                "actionVerbs": {
                                    "words": ["say"],
                                    "tense": "Past",
                                },
                                "additionalEntities": [
                                    {
                                        "name": "commissioned",
                                        "isNamePronoun": False,
                                    }
                                ],
                            }
                        }
                    ],
                }
            ]
        },
    ),
    (
        "Who is Glenn Gould?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Who is Glenn Gould?",
                    "filters": [
                        {
                            "entitySearchTerms": [
                                {
                                    "name": "glenn",
                                    "isNamePronoun": False,
                                    "type": ["word"],
                                }
                            ],
                            "searchTerms": ["recorded"],
                        }
                    ],
                }
            ]
        },
    ),
    (
        "What was discussed on the first day?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "What was discussed on the first day?",
                    "filters": [
                        {
                            "searchTerms": ["goldberg"],
                            "timeRange": {
                                "startDate": {
                                    "date": {"day": 1, "month": 1, "year": 2024}
                                },
                                "stopDate": {
                                    "date": {"day": 1, "month": 1, "year": 2024}
                                },
                            },
                        }
                    ],
                }
            ]
        },
    ),
    (
        # Entity + type or_max group: type 'word' matches every extracted
        # entity; or_max keeps only the double hits (name AND type).
        "Tell me about bach the word",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Tell me about bach the word",
                    "filters": [
                        {
                            "entitySearchTerms": [
                                {
                                    "name": "bach",
                                    "isNamePronoun": False,
                                    "type": ["word"],
                                }
                            ]
                        }
                    ],
                }
            ]
        },
    ),
    (
        # Actor scope from metadata knowledge: Alice's say-actions scope the
        # matches to her messages; the verbless fallback also runs.
        "What did Alice Johnson say about Gould?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "What did Alice Johnson say about Gould?",
                    "filters": [
                        {
                            "actionSearchTerm": {
                                "actorEntities": [
                                    {
                                        "name": "Alice Johnson",
                                        "isNamePronoun": False,
                                    }
                                ],
                                "isInformational": False,
                                "actionVerbs": {"words": ["say"], "tense": "Past"},
                                "additionalEntities": [
                                    {"name": "gould", "isNamePronoun": False}
                                ],
                            }
                        }
                    ],
                }
            ]
        },
    ),
    (
        # Facet-shaped entity term: the extractor yields no facets, so the
        # facet half matches nothing while name/topic still hit.
        "Which recordings have a year facet?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Which recordings have a year facet?",
                    "filters": [
                        {
                            "entitySearchTerms": [
                                {
                                    "name": "recorded",
                                    "isNamePronoun": False,
                                    "facets": [
                                        {
                                            "facetName": "year",
                                            "facetValue": "*",
                                        }
                                    ],
                                }
                            ]
                        }
                    ],
                }
            ]
        },
    ),
    (
        # Pronoun entity names never become property terms; the search term
        # rides alone.
        "What did he record?",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "What did he record?",
                    "filters": [
                        {
                            "entitySearchTerms": [
                                {"name": "he", "isNamePronoun": True}
                            ],
                            "searchTerms": ["recorded"],
                        }
                    ],
                }
            ]
        },
    ),
    (
        # Two search expressions in one query -> two result sets.
        "Compare the 1955 and 1981 recordings",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "the 1955 recording",
                    "filters": [{"searchTerms": ["1955"]}],
                },
                {
                    "rewrittenQuery": "the 1981 recording",
                    "filters": [{"searchTerms": ["1981"]}],
                },
            ]
        },
    ),
    (
        # Time range with no terms: summary wildcard + date scope compose.
        "Summarize the first day",
        {
            "searchExpressions": [
                {
                    "rewrittenQuery": "Summarize the first day",
                    "filters": [
                        {
                            "timeRange": {
                                "startDate": {
                                    "date": {"day": 1, "month": 1, "year": 2024}
                                },
                                "stopDate": None,
                            }
                        }
                    ],
                }
            ]
        },
    ),
]


class WordExtractor:
    """Deterministic offline knowledge: first word entity + per-word topics."""

    async def extract(self, text: str) -> Result[kplib.KnowledgeResponse]:
        words = [w.strip(".,!?").lower() for w in text.split() if len(w) > 3]
        return Success(
            kplib.KnowledgeResponse(
                entities=[kplib.ConcreteEntity(words[0], ["word"])] if words else [],
                actions=[],
                inverse_actions=[],
                topics=words,
            )
        )


async def build_fixture_conversation(
    search_mode: str = "exact", device: str = "cuda"
) -> Podcast:
    settings = ConversationSettings(
        model=create_test_embedding_model(32), search_mode=search_mode, device=device
    )
    settings.semantic_ref_index_settings.knowledge_extractor = WordExtractor()
    return await ingest_podcast(
        FIXTURE,
        settings,
        start_date=datetime(2024, 1, 1, tzinfo=timezone.utc),
        length_minutes=10.0,
    )


async def run_eval(
    update: bool,
    use_device_executor: bool = True,
    search_mode: str = "exact",
    device: str = "cuda",
) -> int:
    conversation = await build_fixture_conversation(search_mode, device)
    results = []
    for question, pinned in PINNED_QUERIES:
        query = deserialize_object(SearchQuery, pinned)
        exprs = compile_search_query(
            conversation, query, LanguageQueryCompileOptions()
        )
        search_results = []
        options = LanguageSearchOptions(max_message_matches=10)
        options.use_device_executor = use_device_executor
        for expr in exprs:
            search_results.extend(
                await run_search_query(
                    conversation,
                    expr,
                    options,
                    question,
                )
            )
        results.append(
            {
                "question": question,
                "knowledgeMatches": [
                    {
                        "types": sorted(r.knowledge_matches.keys()),
                        "semrefs": {
                            ktype: [
                                m.semantic_ref_ordinal
                                for m in matches.semantic_ref_matches[:10]
                            ]
                            for ktype, matches in sorted(
                                r.knowledge_matches.items()
                            )
                        },
                    }
                    for r in search_results
                ],
                "messageMatches": [
                    [m.message_ordinal for m in r.message_matches[:10]]
                    for r in search_results
                ],
            }
        )

    if update:
        with open(GOLDEN_FILE, "w") as f:
            json.dump(results, f, indent=2)
        print(f"Wrote goldens to {GOLDEN_FILE}")
        return 0

    with open(GOLDEN_FILE) as f:
        golden = json.load(f)
    failures = 0
    for got, expected in zip(results, golden):
        if got != expected:
            failures += 1
            print(f"MISMATCH for {got['question']!r}:")
            print(f"  got:      {json.dumps(got)[:300]}")
            print(f"  expected: {json.dumps(expected)[:300]}")
    if len(results) != len(golden):
        failures += 1
        print(f"Result count mismatch: {len(results)} != {len(golden)}")
    if failures:
        print(f"{failures} mismatches")
        return 1
    print(f"All {len(results)} golden queries match")
    return 0


def main() -> None:
    parser = argparse.ArgumentParser(description="Golden query evaluation")
    parser.add_argument("--update", action="store_true", help="Rewrite goldens")
    parser.add_argument(
        "--host-vm",
        action="store_true",
        help="Evaluate through the host query VM instead of the device engine",
    )
    add_device_argument(parser)
    args = parser.parse_args()
    sys.exit(asyncio.run(run_eval(args.update, not args.host_vm, device=args.device)))


if __name__ == "__main__":
    main()
