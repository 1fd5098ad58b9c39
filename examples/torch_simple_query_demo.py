"""End-to-end demo on the PyTorch port: ingest a podcast transcript,
search it, ask a question.

Runs fully offline with the deterministic fake embedder; natural-language
questions additionally need an LLM (OPENAI_API_KEY), otherwise the demo shows
the no-LLM term-search path. The port of ``simple_query_demo.py``.

    python examples/torch_simple_query_demo.py [transcript.txt] [--device cpu]
"""

import argparse
import asyncio
import os
import sys
from datetime import datetime, timezone

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from typeagent_tpu_torch.knowpro.convsettings import ConversationSettings
from typeagent_tpu_torch.knowpro.interfaces import SearchTerm, SearchTermGroup, Term
from typeagent_tpu_torch.knowpro.search import SearchOptions, search_conversation
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.podcasts.podcast_ingest import ingest_podcast
from typeagent_tpu_torch.tools import add_device_argument

DEFAULT_TRANSCRIPT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests",
    "testdata",
    "mini_podcast.txt",
)


async def main(transcript: str, device: str) -> None:
    settings = ConversationSettings(model=create_test_embedding_model(64), device=device)
    # Offline demo: metadata knowledge only (speakers/listeners). With API
    # keys, drop this line to let the LLM extract entities/actions/topics.
    settings.semantic_ref_index_settings.auto_extract_knowledge = False

    print(f"Ingesting {transcript} on {device} ...")
    podcast = await ingest_podcast(
        transcript,
        settings,
        start_date=datetime(2024, 1, 1, tzinfo=timezone.utc),
        length_minutes=10.0,
    )
    print(
        f"  {await podcast.messages.size()} messages, "
        f"{await podcast.semantic_refs.size()} semantic refs\n"
    )

    # No-LLM structured search over the six indexes.
    for term in ("alice johnson", "bob"):
        result = await search_conversation(
            podcast,
            SearchTermGroup(boolean_op="or", terms=[SearchTerm(Term(term))]),
            options=SearchOptions(exact_match=True, max_message_matches=3),
            raw_search_query=term,
        )
        print(f"search {term!r}:")
        for ktype, matches in result.knowledge_matches.items():
            print(f"  {ktype}: {len(matches.semantic_ref_matches)} matches")
        for scored in result.message_matches[:3]:
            message = await podcast.messages.get_item(scored.message_ordinal)
            text = " ".join(message.text_chunks)[:70]
            print(f"  [{scored.score:7.2f}] #{scored.message_ordinal} {text}")
        print()

    if os.getenv("OPENAI_API_KEY") or os.getenv("AZURE_OPENAI_API_KEY"):
        question = "Who recorded the Goldberg Variations?"
        print(f"Q: {question}")
        print(f"A: {await podcast.query(question)}")
    else:
        print("(set OPENAI_API_KEY for natural-language question answering)")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("transcript", nargs="?", default=DEFAULT_TRANSCRIPT)
    add_device_argument(parser)
    args = parser.parse_args()
    asyncio.run(main(args.transcript, args.device))
