"""MCP server exposing ``query_conversation`` over a conversation index.

(Parity: reference mcp/server.py — stdio server; LLM calls route back through
MCP sampling so the CLIENT's model does translation/answers; loads a podcast
from SQLite or a JSON index; embeddings still need an embedding model.)

The port of ``typeagent_tpu/mcp/server.py``. ``--device {cuda,cpu}`` names
where the conversations' embedding indexes (and the corpus) live: the card
by default, and without one the server refuses to start unless ``--device
cpu`` is given.
Run: ``python -m typeagent_tpu_torch.mcp.server --database conv.db``.
"""

from __future__ import annotations

import argparse
import asyncio
from dataclasses import dataclass

import torch

from ..knowpro import answers, searchlang
from ..knowpro.answer_response_schema import AnswerResponse
from ..knowpro.convsettings import ConversationSettings
from ..knowpro.search_query_schema import SearchQuery
from ..models.result import Failure, Result, Success
from ..models.structured import PromptSection, TypedTranslator
from ..podcasts.podcast import Podcast, PodcastMessage
from ..storage.utils import create_storage_provider
from ..tools import add_device_argument
from ..utils.misc import load_dotenv
from .protocol import McpServer

_EXAMPLE_PODCAST_INDEX = "tests/testdata/Episode_53_AdrianTchaikovsky_index"


class McpSamplingChatModel:
    """Chat model that borrows the MCP client's LLM via sampling."""

    model_name = "mcp-sampling"

    def __init__(self, server: McpServer):
        self.server = server

    async def complete(self, prompt: list[PromptSection]) -> Result[str]:
        if isinstance(prompt, str):
            messages = [
                {"role": "user", "content": {"type": "text", "text": prompt}}
            ]
        else:
            messages = [
                {
                    "role": "user" if s["role"] == "user" else "assistant",
                    "content": {"type": "text", "text": s["content"]},
                }
                for s in prompt
            ]
        try:
            result = await self.server.create_message(messages, max_tokens=4096)
        except Exception as e:
            return Failure(f"MCP sampling failed: {e!r}")
        content = result.get("content")
        if isinstance(content, dict) and content.get("type") == "text":
            return Success(content["text"])
        if isinstance(content, list):
            texts = [c["text"] for c in content if c.get("type") == "text"]
            if texts:
                return Success("\n".join(texts))
        return Failure("No text content in MCP response")


@dataclass
class ProcessingContext:
    conversation: Podcast
    lang_search_options: searchlang.LanguageSearchOptions
    answer_context_options: answers.AnswerContextOptions
    query_translator: TypedTranslator[SearchQuery]
    answer_translator: TypedTranslator[AnswerResponse]


async def make_context(
    server: McpServer,
    dbname: str | None,
    index_path: str | None,
    embedding_model_spec: str | None = None,
    device: str = "cuda",
) -> ProcessingContext:
    """Build the query context; the chat model is the MCP client's via sampling.

    Embeddings still need a real embedding model (MCP has no embedding API).
    """
    if embedding_model_spec:
        from ..models.adapters import create_embedding_model

        settings = ConversationSettings(
            model=create_embedding_model(embedding_model_spec), device=device
        )
    else:
        settings = ConversationSettings(device=device)

    if index_path:
        conversation = await Podcast.read_from_file(index_path, settings)
    else:
        settings.storage_provider = await create_storage_provider(
            settings.message_text_index_settings,
            settings.related_term_index_settings,
            dbname,
            PodcastMessage,
        )
        conversation = await Podcast.create(settings, name=dbname or "memory")

    chat_model = McpSamplingChatModel(server)
    return ProcessingContext(
        conversation=conversation,
        lang_search_options=searchlang.LanguageSearchOptions(
            compile_options=searchlang.LanguageQueryCompileOptions(),
            exact_match=False,
            max_message_matches=25,
        ),
        answer_context_options=answers.AnswerContextOptions(
            entities_top_k=50, topics_top_k=50
        ),
        query_translator=searchlang.create_search_query_translator(chat_model),
        answer_translator=answers.create_answer_translator(chat_model),
    )


@dataclass
class CorpusContext:
    corpus: object  # ConversationCorpus
    lang_search_options: searchlang.LanguageSearchOptions
    answer_context_options: answers.AnswerContextOptions
    query_translator: TypedTranslator[SearchQuery]
    answer_translator: TypedTranslator[AnswerResponse]


async def make_corpus_context(
    server: McpServer,
    corpus_specs: list[str],
    embedding_model_spec: str | None = None,
    device: str = "cuda",
) -> CorpusContext:
    """Load NAME=PATH conversation databases into one ConversationCorpus."""
    import os

    from ..parallel import ConversationCorpus

    def new_settings() -> ConversationSettings:
        if embedding_model_spec:
            from ..models.adapters import create_embedding_model

            return ConversationSettings(
                model=create_embedding_model(embedding_model_spec), device=device
            )
        return ConversationSettings(device=device)

    conversations: dict[str, Podcast] = {}
    for spec in corpus_specs:
        name, sep, path = spec.partition("=")
        if not sep:
            path = spec
            name = os.path.splitext(os.path.basename(spec))[0]
        settings = new_settings()
        settings.storage_provider = await create_storage_provider(
            settings.message_text_index_settings,
            settings.related_term_index_settings,
            path,
            PodcastMessage,
        )
        conversations[name] = await Podcast.create(settings, name=name)

    first = next(iter(conversations.values()))
    probe = await first.secondary_indexes.message_index.generate_embedding("dim")
    corpus = ConversationCorpus(dim=len(probe), device=device)
    for name, conversation in conversations.items():
        await corpus.add_conversation(name, conversation)

    chat_model = McpSamplingChatModel(server)
    return CorpusContext(
        corpus=corpus,
        lang_search_options=searchlang.LanguageSearchOptions(
            compile_options=searchlang.LanguageQueryCompileOptions(),
            exact_match=False,
            max_message_matches=25,
        ),
        answer_context_options=answers.AnswerContextOptions(
            entities_top_k=50, topics_top_k=50
        ),
        query_translator=searchlang.create_search_query_translator(chat_model),
        answer_translator=answers.create_answer_translator(chat_model),
    )


def build_server(args: argparse.Namespace) -> McpServer:
    server = McpServer(
        name="typeagent-tpu",
        instructions=(
            "Query a typeagent-tpu conversation index with natural language."
        ),
    )
    context_holder: dict = {}

    if getattr(args, "corpus", None):

        @server.tool(
            "Answer a natural-language question across ALL loaded "
            "conversations (or a named subset); answers carry conversation "
            "attribution.",
            input_schema={
                "type": "object",
                "properties": {
                    "question": {"type": "string"},
                    "conversations": {
                        "type": "array",
                        "items": {"type": "string"},
                        "description": "Restrict to these conversation names",
                    },
                },
                "required": ["question"],
            },
        )
        async def query_corpus(
            srv: McpServer, question: str, conversations: list | None = None
        ) -> str:
            if "corpus" not in context_holder:
                context_holder["corpus"] = await make_corpus_context(
                    srv, args.corpus, args.embedding_model, args.device
                )
            ctx: CorpusContext = context_holder["corpus"]
            per_conv, combined = await ctx.corpus.query_all(
                question,
                ctx.query_translator,
                ctx.answer_translator,
                ctx.lang_search_options,
                ctx.answer_context_options,
                conversations,
            )
            lines = []
            if combined.type == "Answered" and combined.answer:
                lines.append(combined.answer)
            else:
                lines.append(
                    f"No answer found: {combined.why_no_answer or 'unknown'}"
                )
            for name, answer in sorted(per_conv.items()):
                status = (
                    answer.answer
                    if answer.type == "Answered" and answer.answer
                    else "(no answer)"
                )
                lines.append(f"[{name}] {status}")
            return "\n".join(lines)

    @server.tool(
        "Answer a natural-language question about the loaded conversation.",
        input_schema={
            "type": "object",
            "properties": {"question": {"type": "string"}},
            "required": ["question"],
        },
    )
    async def query_conversation(srv: McpServer, question: str) -> str:
        if "ctx" not in context_holder:
            context_holder["ctx"] = await make_context(
                srv, args.database, args.index_path, args.embedding_model,
                args.device,
            )
        ctx: ProcessingContext = context_holder["ctx"]
        result = await searchlang.search_conversation_with_language(
            ctx.conversation,
            ctx.query_translator,
            question,
            ctx.lang_search_options,
        )
        if isinstance(result, Failure):
            return f"Search failed: {result.message}"
        _, combined = await answers.generate_answers(
            ctx.answer_translator,
            result.value,
            ctx.conversation,
            question,
            options=ctx.answer_context_options,
        )
        if combined.type == "Answered":
            return combined.answer or "No answer provided"
        return f"No answer found: {combined.why_no_answer or 'unknown reason'}"

    async def get_ctx(srv: McpServer) -> ProcessingContext:
        if "ctx" not in context_holder:
            context_holder["ctx"] = await make_context(
                srv, args.database, args.index_path, args.embedding_model,
                args.device,
            )
        return context_holder["ctx"]

    @server.resource(
        "conversation://info",
        "Conversation overview",
        "Name, message/knowledge counts and index sizes of the loaded "
        "conversation.",
        mime_type="application/json",
    )
    async def conversation_info(srv: McpServer) -> str:
        import json

        ctx = await get_ctx(srv)
        conv = ctx.conversation
        secondary = conv.secondary_indexes
        message_index = secondary.message_index if secondary else None
        return json.dumps(
            {
                "name": conv.name_tag,
                "tags": conv.tags,
                "messages": await conv.messages.size(),
                "semanticRefs": await conv.semantic_refs.size(),
                "indexedChunks": (
                    await message_index.size() if message_index else 0
                ),
            }
        )

    @server.resource(
        "conversation://messages/recent",
        "Recent messages",
        "The last few messages of the loaded conversation, speaker-tagged.",
    )
    async def recent_messages(srv: McpServer) -> str:
        ctx = await get_ctx(srv)
        conv = ctx.conversation
        total = await conv.messages.size()
        start = max(0, total - 10)
        lines = []
        for message in await conv.messages.get_slice(start, total):
            speaker = getattr(message.metadata, "speaker", None) or "?"
            text = " ".join(message.text_chunks)[:500]
            lines.append(f"[{speaker}] {text}")
        return "\n".join(lines) or "(conversation is empty)"

    @server.prompt(
        "Ask a question grounded in the loaded conversation index.",
        arguments=[
            {
                "name": "question",
                "description": "The natural-language question to answer",
                "required": True,
            }
        ],
    )
    async def ask_conversation(srv: McpServer, question: str) -> str:
        return (
            "Use the query_conversation tool to answer the following from "
            f"the loaded conversation index, and cite speakers:\n{question}"
        )

    @server.prompt(
        "Summarize what the loaded conversation is about.", arguments=[]
    )
    async def summarize_conversation(srv: McpServer) -> str:
        return (
            "Use the query_conversation tool with the question "
            "'Summarize the conversation' and present the main topics, "
            "participants and conclusions."
        )

    return server


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="typeagent-tpu MCP server (stdio)")
    parser.add_argument("--database", "-d", help="SQLite conversation database")
    parser.add_argument(
        "--index-path",
        "-i",
        help=f"JSON index prefix (e.g. {_EXAMPLE_PODCAST_INDEX})",
    )
    parser.add_argument(
        "--embedding-model",
        help="provider:model embedding spec (use 'test' for offline fake)",
    )
    parser.add_argument(
        "--corpus",
        action="append",
        metavar="NAME=PATH",
        help="Serve MANY conversations as one corpus (repeatable); adds the "
        "query_corpus tool. PATH alone uses the file stem as the name.",
    )
    add_device_argument(parser)
    args = parser.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        # The conversations load at the first tool call; refuse now, as
        # the other entry points refuse at their settings.
        raise RuntimeError(
            "device='cuda' but no CUDA device is available; "
            "pass --device cpu to run the plain PyTorch versions"
        )
    server = build_server(args)
    asyncio.run(server.run_stdio())


if __name__ == "__main__":
    main()
