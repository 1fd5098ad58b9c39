"""Corpus-of-conversations search over one mesh-sharded fragment matrix.

BASELINE.json config #5 integrated with the conversation stack: every
registered conversation's message-chunk embeddings live in ONE row-sharded
device matrix (`CorpusVectorStore`), so a query can search one conversation,
a set, or the whole corpus with the same fused SPMD program — scoped search
is EXACT via device segment masks.

This is the multi-tenant replacement for the reference's one-VectorBase-per-
conversation design (`aitools/vectorbase.py:82`): instead of N small
host-RAM matrices scanned serially, N conversations share one HBM-resident
matrix across the mesh.

The port of ``typeagent_tpu/parallel/conversation_corpus.py``: ``mesh=``
(``parallel.mesh.Mesh``) names the devices the matrix shards over, or
``device=`` the one device (or ``"cpu"``) it lives on; each shard runs K1
for a global search and K4 over its part of the conversations' interval
table for a scoped one. :meth:`ConversationCorpus.save` and
:meth:`ConversationCorpus.load` checkpoint the mirror through
``parallel/checkpoint.py`` and restore it onto any mesh shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..knowpro.interfaces import IConversation, ScoredMessageOrdinal, TextLocation
from .corpus import CorpusVectorStore
from .mesh import Mesh, single_device_mesh

if TYPE_CHECKING:
    import os

    from ..knowpro.answer_response_schema import AnswerResponse
    from ..knowpro.answers import AnswerContextOptions
    from ..knowpro.search_query_schema import SearchQuery
    from ..knowpro.searchlang import LanguageSearchOptions, SearchQueryTranslator
    from ..models.structured import TypedTranslator

__all__ = ["ConversationCorpus", "CorpusMessageHit"]


@dataclass
class CorpusMessageHit:
    conversation: str
    message_ordinal: int
    chunk_ordinal: int
    score: float


class ConversationCorpus:
    """Cross-conversation message-text search on a device mesh.

    Conversations keep their own indexes/storage; the corpus mirrors their
    message-chunk embeddings into the shared sharded matrix. ``refresh()``
    folds in chunks indexed since the last sync (append-only, no rebuild).
    """

    def __init__(
        self,
        dim: int,
        mesh: Mesh | None = None,
        dtype: str | torch.dtype | None = None,
        *,
        device: str | torch.device = "cuda",
    ):
        self._store = CorpusVectorStore(dim, device=device, dtype=dtype, mesh=mesh)
        self._conversations: dict[str, IConversation] = {}
        self._locations: dict[str, list[TextLocation]] = {}
        self._synced_counts: dict[str, int] = {}
        self._embedder = None  # first conversation's message index embeds

    @property
    def conversations(self) -> list[str]:
        return list(self._conversations)

    def _message_index(self, conversation: IConversation):
        secondary = conversation.secondary_indexes
        index = secondary.message_index if secondary else None
        if index is None:
            raise ValueError("conversation has no message text index")
        return index

    async def add_conversation(self, name: str, conversation: IConversation) -> None:
        if name in self._conversations:
            raise ValueError(f"conversation {name!r} already registered")
        self._conversations[name] = conversation
        self._locations.setdefault(name, [])
        self._synced_counts.setdefault(name, 0)
        if self._embedder is None:
            self._embedder = self._message_index(conversation)
        await self.refresh(name)

    # -- persistence (see parallel/checkpoint.py) -----------------------------

    def save(self, path: str | os.PathLike) -> None:
        """Checkpoint the mirror (the sharded matrix + location/sync tables).

        After :meth:`load`, re-attach live conversations with
        :meth:`add_conversation`: already mirrored rows are NOT uploaded
        again (refresh resumes from the restored sync watermarks).
        """
        from .checkpoint import save_corpus

        save_corpus(
            self._store,
            path,
            extra_meta={
                "mirror_locations": {
                    name: [[loc.message_ordinal, loc.chunk_ordinal] for loc in locs]
                    for name, locs in self._locations.items()
                },
                "mirror_synced": dict(self._synced_counts),
            },
        )

    @classmethod
    def load(
        cls, path: str | os.PathLike, mesh: Mesh | None = None, *,
        device: str | torch.device = "cuda",
    ) -> "ConversationCorpus":
        """Restore a mirror checkpoint onto ``mesh`` (any shape), or onto
        the one ``device``."""
        from .checkpoint import _read_meta, restore_corpus

        meta = _read_meta(path)
        corpus = cls.__new__(cls)
        corpus._store = restore_corpus(mesh or single_device_mesh(device), path)
        corpus._conversations = {}
        corpus._locations = {
            name: [TextLocation(m, c) for m, c in pairs]
            for name, pairs in meta.get("mirror_locations", {}).items()
        }
        corpus._synced_counts = dict(meta.get("mirror_synced", {}))
        corpus._embedder = None
        return corpus

    async def refresh(self, name: str | None = None) -> int:
        """Mirror newly indexed chunks into the shared matrix.

        Returns the number of fragment rows appended.
        """
        names = [name] if name is not None else list(self._conversations)
        appended = 0
        for conv_name in names:
            conversation = self._conversations[conv_name]
            index = self._message_index(conversation)
            if hasattr(index, "text_location_index"):
                # Memory backend: TextToTextLocationIndex over a VectorStore.
                tli = index.text_location_index
                total = await tli.size()
                synced = self._synced_counts[conv_name]
                if total <= synced:
                    continue
                # Ranged copy: O(new rows), not a full-store serialize.
                rows = tli._embedding_index.host_rows(synced, total)
                locations = [tli.get(pos) for pos in range(synced, total)]
            else:
                # SQLite backend: VectorStore + parallel (msg, chunk) list.
                total = await index.size()
                synced = self._synced_counts[conv_name]
                if total <= synced:
                    continue
                rows = index._vectorbase.host_rows(synced, total)
                locations = [
                    TextLocation(msg, chunk)
                    for msg, chunk in index._locations[synced:total]
                ]
            self._store.append(conv_name, np.asarray(rows, dtype=np.float32))
            self._locations[conv_name].extend(locations)
            self._synced_counts[conv_name] = total
            appended += total - synced
        return appended

    async def search_text(
        self,
        text: str,
        k: int = 10,
        conversations: list[str] | None = None,
        min_score: float = 0.0,
    ) -> list[CorpusMessageHit]:
        """Embed a query and search the corpus (optionally scoped)."""
        if self._embedder is None:
            return []
        embedding = await self._embedder.generate_embedding(text)
        return self.search_embedding(
            np.asarray(embedding, dtype=np.float32),
            k=k,
            conversations=conversations,
            min_score=min_score,
        )

    def search_embedding(
        self,
        embedding: np.ndarray,
        k: int = 10,
        conversations: list[str] | None = None,
        min_score: float = 0.0,
    ) -> list[CorpusMessageHit]:
        raw = self._store.search(
            embedding.reshape(1, -1), k, conversations=conversations,
            min_score=min_score,
        )[0]
        hits = []
        for h in raw:
            location = self._locations[h.conversation][h.local_ordinal]
            hits.append(
                CorpusMessageHit(
                    h.conversation,
                    location.message_ordinal,
                    location.chunk_ordinal,
                    h.score,
                )
            )
        return hits

    # -- full NL query across the corpus ---------------------------------------

    async def query_all(
        self,
        question: str,
        query_translator: SearchQueryTranslator,
        answer_translator: TypedTranslator[AnswerResponse],
        search_options: LanguageSearchOptions | None = None,
        answer_options: AnswerContextOptions | None = None,
        conversations: list[str] | None = None,
    ) -> tuple[dict[str, AnswerResponse], AnswerResponse]:
        """Four-stage NL query across every (or selected) conversation.

        Stage 1 (LLM translation) runs ONCE and is reused for every
        conversation via the debug context; stages 2-3 compile and execute
        per conversation through its own engine (device executor by
        default); stage 4 answers per conversation, then combines the good
        answers with conversation attribution.

        Returns ``(per_conversation_answers, combined_answer)`` where the
        first is ``{name: AnswerResponse}``. (No reference equivalent — it
        has no multi-conversation API at all.)
        """
        from ..knowpro import answers as answers_mod
        from ..knowpro import searchlang
        from ..models.result import Success

        names = conversations or self.conversations
        per_conversation: dict[str, object] = {}
        shared_query = None
        results_by_conv: dict[str, list] = {}
        for name in names:
            conv = self._conversations[name]
            debug = searchlang.LanguageSearchDebugContext()
            if shared_query is not None:
                debug.use_search_query = shared_query
            result = await searchlang.search_conversation_with_language(
                conv, query_translator, question, search_options,
                debug_context=debug,
            )
            if not isinstance(result, Success):
                continue
            if shared_query is None:
                shared_query = debug.search_query
            results_by_conv[name] = result.value

        good: list[tuple[str, str]] = []
        for name, results in results_by_conv.items():
            conv = self._conversations[name]
            _, combined = await answers_mod.generate_answers(
                answer_translator, results, conv, question,
                options=answer_options,
            )
            per_conversation[name] = combined
            if combined.type == "Answered" and combined.answer:
                good.append((name, combined.answer))

        if not good:
            combined_answer = answers_mod.AnswerResponse(
                type="NoAnswer",
                why_no_answer="No conversation produced an answer.",
            )
        elif len(good) == 1:
            combined_answer = answers_mod.AnswerResponse(
                type="Answered", answer=good[0][1]
            )
        else:
            combined_answer = await answers_mod.combine_answers(
                answer_translator,
                [f"[from {name}] {answer}" for name, answer in good],
                question,
            )
        return per_conversation, combined_answer

    @staticmethod
    def merge_by_message(
        hits: list[CorpusMessageHit],
    ) -> list[tuple[str, ScoredMessageOrdinal]]:
        """Max-merge chunk hits per (conversation, message) — the same rule
        MessageTextIndex applies within one conversation."""
        best: dict[tuple[str, int], float] = {}
        order: list[tuple[str, int]] = []
        for h in hits:
            key = (h.conversation, h.message_ordinal)
            if key not in best:
                best[key] = h.score
                order.append(key)
            elif h.score > best[key]:
                best[key] = h.score
        merged = [
            (conv, ScoredMessageOrdinal(msg, best[(conv, msg)]))
            for conv, msg in order
        ]
        merged.sort(key=lambda pair: -pair[1].score)
        return merged
