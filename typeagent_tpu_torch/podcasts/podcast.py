"""Podcast conversation type.

(Parity: reference podcasts/podcast.py — Podcast = ConversationBase over
universal ConversationMessage, with JSON file snapshots, participant-name
aliases (first name <-> full name), and speech-verb synonyms loaded into the
alias table.)
The port of ``typeagent_tpu/podcasts/podcast.py``.
"""

from __future__ import annotations

import json
import os

from ..knowpro import secindex
from ..knowpro.conversation_base import ConversationBase
from ..knowpro.convfiles import FileSerializedConversation
from ..knowpro.interfaces import Term
from ..knowpro.nameutils import SpeakerName, collect_speaker_aliases, split_speaker_name
from ..knowpro.universal_message import ConversationMessage, ConversationMessageMeta

PodcastMessage = ConversationMessage
PodcastMessageMeta = ConversationMessageMeta


class Podcast(FileSerializedConversation, ConversationBase[PodcastMessage]):
    """Podcast conversation with incremental indexing support."""

    message_type = PodcastMessage

    async def _after_deserialize(self, rebuild_related_terms: bool) -> None:
        if rebuild_related_terms:
            await self._build_participant_aliases()
            await self._add_synonyms()

    async def build_participant_aliases(self) -> None:
        await self._build_participant_aliases()
        await self._add_synonyms()

    async def _build_participant_aliases(self) -> None:
        secondary_indexes = self._get_secondary_indexes()
        index = secondary_indexes.term_to_related_terms_index
        assert index is not None
        aliases = index.aliases
        await aliases.clear()
        name_to_alias_map = await self._collect_participant_aliases()
        for name, alias_set in name_to_alias_map.items():
            await aliases.add_related_term(
                name, [Term(text=alias) for alias in alias_set]
            )

    async def _add_synonyms(self) -> None:
        secondary_indexes = self._get_secondary_indexes()
        assert secondary_indexes.term_to_related_terms_index is not None
        aliases = secondary_indexes.term_to_related_terms_index.aliases
        synonym_file = os.path.join(os.path.dirname(__file__), "podcastVerbs.json")
        with open(synonym_file) as f:
            data: list[dict] = json.load(f)
        for obj in data or []:
            text = obj.get("term")
            synonyms = obj.get("relatedTerms")
            if text and synonyms:
                related_term = Term(text=text.lower())
                for synonym in synonyms:
                    await aliases.add_related_term(synonym.lower(), related_term)

    async def _collect_participant_aliases(self) -> dict[str, set[str]]:
        # Podcasts alias every participant: speakers AND their listeners.
        names: list[str | None] = []
        async for message in self.messages:
            names.append(message.metadata.speaker)
            names.extend(message.metadata.recipients)
        return collect_speaker_aliases(names)

    async def _build_transient_secondary_indexes(self, build_all: bool) -> None:
        if build_all:
            await secindex.build_transient_secondary_indexes(self, self.settings)
        await self._build_participant_aliases()
        await self._add_synonyms()


# Historical names for the shared helpers (knowpro/nameutils.py).
ParticipantName = SpeakerName
split_participant_name = split_speaker_name
