"""Transcript conversation type (parity: reference transcripts/transcript.py).

Like the reference (transcript.py:198-232), a Transcript maintains
speaker-name aliases in the related-terms alias table: "kevin" <-> "kevin
scott" in both directions, collected from message speakers only (podcasts
additionally alias listeners). Aliases are rebuilt after ingest and after
deserializing a snapshot that carried no related-terms index.
The port of ``typeagent_tpu/transcripts/transcript.py``.
"""

from __future__ import annotations

from ..knowpro import secindex
from ..knowpro.conversation_base import ConversationBase
from ..knowpro.convfiles import FileSerializedConversation
from ..knowpro.interfaces import Term
from ..knowpro.nameutils import collect_speaker_aliases
from ..knowpro.universal_message import ConversationMessage, ConversationMessageMeta

TranscriptMessage = ConversationMessage
TranscriptMessageMeta = ConversationMessageMeta


class Transcript(FileSerializedConversation, ConversationBase[TranscriptMessage]):
    """Transcript conversation with incremental indexing support."""

    message_type = TranscriptMessage

    async def _after_deserialize(self, rebuild_related_terms: bool) -> None:
        if rebuild_related_terms:
            await self._build_speaker_aliases()

    async def build_speaker_aliases(self) -> None:
        await self._build_speaker_aliases()

    async def _build_speaker_aliases(self) -> None:
        secondary_indexes = self._get_secondary_indexes()
        index = secondary_indexes.term_to_related_terms_index
        assert index is not None
        aliases = index.aliases
        await aliases.clear()
        names = [m.metadata.speaker async for m in self.messages]
        for name, alias_set in collect_speaker_aliases(names).items():
            await aliases.add_related_term(
                name, [Term(text=alias) for alias in alias_set]
            )

    async def _build_transient_secondary_indexes(self, build_all: bool) -> None:
        if build_all:
            await secindex.build_transient_secondary_indexes(self, self.settings)
        await self._build_speaker_aliases()
