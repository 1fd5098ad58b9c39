"""Universal conversation message (transcripts, podcasts, chats, emails).

The port of ``typeagent_tpu/knowpro/universal_message.py``; ``recipients``
is written as ``listeners`` and read under either name, as the JAX
package's pydantic aliases do. (Parity: reference knowpro/universal_message.py — including the "listeners"
serialization alias for recipients, UTC-Z timestamps, and metadata knowledge:
person entities + say/speak actions.)
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import TypedDict

from . import kplib
from .fields import dataclass, deserialize_object, field

from .interfaces import IKnowledgeSource, IMessage, IMessageMetadata

# Unix epoch sentinel for unknown dates.
UNIX_EPOCH = datetime(1970, 1, 1, 0, 0, 0, tzinfo=timezone.utc)


def format_timestamp_utc(dt: datetime) -> str:
    """ISO 8601 with explicit Z suffix; requires a timezone-aware datetime."""
    if dt.tzinfo is None:
        raise ValueError(
            f"format_timestamp_utc needs an aware datetime, not {dt!r}; "
            "attach tzinfo (e.g. timezone.utc) before formatting"
        )
    as_utc = dt if dt.tzinfo == timezone.utc else dt.astimezone(timezone.utc)
    text = as_utc.isoformat()
    return text.removesuffix("+00:00") + "Z" if text.endswith("+00:00") else text


def _person(name: str) -> kplib.ConcreteEntity:
    return kplib.ConcreteEntity(name=name, type=["person"])


def _say_action(speaker: str, target: str, verbs: list[str]) -> kplib.Action:
    return kplib.Action(
        verbs=verbs,
        verb_tense="past",
        subject_entity_name=speaker,
        object_entity_name=target,
        indirect_object_entity_name="none",
    )


@dataclass
class ConversationMessageMeta(IKnowledgeSource, IMessageMetadata):
    """Universal metadata: speaker + recipients (serialized as 'listeners')."""

    speaker: str | None = None
    recipients: list[str] = field(
        default_factory=list,
        serialization_alias="listeners",
        validation_alias=("recipients", "listeners"),
    )

    @property
    def source(self) -> str | None:  # type: ignore[override]
        return self.speaker

    @property
    def dest(self) -> list[str] | None:  # type: ignore[override]
        return self.recipients or None

    def get_knowledge(self) -> kplib.KnowledgeResponse:
        """Person entities for speaker/recipients + say/speak actions.

        The entity/action shapes here are a serialization + extraction
        contract: "say" toward each recipient when there are any, a single
        "say"+"speak" broadcast action otherwise.
        """
        if not self.speaker:
            return kplib.KnowledgeResponse(
                entities=[], actions=[], inverse_actions=[], topics=[]
            )
        people = [_person(self.speaker)] + [_person(r) for r in self.recipients]
        if self.recipients:
            spoken = [
                _say_action(self.speaker, r, ["say"]) for r in self.recipients
            ]
        else:
            spoken = [_say_action(self.speaker, "none", ["say", "speak"])]
        return kplib.KnowledgeResponse(
            entities=people, actions=spoken, inverse_actions=[], topics=[]
        )


class ConversationMessageMetaData(TypedDict):
    speaker: str | None
    listeners: list[str]


class ConversationMessageData(TypedDict):
    metadata: ConversationMessageMetaData
    textChunks: list[str]
    tags: list[str]
    timestamp: str | None


@dataclass
class ConversationMessage(IMessage):
    """Universal message for any conversation type."""

    text_chunks: list[str]
    metadata: ConversationMessageMeta
    tags: list[str] = field(default_factory=list)
    # ISO 8601 UTC-Z; Unix epoch sentinel when the source has no dates.
    timestamp: str | None = None
    source_id: str | None = None

    def add_timestamp(self, timestamp: str) -> None:
        self.timestamp = timestamp

    def add_content(self, content: str) -> None:
        self.text_chunks[0] += content

    def get_knowledge(self) -> kplib.KnowledgeResponse:
        return self.metadata.get_knowledge()

    def serialize(self) -> ConversationMessageData:
        from .serialization import serialize_object

        return serialize_object(self)

    @staticmethod
    def deserialize(message_data: ConversationMessageData) -> "ConversationMessage":
        return deserialize_object(ConversationMessage, message_data)
