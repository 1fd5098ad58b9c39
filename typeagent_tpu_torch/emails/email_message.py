"""Email message type with metadata knowledge.

(Parity: reference emails/email_message.py — sender/recipient entities with
email_address facets, sent/received actions in both display-name and address
forms, subject as topic. The emitted entity/action/topic SHAPES are an
extraction contract; construction below is organized around address forms.)

The port of ``typeagent_tpu/emails/email_message.py``: the dataclasses are
``knowpro/fields.py``'s (the standard library's) in place of pydantic's.
"""

from __future__ import annotations

from email.utils import parseaddr

from ..knowpro import kplib
from ..knowpro.fields import dataclass, deserialize_object, field
from ..knowpro.interfaces import IKnowledgeSource, IMessage, IMessageMetadata


def _forms(address: str) -> list[str]:
    """Name forms of one address header: display name and/or bare address."""
    display, bare = parseaddr(address)
    return [form for form in (display, bare) if form]


def _directed(verb: str, actor: str, other: str) -> kplib.Action:
    """A '<actor> <verb> email (to <other>)' action in past tense."""
    return kplib.Action(
        verbs=[verb],
        verb_tense="past",
        subject_entity_name=actor,
        object_entity_name="email",
        indirect_object_entity_name=other,
    )


@dataclass
class EmailMessageMeta(IKnowledgeSource, IMessageMetadata):
    """Metadata for email messages."""

    sender: str
    recipients: list[str] = field(default_factory=list)
    cc: list[str] = field(default_factory=list)
    bcc: list[str] = field(default_factory=list)
    subject: str | None = None
    id: str | None = None

    @property
    def source(self) -> str | None:  # type: ignore[override]
        return self.sender

    @property
    def dest(self) -> str | list[str] | None:  # type: ignore[override]
        return self.recipients

    def get_knowledge(self) -> kplib.KnowledgeResponse:
        return kplib.KnowledgeResponse(
            entities=self.to_entities(),
            actions=self.to_actions(),
            inverse_actions=[],
            topics=self.to_topics(),
        )

    def to_entities(self) -> list[kplib.ConcreteEntity]:
        everyone: list[str] = []
        if self.sender:
            everyone.append(self.sender)
        for header in (self.recipients, self.cc, self.bcc):
            everyone.extend(header or ())
        found: list[kplib.ConcreteEntity] = []
        for raw in everyone:
            found.extend(self._entities_for(raw))
        # The message itself is an entity other knowledge can attach to.
        found.append(kplib.ConcreteEntity(name="email", type=["message"]))
        return found

    def to_topics(self) -> list[str]:
        return [self.subject] if self.subject else []

    def to_actions(self) -> list[kplib.Action]:
        if not self.sender or not self.recipients:
            return []
        out: list[kplib.Action] = []
        sender_forms = _forms(self.sender)
        for recipient in self.recipients:
            recipient_forms = _forms(recipient)
            # Cross product of name forms, sent and received directions.
            out.extend(
                _directed("sent", s, r)
                for s in sender_forms
                for r in recipient_forms
            )
            out.extend(
                _directed("received", r, s)
                for r in recipient_forms
                for s in sender_forms
            )
        return out

    @staticmethod
    def _entities_for(email_address: str) -> list[kplib.ConcreteEntity]:
        display_name, address = parseaddr(email_address)
        out: list[kplib.ConcreteEntity] = []
        if display_name:
            person = kplib.ConcreteEntity(name=display_name, type=["person"])
            if address:
                person.facets = [kplib.Facet(name="email_address", value=address)]
            out.append(person)
        if address:
            out.append(
                kplib.ConcreteEntity(name=address, type=["email_address", "alias"])
            )
        return out


@dataclass
class EmailMessage(IMessage):
    text_chunks: list[str]
    metadata: EmailMessageMeta
    tags: list[str] = field(default_factory=list)
    timestamp: str | None = None
    src_url: str | None = None  # source file or uri
    source_id: str | None = None

    def add_timestamp(self, timestamp: str) -> None:
        self.timestamp = timestamp

    def add_content(self, content: str) -> None:
        if not self.text_chunks:
            self.text_chunks = [content]
        else:
            self.text_chunks[0] += content

    def get_knowledge(self) -> kplib.KnowledgeResponse:
        return self.metadata.get_knowledge()

    def serialize(self) -> dict:
        from ..knowpro.serialization import serialize_object

        return serialize_object(self)

    @staticmethod
    def deserialize(message_data: dict) -> "EmailMessage":
        return deserialize_object(EmailMessage, message_data)
