"""Answer context structures sent to the answer LLM (parity: reference
knowpro/answer_context_schema.py).

The port of ``typeagent_tpu/knowpro/answer_context_schema.py``: standard
library dataclasses there and here, so ``answers.dictify`` walks the same
``__annotations__`` in the same order and the context prompt is the same
text."""
#
# NOTE ON SIMILARITY TO THE REFERENCE: this module is a wire/prompt CONTRACT,
# not logic. The field names are the camelCase JSON format shared with the
# reference's serialized data, and the Doc() strings are the literal text the
# LLM sees — changing either would change behavior, so they intentionally
# match the reference schema's semantics word for word.
#

from __future__ import annotations

from dataclasses import dataclass
from typing import Annotated, Any, Union

from typing_extensions import Doc

from .interfaces import DateRange

EntityNames = Union[str, list[str]]


@dataclass
class RelevantKnowledge:
    # One merged knowledge item (entity or topic) plus its provenance.
    # answers.py builds these from merged semrefs: `origin`/`audience` come
    # from the source messages' speaker/recipients, `time_range` from the
    # enclosing message timestamps.
    knowledge: Annotated[Any, Doc("The actual knowledge")]
    origin: Annotated[
        EntityNames | None, Doc("Entity or entities who mentioned the knowledge")
    ] = None
    audience: Annotated[
        EntityNames | None,
        Doc("Entity or entities who received or consumed this knowledge"),
    ] = None
    time_range: Annotated[
        DateRange | None, Doc("Time period during which this knowledge was gathered")
    ] = None


@dataclass
class RelevantMessage:
    # `from_` serializes as "from" (python keyword); see fields.py aliasing.
    from_: Annotated[EntityNames | None, Doc("Sender(s) of the message")]
    to: Annotated[EntityNames | None, Doc("Recipient(s) of the message")]
    timestamp: Annotated[str | None, Doc("Timestamp of the message in ISO format")]
    message_text: Annotated[str | list[str] | None, Doc("Text chunks in this message")]


@dataclass
class AnswerContext:
    # The full [ANSWER CONTEXT] payload pprint'ed into the stage-4 prompt
    # (create_context_prompt). Order matters only for prompt readability.
    """Use empty lists for unneeded properties."""

    entities: Annotated[
        list[RelevantKnowledge],
        Doc(
            "Relevant entities. Use the 'name' and 'type' properties of "
            "entities to PRECISELY identify those that answer the user question."
        ),
    ]
    topics: Annotated[list[RelevantKnowledge], Doc("Relevant topics")]
    messages: Annotated[list[RelevantMessage], Doc("Relevant messages")]
