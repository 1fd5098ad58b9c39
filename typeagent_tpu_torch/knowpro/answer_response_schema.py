"""Answer response schema (parity: reference knowpro/answer_response_schema.py).

The port of ``typeagent_tpu/knowpro/answer_response_schema.py``, on the
port's ``fields.dataclass``."""
#
# NOTE ON SIMILARITY TO THE REFERENCE: this module is a wire/prompt CONTRACT,
# not logic. The field names are the camelCase JSON format shared with the
# reference's serialized data, and the Doc() strings are the literal text the
# LLM sees — changing either would change behavior, so they intentionally
# match the reference schema's semantics word for word.
#

from __future__ import annotations

from typing import Annotated, Literal

from typing_extensions import Doc

from .fields import dataclass

AnswerType = Literal[
    "NoAnswer",  # question cannot be accurately answered from [ANSWER CONTEXT]
    "Answered",  # fully answered
]


@dataclass
class AnswerResponse:
    type: Annotated[
        AnswerType,
        Doc('use "NoAnswer" if no highly relevant answer found in the [ANSWER CONTEXT]'),
    ]
    answer: Annotated[
        str | None,
        Doc(
            "the answer to display if [ANSWER CONTEXT] is highly relevant and "
            "can be used to answer the user's question"
        ),
    ] = None
    why_no_answer: Annotated[
        str | None,
        Doc(
            "If NoAnswer, explain why.. particularly explain why you didn't "
            "use any supplied entities"
        ),
    ] = None
