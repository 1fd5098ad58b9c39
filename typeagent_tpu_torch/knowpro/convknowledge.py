"""LLM knowledge extractor: conversation text -> KnowledgeResponse JSON.

(Parity role: reference knowpro/convknowledge.py — a structured translator
over the chat model with a conversation-specific request prompt.)

The port of ``typeagent_tpu/knowpro/convknowledge.py``: any ``IChatModel``
passed as ``model=`` works; left out, the default HTTP chat model is built
from the environment.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..models.result import Result, Success
from ..models.structured import TypedTranslator
from . import kplib


def _default_chat_model():
    from ..models.adapters import create_chat_model

    return create_chat_model()


@dataclass
class KnowledgeExtractor:
    model: object = field(default_factory=_default_chat_model)
    max_chars_per_chunk: int = 2048
    merge_action_knowledge: bool = False
    translator: TypedTranslator[kplib.KnowledgeResponse] = field(init=False)

    def __post_init__(self) -> None:
        self.translator = TypedTranslator(
            self.model,
            kplib.KnowledgeResponse,
            type_name="KnowledgeResponse",
            instructions=(
                "You are a service that translates user messages in a "
                'conversation into JSON objects of type "KnowledgeResponse".'
            ),
        )

    async def extract(self, message: str) -> Result[kplib.KnowledgeResponse]:
        result = await self.translator.translate(message)
        if not isinstance(result, Success):
            result.message += f" -- MESSAGE={message!r}"
        return result
