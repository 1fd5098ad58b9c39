"""Conversation prompt helpers (parity: reference knowpro/convutils.py).

The port of ``typeagent_tpu/knowpro/convutils.py``; the prompt text is the
JAX package's, byte for byte."""

from __future__ import annotations

from ..models.structured import PromptSection
from .interfaces import (
    DateRange,
    Datetime,
    IConversation,
    IMessage,
    ITermToSemanticRefIndex,
)


def _naive_iso(dt: Datetime) -> str:
    return dt.replace(tzinfo=None).isoformat()


async def get_time_range_for_conversation[
    TMessage: IMessage, TIndex: ITermToSemanticRefIndex
](conversation: IConversation[TMessage, TIndex]) -> DateRange | None:
    """The conversation's display span. NOT for index lookups: the end is the
    last message's own (inclusive-looking) timestamp, while DateRange is
    half-open."""
    messages = conversation.messages
    size = await messages.size()
    if size == 0:
        return None
    start = (await messages.get_item(0)).timestamp
    if start is None:
        return None
    end = (await messages.get_item(size - 1)).timestamp
    return DateRange(
        start=Datetime.fromisoformat(start),
        end=Datetime.fromisoformat(end) if end else None,
    )


async def get_time_range_prompt_section_for_conversation[
    TMessage: IMessage, TIndex: ITermToSemanticRefIndex
](conversation: IConversation[TMessage, TIndex]) -> PromptSection | None:
    time_range = await get_time_range_for_conversation(conversation)
    if time_range is None:
        return None
    span = (
        f"{_naive_iso(time_range.start)} to "
        f"{_naive_iso(time_range.end) if time_range.end else 'now'}"
    )
    return PromptSection(
        role="system",
        content=(
            "ONLY IF user request explicitly asks for time ranges, THEN "
            f'use the CONVERSATION TIME RANGE: "{span}"'
        ),
    )
