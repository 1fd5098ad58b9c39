"""Message/chunk location helpers (parity: reference knowpro/messageutils.py)."""

from .interfaces import IMessage, MessageOrdinal, TextLocation, TextRange


def text_range_from_message_chunk(
    message_ordinal: MessageOrdinal,
    chunk_ordinal: int = 0,
) -> TextRange:
    """Point range covering one message chunk."""
    return TextRange(start=TextLocation(message_ordinal, chunk_ordinal), end=None)


def get_all_message_chunk_locations[TMessage: IMessage](
    messages: list[TMessage],
    message_ordinal_start_at: MessageOrdinal,
) -> list[TextLocation]:
    """Flatten messages into one TextLocation per chunk."""
    locations: list[TextLocation] = []
    for idx, message in enumerate(messages):
        for chunk_ordinal in range(len(message.text_chunks)):
            locations.append(
                TextLocation(message_ordinal_start_at + idx, chunk_ordinal)
            )
    return locations
