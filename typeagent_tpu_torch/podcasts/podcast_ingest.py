"""Podcast transcript ingestion.

(Parity: reference podcasts/podcast_ingest.py — speaker-colon turn parsing,
all-other-participants become listeners, proportional timestamp allocation by
text length, source_id = 'path#i', streaming ingestion with per-batch commit
callback; Unix-epoch base date when unknown.)
The port of ``typeagent_tpu/podcasts/podcast_ingest.py``.
"""

from __future__ import annotations

import os
import re
import time
from collections.abc import AsyncIterator
from datetime import timedelta

from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import AddMessagesResult, Datetime
from ..knowpro.universal_message import UNIX_EPOCH, format_timestamp_utc
from ..storage.utils import create_storage_provider
from .podcast import Podcast, PodcastMessage, PodcastMessageMeta

# Speaker turns look like "SPEAKER NAME: speech..." with uppercase speaker
# labels; continuation lines have no speaker prefix.
_TURN_RE = re.compile(
    r"""(?x)
    ^
    (?:
        \s*
        (?P<speaker>[A-Z0-9]+(?:\s+[A-Z0-9]+)*)
        \s* : \s*
    )?
    (?P<speech>(?:.*\S)?)
    \s*
    $
    """
)


def parse_podcast_transcript(transcript_lines: list[str]) -> list[PodcastMessage]:
    """Parse speaker-turn lines into messages (no timestamps/listeners yet)."""
    participants: set[str] = set()
    cur_msg: PodcastMessage | None = None
    msgs: list[PodcastMessage] = []
    for line in transcript_lines:
        match = _TURN_RE.match(line)
        if not match:
            continue
        speaker = match.group("speaker")
        if speaker:
            speaker = speaker.lower()
        speech = match.group("speech")
        if not (speaker or speech):
            continue
        if cur_msg:
            if not speaker:
                cur_msg.add_content("\n" + speech)
            else:
                msgs.append(cur_msg)
                cur_msg = None
        if not cur_msg:
            if speaker:
                participants.add(speaker)
            cur_msg = PodcastMessage(
                [speech], PodcastMessageMeta(speaker=speaker, recipients=[])
            )
    if cur_msg:
        msgs.append(cur_msg)
    assign_message_listeners(msgs, participants)
    return msgs


def assign_message_listeners(
    msgs: list[PodcastMessage], participants: set[str]
) -> None:
    """Each message's listeners = all participants except the speaker."""
    for msg in msgs:
        if msg.metadata.speaker:
            msg.metadata.recipients = [
                p for p in participants if p != msg.metadata.speaker
            ]


def assign_timestamps_proportionally(
    msgs: list[PodcastMessage],
    base_date: Datetime,
    length_minutes: float,
) -> None:
    """Allocate podcast time proportionally to each message's text length."""
    if not msgs:
        return
    message_lengths = [sum(len(c) for c in msg.text_chunks) for msg in msgs]
    total_length = sum(message_lengths)
    if total_length == 0:
        timestamp = format_timestamp_utc(base_date)
        for msg in msgs:
            msg.timestamp = timestamp
        return
    seconds_per_char = (length_minutes * 60.0) / total_length
    offset = 0.0
    for msg, length in zip(msgs, message_lengths):
        msg.timestamp = format_timestamp_utc(base_date + timedelta(seconds=offset))
        offset += seconds_per_char * length


async def ingest_podcast(
    transcript_file_path: str,
    settings: ConversationSettings,
    podcast_name: str | None = None,
    start_date: Datetime | None = None,
    length_minutes: float = 60.0,
    dbname: str | None = None,
    batch_size: int = 0,
    start_message: int = 0,
    concurrency: int = 0,
    verbose: bool = False,
) -> Podcast:
    """Ingest a podcast transcript file into a Podcast object."""
    with open(transcript_file_path, "r") as f:
        transcript_lines = f.readlines()
    if not podcast_name:
        podcast_name = os.path.splitext(os.path.basename(transcript_file_path))[0]
    base_date = start_date if start_date is not None else UNIX_EPOCH

    msgs = parse_podcast_transcript(transcript_lines)
    assign_timestamps_proportionally(msgs, base_date, length_minutes)

    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        dbname,
        PodcastMessage,
    )
    settings.storage_provider = provider
    if (msg_size := await provider.messages.size()) > start_message:
        raise RuntimeError(
            f"{dbname!r} has {msg_size} messages; start_message "
            f"({start_message}) should be at least that."
        )

    pod = await Podcast.create(settings, name=podcast_name, tags=[podcast_name])

    for i, msg in enumerate(msgs):
        msg.source_id = f"{transcript_file_path}#{i}"

    if concurrency:
        settings.semantic_ref_index_settings.concurrency = concurrency

    async def _message_stream() -> AsyncIterator[PodcastMessage]:
        for msg in msgs[start_message:]:
            yield msg

    cumulative = 0
    t0 = time.time()

    def _on_batch_committed(result: AddMessagesResult) -> None:
        nonlocal cumulative
        batch_start = cumulative
        cumulative += result.messages_added
        if verbose:
            print(
                f"Indexed messages {batch_start}-{cumulative - 1} "
                f"({result.chunks_added} chunks, {result.semrefs_added} semrefs) "
                f"at t={time.time() - t0:.1f} seconds."
            )

    batch_size = batch_size or len(msgs)
    result = await pod.add_messages_streaming(
        _message_stream(),
        batch_size=batch_size,
        on_batch_committed=_on_batch_committed,
    )
    if verbose:
        print(
            f"Indexed {result.messages_added} messages "
            f"({result.chunks_added} chunks, {result.semrefs_added} semrefs) "
            f"in {time.time() - t0:.1f} seconds."
        )
    return pod
