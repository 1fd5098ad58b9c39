"""WebVTT transcript ingestion.

(Parity: reference transcripts/transcript_ingest.py — voice-tag (<v Speaker>)
and optional text-pattern speaker extraction, consecutive same-speaker merge,
timestamp = base_date + cue offset, Unix-epoch base when unknown, plus
speakers/duration probes.)
The port of ``typeagent_tpu/transcripts/transcript_ingest.py``.
"""

from __future__ import annotations

import os
import re
from datetime import timedelta

from ..knowpro.convsettings import ConversationSettings
from ..knowpro.interfaces import Datetime
from ..knowpro.universal_message import (
    UNIX_EPOCH,
    ConversationMessage,
    ConversationMessageMeta,
    format_timestamp_utc,
)
from ..storage.utils import create_storage_provider
from . import vtt
from .transcript import Transcript

webvtt_timestamp_to_seconds = vtt.timestamp_to_seconds


def extract_speaker_from_text(text: str) -> tuple[str | None, str]:
    """Extract 'SPEAKER:', '[Speaker]', or '- Speaker:' prefixes."""
    text = text.strip()
    match = re.match(r"^([A-Z][A-Z\s]*?):\s*(.*)$", text)
    if match:
        return match.group(1).strip(), match.group(2).strip()
    match = re.match(r"^[\[\(]([^)\]]+)[\]\)]\s*(.*)$", text)
    if match:
        return match.group(1).strip(), match.group(2).strip()
    match = re.match(r"^-\s*([^:]+):\s*(.*)$", text)
    if match:
        return match.group(1).strip(), match.group(2).strip()
    return None, text


def parse_voice_tags(raw_text: str) -> list[tuple[str | None, str]]:
    """Split a cue payload into (speaker, text) segments by <v Speaker> tags."""
    voice_pattern = r"<v\s+([^>]+)>([^<]*(?:</v>)?)"
    matches = list(re.finditer(voice_pattern, raw_text, re.IGNORECASE))
    if not matches:
        return [(None, raw_text.strip())]
    results = []
    for match in matches:
        speaker = match.group(1).strip()
        text = re.sub(r"</v>\s*$", "", match.group(2).strip(), flags=re.IGNORECASE)
        text = text.strip()
        if text:
            results.append((speaker, text))
    return results or [(None, raw_text.strip())]


def parse_vtt_messages(
    captions: list[vtt.Caption],
    base_date: Datetime,
    merge_consecutive_same_speaker: bool = True,
    use_text_based_speaker_detection: bool = False,
) -> list[ConversationMessage]:
    """Turn VTT cues into speaker-merged, absolutely-timestamped messages."""
    messages: list[ConversationMessage] = []
    current_speaker: str | None = None
    current_chunks: list[str] = []
    current_start: str | None = None

    def flush() -> None:
        nonlocal current_chunks, current_start
        if current_chunks and current_start is not None:
            combined = " ".join(current_chunks).strip()
            if combined:
                offset = vtt.timestamp_to_seconds(current_start)
                messages.append(
                    ConversationMessage(
                        text_chunks=[combined],
                        metadata=ConversationMessageMeta(
                            speaker=current_speaker, recipients=[]
                        ),
                        timestamp=format_timestamp_utc(
                            base_date + timedelta(seconds=offset)
                        ),
                    )
                )

    for caption in captions:
        if not caption.text.strip():
            continue
        segments = parse_voice_tags(caption.raw_text)
        if use_text_based_speaker_detection:
            segments = [
                (speaker, text)
                if speaker is not None
                else extract_speaker_from_text(text)
                for speaker, text in segments
            ]
        for speaker, text in segments:
            if not text.strip():
                continue
            if (
                merge_consecutive_same_speaker
                and speaker == current_speaker
                and current_chunks
            ):
                current_chunks.append(text)
            else:
                flush()
                current_speaker = speaker
                current_chunks = [text] if text.strip() else []
                current_start = caption.start
    flush()
    return messages


async def ingest_vtt_transcript(
    vtt_file_path: str,
    settings: ConversationSettings,
    transcript_name: str | None = None,
    start_date: Datetime | None = None,
    merge_consecutive_same_speaker: bool = True,
    use_text_based_speaker_detection: bool = False,
    dbname: str | None = None,
) -> Transcript:
    """Import a WebVTT file into a Transcript object."""
    try:
        captions = vtt.read(vtt_file_path)
    except Exception as e:
        raise RuntimeError(f"Failed to parse VTT file {vtt_file_path}: {e}")

    if not transcript_name:
        transcript_name = os.path.splitext(os.path.basename(vtt_file_path))[0]
    base_date = start_date if start_date is not None else UNIX_EPOCH

    messages = parse_vtt_messages(
        captions,
        base_date,
        merge_consecutive_same_speaker,
        use_text_based_speaker_detection,
    )

    provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        dbname,
        ConversationMessage,
    )
    settings.storage_provider = provider
    transcript = await Transcript.create(
        settings, name=transcript_name, tags=[transcript_name, "vtt-transcript"]
    )
    await transcript.add_messages_with_indexing(messages)
    return transcript


def get_transcript_speakers(
    vtt_file_path: str, use_text_based_detection: bool = False
) -> set[str]:
    """All unique speakers appearing in a VTT file."""
    try:
        captions = vtt.read(vtt_file_path)
    except Exception as e:
        raise RuntimeError(f"Failed to parse VTT file {vtt_file_path}: {e}")
    speakers: set[str] = set()
    for caption in captions:
        for speaker, text in parse_voice_tags(caption.raw_text):
            if speaker is None and use_text_based_detection:
                speaker, _ = extract_speaker_from_text(text)
            if speaker:
                speakers.add(speaker)
    return speakers


def get_transcript_duration(vtt_file_path: str) -> float:
    """Total duration of a VTT transcript in seconds."""
    try:
        captions = vtt.read(vtt_file_path)
    except Exception as e:
        raise RuntimeError(f"Failed to parse VTT file {vtt_file_path}: {e}")
    if not captions:
        return 0.0
    return vtt.timestamp_to_seconds(captions[-1].end)
