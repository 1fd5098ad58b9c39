"""WebVTT transcript domain adapter (the port of ``typeagent_tpu/transcripts/``)."""

from .transcript import Transcript, TranscriptMessage, TranscriptMessageMeta
from .transcript_ingest import (
    get_transcript_duration,
    get_transcript_speakers,
    ingest_vtt_transcript,
)

__all__ = [
    "Transcript",
    "TranscriptMessage",
    "TranscriptMessageMeta",
    "get_transcript_duration",
    "get_transcript_speakers",
    "ingest_vtt_transcript",
]
