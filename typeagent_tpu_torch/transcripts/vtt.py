"""Minimal WebVTT parser (the webvtt-py package the reference uses is not a
dependency here).

Supports: WEBVTT header (with optional metadata), NOTE/STYLE/REGION blocks
(skipped), optional cue identifiers, "start --> end" timing lines with cue
settings, and multi-line cue payloads. Exposes cues with ``start``, ``end``,
``raw_text`` (tags intact, e.g. <v Speaker>), and ``text`` (tags stripped).
The port of ``typeagent_tpu/transcripts/vtt.py``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_TIMING_RE = re.compile(
    r"^\s*(?P<start>\d{0,2}:?\d{1,2}:\d{2}\.\d{3})\s*-->\s*"
    r"(?P<end>\d{0,2}:?\d{1,2}:\d{2}\.\d{3})"
)
_TAG_RE = re.compile(r"<[^>]*>")


@dataclass
class Caption:
    start: str
    end: str
    raw_text: str

    @property
    def text(self) -> str:
        return _TAG_RE.sub("", self.raw_text)


class WebVTTParseError(Exception):
    pass


def parse(content: str) -> list[Caption]:
    """Parse WebVTT content into cues."""
    lines = content.replace("﻿", "").splitlines()
    if not lines or not lines[0].strip().startswith("WEBVTT"):
        raise WebVTTParseError("Missing WEBVTT header")

    captions: list[Caption] = []
    i = 1
    n = len(lines)
    while i < n:
        line = lines[i].strip()
        if not line:
            i += 1
            continue
        if line.startswith(("NOTE", "STYLE", "REGION")):
            # Skip the block until a blank line.
            while i < n and lines[i].strip():
                i += 1
            continue
        # Optional cue identifier precedes the timing line.
        timing = _TIMING_RE.match(line)
        if timing is None and i + 1 < n:
            next_timing = _TIMING_RE.match(lines[i + 1].strip())
            if next_timing is not None:
                i += 1
                timing = next_timing
        if timing is None:
            i += 1
            continue
        start, end = timing.group("start"), timing.group("end")
        i += 1
        payload: list[str] = []
        while i < n and lines[i].strip():
            payload.append(lines[i].strip())
            i += 1
        captions.append(Caption(start=start, end=end, raw_text="\n".join(payload)))
    return captions


def read(path: str) -> list[Caption]:
    with open(path, encoding="utf-8") as f:
        return parse(f.read())


def timestamp_to_seconds(timestamp: str) -> float:
    """Convert 'HH:MM:SS.mmm' or 'MM:SS.mmm' to seconds."""
    parts = timestamp.split(":")
    if len(parts) == 3:
        hours, minutes, seconds = parts
        return float(hours) * 3600 + float(minutes) * 60 + float(seconds)
    if len(parts) == 2:
        minutes, seconds = parts
        return float(minutes) * 60 + float(seconds)
    return float(timestamp)
