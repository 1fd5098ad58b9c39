"""Person-name splitting and alias collection shared by the domain adapters.

The reference duplicates this logic in `transcripts/transcript.py:238-267`
(split_speaker_name) and `podcasts/podcast.py` (split_participant_name);
here it lives once and Podcast/Transcript both ride it. Semantics match the
reference: names split on whitespace into first/middle/last, a "van" middle
particle merges into the last name, and alias maps link first name <-> full
name in both directions so a search for "kevin" finds "Kevin Scott" and
vice versa.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable


@dataclass
class SpeakerName:
    first_name: str
    last_name: str | None = None
    middle_name: str | None = None


def split_speaker_name(full_name: str) -> SpeakerName | None:
    """Split a display name into first/middle/last parts (None if empty)."""
    parts = full_name.split(None, 2)
    match len(parts):
        case 0:
            return None
        case 1:
            return SpeakerName(first_name=parts[0])
        case 2:
            return SpeakerName(first_name=parts[0], last_name=parts[1])
        case _:
            if parts[1].lower() == "van":
                return SpeakerName(
                    first_name=parts[0], last_name=f"{parts[1]} {parts[2]}"
                )
            return SpeakerName(
                first_name=parts[0],
                middle_name=parts[1],
                last_name=" ".join(parts[2].split()),
            )


def collect_speaker_aliases(names: Iterable[str | None]) -> dict[str, set[str]]:
    """Build the first-name <-> full-name alias map over lowercased names.

    Only full names (first + last present) produce aliases; single-word
    names alias nothing.
    """
    aliases: dict[str, set[str]] = {}
    for name in names:
        if not name:
            continue
        name = name.lower()
        parsed = split_speaker_name(name)
        if parsed and parsed.first_name and parsed.last_name:
            aliases.setdefault(parsed.first_name, set()).add(name)
            aliases.setdefault(name, set()).add(parsed.first_name)
    return aliases
