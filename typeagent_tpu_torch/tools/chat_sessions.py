"""Browse VS Code Copilot chat sessions — and ingest them as conversations.

(Parity role: reference tools/chat_sessions.py — list/show/search the JSON
chat-session files VS Code stores under workspaceStorage. This version adds
what the reference lacks: ``--ingest DB`` converts a session's turns into
ConversationMessages and indexes them, so chat history becomes a searchable
conversation like any podcast or email corpus.)

The port of ``typeagent_tpu/tools/chat_sessions.py``. ``--device
{cuda,cpu}`` names where the ingested conversation's embedding indexes
live (the card unless ``cpu`` is named).

Usage:
    python -m typeagent_tpu_torch.tools.chat_sessions                 # list sessions
    python -m typeagent_tpu_torch.tools.chat_sessions <file-or-id>    # show one
    python -m typeagent_tpu_torch.tools.chat_sessions -s "query"      # search text
    python -m typeagent_tpu_torch.tools.chat_sessions <file> --ingest chats.db

Only the current JSON session format is parsed (the reference additionally
replays the legacy JSONL patch format).
"""

from __future__ import annotations

import argparse
import asyncio
import datetime
from typing import TYPE_CHECKING
import json
import os
from pathlib import Path

from ..utils.misc import load_dotenv
from . import add_device_argument

if TYPE_CHECKING:
    from ..knowpro.universal_message import ConversationMessage


def default_session_dirs() -> list[Path]:
    """VS Code user-data locations that hold chat sessions."""
    home = Path.home()
    candidates = [
        home / ".config" / "Code" / "User" / "workspaceStorage",  # Linux
        home
        / "Library"
        / "Application Support"
        / "Code"
        / "User"
        / "workspaceStorage",  # macOS
        Path(os.environ.get("APPDATA", "")) / "Code" / "User" / "workspaceStorage",
    ]
    dirs: list[Path] = []
    for base in candidates:
        if not base.is_dir():
            continue
        for workspace in base.iterdir():
            for sub in ("chatSessions", "GitHub.copilot-chat"):
                d = workspace / sub
                if d.is_dir():
                    dirs.append(d)
    return dirs


def find_session_files(roots: list[Path]) -> list[Path]:
    files: list[Path] = []
    for root in roots:
        files.extend(p for p in root.rglob("*.json") if p.is_file())
    files.sort(key=lambda p: p.stat().st_mtime, reverse=True)
    return files


def parse_session(path: Path) -> dict | None:
    """Parse one JSON chat-session file into {id, title, turns}."""
    try:
        data = json.loads(path.read_text(errors="replace"))
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(data, dict) or "requests" not in data:
        return None
    turns = []
    for req in data.get("requests", []):
        if not isinstance(req, dict):
            continue
        user = req.get("message", {}).get("text", "")
        parts = [
            p["value"]
            for p in req.get("response", [])
            if isinstance(p, dict)
            and isinstance(p.get("value"), str)
            and p["value"]
            and p.get("kind") not in ("thinking", "toolInvocationSerialized")
        ]
        turns.append(
            {
                "user": user,
                "assistant": "\n".join(parts),
                "timestamp": req.get("timestamp"),
            }
        )
    return {
        "path": str(path),
        "session_id": data.get("sessionId", path.stem),
        "title": data.get("customTitle") or (turns[0]["user"][:60] if turns else ""),
        "creation_date": data.get("creationDate"),
        "turns": turns,
    }


def _fmt_ts(ms: int | None) -> str:
    if not ms:
        return "-"
    return datetime.datetime.fromtimestamp(ms / 1000).strftime("%Y-%m-%d %H:%M")


def list_sessions(sessions: list[dict], limit: int | None) -> None:
    for i, s in enumerate(sessions[:limit]):
        print(
            f"{i:>3} {s['session_id'][:12]:<13} {_fmt_ts(s['creation_date']):<17} "
            f"{len(s['turns']):>3} turns  {s['title'][:50]}"
        )


def show_session(session: dict) -> None:
    print(f"# {session['title']}  ({session['session_id']})")
    for turn in session["turns"]:
        print(f"\n>>> USER [{_fmt_ts(turn['timestamp'])}]")
        print(turn["user"])
        if turn["assistant"]:
            print("\n<<< ASSISTANT")
            print(turn["assistant"])


def search_sessions(sessions: list[dict], query: str) -> None:
    q = query.lower()
    for s in sessions:
        for i, turn in enumerate(s["turns"]):
            for role in ("user", "assistant"):
                text = turn[role]
                pos = text.lower().find(q)
                if pos >= 0:
                    snippet = text[max(0, pos - 30) : pos + len(q) + 30]
                    snippet = " ".join(snippet.split())
                    print(f"{s['session_id'][:12]} #{i} {role}: ...{snippet}...")
                    break


def session_to_messages(session: dict) -> "list[ConversationMessage]":
    """Convert turns into ConversationMessages (user + assistant speakers)."""
    from ..knowpro.universal_message import (
        ConversationMessage,
        ConversationMessageMeta,
    )

    messages = []
    for i, turn in enumerate(session["turns"]):
        ts = None
        if turn["timestamp"]:
            ts = datetime.datetime.fromtimestamp(
                turn["timestamp"] / 1000, tz=datetime.timezone.utc
            ).strftime("%Y-%m-%dT%H:%M:%SZ")
        for role, text in (("user", turn["user"]), ("assistant", turn["assistant"])):
            if not text.strip():
                continue
            messages.append(
                ConversationMessage(
                    text_chunks=[text],
                    metadata=ConversationMessageMeta(
                        speaker=role,
                        recipients=["assistant" if role == "user" else "user"],
                    ),
                    timestamp=ts,
                    source_id=f"{session['session_id']}#{i}.{role}",
                )
            )
    return messages


async def ingest_session(
    session: dict, dbname: str, embedding_model: str | None, device: str = "cuda"
) -> None:
    from ..knowpro.conversation_base import ConversationBase
    from ..knowpro.convsettings import ConversationSettings
    from ..knowpro.universal_message import ConversationMessage
    from ..storage.utils import create_storage_provider

    if embedding_model:
        from ..models.adapters import create_embedding_model

        settings = ConversationSettings(
            model=create_embedding_model(embedding_model), device=device
        )
    else:
        settings = ConversationSettings(device=device)
    settings.semantic_ref_index_settings.auto_extract_knowledge = False
    settings.storage_provider = await create_storage_provider(
        settings.message_text_index_settings,
        settings.related_term_index_settings,
        dbname,
        ConversationMessage,
    )
    conversation = await ConversationBase.create(
        settings, name=session["title"] or session["session_id"]
    )
    messages = session_to_messages(session)
    done = await conversation.storage_provider.are_sources_ingested(
        [m.source_id for m in messages]
    )
    fresh = [m for m in messages if m.source_id not in done]
    if fresh:
        await conversation.add_messages_with_indexing(fresh)
    print(
        f"Ingested {len(fresh)} new messages "
        f"({len(messages) - len(fresh)} already present) into {dbname}"
    )
    await settings.storage_provider.close()


def main() -> None:
    load_dotenv()
    parser = argparse.ArgumentParser(description="Browse/ingest VS Code chat sessions")
    parser.add_argument("target", nargs="?", help="session file, list index, or id")
    parser.add_argument("--dir", action="append", help="extra session directory")
    parser.add_argument("-n", type=int, default=20, help="list at most N sessions")
    parser.add_argument("--search", "-s", help="search session text")
    parser.add_argument("--ingest", metavar="DB", help="index the session into DB")
    parser.add_argument("--embedding-model", help="provider:model spec")
    add_device_argument(parser)
    args = parser.parse_args()

    roots = [Path(d) for d in args.dir or []] or default_session_dirs()
    if args.target and os.path.isfile(args.target):
        sessions = [s for s in [parse_session(Path(args.target))] if s]
    else:
        sessions = [
            s for s in (parse_session(p) for p in find_session_files(roots)) if s
        ]
        if args.target is not None:
            if args.target.isdigit() and int(args.target) < len(sessions):
                sessions = [sessions[int(args.target)]]
            else:
                sessions = [
                    s for s in sessions if s["session_id"].startswith(args.target)
                ]
    if not sessions:
        print("No chat sessions found")
        return
    if args.search:
        search_sessions(sessions, args.search)
    elif args.ingest:
        asyncio.run(
            ingest_session(sessions[0], args.ingest, args.embedding_model, args.device)
        )
    elif args.target:
        show_session(sessions[0])
    else:
        list_sessions(sessions, args.n)


if __name__ == "__main__":
    main()
