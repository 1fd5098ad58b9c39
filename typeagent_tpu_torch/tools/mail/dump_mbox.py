"""Dump an mbox mailbox into per-message .eml files.

(Parity role: reference tools/mail/ mbox dumper; the Gmail/Outlook API
dumpers need OAuth'd network access — export those mailboxes to mbox format
first, e.g. via Google Takeout, then run this.)
The port of ``typeagent_tpu/tools/mail/dump_mbox.py`` (the standard library
only; it touches no device).
Run: ``python -m typeagent_tpu_torch.tools.mail.dump_mbox INBOX.mbox out_dir/``.
"""

from __future__ import annotations

import argparse
import hashlib
import mailbox
import os
import re


def safe_filename(message_id: str | None, index: int) -> str:
    if message_id:
        cleaned = re.sub(r"[^A-Za-z0-9_.-]", "_", message_id.strip("<>"))[:120]
        if cleaned:
            return f"{cleaned}.eml"
    return f"message_{index:06d}.eml"


def dump_mbox(
    mbox_path: str,
    out_dir: str,
    limit: int | None = None,
    verbose: bool = False,
) -> int:
    os.makedirs(out_dir, exist_ok=True)
    box = mailbox.mbox(mbox_path)
    count = 0
    seen: set[str] = set()
    for i, message in enumerate(box):
        if limit is not None and count >= limit:
            break
        raw = bytes(message)
        digest = hashlib.sha256(raw).hexdigest()
        if digest in seen:
            continue  # exact duplicate
        seen.add(digest)
        name = safe_filename(message.get("Message-ID"), i)
        path = os.path.join(out_dir, name)
        if os.path.exists(path):
            path = os.path.join(out_dir, f"{digest[:12]}_{name}")
        with open(path, "wb") as f:
            f.write(raw)
        count += 1
        if verbose and count % 100 == 0:
            print(f"dumped {count} messages...")
    if verbose:
        print(f"dumped {count} messages to {out_dir}")
    return count


def main() -> None:
    parser = argparse.ArgumentParser(description="mbox -> .eml dumper")
    parser.add_argument("mbox", help="Path to the mbox file")
    parser.add_argument("out_dir", help="Output directory for .eml files")
    parser.add_argument("--limit", type=int)
    parser.add_argument("--verbose", "-v", action="store_true")
    args = parser.parse_args()
    dump_mbox(args.mbox, args.out_dir, args.limit, args.verbose)


if __name__ == "__main__":
    main()
