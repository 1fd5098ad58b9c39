"""Print each .eml file's Date header as a hex-encoded POSIX timestamp.

(Parity: reference tools/mail/pt.py — used to spot-order dumped mailboxes;
the value is milliseconds-since-epoch shifted left 20 bits, the reference's
sortable-id convention.) Run:
``python -m typeagent_tpu_torch.tools.mail.print_timestamps mail_dump/``
or pass individual ``.eml`` paths. The port of
``typeagent_tpu/tools/mail/print_timestamps.py`` (the standard library
only; it touches no device).
"""

from __future__ import annotations

import argparse
import email
import email.utils
import sys
from pathlib import Path


def hex_timestamp(date_header: str | None) -> str:
    parsed = email.utils.parsedate_tz(date_header or "")
    if parsed is None:
        return "?" * 8
    return f"{int(email.utils.mktime_tz(parsed)) * 1000 << 20:016x}"


def iter_eml_paths(args: list[str]) -> list[Path]:
    paths: list[Path] = []
    for arg in args:
        p = Path(arg)
        if p.is_dir():
            paths.extend(sorted(p.glob("*.eml")))
        else:
            paths.append(p)
    return paths


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Print .eml Date headers as sortable hex timestamps."
    )
    parser.add_argument(
        "paths", nargs="+", help=".eml files and/or directories of .eml files"
    )
    opts = parser.parse_args()
    for path in iter_eml_paths(opts.paths):
        try:
            with open(path, "rb") as f:
                msg = email.message_from_binary_file(f)
        except OSError as exc:
            print(f"{'!' * 16}  {path}: {exc}", file=sys.stderr)
            continue
        print(f"{hex_timestamp(msg['Date'])}  {path}")


if __name__ == "__main__":
    main()
