"""MIME email import: .eml files -> EmailMessage objects.

(Parity: reference emails/email_import.py — RFC2047 header decoding,
reply/forward thread splitting, charset-tolerant body extraction, paragraph
chunking to 4096 chars.)

The port of ``typeagent_tpu/emails/email_import.py`` (the standard
library's ``email`` package, the same code).
"""

from __future__ import annotations

import re
from collections.abc import Iterable
from email import message_from_string
from email.header import decode_header
from email.message import Message
from email.utils import parsedate_to_datetime
from pathlib import Path

from .email_message import EmailMessage, EmailMessageMeta

DEFAULT_MAX_CHUNK_LENGTH = 4096


def decode_encoded_words(text: str) -> str:
    """Decode RFC2047 encoded words (=?utf-8?...?=) in a header string."""
    try:
        parts = decode_header(text)
    except Exception:
        return text
    decoded = []
    for value, charset in parts:
        if isinstance(value, bytes):
            try:
                decoded.append(value.decode(charset or "latin-1", errors="replace"))
            except LookupError:
                decoded.append(value.decode("latin-1", errors="replace"))
        else:
            decoded.append(value)
    return "".join(decoded)


def import_emails_from_dir(
    dir_path: str, max_chunk_length: int = DEFAULT_MAX_CHUNK_LENGTH
) -> Iterable[EmailMessage]:
    for file_path in Path(dir_path).iterdir():
        if file_path.is_file():
            yield import_email_from_file(str(file_path.resolve()), max_chunk_length)


def import_email_from_file(
    file_path: str, max_chunk_length: int = DEFAULT_MAX_CHUNK_LENGTH
) -> EmailMessage:
    with open(file_path, "r") as f:
        email_string = f.read()
    email = import_email_string(email_string, max_chunk_length)
    email.src_url = file_path
    return email


def import_email_string(
    email_string: str, max_chunk_length: int = DEFAULT_MAX_CHUNK_LENGTH
) -> EmailMessage:
    return import_email_message(message_from_string(email_string), max_chunk_length)


def import_forwarded_email_string(
    email_string: str, max_chunk_length: int = DEFAULT_MAX_CHUNK_LENGTH
) -> list[EmailMessage]:
    parts = get_forwarded_email_parts(email_string)
    return [import_email_string(p, max_chunk_length) for p in parts if p]


def import_email_message(msg: Message, max_chunk_length: int) -> EmailMessage:
    """Message object -> EmailMessage. Replies keep only the latest response."""
    email_meta = EmailMessageMeta(
        sender=_header_to_str(msg.get("From"), ""),
        recipients=_import_address_headers(msg.get_all("To", [])),
        cc=_import_address_headers(msg.get_all("Cc", [])),
        bcc=_import_address_headers(msg.get_all("Bcc", [])),
        subject=_header_to_str(msg.get("Subject")),
        id=_header_to_str(msg.get("Message-ID")),
    )
    timestamp: str | None = None
    date_header = msg.get("Date", None)
    if date_header is not None:
        timestamp = parsedate_to_datetime(date_header).isoformat()

    body = _extract_email_body(msg) or ""
    if is_reply(msg):
        body = get_last_response_in_thread(body)
    if email_meta.subject is not None:
        body = decode_encoded_words(email_meta.subject) + "\n\n" + body

    return EmailMessage(
        metadata=email_meta,
        text_chunks=_text_to_chunks(body, max_chunk_length),
        timestamp=timestamp,
    )


def is_reply(msg: Message) -> bool:
    return msg.get("In-Reply-To") is not None or msg.get("References") is not None


def is_forwarded(msg: Message) -> bool:
    subject = msg.get("Subject", "").upper()
    return subject.startswith("FW:") or subject.startswith("FWD:")


def get_forwarded_email_parts(email_text: str) -> list[str]:
    """Split a forwarded email on embedded 'From:' headers."""
    parts = re.split(re.compile(r"(?=From:)", re.IGNORECASE), email_text)
    return _remove_empty_strings(parts)


_THREAD_DELIMITERS = re.compile(
    "|".join(
        [
            r"^from: .+$",
            r"^sent: .+$",
            r"^to: .+$",
            r"^subject: .+$",
            r"^-{2,}\s*Original Message\s*-{2,}$",
            r"^-{2,}\s*Forwarded by.*$",
            r"^_{5,}$",
            r"^on .+wrote:\s*(?:\r?\n\s*)+>",
        ]
    ),
    re.IGNORECASE | re.MULTILINE,
)

_TRAILING_LINE_DELIMITERS = re.compile(r"[\r\n][_\-= ]+\s*$")


def get_last_response_in_thread(email_text: str) -> str:
    """Strip quoted earlier thread parts, keeping the latest response only."""
    if not email_text:
        return ""
    match = _THREAD_DELIMITERS.search(email_text)
    if match:
        email_text = email_text[: match.start()]
    email_text = email_text.strip()
    return _TRAILING_LINE_DELIMITERS.sub("", email_text)


def _extract_email_body(msg: Message) -> str:
    if msg.is_multipart():
        parts: list[str] = []
        for part in msg.walk():
            if part.get_content_type() == "text/plain" and not part.get_filename():
                text = _decode_email_payload(part)
                if text:
                    parts.append(text)
        return "\n".join(parts)
    return _decode_email_payload(msg)


def _decode_email_payload(part: Message) -> str:
    payload = part.get_payload(decode=True)
    if payload is None:
        payload = part.get_payload(decode=False)
        return payload if isinstance(payload, str) else ""
    if isinstance(payload, bytes):
        charset = part.get_content_charset() or "latin-1"
        try:
            return payload.decode(charset, errors="replace")
        except LookupError:
            # Unknown charset: latin-1 accepts all 256 byte values.
            return payload.decode("latin-1")
    if isinstance(payload, str):
        return payload
    return ""


def _header_to_str(header, default=None):
    return str(header) if header is not None else default


def _import_address_headers(headers: list) -> list[str]:
    if not headers:
        return []
    unique: set[str] = set()
    for header in headers:
        if header:
            for address in _remove_empty_strings(str(header).split(",")):
                unique.add(address)
    return list(unique)


def _remove_empty_strings(strings: list[str]) -> list[str]:
    return [s.strip() for s in strings if s.strip()]


def _text_to_chunks(text: str, max_chunk_length: int) -> list[str]:
    if len(text) < max_chunk_length:
        return [text]
    paragraphs = _remove_empty_strings(re.split(r"\n{2,}", text))
    return list(_merge_chunks(paragraphs, "\n\n", max_chunk_length))


def _merge_chunks(
    chunks: Iterable[str], separator: str, max_chunk_length: int
) -> Iterable[str]:
    """Greedily pack paragraphs into chunks of at most max_chunk_length."""
    sep_length = len(separator)
    cur_chunk = ""
    for new_chunk in chunks:
        if len(new_chunk) > max_chunk_length:
            new_chunk = new_chunk[:max_chunk_length]
        if len(cur_chunk) + len(new_chunk) + sep_length > max_chunk_length:
            if cur_chunk:
                yield cur_chunk
            cur_chunk = new_chunk
        else:
            if cur_chunk:
                cur_chunk += separator
            cur_chunk += new_chunk
    if cur_chunk:
        yield cur_chunk


def email_matches_date_filter(
    timestamp: str | None,
    after: str | None = None,
    before: str | None = None,
) -> bool:
    """ISO-string date window filter; emails without timestamps never match a
    bounded filter."""
    if after is None and before is None:
        return True
    if timestamp is None:
        return False
    if after is not None and timestamp < after:
        return False
    if before is not None and timestamp >= before:
        return False
    return True
