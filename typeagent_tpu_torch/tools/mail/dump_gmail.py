"""Dump Gmail messages into per-message .eml files via the Gmail REST API.

(Parity role: reference tools/mail/gmail_dump.py — list messages, fetch each
in raw RFC-822 form, write ``<id>.eml``.) Implemented over the standard
library's ``http.client`` (``tools/rest.py``) against the REST endpoints
instead of the google-api-python-client stack, so the only dependency is
an OAuth2 token:

  * ``--access-token`` / ``GMAIL_ACCESS_TOKEN`` — use a ready bearer token;
  * ``--creds-dir`` with ``token.json`` (``refresh_token``, ``client_id``,
    ``client_secret``) — refresh through oauth2.googleapis.com, and the new
    access token is cached back into the file.

The port of ``typeagent_tpu/tools/mail/dump_gmail.py`` (which uses
httpx); it touches no device. Pass a ``RestClient(connect_to=...)`` to
send every request to another address (a test's loopback fake).

Run: ``python -m typeagent_tpu_torch.tools.mail.dump_gmail --max-results 50 out/``.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import time

from ..rest import RestClient

API_BASE = "https://gmail.googleapis.com/gmail/v1/users/me"
TOKEN_URL = "https://oauth2.googleapis.com/token"


class GmailClient:
    """Minimal Gmail REST client (list + raw fetch), injectable transport."""

    def __init__(self, access_token: str, client: RestClient | None = None):
        self._headers = {"Authorization": f"Bearer {access_token}"}
        self._client = client or RestClient(timeout=60.0)

    def _get(self, url: str, params: dict | None = None) -> dict:
        resp = self._client.get(url, params=params, headers=self._headers)
        resp.raise_for_status()
        return resp.json()

    def list_message_ids(
        self, query: str = "", max_results: int = 50
    ) -> list[str]:
        """Paginated message-id listing honoring a Gmail search query."""
        ids: list[str] = []
        page_token: str | None = None
        while len(ids) < max_results:
            params: dict = {
                "maxResults": min(500, max_results - len(ids)),
            }
            if query:
                params["q"] = query
            if page_token:
                params["pageToken"] = page_token
            data = self._get(f"{API_BASE}/messages", params)
            ids.extend(m["id"] for m in data.get("messages", []))
            page_token = data.get("nextPageToken")
            if not page_token:
                break
        return ids[:max_results]

    def fetch_raw(self, message_id: str) -> bytes:
        """One message in raw RFC-822 form (base64url in the API)."""
        data = self._get(
            f"{API_BASE}/messages/{message_id}", {"format": "raw"}
        )
        raw = data["raw"]
        return base64.urlsafe_b64decode(raw + "=" * (-len(raw) % 4))


def refresh_access_token(
    creds: dict, client: RestClient | None = None
) -> tuple[str, float]:
    """OAuth2 refresh-token grant; returns (access_token, expires_in_s)."""
    client = client or RestClient(timeout=30.0)
    resp = client.post(
        TOKEN_URL,
        data={
            "grant_type": "refresh_token",
            "refresh_token": creds["refresh_token"],
            "client_id": creds["client_id"],
            "client_secret": creds["client_secret"],
        },
    )
    resp.raise_for_status()
    data = resp.json()
    return data["access_token"], float(data.get("expires_in", 3600))


def resolve_access_token(
    access_token: str | None,
    creds_dir: str,
    client: RestClient | None = None,
) -> str:
    if access_token:
        return access_token
    env_token = os.getenv("GMAIL_ACCESS_TOKEN")
    if env_token:
        return env_token
    token_file = os.path.join(creds_dir, "token.json")
    if os.path.exists(token_file):
        with open(token_file) as f:
            creds = json.load(f)
        # A still-valid cached access token short-circuits the refresh.
        if creds.get("access_token") and creds.get("expiry_ts", 0) > time.time() + 60:
            return creds["access_token"]
        token, expires_in = refresh_access_token(creds, client)
        creds["access_token"] = token
        # Cache until 5 minutes before the server-reported expiry.
        creds["expiry_ts"] = time.time() + max(0.0, expires_in - 300)
        with open(token_file, "w") as f:
            json.dump(creds, f)
        return token
    raise SystemExit(
        "No Gmail credentials: pass --access-token, set GMAIL_ACCESS_TOKEN, "
        f"or provide {token_file} with refresh_token/client_id/client_secret."
    )


def dump_gmail(
    out_dir: str,
    max_results: int = 50,
    query: str = "",
    access_token: str | None = None,
    creds_dir: str = ".",
    client: RestClient | None = None,
    verbose: bool = False,
) -> int:
    os.makedirs(out_dir, exist_ok=True)
    token = resolve_access_token(access_token, creds_dir, client)
    gmail = GmailClient(token, client)
    count = 0
    for message_id in gmail.list_message_ids(query, max_results):
        raw = gmail.fetch_raw(message_id)
        path = os.path.join(out_dir, f"{message_id}.eml")
        with open(path, "wb") as f:
            f.write(raw)
        count += 1
        if verbose:
            print(f"wrote {path} ({len(raw)} bytes)")
    return count


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Download Gmail messages as .eml files (REST, no SDK)"
    )
    parser.add_argument("output_dir", nargs="?", default="mail_dump")
    parser.add_argument("--max-results", type=int, default=50)
    parser.add_argument(
        "--query", default="", help="Gmail search query (e.g. 'from:alice')"
    )
    parser.add_argument("--access-token", default=None)
    parser.add_argument(
        "--creds-dir",
        default=".",
        help="Directory containing token.json (refresh_token/client_id/secret)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()
    start = time.time()
    count = dump_gmail(
        args.output_dir,
        max_results=args.max_results,
        query=args.query,
        access_token=args.access_token,
        creds_dir=args.creds_dir,
        verbose=args.verbose,
    )
    print(
        f"Downloaded {count} messages to {args.output_dir} "
        f"in {time.time() - start:.1f}s"
    )


if __name__ == "__main__":
    main()
