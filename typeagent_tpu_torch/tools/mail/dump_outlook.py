"""Dump Outlook messages into .eml files via the Microsoft Graph REST API.

(Parity role: reference tools/mail/outlook_dump.py — list /me/messages with
optional $filter / $search, fetch each message's MIME via ``/$value``, write
``<id>.eml``.) Implemented over the standard library's ``http.client``
(``tools/rest.py``) against graph.microsoft.com instead of the
msgraph-sdk/kiota stack. Auth options:

  * ``--access-token`` / ``GRAPH_ACCESS_TOKEN`` — ready bearer token;
  * ``--device-code`` — the OAuth2 device-code flow against
    login.microsoftonline.com (prints the verification URL + code, polls the
    token endpoint), requires ``--application-client-id`` (an Azure AD app
    with delegated Mail.Read).

The port of ``typeagent_tpu/tools/mail/dump_outlook.py`` (which uses
httpx); it touches no device. Pass a ``RestClient(connect_to=...)`` to
send every request to another address (a test's loopback fake).

Run: ``python -m typeagent_tpu_torch.tools.mail.dump_outlook --max-results 50 out/``.
"""

from __future__ import annotations

import argparse
import os
import re
import time
from collections.abc import Callable

from ..rest import RestClient

GRAPH_BASE = "https://graph.microsoft.com/v1.0"
LOGIN_BASE = "https://login.microsoftonline.com"
DEFAULT_SCOPE = "https://graph.microsoft.com/Mail.Read offline_access"


class DeviceCodeAuth:
    """OAuth2 device-code flow over plain REST (no azure-identity)."""

    def __init__(
        self,
        application_client_id: str,
        tenant: str = "common",
        scope: str = DEFAULT_SCOPE,
        client: RestClient | None = None,
        sleeper: Callable[[float], None] = time.sleep,
    ):
        self.client_id = application_client_id
        self.tenant = tenant
        self.scope = scope
        self._client = client or RestClient(timeout=30.0)
        self._sleep = sleeper

    def acquire_token(self) -> str:
        start = self._client.post(
            f"{LOGIN_BASE}/{self.tenant}/oauth2/v2.0/devicecode",
            data={"client_id": self.client_id, "scope": self.scope},
        )
        start.raise_for_status()
        info = start.json()
        print(info.get("message") or (
            f"Visit {info['verification_uri']} and enter code "
            f"{info['user_code']}"
        ), flush=True)
        interval = int(info.get("interval", 5))
        deadline = time.time() + int(info.get("expires_in", 900))
        while time.time() < deadline:
            resp = self._client.post(
                f"{LOGIN_BASE}/{self.tenant}/oauth2/v2.0/token",
                data={
                    "grant_type": "urn:ietf:params:oauth:grant-type:device_code",
                    "client_id": self.client_id,
                    "device_code": info["device_code"],
                },
            )
            data = resp.json()
            if resp.status_code == 200:
                return data["access_token"]
            if data.get("error") in ("authorization_pending", "slow_down"):
                self._sleep(interval)
                continue
            raise RuntimeError(f"device-code flow failed: {data}")
        raise TimeoutError("device-code flow expired before authorization")


class OutlookClient:
    """Minimal Graph mail client (list + MIME fetch), injectable transport."""

    def __init__(self, access_token: str, client: RestClient | None = None):
        self._headers = {"Authorization": f"Bearer {access_token}"}
        self._client = client or RestClient(timeout=60.0)

    def list_message_ids(
        self,
        max_results: int = 50,
        filter: str | None = None,
        search: str | None = None,
    ) -> list[str]:
        """Paginated id listing with optional OData $filter or $search."""
        ids: list[str] = []
        params: dict = {"$top": min(100, max_results), "$select": "id"}
        if filter:
            params["$filter"] = filter
        headers = dict(self._headers)
        if search:
            params["$search"] = f'"{search}"'
            headers["ConsistencyLevel"] = "eventual"
        url: str | None = f"{GRAPH_BASE}/me/messages"
        while url and len(ids) < max_results:
            resp = self._client.get(url, params=params, headers=headers)
            resp.raise_for_status()
            data = resp.json()
            ids.extend(m["id"] for m in data.get("value", []))
            url = data.get("@odata.nextLink")
            params = None  # nextLink embeds the query
        return ids[:max_results]

    def fetch_mime(self, message_id: str) -> bytes:
        """One message as RFC-822 MIME (/messages/{id}/$value)."""
        resp = self._client.get(
            f"{GRAPH_BASE}/me/messages/{message_id}/$value",
            headers=self._headers,
        )
        resp.raise_for_status()
        return resp.content


def _safe_name(message_id: str) -> str:
    """Filesystem-safe, collision-free name for a Graph message id.

    Graph ids often exceed 150 chars and share a long mailbox prefix, so a
    bare truncation would collide; a content hash suffix keeps truncated
    names unique."""
    import hashlib

    cleaned = re.sub(r"[^A-Za-z0-9_.-]", "_", message_id)
    if len(cleaned) <= 120:
        return cleaned
    digest = hashlib.sha256(message_id.encode()).hexdigest()[:12]
    return f"{cleaned[:107]}.{digest}"


def dump_outlook(
    out_dir: str,
    max_results: int = 50,
    filter: str | None = None,
    search: str | None = None,
    access_token: str | None = None,
    application_client_id: str | None = None,
    tenant: str = "common",
    client: RestClient | None = None,
    verbose: bool = False,
) -> int:
    os.makedirs(out_dir, exist_ok=True)
    token = access_token or os.getenv("GRAPH_ACCESS_TOKEN")
    if not token:
        if not application_client_id:
            raise SystemExit(
                "No Graph credentials: pass --access-token, set "
                "GRAPH_ACCESS_TOKEN, or use --device-code with "
                "--application-client-id."
            )
        token = DeviceCodeAuth(
            application_client_id, tenant=tenant, client=client
        ).acquire_token()
    outlook = OutlookClient(token, client)
    count = 0
    for message_id in outlook.list_message_ids(max_results, filter, search):
        raw = outlook.fetch_mime(message_id)
        path = os.path.join(out_dir, f"{_safe_name(message_id)}.eml")
        with open(path, "wb") as f:
            f.write(raw)
        count += 1
        if verbose:
            print(f"wrote {path} ({len(raw)} bytes)")
    return count


def main() -> None:
    parser = argparse.ArgumentParser(
        description="Download Outlook messages as .eml files (Graph REST, no SDK)"
    )
    parser.add_argument("output_dir", nargs="?", default="mail_dump")
    parser.add_argument("--max-results", type=int, default=50)
    parser.add_argument("--filter", default=None, help="OData $filter")
    parser.add_argument("--search", default=None, help="KQL $search")
    parser.add_argument("--access-token", default=None)
    parser.add_argument(
        "--application-client-id",
        default=os.getenv("AZURE_APPLICATION_CLIENT_ID"),
        help="Azure AD app registration id (delegated Mail.Read)",
    )
    parser.add_argument("--tenant", default="common")
    parser.add_argument(
        "--device-code",
        action="store_true",
        help="Authenticate with the OAuth2 device-code flow",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()
    start = time.time()
    count = dump_outlook(
        args.output_dir,
        max_results=args.max_results,
        filter=args.filter,
        search=args.search,
        access_token=args.access_token,
        application_client_id=args.application_client_id,
        tenant=args.tenant,
        verbose=args.verbose,
    )
    print(
        f"Downloaded {count} messages to {args.output_dir} "
        f"in {time.time() - start:.1f}s"
    )


if __name__ == "__main__":
    main()
