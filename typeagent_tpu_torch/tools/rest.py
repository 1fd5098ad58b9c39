"""A small blocking REST client on ``http.client`` for the cloud tools.

The JAX package's ``get_keys``, ``mail/dump_gmail`` and ``mail/dump_outlook``
speak REST through httpx; the port's speak it through :class:`RestClient`,
which covers what they use: GET, POST and PUT with query parameters merged
into the URL's own, form or JSON bodies, headers, and a response with
``status_code``, ``content``, ``json()`` and ``raise_for_status()``.

``connect_to="host:port"`` sends every request, over plain HTTP, to that
address instead of the URL's host, keeping the URL's path, query and
``Host`` header (as ``curl --connect-to`` does): a test points a tool at a
loopback fake that sees the requests the real service would.
"""

from __future__ import annotations

import http.client
import json as json_mod
import urllib.parse
from dataclasses import dataclass, field


class HTTPStatusError(Exception):
    """A response with a 4xx or 5xx status (``raise_for_status``)."""

    def __init__(self, message: str, response: Response):
        super().__init__(message)
        self.response = response


@dataclass
class Response:
    status_code: int
    url: str
    content: bytes = b""
    headers: dict[str, str] = field(default_factory=dict)

    def json(self) -> object:
        return json_mod.loads(self.content)

    def raise_for_status(self) -> None:
        if self.status_code >= 400:
            reason = http.client.responses.get(self.status_code, "")
            raise HTTPStatusError(
                f"{self.status_code} {reason} for {self.url}", self
            )


def merge_params(url: str, params: dict | None) -> str:
    """``url`` with ``params`` added to its query (a key the URL already
    has takes the new value)."""
    if not params:
        return url
    parts = urllib.parse.urlsplit(url)
    query = [
        (k, v)
        for k, v in urllib.parse.parse_qsl(parts.query, keep_blank_values=True)
        if k not in params
    ]
    query += [(k, str(v)) for k, v in params.items()]
    return urllib.parse.urlunsplit(parts._replace(query=urllib.parse.urlencode(query)))


class RestClient:
    """One connection per request, closed when its response is read."""

    def __init__(self, timeout: float = 30.0, connect_to: str | None = None):
        self._timeout = timeout
        self._connect_to = connect_to

    def request(
        self,
        method: str,
        url: str,
        *,
        params: dict | None = None,
        headers: dict[str, str] | None = None,
        data: dict | None = None,
        json: object = None,
    ) -> Response:
        url = merge_params(url, params)
        parts = urllib.parse.urlsplit(url)
        send = {"Host": parts.netloc, "Accept": "*/*"}
        send.update(headers or {})
        body = None
        if data is not None:
            body = urllib.parse.urlencode(data).encode()
            send["Content-Type"] = "application/x-www-form-urlencoded"
        elif json is not None:
            body = json_mod.dumps(json).encode()
            send["Content-Type"] = "application/json"
        if self._connect_to is not None:
            conn = http.client.HTTPConnection(self._connect_to, timeout=self._timeout)
        elif parts.scheme == "https":
            conn = http.client.HTTPSConnection(parts.netloc, timeout=self._timeout)
        else:
            conn = http.client.HTTPConnection(parts.netloc, timeout=self._timeout)
        path = urllib.parse.urlunsplit(("", "", parts.path or "/", parts.query, ""))
        try:
            conn.request(method, path, body=body, headers=send)
            resp = conn.getresponse()
            return Response(resp.status, url, resp.read(), dict(resp.getheaders()))
        finally:
            conn.close()

    def get(self, url: str, **kwargs: object) -> Response:
        return self.request("GET", url, **kwargs)

    def post(self, url: str, **kwargs: object) -> Response:
        return self.request("POST", url, **kwargs)
