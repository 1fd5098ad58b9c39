"""The port's cloud tools (``get_keys``, ``mail/dump_gmail``,
``mail/dump_outlook``) against a loopback fake of the services.

The JAX tests (``tests/test_get_keys.py``'s nine, and the six Gmail and
Outlook tests of ``tests/test_tools.py``) feed pages to httpx through
``httpx.MockTransport``. The port speaks REST through ``http.client``
(``typeagent_tpu_torch/tools/rest.py``), so each counterpart here, under
the JAX test's name, serves the same pages from :class:`LoopbackService`,
a server on 127.0.0.1 that the tools reach through
``RestClient(connect_to=...)``: the requests keep the real services' hosts
(in ``Host``), paths, queries, headers and bodies, and the handlers assert
the same things the JAX handlers do. No real Gmail, Graph or Key Vault
endpoint is reached.
"""

import argparse
import base64
import json
import threading
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from typeagent_tpu_torch.emails.email_import import import_email_from_file
from typeagent_tpu_torch.tools import get_keys as gk
from typeagent_tpu_torch.tools.rest import RestClient


@dataclass
class Url:
    host: str
    path: str
    query: str

    @property
    def params(self) -> dict[str, str]:
        return dict(urllib.parse.parse_qsl(self.query, keep_blank_values=True))

    def __str__(self) -> str:
        return f"https://{self.host}{self.path}" + (f"?{self.query}" if self.query else "")


@dataclass
class Request:
    method: str
    url: Url
    headers: dict[str, str]
    content: bytes


@dataclass
class Reply:
    status: int
    json: object = None
    content: bytes = b""
    headers: dict = field(default_factory=dict)


class LoopbackService:
    """A threading HTTP server on 127.0.0.1 that hands each request to
    ``handler(Request) -> Reply`` (an assertion error in the handler is
    kept and re-raised by :meth:`close`, and answered with a 500)."""

    def __init__(self, handler):
        self.handler = handler
        self.errors: list[BaseException] = []
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _serve(self):
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                path, _, query = self.path.partition("?")
                host = self.headers["Host"].split(":")[0]
                req = Request(self.command, Url(host, path, query), dict(self.headers.items()), body)
                try:
                    reply = service.handler(req)
                except Exception as exc:  # an assertion; raised again by close()
                    service.errors.append(exc)
                    reply = Reply(500, content=b"handler failed")
                payload = reply.content if reply.json is None else json.dumps(reply.json).encode()
                self.send_response(reply.status)
                self.send_header("Content-Length", str(len(payload)))
                for name, value in reply.headers.items():
                    self.send_header(name, value)
                self.end_headers()
                self.wfile.write(payload)

            do_GET = do_POST = do_PUT = _serve

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self._server.server_address[1]}"

    def client(self) -> RestClient:
        return RestClient(timeout=10.0, connect_to=self.address)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
        assert not self._thread.is_alive()
        if self.errors:
            raise self.errors[0]


@pytest.fixture
def serve():
    """``serve(handler)`` -> a running :class:`LoopbackService`, closed
    (and its handler's failures raised) after the test."""
    services = []

    def start(handler):
        services.append(LoopbackService(handler))
        return services[-1]

    yield start
    for service in services:
        service.close()


def test_rest_client_keeps_host_path_query_and_body(serve):
    seen = []

    def handler(req):
        seen.append(req)
        return Reply(201, json={"ok": True})

    service = serve(handler)
    resp = service.client().request(
        "PUT", "https://vault.example.net/secrets/A-B?x=1", params={"api-version": "7.4", "x": "2"},
        headers={"Authorization": "Bearer t"}, json={"value": "v"},
    )
    assert resp.status_code == 201 and resp.json() == {"ok": True}
    req = seen[0]
    assert req.method == "PUT" and req.url.host == "vault.example.net"
    assert req.url.path == "/secrets/A-B" and req.url.params == {"x": "2", "api-version": "7.4"}
    assert req.headers["Authorization"] == "Bearer t" and json.loads(req.content) == {"value": "v"}


# ---------------------------------------------------------------------------
# get_keys (tests/test_get_keys.py)
# ---------------------------------------------------------------------------


class FakeVault:
    """In-memory vault served on the loopback interface."""

    def __init__(self, name: str, secrets: dict[str, str]):
        self.name = name
        self.secrets = dict(secrets)
        self.writes: list[str] = []

    def handler(self, request: Request) -> Reply:
        assert request.headers["Authorization"] == "Bearer tok"
        assert request.url.host == f"{self.name}.vault.azure.net"
        assert request.url.params["api-version"] == gk.API_VERSION
        parts = request.url.path.strip("/").split("/")
        if parts == ["secrets"]:
            value = [{"id": f"https://{self.name}.vault.azure.net/secrets/{n}"} for n in self.secrets]
            return Reply(200, json={"value": value, "nextLink": None})
        assert parts[0] == "secrets" and len(parts) == 2
        name = parts[1]
        if request.method == "PUT":
            self.secrets[name] = json.loads(request.content)["value"]
            self.writes.append(name)
            return Reply(200, json={"value": self.secrets[name]})
        if name not in self.secrets:
            return Reply(404, json={"error": {"code": "SecretNotFound"}})
        return Reply(200, json={"value": self.secrets[name]})


@pytest.fixture
def make_client(serve):
    def make(vault: FakeVault) -> gk.KeyVaultClient:
        return gk.KeyVaultClient(token="tok", client=serve(vault.handler).client())

    return make


def write_config(tmp_path, dotenv_name=".env", shared=("OPENAI_API_KEY",), delete=(), vault="teamvault"):
    cfg = tmp_path / "get_keys.config.json"
    cfg.write_text(json.dumps({
        "defaultDotEnvPath": dotenv_name,
        "env": {"shared": list(shared), "private": [], "delete": list(delete)},
        "vault": {"shared": vault},
    }))
    return cfg


def test_get_keys__test_pull_updates_configured_keys_and_preserves_comments(tmp_path, make_client):
    cfg = write_config(tmp_path, shared=("OPENAI_API_KEY", "GEMINI_API_KEY"), delete=("OLD_KEY",))
    dotenv = tmp_path / ".env"
    dotenv.write_text("# provider keys\nOPENAI_API_KEY=stale\nOLD_KEY=gone\nUNMANAGED=keep\n")
    vault = FakeVault("teamvault", {
        "OPENAI-API-KEY": "sk-new", "GEMINI-API-KEY": "gm-1", "IRRELEVANT-SECRET": "nope",
    })
    args = argparse.Namespace(vault=None, private=None, dotenv=None)
    changed = gk.pull(make_client(vault), gk.Config(cfg), args)
    text = dotenv.read_text()
    assert changed == 4  # two values + delete + TYPEAGENT_SHAREDVAULT
    assert text.startswith("# provider keys\n")
    assert "OPENAI_API_KEY=sk-new" in text
    assert "GEMINI_API_KEY=gm-1" in text
    assert "UNMANAGED=keep" in text
    assert "IRRELEVANT_SECRET" not in text
    assert "OLD_KEY" not in text
    assert "TYPEAGENT_SHAREDVAULT=teamvault" in text


def test_get_keys__test_pull_is_idempotent(tmp_path, make_client):
    cfg = write_config(tmp_path)
    vault = FakeVault("teamvault", {"OPENAI-API-KEY": "sk-1"})
    args = argparse.Namespace(vault=None, private=None, dotenv=None)
    assert gk.pull(make_client(vault), gk.Config(cfg), args) == 2
    assert gk.pull(make_client(vault), gk.Config(cfg), args) == 0


def test_get_keys__test_pull_empty_vault_errors(tmp_path, make_client):
    cfg = write_config(tmp_path)
    args = argparse.Namespace(vault=None, private=None, dotenv=None)
    with pytest.raises(SystemExit, match="No secrets found"):
        gk.pull(make_client(FakeVault("teamvault", {})), gk.Config(cfg), args)


def test_get_keys__test_push_writes_only_changed_secrets(tmp_path, make_client):
    cfg = write_config(tmp_path, shared=("OPENAI_API_KEY", "GEMINI_API_KEY"))
    (tmp_path / ".env").write_text("OPENAI_API_KEY=sk-same\nGEMINI_API_KEY=gm-new\nUNMANAGED=x\n")
    vault = FakeVault("teamvault", {"OPENAI-API-KEY": "sk-same", "GEMINI-API-KEY": "gm-old"})
    args = argparse.Namespace(vault=None, private=None, dotenv=None, yes=True)
    written = gk.push(make_client(vault), gk.Config(cfg), args)
    assert written == 1
    assert vault.writes == ["GEMINI-API-KEY"]
    assert vault.secrets["GEMINI-API-KEY"] == "gm-new"
    assert "UNMANAGED" not in {gk.to_env_key(n) for n in vault.secrets}


def test_get_keys__test_dashed_dotenv_key_rejected(tmp_path, make_client):
    cfg = write_config(tmp_path)
    (tmp_path / ".env").write_text("BAD-KEY=x\n")
    args = argparse.Namespace(vault=None, private=None, dotenv=None)
    with pytest.raises(SystemExit, match="dash"):
        gk.pull(make_client(FakeVault("teamvault", {"A-B": "v"})), gk.Config(cfg), args)


def test_get_keys__test_vault_resolution_precedence(tmp_path):
    cfg_file = write_config(tmp_path, vault="from-config")
    (tmp_path / ".env").write_text("TYPEAGENT_SHAREDVAULT=from-env\n")
    cfg = gk.Config(cfg_file)
    env = gk.dotenv_values(gk.read_dotenv_lines(tmp_path / ".env"))
    ns = argparse.Namespace(vault=None, private=None)
    assert gk.resolve_vaults(ns, cfg, env)["shared"] == "from-env"
    ns_flag = argparse.Namespace(vault="from-flag", private=None)
    assert gk.resolve_vaults(ns_flag, cfg, env)["shared"] == "from-flag"
    assert gk.resolve_vaults(ns, cfg, {})["shared"] == "from-config"


def test_get_keys__test_forbidden_maps_to_actionable_error(serve):
    def deny(request: Request) -> Reply:
        return Reply(403, json={"error": {"code": "Forbidden"}})

    client = gk.KeyVaultClient(token="tok", client=serve(deny).client())
    with pytest.raises(SystemExit, match="Secrets User"):
        client.list_secret_names("teamvault")


def test_get_keys__test_pull_rewrites_duplicate_keys(tmp_path, make_client):
    cfg = write_config(tmp_path)
    dotenv = tmp_path / ".env"
    dotenv.write_text("OPENAI_API_KEY=old1\nOTHER=x\nOPENAI_API_KEY=old2\n")
    vault = FakeVault("teamvault", {"OPENAI-API-KEY": "sk-new"})
    args = argparse.Namespace(vault=None, private=None, dotenv=None)
    gk.pull(make_client(vault), gk.Config(cfg), args)
    values = gk.dotenv_values(gk.read_dotenv_lines(dotenv))
    assert values["OPENAI_API_KEY"] == "sk-new"
    assert "old2" not in dotenv.read_text()


def test_get_keys__test_push_reads_only_configured_secrets(tmp_path, serve):
    cfg = write_config(tmp_path, shared=("OPENAI_API_KEY",))
    (tmp_path / ".env").write_text("OPENAI_API_KEY=sk-1\n")
    vault = FakeVault("teamvault", {"OPENAI-API-KEY": "sk-0", "UNRELATED-SECRET": "other"})
    reads: list[str] = []

    def counting(request: Request) -> Reply:
        parts = request.url.path.strip("/").split("/")
        if len(parts) == 2 and request.method == "GET":
            reads.append(parts[1])
        return vault.handler(request)

    client = gk.KeyVaultClient(token="tok", client=serve(counting).client())
    args = argparse.Namespace(vault=None, private=None, dotenv=None, yes=True)
    assert gk.push(client, gk.Config(cfg), args) == 1
    assert reads == ["OPENAI-API-KEY"]


# ---------------------------------------------------------------------------
# Gmail / Outlook dumpers (tests/test_tools.py)
# ---------------------------------------------------------------------------

EML_A = (
    b"From: alice@example.com\r\nTo: bob@example.com\r\n"
    b"Subject: quarterly report\r\nMessage-ID: <a1@example.com>\r\n\r\n"
    b"Numbers are up.\r\n"
)
EML_B = (
    b"From: carol@example.com\r\nTo: bob@example.com\r\n"
    b"Subject: lunch\r\nMessage-ID: <b2@example.com>\r\n\r\nNoodles?\r\n"
)


def test_tools__test_dump_gmail_roundtrip(tmp_path, serve):
    from typeagent_tpu_torch.tools.mail.dump_gmail import dump_gmail

    pages = {
        None: {"messages": [{"id": "m1"}], "nextPageToken": "p2"},
        "p2": {"messages": [{"id": "m2"}]},
    }
    raws = {"m1": EML_A, "m2": EML_B}

    def handler(request):
        assert request.url.host == "gmail.googleapis.com"
        if request.url.path.endswith("/messages"):
            token = request.url.params.get("pageToken")
            assert request.url.params.get("q") == "from:alice"
            assert request.headers["Authorization"] == "Bearer tok"
            return Reply(200, json=pages[token])
        message_id = request.url.path.rsplit("/", 1)[-1]
        assert request.url.params["format"] == "raw"
        raw = base64.urlsafe_b64encode(raws[message_id]).decode().rstrip("=")
        return Reply(200, json={"id": message_id, "raw": raw})

    out = tmp_path / "gmail"
    count = dump_gmail(
        str(out), max_results=10, query="from:alice", access_token="tok", client=serve(handler).client(),
    )
    assert count == 2
    msg = import_email_from_file(str(out / "m1.eml"))
    assert msg.metadata.sender == "alice@example.com"
    assert msg.metadata.subject == "quarterly report"
    msg2 = import_email_from_file(str(out / "m2.eml"))
    assert msg2.metadata.sender == "carol@example.com"


def test_tools__test_dump_gmail_token_refresh(tmp_path, serve):
    from typeagent_tpu_torch.tools.mail.dump_gmail import resolve_access_token

    creds_dir = tmp_path / "creds"
    creds_dir.mkdir()
    (creds_dir / "token.json").write_text(
        json.dumps({"refresh_token": "rt", "client_id": "cid", "client_secret": "cs"})
    )

    def handler(request):
        assert request.url.host == "oauth2.googleapis.com"
        body = dict(pair.split("=") for pair in request.content.decode().split("&"))
        assert body["grant_type"] == "refresh_token"
        assert body["refresh_token"] == "rt"
        return Reply(200, json={"access_token": "fresh-tok", "expires_in": 1200})

    token = resolve_access_token(None, str(creds_dir), serve(handler).client())
    assert token == "fresh-tok"
    cached = json.loads((creds_dir / "token.json").read_text())
    assert cached["access_token"] == "fresh-tok"
    token2 = resolve_access_token(None, str(creds_dir), None)  # no client: the cache
    assert token2 == "fresh-tok"


def test_tools__test_dump_outlook_roundtrip(tmp_path, serve):
    from typeagent_tpu_torch.tools.mail.dump_outlook import dump_outlook

    raws = {"AAA-1": EML_A, "BBB=2": EML_B}

    def handler(request):
        assert request.url.host == "graph.microsoft.com"
        if request.url.path.endswith("/$value"):
            message_id = request.url.path.split("/")[-2]
            return Reply(200, content=raws[urllib.parse.unquote(message_id)])
        assert request.url.path.endswith("/me/messages")
        assert request.url.params["$filter"] == "isRead eq false"
        if "$skiptoken" in str(request.url):
            return Reply(200, json={"value": [{"id": "BBB=2"}]})
        return Reply(200, json={
            "value": [{"id": "AAA-1"}],
            "@odata.nextLink": str(request.url) + "&$skiptoken=x",
        })

    out = tmp_path / "outlook"
    count = dump_outlook(
        str(out), max_results=5, filter="isRead eq false", access_token="tok",
        client=serve(handler).client(),
    )
    assert count == 2
    files = sorted(p.name for p in out.iterdir())
    assert files == ["AAA-1.eml", "BBB_2.eml"]  # ids sanitized
    msg = import_email_from_file(str(out / "AAA-1.eml"))
    assert msg.metadata.subject == "quarterly report"


def test_tools__test_outlook_device_code_flow(serve):
    from typeagent_tpu_torch.tools.mail.dump_outlook import DeviceCodeAuth

    polls = {"n": 0}

    def handler(request):
        assert request.url.host == "login.microsoftonline.com"
        if request.url.path.endswith("/devicecode"):
            return Reply(200, json={
                "device_code": "dc", "user_code": "ABCD-EFGH",
                "verification_uri": "https://microsoft.com/devicelogin", "interval": 0, "expires_in": 900,
            })
        polls["n"] += 1
        if polls["n"] < 3:
            return Reply(400, json={"error": "authorization_pending"})
        return Reply(200, json={"access_token": "graph-tok"})

    auth = DeviceCodeAuth("app-id", client=serve(handler).client(), sleeper=lambda s: None)
    assert auth.acquire_token() == "graph-tok"
    assert polls["n"] == 3


def test_tools__test_gmail_cached_token_respects_short_expiry(tmp_path, serve):
    """A short server-reported expires_in must not be outlived by the cache."""
    from typeagent_tpu_torch.tools.mail.dump_gmail import resolve_access_token

    creds_dir = tmp_path / "creds"
    creds_dir.mkdir()
    (creds_dir / "token.json").write_text(
        json.dumps({"refresh_token": "rt", "client_id": "cid", "client_secret": "cs"})
    )
    calls = {"n": 0}

    def handler(request):
        calls["n"] += 1
        return Reply(200, json={"access_token": f"tok-{calls['n']}", "expires_in": 200})

    client = serve(handler).client()
    token = resolve_access_token(None, str(creds_dir), client)
    assert token == "tok-1"
    token2 = resolve_access_token(None, str(creds_dir), client)
    assert token2 == "tok-2"
    assert calls["n"] == 2


def test_tools__test_outlook_safe_name_no_collisions_on_long_ids():
    from typeagent_tpu_torch.tools.mail.dump_outlook import _safe_name

    prefix = "AAMkAD" + "x" * 140
    a = _safe_name(prefix + "AAA=")
    b = _safe_name(prefix + "BBB=")
    assert a != b
    assert len(a) <= 120 and len(b) <= 120
    assert _safe_name("simple-id") == "simple-id"
