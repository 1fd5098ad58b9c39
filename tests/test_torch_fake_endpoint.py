"""An OpenAI-compatible fake endpoint on the loopback interface, for the
port's model-adapter tests and ``chip_smoke.py``.

This module imports no JAX and nothing of either package at module level,
so the card's smoke can start the same server. :class:`FakeEndpoint` is a
standard-library ``ThreadingHTTPServer`` on ``127.0.0.1`` speaking
HTTP/1.1 (connections are kept alive, as a real endpoint keeps them):

* ``POST .../embeddings`` answers each input with a deterministic vector
  of ``dim`` floats made from a hash of the text (:func:`hash_embedding`);
* ``POST .../chat/completions`` answers with ``chat(messages)``, the
  responder the caller gives (a reply text, or None for an empty reply);
* ``errors(n)`` may turn the n-th request (1-based, counted over both
  routes) into an error status once: a retry is a new request. The server
  counts the errors it sent and the errored requests that came back
  (the same body again), and records every request when asked to;
  ``GET /stats`` returns the counts.

Run as a script (``python tests/test_torch_fake_endpoint.py --stage1
questions.json``) it serves the canned responder in a process of its own,
prints its base URL on its first line and stops when its standard input
closes. :func:`point_models_at` aims a test's default models at it, and
:class:`McpClient` drives a spawned MCP server over stdio, answering the
server's sampling requests with a responder as a client's model would.

Nothing here reaches past 127.0.0.1.
"""

import functools
import hashlib
import json
import os
import re
import threading
from collections import Counter
from collections.abc import Callable
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest


def hash_embedding(text: str, dim: int) -> np.ndarray:
    """A deterministic f32 vector for ``text``: sha256-seeded uniforms."""
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    rng = np.random.default_rng(np.frombuffer(digest[:16], dtype=np.uint64))
    return rng.random(dim, dtype=np.float32) - np.float32(0.5)


@functools.cache
def _vector_format(dim: int) -> str:
    return "[" + ",".join(["%.9g"] * dim) + "]"


def embedding_json(text: str, dim: int) -> str:
    """:func:`hash_embedding` as a JSON array of 9 significant digits: the
    float32 values exactly, in the short form a real endpoint sends them
    (``0.0023064255``, not the 17 digits of the float64 they widen to)."""
    return _vector_format(dim) % tuple(hash_embedding(text, dim).tolist())


_REQUEST_RE = re.compile(r'"""\n(.*?)\n"""', re.DOTALL)


def knowledge_of(text: str) -> dict:
    """The ``KnowledgeResponse`` JSON that ``test_torch_conv_corpus
    .WordExtractor`` gives for ``text``: one entity (the first word, with
    its word count as a facet) and two topics (the next two words)."""
    words = text.split()
    return {
        "entities": [{"name": words[0], "type": ["word"],
                      "facets": [{"name": "length", "value": float(len(words))}]}],
        "actions": [], "inverseActions": [], "topics": words[1:3],
    }


def canned_responder(stage1: dict[str, dict] | None = None) -> Callable[[list[dict]], str | None]:
    """A chat responder for the whole pipeline: a knowledge-extraction
    request gets :func:`knowledge_of` its text; stage 1 (the recorded
    ``searchQueryExpr`` of a question in ``stage1``), stage 4 and the
    combine round get what ``models/canned.py``'s ``CannedChatModel``
    gives."""
    from typeagent_tpu_torch.models.canned import CannedChatModel

    canned = CannedChatModel(stage1)

    def respond(messages: list[dict]) -> str | None:
        prompt = messages[-1]["content"]
        if '"KnowledgeResponse"' in prompt:
            match = _REQUEST_RE.search(prompt)
            return json.dumps(knowledge_of(match.group(1) if match else prompt))
        # The canned model awaits nothing: run its coroutine to its end
        # here, on whatever thread (or event loop) calls the responder.
        try:
            canned.complete(messages).send(None)
        except StopIteration as done:
            return getattr(done.value, "value", None)
        raise RuntimeError("the canned chat model awaited")

    return respond


def point_models_at(fake: "FakeEndpoint", monkeypatch, embedding_spec: str | None = None) -> None:
    """The default HTTP models (settings, extractor, translators) through
    ``fake`` and nothing else; ``embedding_spec`` (e.g. ``test:16``) in
    place of the HTTP embedding model."""
    for name in ("OPENAI_MODEL", "OPENAI_EMBEDDING_MODEL", "AZURE_OPENAI_API_KEY"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OPENAI_API_KEY", "sk-fake")
    monkeypatch.setenv("OPENAI_BASE_URL", fake.url)
    if embedding_spec:
        monkeypatch.setenv("OPENAI_EMBEDDING_MODEL", embedding_spec)


class McpClient:
    """A JSON-RPC client over a spawned MCP server's stdio (an
    ``asyncio`` subprocess) that answers the server's sampling requests
    with ``respond`` and records their parameters."""

    def __init__(self, proc, respond: Callable[[list[dict]], str | None]):
        self.proc, self.respond = proc, respond
        self.sampling: list[dict] = []
        self._next_id = 1

    async def _write(self, message: dict) -> None:
        self.proc.stdin.write((json.dumps(message) + "\n").encode())
        await self.proc.stdin.drain()

    async def request(self, method: str, params: dict | None = None, timeout: float = 300) -> dict:
        import asyncio

        request_id, self._next_id = self._next_id, self._next_id + 1
        await self._write({"jsonrpc": "2.0", "id": request_id, "method": method, "params": params or {}})
        while True:
            line = await asyncio.wait_for(self.proc.stdout.readline(), timeout)
            if not line:
                raise RuntimeError(f"the MCP server closed its output during {method}")
            message = json.loads(line)
            if message.get("method") == "sampling/createMessage":
                self.sampling.append(message["params"])
                sections = [{"role": m["role"], "content": m["content"]["text"]}
                            for m in message["params"]["messages"]]
                await self._write({"jsonrpc": "2.0", "id": message["id"], "result": {
                    "role": "assistant", "content": {"type": "text", "text": self.respond(sections) or ""},
                    "model": "canned"}})
            elif message.get("id") == request_id:
                return message


def every(n_429: int, n_503: int) -> Callable[[int], int | None]:
    """An error schedule: 429 to every ``n_429``-th request, else 503 to
    every ``n_503``-th."""

    def schedule(n: int) -> int | None:
        if n % n_429 == 0:
            return 429
        if n % n_503 == 0:
            return 503
        return None

    return schedule


class FakeEndpoint:
    """The fake, started and stopped as a context manager; ``url`` is its
    OpenAI-style base URL (``http://127.0.0.1:<port>/v1``)."""

    def __init__(
        self,
        chat: Callable[[list[dict]], str | None] | None = None,
        *,
        dim: int = 1536,
        errors: Callable[[int], int | None] | None = None,
        record: bool = False,
    ):
        self.chat = chat or (lambda messages: "ok")
        self.dim = dim
        self.errors = errors or (lambda n: None)
        self.record = record
        self.requests: list[dict] = []  # path, headers, body, client (when recording)
        self.counts: Counter = Counter()  # requests by route, errors by status
        self.retried = 0  # errored requests whose body came back
        self._errored: set[bytes] = set()
        self._n = 0
        self._lock = threading.Lock()
        self._server: ThreadingHTTPServer | None = None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}/v1"

    def __enter__(self) -> "FakeEndpoint":
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True  # the headers and the body go out at once

            def log_message(self, *args) -> None:  # quiet
                pass

            def do_GET(self) -> None:
                found = self.path == "/stats"
                data = json.dumps(endpoint.stats() if found else {}).encode()
                self.send_response(200 if found else 404)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self) -> None:
                body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                status, reply = endpoint._answer(self.path, dict(self.headers), body, self.client_address)
                data = reply if isinstance(reply, bytes) else json.dumps(reply).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self

    def __exit__(self, *exc) -> None:
        self._server.shutdown()
        self._server.server_close()

    def _answer(self, path: str, headers: dict, body: bytes, client=None) -> tuple[int, dict]:
        digest = hashlib.sha256(path.encode() + body).digest()
        with self._lock:
            self._n += 1
            n = self._n
            if self.record:
                self.requests.append({"path": path, "headers": headers, "body": body, "client": client})
            if digest in self._errored:
                self._errored.discard(digest)
                self.retried += 1
            status = self.errors(n)
            if status is not None:
                self._errored.add(digest)
                self.counts[status] += 1
                return status, {"error": {"message": f"fake {status}", "type": "fake"}}
        payload = json.loads(body)
        if path.split("?")[0].endswith("/embeddings"):
            with self._lock:
                self.counts["embeddings"] += 1
            inputs = payload["input"]
            inputs = [inputs] if isinstance(inputs, str) else inputs
            data = ",".join('{"object": "embedding", "index": %d, "embedding": %s}' % (i, embedding_json(t, self.dim))
                            for i, t in enumerate(inputs))
            return 200, ('{"object": "list", "data": [%s], "model": %s}'
                         % (data, json.dumps(payload.get("model", "fake")))).encode()
        if path.split("?")[0].endswith("/chat/completions"):
            with self._lock:
                self.counts["chat"] += 1
            text = self.chat(payload["messages"])
            return 200, {
                "object": "chat.completion",
                "choices": [{"index": 0, "message": {"role": "assistant", "content": text},
                             "finish_reason": "stop"}],
                "model": payload.get("model", "fake"),
            }
        return 404, {"error": {"message": f"no route {path}"}}

    def stats(self) -> dict:
        with self._lock:
            return {"requests": self._n, "embeddings": self.counts["embeddings"],
                    "chat": self.counts["chat"], "sent_429": self.counts[429],
                    "sent_503": self.counts[503], "retried": self.retried,
                    "unresolved": len(self._errored)}


def _post(url: str, payload: dict) -> tuple[int, dict]:
    import http.client
    import urllib.parse

    parts = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(parts.netloc, timeout=10)
    conn.request("POST", parts.path, body=json.dumps(payload), headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_fake_embeddings_are_the_hash_vectors():
    with FakeEndpoint(dim=12) as fake:
        status, reply = _post(fake.url + "/embeddings", {"input": ["a", "bb"], "model": "m"})
    assert status == 200
    got = np.array([d["embedding"] for d in reply["data"]], dtype=np.float32)
    np.testing.assert_array_equal(got, np.stack([hash_embedding("a", 12), hash_embedding("bb", 12)]))
    assert fake.stats()["embeddings"] == 1


def test_fake_errors_once_and_counts_the_retry():
    with FakeEndpoint(lambda messages: messages[-1]["content"].upper(), errors=every(3, 5)) as fake:
        replies = [_post(fake.url + "/chat/completions", {"messages": [{"role": "user", "content": "hi"}]})
                   for _ in range(6)]
    assert [s for s, _ in replies] == [200, 200, 429, 200, 503, 429]
    assert replies[0][1]["choices"][0]["message"]["content"] == "HI"
    # Each errored body came back once: requests 4 and 6 retry 3 and 5.
    assert fake.stats() == {"requests": 6, "embeddings": 0, "chat": 3, "sent_429": 2,
                            "sent_503": 1, "retried": 2, "unresolved": 1}


@pytest.mark.parametrize("path", ["/v1/nothing", "/v1/embeddings?api-version=1"])
def test_fake_routes(path):
    with FakeEndpoint(dim=4) as fake:
        status, _ = _post(fake.url.removesuffix("/v1") + path, {"input": "x"})
    assert status == (200 if "embeddings" in path else 404)


def test_fake_serves_from_its_own_process(tmp_path):
    import subprocess
    import sys
    import urllib.request

    stage1 = {"q?": {"searchExpressions": [{"rewrittenQuery": "q", "filters": [{"searchTerms": ["x"]}]}]}}
    (tmp_path / "s.json").write_text(json.dumps(stage1))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, __file__, "--stage1", str(tmp_path / "s.json"), "--dim", "8",
                             "--errors", "2,1000"], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                            cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=repo))
    try:
        url = proc.stdout.readline().strip()
        assert url.startswith("http://127.0.0.1:"), url
        prompt = 'x "SearchQuery" y\n"""\nq?\n"""\n'
        status, reply = _post(url + "/chat/completions", {"messages": [{"role": "user", "content": prompt}]})
        assert status == 200 and json.loads(reply["choices"][0]["message"]["content"]) == stage1["q?"]
        assert _post(url + "/embeddings", {"input": ["a"]})[0] == 429
        with urllib.request.urlopen(url.removesuffix("/v1") + "/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["sent_429"] == 1 and stats["unresolved"] == 1 and stats["chat"] == 1
    finally:
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0


def main() -> None:
    import argparse
    import sys

    parser = argparse.ArgumentParser(description="the loopback fake endpoint, in a process of its own")
    parser.add_argument("--stage1", help="JSON file: question -> its stage-1 searchQueryExpr")
    parser.add_argument("--dim", type=int, default=1536)
    parser.add_argument("--errors", default="", help="N429,N503: 429 to every N429-th request, 503 to every N503-th")
    args = parser.parse_args()
    stage1 = json.load(open(args.stage1)) if args.stage1 else None
    errors = every(*map(int, args.errors.split(","))) if args.errors else None
    with FakeEndpoint(canned_responder(stage1), dim=args.dim, errors=errors) as fake:
        print(fake.url, flush=True)
        sys.stdin.read()  # until the parent closes the pipe


if __name__ == "__main__":
    main()
