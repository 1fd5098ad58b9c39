"""The HTTP model adapters of the port against the JAX package's.

``tests/test_models.py`` runs against the port through
``test_torch_query_suites.mirror`` (nothing excluded). Then both packages'
``HttpChatModel`` and ``HttpEmbedder`` (httpx in JAX, ``http.client`` in
the port) talk to one loopback fake (``test_torch_fake_endpoint.py``) that
records every request: for the ``openai`` provider, ``azure`` with an API
key, ``azure`` with a managed identity (a fake credential) behind an APIM
key, and a provider added with ``register_provider``, both must send the
same path, the same JSON body, byte for byte, and the same headers, and
get the same answers (embeddings to 1e-6). A 429 then 200 is retried once
in both; a 400 is retried in neither. Nothing reaches past 127.0.0.1.
"""

import asyncio
import json
import time

import numpy as np
import pytest

from test_torch_fake_endpoint import FakeEndpoint
from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu.models import adapters as jax_adapters
from typeagent_tpu.models import auth as jax_auth
from typeagent_tpu.models import retry as jax_retry
from typeagent_tpu_torch.models import adapters as port_adapters
from typeagent_tpu_torch.models import auth as port_auth
from typeagent_tpu_torch.models import retry as port_retry

SUITES = ("test_models.py",)
EXCLUDED: dict = {}
MIRRORED = mirror(SUITES, EXCLUDED, globals())

TOL_EMBED = 1e-6
# The headers the adapters set; the transports add their own (User-Agent,
# Accept-Encoding, Host, Content-Length), which are not the adapters'.
ADAPTER_HEADERS = ("authorization", "api-key", "ocp-apim-subscription-key", "content-type")
ENV_VARS = (
    "OPENAI_API_KEY", "OPENAI_BASE_URL", "OPENAI_MODEL", "OPENAI_EMBEDDING_MODEL",
    "AZURE_OPENAI_API_KEY", "AZURE_OPENAI_ENDPOINT", "AZURE_OPENAI_ENDPOINT_EMBEDDING",
    "AZURE_OPENAI_API_KEY_EMBEDDING", "AZURE_APIM_SUBSCRIPTION_KEY", "AZURE_OPENAI_ENDPOINT_EMBEDDING_3_SMALL",
    "FAKECO_API_KEY", "FAKECO_BASE_URL",
)


@pytest.fixture(autouse=True)
def no_retry_sleeps():
    """The port's retry sleeps are off here, as the JAX package's conftest
    turns off its own."""
    port_retry.set_testing(True)
    yield
    port_retry.set_testing(False)


def test_every_models_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


class _Token:
    def __init__(self, token, expires_on):
        self.token = token
        self.expires_on = expires_on


class _Credential:
    """The same token sequence for both packages' providers."""

    def __init__(self):
        self.calls = 0

    def get_token(self, scope):
        self.calls += 1
        return _Token(f"tok-{self.calls}", int(time.time() + 3600))


def _chat_reply(messages):
    return "reply to " + messages[-1]["content"][:40]


def _configure(case: str, url: str, monkeypatch) -> tuple[str, str]:
    """Point the environment at the fake for ``case``; returns the chat and
    embedding specs to build."""
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    if case == "openai":
        monkeypatch.setenv("OPENAI_API_KEY", "sk-fake")
        monkeypatch.setenv("OPENAI_BASE_URL", url)
        return "openai:gpt-4o", "openai:text-embedding-ada-002"
    if case in ("azure_key", "azure_identity"):
        base = url.removesuffix("/v1")
        monkeypatch.setenv(
            "AZURE_OPENAI_ENDPOINT",
            f"{base}/openai/deployments/gpt-4o/chat/completions?api-version=2024-06-01",
        )
        monkeypatch.setenv(
            "AZURE_OPENAI_ENDPOINT_EMBEDDING",
            f"{base}/apim/openai/deployments/ada-002/embeddings?api-version=2024-06-01",
        )
        if case == "azure_key":
            monkeypatch.setenv("AZURE_OPENAI_API_KEY", "az-key")
        else:
            monkeypatch.setenv("AZURE_OPENAI_API_KEY", "identity")
            monkeypatch.setenv("AZURE_APIM_SUBSCRIPTION_KEY", "apim-key")
        return "azure:gpt-4o", "azure:text-embedding-ada-002"
    assert case == "registered"
    for pkg in (jax_adapters, port_adapters):
        pkg.register_provider("fakeco", pkg.ProviderSpec(url, "FAKECO_API_KEY"))
    monkeypatch.setenv("FAKECO_API_KEY", "fk")
    return "fakeco:chat-1", "fakeco:embed-1"


async def _drive(pkg, chat_spec: str, embed_spec: str):
    chat = pkg.create_chat_model(chat_spec)
    embedder = pkg.create_embedding_model(embed_spec)
    answers = [await chat.complete("hello there"),
               await chat.complete([{"role": "system", "content": "be brief"},
                                    {"role": "user", "content": "what now?"}])]
    one = await embedder.get_embedding_nocache("a single text")
    many = await embedder.get_embeddings(["first text", "second text", "first text"])
    return [a.value for a in answers], one, many


@pytest.mark.parametrize("case", ["openai", "azure_key", "azure_identity", "registered"])
def test_both_packages_send_the_same_requests(case, monkeypatch):
    outputs, recorded = {}, {}
    for name, pkg, auth in (("jax", jax_adapters, jax_auth), ("port", port_adapters, port_auth)):
        with FakeEndpoint(_chat_reply, dim=24, record=True) as fake:
            chat_spec, embed_spec = _configure(case, fake.url, monkeypatch)
            auth.set_shared_token_provider(auth.AzureTokenProvider(credential=_Credential()))
            try:
                outputs[name] = asyncio.run(_drive(pkg, chat_spec, embed_spec))
            finally:
                auth.set_shared_token_provider(None)
        recorded[name] = fake.requests
    jax_reqs, port_reqs = recorded["jax"], recorded["port"]
    assert len(jax_reqs) == len(port_reqs) == 4
    for j, p in zip(jax_reqs, port_reqs):
        assert p["path"] == j["path"]
        assert p["body"] == j["body"]  # the same JSON, byte for byte
        jh = {k.lower(): v for k, v in j["headers"].items() if k.lower() in ADAPTER_HEADERS}
        ph = {k.lower(): v for k, v in p["headers"].items() if k.lower() in ADAPTER_HEADERS}
        assert ph == jh
    bodies = [json.loads(r["body"]) for r in port_reqs]
    # Azure embeddings leave out the model field (send_model_field=False).
    assert ("model" in bodies[2]) == (case != "azure_key" and case != "azure_identity")
    if case == "azure_identity":
        assert port_reqs[0]["headers"]["Authorization"] == "Bearer tok-1"
        assert port_reqs[0]["headers"]["Ocp-Apim-Subscription-Key"] == "apim-key"
    (j_answers, j_one, j_many), (p_answers, p_one, p_many) = outputs["jax"], outputs["port"]
    assert p_answers == j_answers and p_answers[0].startswith("reply to ")
    np.testing.assert_allclose(p_one, j_one, rtol=0, atol=TOL_EMBED)
    np.testing.assert_allclose(p_many, j_many, rtol=0, atol=TOL_EMBED)
    assert p_many.shape == (3, 24)


@pytest.mark.parametrize("status,retried", [(429, True), (503, True), (400, False)])
def test_retries_match(status, retried, monkeypatch):
    """A first reply of ``status`` then 200s: both packages send the same
    number of requests, and get the same outcome."""
    seen = {}
    for name, pkg in (("jax", jax_adapters), ("port", port_adapters)):
        # The first chat request and the first embedding request fail.
        failing = (1, 3) if retried else (1, 2)
        with FakeEndpoint(_chat_reply, dim=8, errors=lambda n: status if n in failing else None) as fake:
            chat_spec, embed_spec = _configure("openai", fake.url, monkeypatch)
            chat = pkg.create_chat_model(chat_spec)
            embedder = pkg.create_embedding_model(embed_spec)

            async def run():
                answer = await chat.complete("hi")
                try:
                    vec = await embedder.get_embedding_nocache("x")
                except Exception as exc:  # httpx's or urllib's error
                    vec = type(exc).__name__
                return answer, vec

            answer, vec = asyncio.run(run())
            seen[name] = (answer, vec, fake.stats())
    (ja, jv, js), (pa, pv, ps) = seen["jax"], seen["port"]
    assert ps == js
    assert ps["requests"] == (4 if retried else 2) and ps["retried"] == (2 if retried else 0)
    assert ps["sent_429"] + ps["sent_503"] == (2 if retried else 0)
    assert type(pa).__name__ == type(ja).__name__
    if retried:
        assert pa.value == ja.value
        np.testing.assert_allclose(pv, jv, rtol=0, atol=TOL_EMBED)
    else:
        # The failure's text is the JAX one; the exception's repr differs.
        assert pa.message.startswith("chat request failed: ")
        assert ja.message.startswith("chat request failed: ")
        assert "400" in pa.message
        assert (jv, pv) == ("HTTPStatusError", "HTTPError")


def test_an_empty_reply_is_a_failure(monkeypatch):
    for pkg in (jax_adapters, port_adapters):
        with FakeEndpoint(lambda messages: None) as fake:
            chat_spec, _ = _configure("openai", fake.url, monkeypatch)
            result = asyncio.run(pkg.create_chat_model(chat_spec).complete("hi"))
        assert result.message == "No text content in model response"


def test_is_transient_maps_the_stdlib_errors():
    import socket
    import urllib.error

    def http_error(code):
        return urllib.error.HTTPError("http://x", code, "", None, None)

    for exc, want in (
        (http_error(429), True), (http_error(500), True), (http_error(503), True),
        (http_error(400), False), (http_error(404), False),
        (urllib.error.URLError("unreachable"), True), (ConnectionRefusedError(), True),
        (TimeoutError(), True), (socket.timeout(), True),
        (port_retry.TransientError("x"), True), (ValueError("x"), False),
    ):
        assert port_retry.is_transient(exc) is want, exc
    assert port_retry.DEFAULT_CHAT_RETRIER.attempts == jax_retry.DEFAULT_CHAT_RETRIER.attempts == 6
    assert port_retry.DEFAULT_EMBED_RETRIER.timeout == jax_retry.DEFAULT_EMBED_RETRIER.timeout == 120


def test_unreachable_host_is_a_transient_url_error(monkeypatch):
    """A refused connection (a loopback port nobody listens on) is retried
    and surfaces as the transport's error after the attempts."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OPENAI_BASE_URL", f"http://127.0.0.1:{port}/v1")
    chat = port_adapters.create_chat_model("openai:gpt-4o", retrier=port_retry.AsyncRetrier(attempts=3))
    result = asyncio.run(chat.complete("hi"))
    assert result.message.startswith("chat request failed: ConnectionRefusedError")


def test_requests_overlap_and_reuse_connections(monkeypatch):
    """Extraction's concurrency reaches the wire: four requests in flight
    at once, each worker thread reusing its connection."""
    import threading

    active, peak, lock = 0, 0, threading.Lock()

    def slow(messages):
        nonlocal active, peak
        with lock:
            active += 1
            peak = max(peak, active)
        time.sleep(0.05)
        with lock:
            active -= 1
        return "ok"

    with FakeEndpoint(slow, record=True) as fake:
        chat_spec, _ = _configure("openai", fake.url, monkeypatch)
        chat = port_adapters.create_chat_model(chat_spec)

        async def run():
            for _ in range(3):
                await asyncio.gather(*(chat.complete(f"q{i}") for i in range(4)))

        asyncio.run(run())
        connections = {r["client"] for r in fake.requests}
    assert peak == 4
    assert len(fake.requests) == 12 and 4 <= len(connections) < 12
