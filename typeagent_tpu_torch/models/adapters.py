"""Chat + embedding providers over plain HTTP (standalone).

The port of ``typeagent_tpu/models/adapters.py``, which replaces the
reference's pydantic-ai/openai dependency stack
(`aitools/model_adapters.py`) with a direct OpenAI-compatible HTTP adapter:

  * ``HttpChatModel`` — POST /chat/completions (OpenAI or Azure OpenAI).
  * ``HttpEmbedder`` — POST /embeddings; L2-normalizes on receipt
    (parity: `model_adapters.py:176-184`).
  * ``FakeEmbedder`` / ``FakeChatModel`` — deterministic, offline test models
    (parity role: `model_adapters.py:375-448`).
  * ``create_chat_model`` / ``create_embedding_model`` / ``configure_models``
    — ``provider:model`` spec factories with env wiring and Azure fallback
    when only ``AZURE_OPENAI_API_KEY`` is set
    (parity: `model_adapters.py:254-367`).

The JAX package awaits an ``httpx.AsyncClient``; this module, which must
not import ``httpx``, sends the same requests (the same JSON bodies, byte
for byte, and the same headers) with ``http.client``. A request blocks, so
it runs off the event loop on the model's bounded pool of worker threads,
each thread keeping one persistent connection per host:
``DEFAULT_EXTRACTION_CONCURRENCY`` extraction requests stay in flight at
once, as they do over httpx. A status of 429 or 5xx raises
:class:`TransientError`, any other non-2xx status
``urllib.error.HTTPError``, so the retrier retries what the JAX one does.

Environment variables honored (parity: reference `docs/env-vars.md`):
``OPENAI_API_KEY``, ``OPENAI_MODEL``, ``OPENAI_EMBEDDING_MODEL``,
``OPENAI_BASE_URL``, ``AZURE_OPENAI_API_KEY``, ``AZURE_OPENAI_ENDPOINT``,
``AZURE_OPENAI_ENDPOINT_EMBEDDING`` (+ per-model variants).
"""

from __future__ import annotations

import asyncio
import hashlib
import http.client
import json
import os
import threading
import urllib.error
import urllib.parse
from collections.abc import Callable
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass as _dataclass

import numpy as np

from .structured import IChatModel, PromptSection
from .embeddings import (
    CachingEmbeddingModel,
    IEmbeddingModel,
    NormalizedEmbedding,
    NormalizedEmbeddings,
    TEST_MODEL_NAME,
    model_to_envvar,
    normalize,
)
from .result import Failure, Result, Success
from .retry import (
    DEFAULT_CHAT_RETRIER,
    DEFAULT_EMBED_RETRIER,
    AsyncRetrier,
    TransientError,
)

DEFAULT_CHAT_SPEC = "openai:gpt-4o"
DEFAULT_EMBEDDING_SPEC = "openai:text-embedding-ada-002"


# ---------------------------------------------------------------------------
# Azure endpoint handling
# ---------------------------------------------------------------------------


def parse_azure_endpoint(envvar: str = "AZURE_OPENAI_ENDPOINT") -> tuple[str, str, str]:
    """Split a full Azure deployment URL into (base, api_version, deployment).

    Accepts the repo-wide format: a complete request URL such as
    ``https://res.openai.azure.com/openai/deployments/gpt-4o/chat/completions
    ?api-version=2024-06-01``. Also accepts a bare resource endpoint.

    A gateway path prefix before the ``/openai/deployments/`` route is
    preserved in the base, so APIM-proxied endpoints like
    ``https://apim.net/openai/openai/deployments/gpt-4o/...`` yield base
    ``https://apim.net/openai`` (parity: reference aitools/utils.py
    parse_azure_endpoint_parts).
    """
    raw = os.environ.get(envvar, "")
    if not raw:
        raise ValueError(f"Environment variable {envvar} is not set")
    parsed = urllib.parse.urlparse(raw)
    query = urllib.parse.parse_qs(parsed.query)
    api_version = query.get("api-version", ["2024-06-01"])[0]
    deployment = ""
    segs = [s for s in parsed.path.split("/") if s]
    if "deployments" in segs:
        i = segs.index("deployments")
        if i + 1 < len(segs):
            deployment = segs[i + 1]
        # The Azure route is ".../openai/deployments/<name>/..."; everything
        # before its "openai" segment is a gateway (APIM) prefix to keep.
        route_start = i - 1 if i > 0 and segs[i - 1] == "openai" else i
        base_segs = segs[:route_start]
    elif segs and segs[-1] == "openai":
        base_segs = segs[:-1]  # bare ".../openai" route, no deployment
    else:
        base_segs = segs  # bare resource endpoint (possibly behind a prefix)
    base = f"{parsed.scheme}://{parsed.netloc}"
    if base_segs:
        base += "/" + "/".join(base_segs)
    return base, api_version, deployment


# ---------------------------------------------------------------------------
# Transport: blocking POSTs on worker threads, one connection per host each
# ---------------------------------------------------------------------------

# Worker threads of one model's transport: enough for the extraction
# pipeline's concurrent chunks with room to spare.
HTTP_WORKERS = 8


class _HttpTransport:
    """JSON POSTs with ``http.client`` off the event loop: a bounded pool
    of worker threads (started as requests need them), each keeping one
    persistent connection per host. One per model, as the JAX adapters
    keep one ``httpx.AsyncClient`` each."""

    def __init__(self, timeout: float):
        self._timeout = timeout
        self._executor = ThreadPoolExecutor(
            max_workers=HTTP_WORKERS, thread_name_prefix="typeagent-http"
        )
        self._local = threading.local()

    def _connection(
        self, parts: urllib.parse.SplitResult
    ) -> tuple[http.client.HTTPConnection, bool]:
        """This thread's connection to the URL's host, and whether it is new."""
        pool: dict = self._local.__dict__.setdefault("connections", {})
        conn = pool.get((parts.scheme, parts.netloc))
        if conn is not None:
            return conn, False
        if parts.scheme == "https":
            conn = http.client.HTTPSConnection(parts.netloc, timeout=self._timeout)
        elif parts.scheme == "http":
            conn = http.client.HTTPConnection(parts.netloc, timeout=self._timeout)
        else:
            raise ValueError(f"unsupported URL scheme {parts.scheme!r}")
        pool[(parts.scheme, parts.netloc)] = conn
        return conn, True

    def _drop(self, parts: urllib.parse.SplitResult) -> None:
        pool: dict = self._local.__dict__.get("connections", {})
        conn = pool.pop((parts.scheme, parts.netloc), None)
        if conn is not None:
            conn.close()

    def _post_blocking(
        self, url: str, headers: dict[str, str], payload: dict
    ) -> tuple[int, bytes]:
        """POST ``payload`` as JSON, encoded as httpx encodes it (compact,
        UTF-8), on this thread's connection; returns (status, body). A
        kept-alive connection that the server closed since its last use is
        reopened, as httpx's pool does; a failure to reach the host is a
        ``URLError``, transient as httpx's ``ConnectError`` is."""
        parts = urllib.parse.urlsplit(url)
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        body = json.dumps(
            payload, ensure_ascii=False, separators=(",", ":"), allow_nan=False
        ).encode("utf-8")
        request_headers = {"Content-Type": "application/json", **headers}
        while True:
            conn, fresh = self._connection(parts)
            try:
                conn.request("POST", target, body=body, headers=request_headers)
                resp = conn.getresponse()
                data = resp.read()
            except ConnectionError:
                self._drop(parts)
                if fresh:
                    raise
                continue  # the server closed the idle connection: reconnect
            except (TimeoutError, http.client.HTTPException):
                self._drop(parts)
                raise
            except OSError as exc:  # name resolution, an unreachable network
                self._drop(parts)
                raise urllib.error.URLError(exc) from exc
            if resp.will_close:
                self._drop(parts)
            return resp.status, data

    async def post_json(self, url: str, headers: dict[str, str], payload: dict) -> dict:
        """One request off the event loop; the parsed JSON of a 2xx reply.
        429 and 5xx raise :class:`TransientError`, any other non-2xx
        status ``urllib.error.HTTPError``."""
        loop = asyncio.get_running_loop()
        status, data = await loop.run_in_executor(
            self._executor, self._post_blocking, url, headers, payload
        )
        if status == 429 or status >= 500:
            text = data.decode("utf-8", errors="replace")
            raise TransientError(f"HTTP {status}: {text[:200]}")
        if not 200 <= status < 300:
            raise urllib.error.HTTPError(
                url, status, http.client.responses.get(status, ""), None, None
            )
        return json.loads(data)


# ---------------------------------------------------------------------------
# HTTP chat model
# ---------------------------------------------------------------------------


class HttpChatModel:
    """OpenAI-compatible chat completions over HTTP.

    Satisfies the framework's chat protocol: ``complete(prompt) -> Result[str]``
    where prompt is a string or a list of {"role", "content"} sections
    (parity: `model_adapters.py:107-143`).
    """

    def __init__(
        self,
        model_name: str,
        *,
        url: str,
        headers: dict[str, str] | Callable[[], dict[str, str]],
        retrier: AsyncRetrier | None = None,
        timeout: float = 120.0,
    ):
        self.model_name = model_name
        self._url = url
        self._headers = headers
        self._retrier = retrier or DEFAULT_CHAT_RETRIER
        self._transport = _HttpTransport(timeout)

    async def _request(self, messages: list[dict]) -> str:
        payload = {"model": self.model_name, "messages": messages}
        headers = self._headers() if callable(self._headers) else self._headers
        data = await self._transport.post_json(self._url, headers, payload)
        return data["choices"][0]["message"]["content"] or ""

    async def complete(self, prompt: list[PromptSection]) -> Result[str]:
        if isinstance(prompt, str):
            messages = [{"role": "user", "content": prompt}]
        else:
            messages = [
                {"role": s["role"], "content": s["content"]} for s in prompt
            ]
        try:
            text = await self._retrier(self._request, messages)
        except Exception as exc:
            return Failure(f"chat request failed: {exc!r}")
        if not text:
            return Failure("No text content in model response")
        return Success(text)


# ---------------------------------------------------------------------------
# HTTP embedder
# ---------------------------------------------------------------------------


class HttpEmbedder:
    """OpenAI-compatible /embeddings over HTTP; normalizes on receipt."""

    def __init__(
        self,
        model_name: str,
        *,
        url: str,
        headers: dict[str, str] | Callable[[], dict[str, str]],
        retrier: AsyncRetrier | None = None,
        timeout: float = 60.0,
        send_model_field: bool = True,
    ):
        self.model_name = model_name
        self._url = url
        self._headers = headers
        self._retrier = retrier or DEFAULT_EMBED_RETRIER
        self._transport = _HttpTransport(timeout)
        self._send_model_field = send_model_field

    async def _request(self, inputs: list[str]) -> NormalizedEmbeddings:
        payload: dict = {"input": inputs}
        if self._send_model_field:
            payload["model"] = self.model_name
        headers = self._headers() if callable(self._headers) else self._headers
        data = (await self._transport.post_json(self._url, headers, payload))["data"]
        data.sort(key=lambda d: d["index"])
        return normalize(np.array([d["embedding"] for d in data], dtype=np.float32))

    async def get_embedding_nocache(self, input: str) -> NormalizedEmbedding:
        return (await self.get_embeddings_nocache([input]))[0]

    async def get_embeddings_nocache(self, input: list[str]) -> NormalizedEmbeddings:
        if not input:
            raise ValueError("Cannot embed an empty list")
        return await self._retrier(self._request, input)


# ---------------------------------------------------------------------------
# Deterministic offline fakes
# ---------------------------------------------------------------------------


def _fake_embedding(text: str, size: int) -> np.ndarray:
    """Deterministic pseudo-embedding: sha256-seeded floats, unnormalized.

    Same string -> same vector across runs/processes; different strings get
    (nearly always) different directions. Raises on empty input (parity with
    the reference fake, `model_adapters.py:382-404`).
    """
    if not text:
        raise ValueError("Empty input text")
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    rng = np.random.default_rng(np.frombuffer(digest[:16], dtype=np.uint64))
    return rng.random(size, dtype=np.float32)


class FakeEmbedder:
    """Offline deterministic embedder for hermetic tests (model_name='test')."""

    def __init__(self, embedding_size: int = 3):
        self._size = embedding_size

    @property
    def model_name(self) -> str:
        return TEST_MODEL_NAME

    async def get_embedding_nocache(self, input: str) -> NormalizedEmbedding:
        return normalize(_fake_embedding(input, self._size))

    async def get_embeddings_nocache(self, input: list[str]) -> NormalizedEmbeddings:
        if not input:
            raise ValueError("Cannot embed an empty list")
        return normalize(np.stack([_fake_embedding(t, self._size) for t in input]))


class FakeChatModel:
    """Offline chat model returning canned or echo responses (for tests)."""

    model_name = TEST_MODEL_NAME

    def __init__(self, responses: list[str] | None = None):
        self.responses = list(responses or [])
        self.prompts: list = []

    async def complete(self, prompt: list[PromptSection]) -> Result[str]:
        self.prompts.append(prompt)
        if self.responses:
            return Success(self.responses.pop(0))
        return Failure("FakeChatModel has no canned responses left")


# ---------------------------------------------------------------------------
# Provider registry
# ---------------------------------------------------------------------------


@_dataclass(frozen=True)
class ProviderSpec:
    """An OpenAI-compatible provider: base URL + API-key env var.

    Covers the breadth the reference reaches through the pydantic-ai
    registry (`model_adapters.py:254-367` there): any vendor speaking the
    /chat/completions + /embeddings wire format plugs in with one entry.
    """

    base_url: str
    api_key_envvar: str
    chat_path: str = "/chat/completions"
    embeddings_path: str = "/embeddings"


# Built-in OpenAI-compatible endpoints. The base URL can be overridden per
# provider with <PROVIDER>_BASE_URL.
PROVIDERS: dict[str, ProviderSpec] = {
    "openai": ProviderSpec("https://api.openai.com/v1", "OPENAI_API_KEY"),
    "openrouter": ProviderSpec(
        "https://openrouter.ai/api/v1", "OPENROUTER_API_KEY"
    ),
    "deepseek": ProviderSpec("https://api.deepseek.com/v1", "DEEPSEEK_API_KEY"),
    "together": ProviderSpec("https://api.together.xyz/v1", "TOGETHER_API_KEY"),
    "fireworks": ProviderSpec(
        "https://api.fireworks.ai/inference/v1", "FIREWORKS_API_KEY"
    ),
    "groq": ProviderSpec("https://api.groq.com/openai/v1", "GROQ_API_KEY"),
    "mistral": ProviderSpec("https://api.mistral.ai/v1", "MISTRAL_API_KEY"),
    "xai": ProviderSpec("https://api.x.ai/v1", "XAI_API_KEY"),
    "grok": ProviderSpec("https://api.x.ai/v1", "XAI_API_KEY"),
    "perplexity": ProviderSpec("https://api.perplexity.ai", "PERPLEXITY_API_KEY"),
    "moonshot": ProviderSpec("https://api.moonshot.ai/v1", "MOONSHOT_API_KEY"),
    "cerebras": ProviderSpec("https://api.cerebras.ai/v1", "CEREBRAS_API_KEY"),
    "anthropic": ProviderSpec(
        # Anthropic's OpenAI-compatible surface (chat only).
        "https://api.anthropic.com/v1",
        "ANTHROPIC_API_KEY",
    ),
    "ollama": ProviderSpec("http://localhost:11434/v1", "OLLAMA_API_KEY"),
    "vllm": ProviderSpec("http://localhost:8000/v1", "VLLM_API_KEY"),
    # Vendors with OpenAI-compatible gateways (the compatibility base URL,
    # not their native API). Matches the breadth of the reference's
    # pydantic-ai registry (`model_adapters.py:17-25` there).
    "gemini": ProviderSpec(
        "https://generativelanguage.googleapis.com/v1beta/openai",
        "GEMINI_API_KEY",
    ),
    "cohere": ProviderSpec(
        "https://api.cohere.ai/compatibility/v1", "COHERE_API_KEY"
    ),
    "huggingface": ProviderSpec("https://router.huggingface.co/v1", "HF_TOKEN"),
    "github": ProviderSpec("https://models.github.ai/inference", "GITHUB_TOKEN"),
    "nebius": ProviderSpec("https://api.studio.nebius.com/v1", "NEBIUS_API_KEY"),
    "heroku": ProviderSpec(
        "https://us.inference.heroku.com/v1", "HEROKU_INFERENCE_KEY"
    ),
    "vercel": ProviderSpec(
        "https://ai-gateway.vercel.sh/v1", "VERCEL_AI_GATEWAY_API_KEY"
    ),
    "dashscope": ProviderSpec(
        "https://dashscope-intl.aliyuncs.com/compatible-mode/v1",
        "DASHSCOPE_API_KEY",
    ),
    "zhipu": ProviderSpec(
        "https://open.bigmodel.cn/api/paas/v4", "ZHIPU_API_KEY"
    ),
    "siliconflow": ProviderSpec(
        "https://api.siliconflow.com/v1", "SILICONFLOW_API_KEY"
    ),
    "novita": ProviderSpec("https://api.novita.ai/v3/openai", "NOVITA_API_KEY"),
    "baseten": ProviderSpec(
        "https://inference.baseten.co/v1", "BASETEN_API_KEY"
    ),
    "lmstudio": ProviderSpec("http://localhost:1234/v1", "LMSTUDIO_API_KEY"),
    "litellm": ProviderSpec("http://localhost:4000/v1", "LITELLM_API_KEY"),
}


def register_provider(name: str, spec: ProviderSpec) -> None:
    """Add or replace a ``provider:model`` spec target at runtime."""
    PROVIDERS[name] = spec


def _provider_base_and_headers(provider: str) -> tuple[ProviderSpec, str, dict]:
    spec = PROVIDERS[provider]
    base = os.getenv(
        f"{provider.upper()}_BASE_URL",
        os.getenv("OPENAI_BASE_URL", spec.base_url) if provider == "openai"
        else spec.base_url,
    ).rstrip("/")
    headers = {
        "Authorization": f"Bearer {os.getenv(spec.api_key_envvar, '')}"
    }
    return spec, base, headers


# ---------------------------------------------------------------------------
# Factories
# ---------------------------------------------------------------------------


def _needs_azure_fallback(provider: str) -> bool:
    return (
        provider == "openai"
        and not os.getenv("OPENAI_API_KEY")
        and bool(os.getenv("AZURE_OPENAI_API_KEY"))
    )


def _azure_headers(
    api_key_envvar: str,
) -> dict[str, str] | Callable[[], dict[str, str]]:
    raw_key = os.environ[api_key_envvar]
    apim = os.getenv("AZURE_APIM_SUBSCRIPTION_KEY")
    if raw_key.lower() == "identity":
        # Managed identity: bearer tokens fetched per request through the
        # shared caching provider (parity: reference aitools/auth.py:20-63,
        # model_adapters.py managed-identity client path).
        from .auth import get_shared_token_provider

        provider = get_shared_token_provider()

        def headers() -> dict[str, str]:
            out = {"Authorization": f"Bearer {provider.get_token()}"}
            if apim:
                out["Ocp-Apim-Subscription-Key"] = apim
            return out

        return headers
    headers = {"api-key": raw_key}
    if apim:
        headers["Ocp-Apim-Subscription-Key"] = apim
    return headers


def create_chat_model(
    model_spec: str | None = None,
    *,
    retrier: AsyncRetrier | None = None,
) -> IChatModel:
    """Create a chat model from a ``provider:model`` spec.

    Supported providers: ``openai`` (with automatic Azure fallback),
    ``azure``, ``test``. Any OpenAI-compatible endpoint works via
    ``OPENAI_BASE_URL``.
    """
    if model_spec is None:
        env_model = os.getenv("OPENAI_MODEL")
        model_spec = f"openai:{env_model}" if env_model else DEFAULT_CHAT_SPEC
    provider, _, model_name = model_spec.partition(":")
    if provider == "test":
        return FakeChatModel()
    if not model_name:
        provider, model_name = "openai", provider
    if provider == "azure" or _needs_azure_fallback(provider):
        base, api_version, deployment = parse_azure_endpoint()
        name = deployment or model_name
        url = (
            f"{base}/openai/deployments/{name}/chat/completions"
            f"?api-version={api_version}"
        )
        return HttpChatModel(
            name, url=url, headers=_azure_headers("AZURE_OPENAI_API_KEY"),
            retrier=retrier,
        )
    if provider not in PROVIDERS:
        raise ValueError(
            f"Unknown provider {provider!r}; known: azure, test, "
            f"{', '.join(sorted(PROVIDERS))}. Use register_provider() for "
            "custom OpenAI-compatible endpoints."
        )
    spec, base, headers = _provider_base_and_headers(provider)
    return HttpChatModel(
        model_name, url=f"{base}{spec.chat_path}", headers=headers, retrier=retrier
    )


def create_embedding_model(
    model_spec: str | None = None,
    retrier: AsyncRetrier | None = None,
) -> CachingEmbeddingModel:
    """Create a caching embedding model from a ``provider:model`` spec."""
    if model_spec is None:
        env_model = os.getenv("OPENAI_EMBEDDING_MODEL")
        if env_model and ":" in env_model:
            model_spec = env_model  # full provider:model spec in the env var
        else:
            model_spec = f"openai:{env_model}" if env_model else DEFAULT_EMBEDDING_SPEC
    provider, _, model_name = model_spec.partition(":")
    if provider == "test":
        # 'test' or 'test:<dim>' -> offline deterministic embedder.
        size = int(model_name) if model_name.isdigit() else 3
        return create_test_embedding_model(size)
    if not model_name:
        provider, model_name = "openai", provider
    if provider == "azure" or _needs_azure_fallback(provider):
        envvar = model_to_envvar.get(model_name, "")
        endpoint_envvar = (
            envvar if envvar and os.getenv(envvar) else "AZURE_OPENAI_ENDPOINT_EMBEDDING"
        )
        api_key_envvar = (
            "AZURE_OPENAI_API_KEY_EMBEDDING"
            if os.getenv("AZURE_OPENAI_API_KEY_EMBEDDING")
            else "AZURE_OPENAI_API_KEY"
        )
        base, api_version, deployment = parse_azure_endpoint(endpoint_envvar)
        name = deployment or model_name
        url = f"{base}/openai/deployments/{name}/embeddings?api-version={api_version}"
        embedder = HttpEmbedder(
            name, url=url, headers=_azure_headers(api_key_envvar), retrier=retrier,
            send_model_field=False,
        )
        return CachingEmbeddingModel(embedder)
    if provider not in PROVIDERS:
        raise ValueError(
            f"Unknown provider {provider!r}; known: azure, test, "
            f"{', '.join(sorted(PROVIDERS))}. Use register_provider() for "
            "custom OpenAI-compatible endpoints."
        )
    spec, base, headers = _provider_base_and_headers(provider)
    embedder = HttpEmbedder(
        model_name,
        url=f"{base}{spec.embeddings_path}",
        headers=headers,
        retrier=retrier,
    )
    return CachingEmbeddingModel(embedder)


def create_test_embedding_model(embedding_size: int = 3) -> CachingEmbeddingModel:
    """Deterministic offline embedding model — no keys, no network."""
    return CachingEmbeddingModel(FakeEmbedder(embedding_size))


def configure_models(
    chat_model_spec: str,
    embedding_model_spec: str,
    chat_retrier: AsyncRetrier | None = None,
    embed_retrier: AsyncRetrier | None = None,
) -> tuple[IChatModel, IEmbeddingModel]:
    """Configure chat + embedding models at once (parity: model_adapters.py:451-474)."""
    return (
        create_chat_model(chat_model_spec, retrier=chat_retrier),
        create_embedding_model(embedding_model_spec, retrier=embed_retrier),
    )
