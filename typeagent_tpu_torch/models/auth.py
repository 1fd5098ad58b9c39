"""Azure managed-identity token provider.

Parity: reference ``aitools/auth.py:20-63`` — a ``DefaultAzureCredential``
wrapper that caches the access token and refreshes it when it is within
5 minutes of expiry. The ``azure-identity`` package is optional: pass an
explicit ``credential`` (anything with ``get_token(scope)``) to avoid the
import, which is what the tests do.

Used when ``AZURE_OPENAI_API_KEY=identity``: request headers are built per
call through :meth:`AzureTokenProvider.get_token`, so tokens rotate without
recreating the model adapter.

The port of ``typeagent_tpu/models/auth.py`` (plain Python, the same code);
``azure.identity`` is imported only when no credential is given.
"""

from __future__ import annotations

import time
from typing import Any, Protocol

COGNITIVE_SERVICES_SCOPE = "https://cognitiveservices.azure.com/.default"
_REFRESH_MARGIN_SECONDS = 300


class IAccessToken(Protocol):
    @property
    def token(self) -> str: ...

    @property
    def expires_on(self) -> int:  # POSIX timestamp
        ...


class AzureTokenProvider:
    """Caching credential wrapper; refreshes within 5 minutes of expiry."""

    def __init__(self, credential: Any | None = None):
        if credential is None:
            try:
                from azure.identity import DefaultAzureCredential
            except ImportError as exc:  # pragma: no cover - env dependent
                raise RuntimeError(
                    "Azure managed-identity auth requires the azure-identity "
                    "package (or pass an explicit credential)."
                ) from exc
            credential = DefaultAzureCredential()
        self.credential = credential
        self.access_token: IAccessToken | None = None

    def get_token(self) -> str:
        if self.needs_refresh():
            return self.refresh_token()
        assert self.access_token is not None
        return self.access_token.token

    def refresh_token(self) -> str:
        self.access_token = self.credential.get_token(COGNITIVE_SERVICES_SCOPE)
        assert self.access_token is not None
        return self.access_token.token

    def needs_refresh(self) -> bool:
        return (
            self.access_token is None
            or self.access_token.expires_on - time.time() <= _REFRESH_MARGIN_SECONDS
        )


_shared_token_provider: AzureTokenProvider | None = None


def get_shared_token_provider() -> AzureTokenProvider:
    global _shared_token_provider
    if _shared_token_provider is None:
        _shared_token_provider = AzureTokenProvider()
    return _shared_token_provider


def set_shared_token_provider(provider: AzureTokenProvider | None) -> None:
    """Inject/reset the process-wide provider (tests, custom credentials)."""
    global _shared_token_provider
    _shared_token_provider = provider
