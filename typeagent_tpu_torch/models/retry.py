"""Async retry with exponential backoff and jitter.

The port of ``typeagent_tpu/models/retry.py``: 6 attempts, a 120 s total
budget, a warning logged per retry; tests disable the sleeps with
:func:`set_testing`. The JAX module recognizes transient errors by
``httpx``'s types; this one, which must not import ``httpx``, by the
standard library's, case for case: ``urllib.error.HTTPError`` with status
429 or 5xx (httpx's ``HTTPStatusError``), ``URLError`` and
``ConnectionError`` (``ConnectError``), ``TimeoutError``, which
``socket.timeout`` is (``TimeoutException``).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import urllib.error
from typing import Any, Awaitable, Callable

logger = logging.getLogger("typeagent_tpu_torch.retry")

_TESTING = False


def set_testing(flag: bool) -> None:
    """Disable retry sleeps (used by the test suite)."""
    global _TESTING
    _TESTING = flag


class TransientError(Exception):
    """An error worth retrying (rate limit, timeout, 5xx)."""


def is_transient(exc: BaseException) -> bool:
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code == 429 or exc.code >= 500
    return isinstance(
        exc, (TransientError, TimeoutError, ConnectionError, urllib.error.URLError)
    )


class AsyncRetrier:
    def __init__(
        self,
        attempts: int = 6,
        timeout: float = 120.0,
        base_delay: float = 1.0,
        max_delay: float = 30.0,
    ):
        self.attempts = attempts
        self.timeout = timeout
        self.base_delay = base_delay
        self.max_delay = max_delay

    async def __call__(self, fn: Callable[..., Awaitable[Any]], *args: Any, **kwargs: Any) -> Any:
        start = time.monotonic()
        attempt = 0
        while True:
            attempt += 1
            try:
                return await fn(*args, **kwargs)
            except Exception as exc:
                elapsed = time.monotonic() - start
                if (
                    not is_transient(exc)
                    or attempt >= self.attempts
                    or elapsed >= self.timeout
                ):
                    raise
                delay = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
                delay *= 0.5 + random.random()  # full jitter
                logger.warning(
                    "retrying %s (attempt %d, waited %.1fs so far, waiting %.1fs): %r",
                    getattr(fn, "__name__", fn),
                    attempt,
                    elapsed,
                    delay,
                    exc,
                )
                if not _TESTING:
                    await asyncio.sleep(delay)


DEFAULT_CHAT_RETRIER = AsyncRetrier(attempts=6, timeout=120)
DEFAULT_EMBED_RETRIER = AsyncRetrier(attempts=6, timeout=120)
