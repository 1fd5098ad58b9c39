"""The port's retrier (``typeagent_tpu_torch/models/retry.py``): the JAX
module's retry cases, and which standard-library errors are transient
(the JAX module tests ``httpx``'s; the port may not import it)."""

import asyncio
import urllib.error

import pytest

from typeagent_tpu_torch.models import retry
from typeagent_tpu_torch.models.retry import AsyncRetrier, TransientError, is_transient


@pytest.fixture(autouse=True)
def no_sleep():
    retry.set_testing(True)
    yield
    retry.set_testing(False)


def _http_error(code: int) -> urllib.error.HTTPError:
    return urllib.error.HTTPError("http://localhost/", code, "status", {}, None)


@pytest.mark.parametrize("exc,transient", [
    (TransientError("x"), True),
    (TimeoutError(), True),
    (asyncio.TimeoutError(), True),
    (ConnectionError(), True),
    (ConnectionResetError(), True),
    (_http_error(429), True),
    (_http_error(500), True),
    (_http_error(503), True),
    (_http_error(400), False),
    (_http_error(404), False),
    (ValueError("x"), False),
    # A host that cannot be reached: transient, as httpx's ConnectError is
    # in the JAX package.
    (urllib.error.URLError("no route"), True),
])
def test_is_transient(exc, transient):
    assert is_transient(exc) is transient


def _flaky(fail_times: int, exc: BaseException):
    calls = {"n": 0}

    async def fn():
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise exc
        return "ok"

    return fn, calls


def test_retry_transient_then_success():
    fn, calls = _flaky(2, TransientError("try again"))
    assert asyncio.run(AsyncRetrier(attempts=5)(fn)) == "ok"
    assert calls["n"] == 3


def test_retry_http_429_then_success():
    fn, calls = _flaky(1, _http_error(429))
    assert asyncio.run(AsyncRetrier(attempts=5)(fn)) == "ok"
    assert calls["n"] == 2


def test_retry_nontransient_raises_immediately():
    fn, calls = _flaky(9, ValueError("permanent"))
    with pytest.raises(ValueError):
        asyncio.run(AsyncRetrier(attempts=5)(fn))
    assert calls["n"] == 1


def test_retry_exhausts_attempts():
    fn, calls = _flaky(9, TransientError("nope"))
    with pytest.raises(TransientError):
        asyncio.run(AsyncRetrier(attempts=3)(fn))
    assert calls["n"] == 3


def test_cancellation_is_not_retried():
    fn, calls = _flaky(9, asyncio.CancelledError())
    with pytest.raises(asyncio.CancelledError):
        asyncio.run(AsyncRetrier(attempts=5)(fn))
    assert calls["n"] == 1
