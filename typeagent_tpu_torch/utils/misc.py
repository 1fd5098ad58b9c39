"""Timing context manager, .env loader, batching helpers.

(Parity role: reference `aitools/utils.py:20-44` timelog; python-dotenv use.)
The port of ``typeagent_tpu/utils/misc.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections.abc import Iterable, Iterator
from typing import TypeVar

T = TypeVar("T")


@contextlib.contextmanager
def timelog(label: str, *, verbose: bool = True) -> Iterator[None]:
    """Print wall-clock seconds for the enclosed block."""
    start = time.perf_counter()
    try:
        yield
    finally:
        if verbose:
            elapsed = time.perf_counter() - start
            print(f"{label}: {elapsed:.3f}s")


def load_dotenv(path: str = ".env", *, override: bool = False) -> dict[str, str]:
    """Minimal .env loader (KEY=VALUE lines, # comments, optional quotes)."""
    loaded: dict[str, str] = {}
    if not os.path.exists(path):
        return loaded
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip().strip("'\"")
            loaded[key] = value
            if override or key not in os.environ:
                os.environ[key] = value
    return loaded


def batched(items: Iterable[T], batch_size: int) -> Iterator[list[T]]:
    """Yield lists of up to batch_size items."""
    batch: list[T] = []
    for item in items:
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
