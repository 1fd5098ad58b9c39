"""Success/Failure result types for LLM calls (typechat-equivalent).

The reference uses ``typechat.Result`` (Success/Failure union); this is the
standalone replacement with the same shape: ``Success.value`` holds the data,
``Failure.message`` the error.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Generic, TypeVar, Union

T = TypeVar("T")


@dataclass
class Success(Generic[T]):
    value: T


@dataclass
class Failure:
    message: str


Result = Union[Success[T], Failure]
