"""Small async helpers."""

from collections.abc import AsyncIterable, AsyncIterator


async def aenumerate[T](
    iterable: AsyncIterable[T], start: int = 0
) -> AsyncIterator[tuple[int, T]]:
    i = start
    async for item in iterable:
        yield i, item
        i += 1
