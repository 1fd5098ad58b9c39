"""Text-location index: embedding row ordinal -> (message, chunk) location.

The port of ``typeagent_tpu/knowpro/textlocindex.py`` (parity: reference
knowpro/textlocindex.py). Embeddings live on the settings' device via
EmbeddingIndex; locations are a host-side SoA mirror consulted only for the
k winners of each lookup.
"""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np

from ..vectorstore import ScoredInt, TextEmbeddingIndexSettings
from .fuzzyindex import EmbeddingIndex
from .interfaces import TextLocation, TextToTextLocationIndexData


@dataclass
class ScoredTextLocation:
    text_location: TextLocation
    score: float


class TextToTextLocationIndex:
    def __init__(self, settings: TextEmbeddingIndexSettings):
        self._text_locations: list[TextLocation] = []
        self._embedding_index = EmbeddingIndex(settings=settings)
        self._settings = settings

    async def size(self) -> int:
        return await self._embedding_index.size()

    async def is_empty(self) -> bool:
        return await self._embedding_index.is_empty()

    def get(self, pos: int, default: TextLocation | None = None) -> TextLocation | None:
        if 0 <= pos < len(self._text_locations):
            return self._text_locations[pos]
        return default

    async def add_text_location(self, text: str, text_location: TextLocation) -> None:
        await self.add_text_locations([(text, text_location)])

    async def add_text_locations(
        self, text_and_locations: list[tuple[str, TextLocation]]
    ) -> None:
        await self._embedding_index.add_texts([t for t, _ in text_and_locations])
        self._text_locations.extend([loc for _, loc in text_and_locations])

    async def add_text_locations_with_embeddings(
        self,
        text_locations: list[TextLocation],
        embeddings: list[np.ndarray],
    ) -> None:
        if len(text_locations) != len(embeddings):
            raise ValueError(
                "text_locations and embeddings must have the same length: "
                f"{len(text_locations)} != {len(embeddings)}"
            )
        if not text_locations:
            return
        array = np.stack(embeddings, axis=0).astype(np.float32, copy=False)
        self._embedding_index.push(array)
        self._text_locations.extend(text_locations)

    # -- embedding generation (model + cache live in the vector base) --------

    async def generate_embedding(self, text: str, cache: bool = True) -> np.ndarray:
        return await self._embedding_index.get_embedding(text, cache)

    async def generate_embeddings(
        self, texts: list[str], cache: bool = True
    ) -> list[np.ndarray]:
        if not texts:
            return []
        return list(
            await self._embedding_index.get_embeddings(texts, cache=cache)
        )

    # -- lookups: text strings embed first, embedding variants go straight
    # to the device index ------------------------------------------------------

    def to_scored_locations(self, matches: list[ScoredInt]) -> list[ScoredTextLocation]:
        locations = self._text_locations
        return [ScoredTextLocation(locations[m.item], m.score) for m in matches]

    def lookup_by_embedding(
        self,
        text_embedding: np.ndarray,
        max_matches: int | None = None,
        threshold_score: float | None = None,
        predicate: Callable[[int], bool] | None = None,
    ) -> list[ScoredTextLocation]:
        return self.to_scored_locations(
            self._embedding_index.get_indexes_of_nearest(
                text_embedding, max_matches, threshold_score, predicate
            )
        )

    def lookup_in_subset_by_embedding(
        self,
        text_embedding: np.ndarray,
        ordinals_to_match: list[int],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredTextLocation]:
        return self.to_scored_locations(
            self._embedding_index.get_indexes_of_nearest_in_subset(
                text_embedding, ordinals_to_match, max_matches, threshold_score
            )
        )

    async def lookup_in_subset_by_embedding_async(
        self,
        text_embedding: np.ndarray,
        ordinals_to_match: list[int],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredTextLocation]:
        """Async subset lookup (non-blocking device fetch)."""
        return self.to_scored_locations(
            await self._embedding_index.get_indexes_of_nearest_in_subset_async(
                text_embedding, ordinals_to_match, max_matches, threshold_score
            )
        )

    async def lookup_text(
        self,
        text: str,
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredTextLocation]:
        min_score = 0.85 if threshold_score is None else threshold_score
        embedding = await self.generate_embedding(text)
        # Async route: event loop stays live during the device round trip;
        # concurrent requests' lookups coalesce into shared dispatches.
        rows = await self._embedding_index.get_indexes_of_nearest_batch_async(
            np.asarray(embedding, dtype=np.float32).reshape(1, -1),
            max_matches=max_matches,
            min_score=min_score,
        )
        return self.to_scored_locations(rows[0])

    async def lookup_text_in_subset(
        self,
        text: str,
        ordinals_to_search: list[int],
        max_matches: int | None = None,
        threshold_score: float | None = None,
    ) -> list[ScoredTextLocation]:
        return self.lookup_in_subset_by_embedding(
            await self.generate_embedding(text),
            ordinals_to_search,
            max_matches,
            threshold_score,
        )

    def clear(self) -> None:
        self._text_locations = []
        self._embedding_index.clear()

    def serialize(self) -> TextToTextLocationIndexData:
        return TextToTextLocationIndexData(
            textLocations=[loc.serialize() for loc in self._text_locations],
            embeddings=self._embedding_index.serialize(),
        )

    def deserialize(self, data: TextToTextLocationIndexData) -> None:
        self.clear()
        text_locations = data["textLocations"]
        embeddings = data["embeddings"]
        if embeddings is None:
            raise ValueError("No embeddings found")
        if len(text_locations) != len(embeddings):
            raise ValueError(
                f"TextToTextLocationIndexData corrupt: {len(text_locations)} "
                f"locations != {len(embeddings)} embeddings"
            )
        self._text_locations = [TextLocation.deserialize(l) for l in text_locations]
        self._embedding_index.deserialize(embeddings)
