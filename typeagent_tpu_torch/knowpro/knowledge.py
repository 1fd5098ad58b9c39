"""Bounded-concurrency LLM knowledge extraction + entity/topic merging.

The port of ``typeagent_tpu/knowpro/knowledge.py`` (plain Python, the same code).

(Parity: reference knowpro/knowledge.py — asyncio queue + worker pool,
lowercase-normalized entity merge with "; "-joined facet values.)
"""

from __future__ import annotations

import asyncio
from collections.abc import Callable
from dataclasses import dataclass

from ..models.result import Result
from . import kplib
from .interfaces import IKnowledgeExtractor


async def extract_knowledge_from_text(
    knowledge_extractor: IKnowledgeExtractor, text: str
) -> Result[kplib.KnowledgeResponse]:
    return await knowledge_extractor.extract(text)


async def _batch_worker(
    q: asyncio.Queue,
    knowledge_extractor: IKnowledgeExtractor,
    results: dict[int, Result[kplib.KnowledgeResponse]],
) -> None:
    while item := await q.get():
        index, text = item
        results[index] = await extract_knowledge_from_text(knowledge_extractor, text)


async def extract_knowledge_from_text_batch(
    knowledge_extractor: IKnowledgeExtractor,
    text_batch: list[str],
    concurrency: int = 4,
) -> list[Result[kplib.KnowledgeResponse]]:
    """Extract knowledge for each text with a bounded worker pool."""
    if not text_batch:
        return []
    q: asyncio.Queue = asyncio.Queue(maxsize=2 * concurrency + 2)
    results: dict[int, Result[kplib.KnowledgeResponse]] = {}
    async with asyncio.TaskGroup() as tg:
        for _ in range(concurrency):
            tg.create_task(_batch_worker(q, knowledge_extractor, results))
        for index, text in enumerate(text_batch):
            await q.put((index, text))
        for _ in range(concurrency):
            await q.put(None)
    return [results[i] for i in range(len(text_batch))]


# ---------------------------------------------------------------------------
# Merging
# ---------------------------------------------------------------------------


@dataclass
class _MergedEntity:
    name: str
    types: set[str]
    facets: dict[str, set[str]]


def merge_concrete_entities(
    entities: list[kplib.ConcreteEntity],
    normalize: Callable[[str], str] = str.lower,
) -> list[kplib.ConcreteEntity]:
    """Merge entities by normalized name: union of types, facet values joined
    with '; ', output sorted by name for determinism."""
    if not entities:
        return []
    merged: dict[str, _MergedEntity] = {}
    for entity in entities:
        key = normalize(entity.name)
        existing = merged.get(key)
        if existing is None:
            merged[key] = _MergedEntity(
                name=key,
                types={normalize(t) for t in entity.type},
                facets=_facets_to_dict(entity.facets or [], normalize),
            )
        else:
            existing.types.update(normalize(t) for t in entity.type)
            for name, values in _facets_to_dict(entity.facets or [], normalize).items():
                existing.facets.setdefault(name, set()).update(values)

    result = []
    for m in sorted(merged.values(), key=lambda e: e.name):
        concrete = kplib.ConcreteEntity(name=m.name, type=sorted(m.types))
        if m.facets:
            concrete.facets = [
                kplib.Facet(name=name, value="; ".join(sorted(values)))
                for name, values in sorted(m.facets.items())
                if values
            ]
        result.append(concrete)
    return result


def _facets_to_dict(
    facets: list[kplib.Facet], normalize: Callable[[str], str]
) -> dict[str, set[str]]:
    merged: dict[str, set[str]] = {}
    for facet in facets:
        name = normalize(facet.name)
        value = normalize(str(facet.value)) if facet.value is not None else ""
        merged.setdefault(name, set()).add(value)
    return merged


def merge_topics(topics: list[str]) -> list[str]:
    """Unique topics (order not preserved, matching the reference)."""
    return list(set(topics))
