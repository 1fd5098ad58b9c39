"""The system under test: the port's stores, built from a configuration
and fed the benchmark's blocks through their public entries. This is the
only module of the benchmark that imports the program
(``typeagent_tpu_torch``); the reference never does.
"""

from __future__ import annotations

import numpy as np
import torch

from . import generate


def build(cfg: dict, seed: int, device: torch.device):
    kind = {"vector_store": VectorStoreSystem, "corpus_store": CorpusSystem}[cfg["system"]]
    return kind(cfg, seed, device)


def counters() -> dict[str, float]:
    """The program's counters (``utils.metrics.METRICS``) and kernel
    launch counts (``ops.topk.launch_counts``), as one flat dict."""
    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.utils.metrics import METRICS

    out = {f"launch.{k}": float(v) for k, v in topk.launch_counts().items()}
    out.update({k: float(v) for k, v in METRICS.counters.items()})
    return out


class VectorStoreSystem:
    """One ``VectorStore``, fed by ``reserve`` + ``load_device_rows``, asked
    through its async route (``fuzzy_lookup_embeddings_batch_async``: the
    per-loop ``LookupBatcher`` with the settings the program gives it)."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from typeagent_tpu_torch.models.adapters import create_test_embedding_model
        from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

        settings = TextEmbeddingIndexSettings(
            create_test_embedding_model(cfg["dim"]), min_score=0.0, dtype=cfg["dtype"],
            search_mode=cfg["search_mode"], device=device,
        )
        self.store = VectorStore(settings)
        self.store.reserve(cfg["rows"])
        self.centers = generate.topic_centers(cfg["topics"], cfg["dim"], seed, device)
        for block in generate.even_blocks(cfg["rows"], cfg["block_rows"]):
            self.store.load_device_rows(generate.rows_block(cfg, self.centers, seed, block))

    async def lookup(self, queries: np.ndarray, k: int, min_score: float, scope=None):
        return await self.store.fuzzy_lookup_embeddings_batch_async(
            queries, max_hits=k, min_score=min_score
        )

    @staticmethod
    def hits(result, k: int) -> dict[str, np.ndarray]:
        items = np.full((len(result), k), -1, dtype=np.int64)
        scores = np.full((len(result), k), np.nan)
        for i, row in enumerate(result):
            for j, hit in enumerate(row[:k]):
                items[i, j], scores[i, j] = hit.item, hit.score
        return {"items": items, "scores": scores}

    async def close(self) -> None:
        batcher = self.store._batcher
        if batcher is not None:
            await batcher.close()


class CorpusSystem:
    """One ``CorpusVectorStore``, fed by ``reserve`` + ``append_device`` one
    conversation (segment) at a time in the layout's order, and searched
    through ``search``, one query a call, as
    ``ConversationCorpus.search_embedding`` calls it: over the whole
    corpus, or scoped to a range of conversations."""

    def __init__(self, cfg: dict, seed: int, device: torch.device):
        from typeagent_tpu_torch.parallel.corpus import CorpusVectorStore

        self.layout = layout = generate.corpus_layout(cfg)
        self.names = [generate.conversation_name(c) for c in range(layout.n_conversations)]
        self.ids = {name: c for c, name in enumerate(self.names)}
        self._scopes: dict[tuple[int, int], list[str]] = {}
        self.store = CorpusVectorStore(
            cfg["dim"], device=device, dtype=cfg["dtype"], search_mode=cfg["search_mode"]
        )
        self.store.reserve(cfg["rows"])
        self.centers = generate.topic_centers(cfg["topics"], cfg["dim"], seed, device)
        segments = iter(layout.segments)
        for block in generate.even_blocks(cfg["rows"], cfg["block_rows"]):
            rows = generate.rows_block(cfg, self.centers, seed, block)
            at = block.start
            while at < block.stop:
                conv, start, count, _local = next(segments)
                self.store.append_device(self.names[conv], rows[start - block.start :][:count])
                at = start + count

    def search(self, queries: np.ndarray, k: int, min_score: float, scope):
        """``scope``: None for the whole corpus, or ``(lo, hi)`` for the
        conversations ``[lo, hi)`` (their name list made once)."""
        conversations = None
        if scope is not None:
            conversations = self._scopes.get(scope)
            if conversations is None:
                conversations = self._scopes[scope] = self.names[scope[0] : scope[1]]
        return self.store.search(queries, k, conversations=conversations, min_score=min_score)

    def hits(self, result, k: int) -> dict[str, np.ndarray]:
        m = len(result)
        items = np.full((m, k), -1, dtype=np.int64)
        scores = np.full((m, k), np.nan)
        conv = np.full((m, k), -1, dtype=np.int64)
        local = np.full((m, k), -1, dtype=np.int64)
        for i, row in enumerate(result):
            for j, hit in enumerate(row[:k]):
                items[i, j], scores[i, j] = hit.global_ordinal, hit.score
                conv[i, j] = self.ids.get(hit.conversation, -1)
                local[i, j] = hit.local_ordinal
        return {"items": items, "scores": scores, "conv": conv, "local": local}

    async def close(self) -> None:
        """Let the store go, so that the check runs on a card it has left."""
        self.store = None
