"""Checkpoints of row-sharded stores, one-device stores and corpora.

Port of ``typeagent_tpu/parallel/checkpoint.py``. ``serialize()`` gathers
a store into one host f32 array (the ``_embeddings.bin`` format), which is
O(corpus) on one host and loses an int8 store's exact bytes. A checkpoint
instead writes each shard's live rows straight from its device in the
store's own dtype (a bf16 checkpoint is half the bytes of f32, an int8 one
a quarter plus its scales), and restores into ANY mesh shape: a corpus
saved from (dp=2, shard=4) resumes on (dp=1, shard=8), (2, 2) or one
device, reading one saved shard at a time into the new layout, with no
host copy of the whole matrix.

Layout on disk:
  <path>/store_meta.json   dim / dtype / count / capacity / the saved
                           shards' row counts (+ corpus segments)
  <path>/state/            rows.<s>.pt (+ scales.<s>.pt for int8): shard
                           s's live rows ``[n_s, dim]``, ``torch.save``d

The JAX package writes ``state/`` with orbax, which the card's machine
does not have; the two packages share the layout and ``store_meta.json``'s
keys but cannot read each other's ``state/``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import TYPE_CHECKING, Callable

import torch

from .corpus import CorpusVectorStore, _Segment
from .mesh import Mesh
from .sharded import _DTYPE_NAMES, ShardedVectorStore

if TYPE_CHECKING:
    from ..vectorstore import TextEmbeddingIndexSettings, VectorStore

__all__ = [
    "PendingSave",
    "save_sharded_store",
    "restore_sharded_store",
    "save_vector_store",
    "restore_vector_store",
    "save_corpus",
    "restore_corpus",
]

_META_FILE = "store_meta.json"
_STATE_DIR = "state"


def _dtype_name(dtype: torch.dtype) -> str:
    for name, dt in _DTYPE_NAMES.items():
        if dt == dtype:
            return name
    raise ValueError(f"Unknown store dtype {dtype!r}")


class PendingSave:
    """Handle of a save; ``wait()`` finishes it (the metadata is written
    only once every shard file is on disk)."""

    def __init__(self, thread: threading.Thread | None, finalize: Callable[[], None]):
        self._thread = thread
        self._finalize = finalize
        self._done = False
        self._error: BaseException | None = None

    def wait(self) -> None:
        if self._done:
            return
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        self._finalize()
        self._done = True


def _shard_pieces(rows: list[torch.Tensor], scales: list, count: int, local_n: int, dim: int):
    """(rows, scales) of each shard's live rows, as views on the device."""
    pieces = []
    for s, shard in enumerate(rows):
        n = max(0, min(count - s * local_n, local_n))
        pieces.append((shard[:n, :dim], None if scales[s] is None else scales[s][:n]))
    return pieces


def _save(path, meta: dict, pieces: list[tuple], block: bool) -> PendingSave:
    """Write ``pieces`` (device views) under ``path/state`` and the meta
    file; blocking saves copy and write one shard at a time, a
    non-blocking one copies every shard to the host first and writes on a
    thread."""
    path = os.fspath(path)
    state_dir = os.path.join(path, _STATE_DIR)
    if os.path.exists(state_dir):
        shutil.rmtree(state_dir)
    meta_path = os.path.join(path, _META_FILE)
    if os.path.exists(meta_path):
        os.remove(meta_path)
    os.makedirs(state_dir)
    meta = dict(meta, shard_rows=[int(r.shape[0]) for r, _ in pieces])

    def compact(t: torch.Tensor) -> torch.Tensor:
        # torch.save writes a view's whole storage: keep the live rows only.
        t = t.contiguous()
        return t if t.untyped_storage().nbytes() == t.nbytes else t.clone()

    def write(s: int, rows: torch.Tensor, scales: torch.Tensor | None) -> None:
        torch.save(compact(rows), os.path.join(state_dir, f"rows.{s}.pt"))
        if scales is not None:
            torch.save(compact(scales), os.path.join(state_dir, f"scales.{s}.pt"))

    def finalize() -> None:
        with open(meta_path, "w", encoding="utf-8") as f:
            json.dump(meta, f)

    if block:
        for s, (rows, scales) in enumerate(pieces):
            write(s, rows.cpu(), None if scales is None else scales.cpu())
        pending = PendingSave(None, finalize)
        pending.wait()
        return pending
    staged = [(r.cpu(), None if c is None else c.cpu()) for r, c in pieces]

    def run() -> None:
        try:
            for s, (rows, scales) in enumerate(staged):
                write(s, rows, scales)
        except BaseException as exc:  # re-raised by wait()
            pending._error = exc

    thread = threading.Thread(target=run, daemon=True, name="tat-checkpoint")
    pending = PendingSave(thread, finalize)
    thread.start()
    return pending


def save_sharded_store(
    store: ShardedVectorStore,
    path: str | os.PathLike,
    *,
    extra_meta: dict | None = None,
    block: bool = True,
) -> PendingSave:
    """Write the store's live rows under ``path`` (overwrites), one file
    per shard of dp rank 0. With ``block=False`` the rows are copied to
    the host and the disk writes go on on a thread: keep serving, and call
    ``.wait()`` on the returned handle before relying on the checkpoint."""
    with store._view() as count:
        pieces = _shard_pieces(store.shard_rows(0), store.shard_scales(0), count, store.local_n, store.dim)
        meta = {
            "dim": store.dim,
            "dim_pad": store.dim_pad,
            "dtype": _dtype_name(store._dtype),
            "count": count,
            "capacity": store.capacity,
            **(extra_meta or {}),
        }
        return _save(path, meta, pieces, block)


def _read_meta(path: str | os.PathLike) -> dict:
    with open(os.path.join(os.fspath(path), _META_FILE), encoding="utf-8") as f:
        return json.load(f)


def _state_dir(path, meta: dict) -> str:
    state_dir = os.path.join(os.fspath(path), _STATE_DIR)
    if not os.path.isdir(state_dir):
        raise FileNotFoundError(f"checkpoint state directory {state_dir} not found")
    if "shard_rows" not in meta:
        raise ValueError(
            f"{state_dir} was not written by typeagent_tpu_torch (its metadata lists no "
            "shard_rows; the JAX package's orbax state cannot be read here)"
        )
    return state_dir


def _load_into(store: ShardedVectorStore, path, meta: dict) -> None:
    """Write each saved shard, read one at a time, at its global rows."""
    state_dir = _state_dir(path, meta)
    with store._lock:
        store._grow(max(meta["count"], 1))
        offset = 0
        for s, n in enumerate(meta["shard_rows"]):
            if n:
                rows = torch.load(os.path.join(state_dir, f"rows.{s}.pt"), weights_only=True)
                scales = None
                if meta["dtype"] == "int8":
                    scales = torch.load(os.path.join(state_dir, f"scales.{s}.pt"), weights_only=True)
                store._write(rows, scales, offset)
                del rows, scales
            offset += n
        store.count = meta["count"]


def restore_sharded_store(
    mesh: Mesh, path: str | os.PathLike, *, _meta: dict | None = None
) -> ShardedVectorStore:
    """Rebuild a store on ``mesh`` (any shape) from a checkpoint; the
    saved capacity is kept where it tiles the mesh's shards."""
    meta = _meta or _read_meta(path)
    store = ShardedVectorStore(meta["dim"], dtype=meta["dtype"], mesh=mesh)
    if meta["dim_pad"] != store.dim_pad:
        raise ValueError(f"checkpoint dim_pad {meta['dim_pad']}, store {store.dim_pad}")
    store.reserve(meta["capacity"])
    _load_into(store, path, meta)
    return store


# ---------------------------------------------------------------------------
# One-device VectorStore checkpoints (the same format)
# ---------------------------------------------------------------------------


def save_vector_store(
    store: VectorStore, path: str | os.PathLike, *, block: bool = True
) -> PendingSave:
    """Checkpoint a ``vectorstore.VectorStore``: its rows as one shard in
    their own dtype (a mesh-backed store saves its shards)."""
    store._flush()
    if store._mesh is not None:
        return save_sharded_store(store._sharded_store(), path, block=block)
    with store._dispatch_view() as (buf, scales, count):
        meta = {
            "dim": store._embedding_size,
            "dim_pad": store._dim_pad,
            "dtype": store.settings.dtype,
            "count": count,
            "capacity": int(buf.shape[0]) if buf is not None else 0,
            "single_chip": True,
        }
        pieces = []
        if count:
            pieces = [(buf[:count, : store._embedding_size], None if scales is None else scales[:count])]
        return _save(path, meta, pieces, block)


def restore_vector_store(
    settings: TextEmbeddingIndexSettings, path: str | os.PathLike
) -> VectorStore:
    """Rebuild a ``vectorstore.VectorStore`` with ``settings`` from a
    checkpoint of :func:`save_vector_store` or of the sharded saver (a
    mesh in ``settings`` restores through the sharded path)."""
    from ..vectorstore import VectorStore

    meta = _read_meta(path)
    store = VectorStore(settings)
    if not meta.get("count"):
        return store  # an empty checkpoint
    if meta["dtype"] != settings.dtype:
        raise ValueError(f"checkpoint dtype {meta['dtype']}, settings {settings.dtype}")
    store._set_embedding_size(meta["dim"])
    if store._mesh is not None:
        inner = restore_sharded_store(store._mesh, path, _meta=meta)
        store._sharded = inner
        store._count = inner.count
        return store
    state_dir = _state_dir(path, meta)
    store.reserve(meta["capacity"])
    with store._flush_lock:
        store._ensure_capacity_locked(meta["count"])
        offset = 0
        for s, n in enumerate(meta["shard_rows"]):
            if n:
                rows = torch.load(os.path.join(state_dir, f"rows.{s}.pt"), weights_only=True)
                store._buf[offset : offset + n, : meta["dim"]].copy_(rows)
                if store._quantized:
                    scales = torch.load(os.path.join(state_dir, f"scales.{s}.pt"), weights_only=True)
                    store._scales[offset : offset + n].copy_(scales)
            offset += n
        store._count = meta["count"]
    return store


# ---------------------------------------------------------------------------
# Corpus (multi-conversation) checkpoints
# ---------------------------------------------------------------------------


def save_corpus(
    corpus: CorpusVectorStore,
    path: str | os.PathLike,
    *,
    extra_meta: dict | None = None,
    block: bool = True,
) -> PendingSave:
    """Checkpoint a corpus: the sharded matrix and its segment table."""
    meta = {
        "segments": [
            {"conversation": s.conversation, "start": s.start, "count": s.count,
             "local_base": s.local_base}
            for s in corpus._segments
        ],
        "search_mode": corpus._store.search_mode,
        **(extra_meta or {}),
    }
    return save_sharded_store(corpus._store, path, extra_meta=meta, block=block)


def restore_corpus(mesh: Mesh, path: str | os.PathLike) -> CorpusVectorStore:
    """Rebuild a corpus on ``mesh`` (any shape) from :func:`save_corpus`."""
    meta = _read_meta(path)
    corpus = CorpusVectorStore(
        meta["dim"], dtype=meta["dtype"], search_mode=meta.get("search_mode", "exact"), mesh=mesh
    )
    corpus._store.reserve(meta["capacity"])
    _load_into(corpus._store, path, meta)
    corpus._segments = [
        _Segment(s["conversation"], s["start"], s["count"], s["local_base"])
        for s in meta.get("segments", [])
    ]
    corpus._local_counts = {}
    for s in corpus._segments:
        corpus._local_counts[s.conversation] = corpus._local_counts.get(s.conversation, 0) + s.count
    return corpus
