"""Checkpoints of the port's stores and corpora, across mesh shapes.

The JAX suite ``test_checkpoint.py`` runs on the port through
``test_torch_query_suites.mirror()``, its meshes made of CPU devices and
its ``ShardedVectorStore(mesh, dim, ...)`` calls given as keywords (the
port's store takes ``dim`` first); its two reads of a whole buffer as
numpy go through ``.float()``, since numpy has no bf16. The port's
checkpoint format is its own (``torch.save`` per shard; the JAX package's
is orbax), so the round trips are held to the JAX package's search
results on the same rows as the oracle: a store saved from (dp=2, shard=4)
answers identically on (1, 8), (2, 2) and (1, 1), and as the JAX store.
"""

import functools
import json
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu.parallel import create_mesh as jax_create_mesh
from typeagent_tpu.parallel.sharded import ShardedVectorStore as JaxSharded
from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.parallel import CorpusVectorStore, ShardedVectorStore, create_mesh
from typeagent_tpu_torch.parallel.checkpoint import (
    restore_corpus,
    restore_sharded_store,
    restore_vector_store,
    save_corpus,
    save_sharded_store,
    save_vector_store,
)
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

CPU = torch.device("cpu")
cpu_mesh = functools.partial(create_mesh, devices=[CPU] * 8)

SUITES = ("test_checkpoint.py",)
EXCLUDED: dict = {}
REWRITE = {
    "test_checkpoint.py": (
        ("ShardedVectorStore(mesh, DIM", "ShardedVectorStore(mesh=mesh, dim=DIM"),
        ("ShardedVectorStore(mesh8, DIM", "ShardedVectorStore(mesh=mesh8, dim=DIM"),
        ("ShardedVectorStore(mesh4, DIM", "ShardedVectorStore(mesh=mesh4, dim=DIM"),
        ("np.asarray(restored.buf), np.asarray(store.buf)",
         "restored.buf.float().numpy(), store.buf.float().numpy()"),
        ("np.asarray(restored._buf), np.asarray(store._buf)",
         "restored._buf.float().numpy(), store._buf.float().numpy()"),
        ("        mesh=mesh,\n    )", '        mesh=mesh,\n        device="cpu",\n    )'),
    ),
}
MIRRORED = mirror(SUITES, EXCLUDED, globals(), rewrite=REWRITE)
sys.modules["port_mirror_test_checkpoint"].create_mesh = cpu_mesh


def test_every_checkpoint_test_is_mirrored_or_excluded():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


DIM = 32
TOL = {"float32": 1e-6, "bfloat16": 1e-5, "int8": 1e-5}
SHAPES = ((1, 8), (2, 2), (1, 1))


def _rows(n, seed):
    r = np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)
    return r / np.linalg.norm(r, axis=1, keepdims=True)


def _queries(n=9, seed=12):
    rng = np.random.default_rng(seed)
    q = np.zeros((n, DIM), np.float32)  # unit norm and exact in bf16
    for row in q:
        row[rng.choice(DIM, 16, replace=False)] = rng.choice([-0.25, 0.25], 16)
    return q


def _assert_pairs_match(got, want, tol):
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose([s for _, s in a], [s for _, s in b], atol=tol)
        kth = min(s for _, s in b)
        assert all(i in {j for j, _ in b} or abs(s - kth) <= tol for i, s in a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_round_trip_across_shapes_matches_jax(tmp_path, dtype):
    data = _rows(2600, 1)
    store = ShardedVectorStore(DIM, dtype=dtype, mesh=cpu_mesh(n_shard=4, n_dp=2))
    ref = JaxSharded(jax_create_mesh(n_shard=4, n_dp=2), DIM, dtype=dtype)
    for s in (store, ref):
        s.append(data)
    q = _queries()
    want = ref.search(q, 10)
    scoped = np.asarray([(100, 900), (2000, 2600)])
    want_scoped = ref.search_intervals(q, scoped, 10)
    got = store.search(q, 10)
    _assert_pairs_match(got, want, TOL[dtype])
    save_sharded_store(store, tmp_path / "ckpt")
    for n_dp, n_shard in SHAPES:
        mesh = create_mesh(n_shard=n_shard, n_dp=n_dp, devices=[CPU] * (n_dp * n_shard))
        restored = restore_sharded_store(mesh, tmp_path / "ckpt")
        assert restored.count == 2600 and restored.mesh.devices.shape == (n_dp, n_shard)
        assert restored.search(q, 10) == got
        _assert_pairs_match(restored.search_intervals(q, scoped, 10), want_scoped, TOL[dtype])
        np.testing.assert_array_equal(restored.serialize(), store.serialize())


def test_saved_bytes_keep_the_store_dtype(tmp_path):
    """bf16 saves half the row bytes of f32, int8 a quarter (plus its
    scales); only live rows are written, one file per shard."""
    data = _rows(1000, 2)
    sizes = {}
    for dtype in ("float32", "bfloat16", "int8"):
        store = ShardedVectorStore(DIM, dtype=dtype, mesh=cpu_mesh(n_shard=4, n_dp=1))
        store.append(data)
        save_sharded_store(store, tmp_path / dtype)
        meta = json.loads((tmp_path / dtype / "store_meta.json").read_text())
        assert meta["shard_rows"] == [256, 256, 256, 232] and meta["count"] == 1000
        rows = sum(torch.load(p, weights_only=True).nbytes for p in (tmp_path / dtype / "state").glob("rows.*"))
        sizes[dtype] = rows
    assert sizes["float32"] == 1000 * DIM * 4
    assert sizes["bfloat16"] * 2 == sizes["float32"] == sizes["int8"] * 4


def test_corpus_and_vector_store_round_trips(tmp_path):
    mesh = cpu_mesh(n_shard=4, n_dp=2)
    corpus = CorpusVectorStore(DIM, mesh=mesh, dtype="bfloat16")
    corpus.append("alpha", _rows(700, 3))
    corpus.append("beta", _rows(500, 4))
    corpus.append("alpha", _rows(60, 5))
    q = _queries(4)
    want = corpus.search(q, 5, conversations=["alpha"])
    save_corpus(corpus, tmp_path / "corpus")
    for n_dp, n_shard in SHAPES:
        restored = restore_corpus(create_mesh(n_shard=n_shard, n_dp=n_dp, devices=[CPU] * (n_dp * n_shard)),
                                  tmp_path / "corpus")
        assert restored.search(q, 5, conversations=["alpha"]) == want
        assert restored.count_for("alpha") == 760 and restored.count_for("beta") == 500
    settings = TextEmbeddingIndexSettings(create_test_embedding_model(DIM), min_score=0.0, dtype="int8", device="cpu")
    store = VectorStore(settings)
    store.add_embeddings(None, _rows(300, 6))
    save_vector_store(store, tmp_path / "vs")
    mesh_settings = TextEmbeddingIndexSettings(create_test_embedding_model(DIM), min_score=0.0, dtype="int8",
                                               mesh=mesh)
    for target in (settings, mesh_settings):
        restored = restore_vector_store(target, tmp_path / "vs")
        assert restored.fuzzy_lookup_embeddings_batch(q, 5) == store.fuzzy_lookup_embeddings_batch(q, 5)


def test_state_of_another_writer_is_refused(tmp_path):
    """A checkpoint whose metadata names no per-shard row counts (the JAX
    package's orbax layout) is refused with a clear error."""
    (tmp_path / "state").mkdir()
    (tmp_path / "store_meta.json").write_text(json.dumps(
        {"dim": DIM, "dim_pad": 128, "dtype": "float32", "count": 5, "capacity": 1024}))
    with pytest.raises(ValueError, match="orbax"):
        restore_sharded_store(cpu_mesh(n_shard=1), tmp_path)
