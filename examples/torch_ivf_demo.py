"""Demo on the PyTorch port: sublinear search over a clustered corpus with
the IVF engine.

Builds a VectorStore in ``search_mode="ivf"`` over a clustered corpus (the
structure real text-embedding data has), snapshots the learned-bucket
index, and runs lookups three ways:

  1. default IVF: pruned search with a per-query exactness certificate;
  2. strict mode (``ivf_certified=True``): certificate misses transparently
     rerun through the exact kernel — exact results always, sublinear
     speed where the data allows;
  3. after appends: rows added after the snapshot are merged through an
     exact interval scan until the next ``build_ivf()``.

Runs fully offline (deterministic fake embedder). The port of
``ivf_demo.py``.

    python examples/torch_ivf_demo.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from typeagent_tpu_torch.models.adapters import create_test_embedding_model
from typeagent_tpu_torch.tools import add_device_argument
from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

DIM = 64
N_ROWS = 20_000
TOPICS = 40


def make_clustered(rng, n, topics):
    centers = rng.standard_normal((topics, DIM)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, topics, n)
    rows = centers[labels] + 0.35 * rng.standard_normal((n, DIM)).astype(
        np.float32
    ) / np.sqrt(DIM)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32)


def main(device: str) -> None:
    rng = np.random.default_rng(7)
    rows = make_clustered(rng, N_ROWS, TOPICS)

    settings = TextEmbeddingIndexSettings(
        embedding_model=create_test_embedding_model(DIM),
        min_score=0.0,
        search_mode="ivf",
        device=device,
    )
    store = VectorStore(settings)
    store.add_embeddings(None, rows)

    print(f"building IVF over {N_ROWS} rows ({TOPICS} topics) on {device} ...")
    store.build_ivf(rows_per_cluster=256, train_rows=8192, iters=4)

    queries = rows[rng.choice(N_ROWS, 8, replace=False)]
    exact = np.argsort(-(queries @ rows.T), axis=1)[:, :5]

    hits = store.fuzzy_lookup_embeddings_batch(queries, max_hits=5)
    recall = np.mean(
        [
            len({h.item for h in row} & set(want.tolist())) / 5
            for row, want in zip(hits, exact)
        ]
    )
    print(f"IVF top-5 recall vs exact oracle: {recall:.3f}")

    # Strict mode: exact results guaranteed (cert miss -> exact rerun).
    settings.ivf_certified = True
    hits = store.fuzzy_lookup_embeddings_batch(queries, max_hits=5)
    for row, want in zip(hits, exact):
        assert {h.item for h in row} == set(want.tolist())
    print("strict mode: results identical to the exact scan")

    # Appends after the snapshot stay exact via the interval-scan merge.
    extra = make_clustered(rng, 500, TOPICS)
    store.add_embeddings(None, extra)
    q_new = extra[:2]
    hits = store.fuzzy_lookup_embeddings_batch(q_new, max_hits=1)
    assert all(row[0].item >= N_ROWS for row in hits)  # self-match in the tail
    print("appended rows surface before a rebuild: ivf demo ok")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(parser)
    main(parser.parse_args().device)
