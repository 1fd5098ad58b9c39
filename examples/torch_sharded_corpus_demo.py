"""Multi-conversation corpus search over a device mesh, on the PyTorch port.

Runs anywhere: on the card(s) the rows shard across a mesh of cards (each
shard's fused top-k on its card, the winners merged); ``--device cpu``
builds the mesh of 8 CPU devices. The port of ``sharded_corpus_demo.py``.

    python examples/torch_sharded_corpus_demo.py [--device cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from typeagent_tpu_torch.parallel import create_mesh, restore_corpus, save_corpus
from typeagent_tpu_torch.parallel.corpus import CorpusVectorStore
from typeagent_tpu_torch.tools import add_device_argument


def main(device: str) -> None:
    if device == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is available; pass --device cpu")
    else:
        devices = [torch.device("cpu")] * 8
    n_shard = max(1, len(devices) // 2)
    n_dp = max(1, len(devices) // n_shard)
    mesh = create_mesh(n_shard=n_shard, n_dp=n_dp, devices=devices)
    print(f"mesh: {mesh} over {len(devices)} device(s)")

    corpus = CorpusVectorStore(dim=256, mesh=mesh)
    rng = np.random.default_rng(0)
    stored: dict[str, np.ndarray] = {}
    for name, n_fragments in [("support-tickets", 4000), ("design-docs", 2500), ("meeting-notes", 1500)]:
        rows = rng.standard_normal((n_fragments, 256)).astype(np.float32)
        stored[name] = rows
        corpus.append(name, rows)
    print(f"corpus: {len(corpus)} fragments across {corpus.conversations}")

    # Cross-corpus search: one fused lookup over everything.
    query = stored["design-docs"][42:43]  # raw (unnormalized) — the store handles it
    [hits] = corpus.search(query, k=3)
    for h in hits:
        print(f"  {h.conversation}#{h.local_ordinal}  score={h.score:.3f}")
    assert hits[0].conversation == "design-docs" and hits[0].local_ordinal == 42

    # Scoped search: EXACT — the target segments become each shard's
    # interval table or row mask (the same fused scan as a global search).
    [scoped] = corpus.search(query, k=3, conversations=["meeting-notes"])
    assert all(h.conversation == "meeting-notes" for h in scoped)
    print(f"scoped to meeting-notes: top score {scoped[0].score:.3f}")

    # Sharding-aware checkpoint: a file per shard; restores into any mesh
    # shape (save on the mesh, resume on one device).
    with tempfile.TemporaryDirectory() as ckpt_dir:
        save_corpus(corpus, ckpt_dir)
        resumed = restore_corpus(create_mesh(n_shard=1, n_dp=1, devices=devices[:1]), ckpt_dir)
        [hits2] = resumed.search(query, k=1)
        assert hits2[0].conversation == "design-docs" and hits2[0].local_ordinal == 42
        print(f"checkpoint restored onto 1 device: {len(resumed)} fragments, self-match OK")
    print("OK")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_argument(parser)
    main(parser.parse_args().device)
