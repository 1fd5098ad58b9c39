"""The golden eval on the port, against the goldens the JAX package wrote.

``tests/test_eval_golden.py`` runs on the port through
``test_torch_query_suites.mirror``: ``run_eval`` builds the fixture from
``tests/testdata/mini_podcast.txt`` with the offline extractor and
embedder and diffs 13 pinned queries' stages 2-3 against the committed
``tests/testdata/golden_eval.json`` on the device engine, the host VM and
approx lookups. The rewrite gives each ``run_eval`` call ``device="cpu"``:
the tool builds its settings on the port's default device, the card.
The goldens are compared as committed; nothing here rewrites them.

The fixture's related-terms expansion asks for 50 matches of a 33-row
index, the materialized route, and its scores tie exactly. So beside the
mirror: that route keeps the lowest row first on ties, as ``lax.top_k``
does, where ``torch.topk`` would not.
"""

import hashlib
import pathlib

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_query_suites import check_mirrored, mirror
from typeagent_tpu.ops import topk as jtopk
from typeagent_tpu_torch.ops import topk
from typeagent_tpu_torch.tools import eval_golden

SUITES = ("test_eval_golden.py",)
EXCLUDED: dict = {}
MIRRORED = mirror(
    SUITES, EXCLUDED, globals(),
    rewrite={"test_eval_golden.py": (("await run_eval(update=False, ", 'await run_eval(update=False, device="cpu", '),)},
)
TESTDATA = pathlib.Path(__file__).resolve().parent / "testdata"


def test_every_eval_golden_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


def test_port_reads_the_committed_goldens():
    """The port's tool resolves the JAX package's committed files."""
    assert pathlib.Path(eval_golden.GOLDEN_FILE).resolve() == TESTDATA / "golden_eval.json"
    assert pathlib.Path(eval_golden.FIXTURE).resolve() == TESTDATA / "mini_podcast.txt"
    assert hashlib.sha256((TESTDATA / "golden_eval.json").read_bytes()).hexdigest() == (
        hashlib.sha256(pathlib.Path(eval_golden.GOLDEN_FILE).read_bytes()).hexdigest()
    )


def test_materialized_topk_keeps_lowest_row_on_ties():
    """k = 50 over rows made of a few repeated vectors (every score ties
    with others): the port's materialized route returns JAX's ``lax.top_k``
    order, the lowest row first within each tie. ``torch.topk`` returns
    the tied rows in another order on this very input."""
    rng = np.random.default_rng(5)
    d, n, count, k = 16, 4096, 4000, 50
    base = rng.standard_normal((6, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    emb = base[rng.integers(0, 6, n)]
    queries = np.zeros((8, d), np.float32)
    queries[:3] = base[:3]
    queries[3:] = rng.standard_normal((5, d)).astype(np.float32)
    queries[3:] /= np.linalg.norm(queries[3:], axis=1, keepdims=True)
    vals, idx = topk.cosine_topk(torch.from_numpy(emb), torch.from_numpy(queries), count, k)
    jvals, jidx = jtopk.cosine_topk(jnp.asarray(emb), jnp.asarray(queries), count, k)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), atol=1e-6)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    for row, rv in zip(idx.numpy(), vals.numpy()):
        for a in range(k - 1):  # descending, ascending rows within a tie
            assert rv[a] > rv[a + 1] or row[a] < row[a + 1]
    scores = topk.cosine_scores(torch.from_numpy(emb), torch.from_numpy(queries), count)
    assert not torch.equal(torch.topk(scores, k, dim=1).indices.to(torch.int32), idx)
