"""The int8 query wire (``query_wire="int8"``) of the port's store, held to
the JAX package's.

``tests/test_query_wire.py`` runs on the port through
``test_torch_query_suites.mirror`` (its store on CPU tensors, as every
mirrored suite's), each test under ``test_query_wire__<name>``. Beside it:
the device dequantization gives the JAX function's bf16 values bit for
bit, the host quantization the same codes and scales, and an int8-wire
store answers as the JAX int8-wire store does on the same seeded rows and
queries (scores within 1e-5, the bf16 stores' tolerance in
``test_torch_vectorstore.py``; items equal except where scores tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_query_suites import check_mirrored, mirror
from test_torch_vectorstore import BF16_TOL, _normed, assert_rows_match, jax_store, port_store
from typeagent_tpu import vectorstore as jvs
from typeagent_tpu_torch import vectorstore as vs

SUITES = ("test_query_wire.py",)
EXCLUDED: dict = {}
MIRRORED = mirror(SUITES, EXCLUDED, globals())


def test_every_query_wire_test_is_mirrored():
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


def test_dequant_queries_bit_for_bit():
    """[3, 5, 64] int8 codes with per-query scales (a zero scale among
    them, as a padded slot carries): the same bf16 bits as JAX's
    ``_dequant_queries``, scale cast to bf16 first, then the product."""
    rng = np.random.default_rng(17)
    qi = rng.integers(-127, 128, size=(3, 5, 64)).astype(np.int8)
    sc = (rng.random((3, 5)) * 0.05).astype(np.float32)
    sc[2, 4] = 0.0
    want = np.asarray(jvs._dequant_queries(jnp.asarray(qi), jnp.asarray(sc)).astype(jnp.float32))
    got = vs._dequant_queries(torch.from_numpy(qi), torch.from_numpy(sc))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    # The [b, d] form too.
    want2 = np.asarray(jvs._dequant_queries(jnp.asarray(qi[0]), jnp.asarray(sc[0])).astype(jnp.float32))
    got2 = vs._dequant_queries(torch.from_numpy(qi[0]), torch.from_numpy(sc[0])).float().numpy()
    assert np.array_equal(got2.view(np.uint32), want2.view(np.uint32))


def test_quantize_queries_host_matches_jax():
    rng = np.random.default_rng(18)
    q = _normed(rng, 40, 48)
    q[3] = 0.0  # an all-zero query keeps scale 1, as in JAX
    qi, sc = vs._quantize_queries_host(q)
    jqi, jsc = jvs._quantize_queries_host(q)
    assert np.array_equal(qi, jqi) and np.array_equal(sc, jsc)


def test_int8_wire_upload_pads_with_zero_scale():
    """Only int8 codes and f32 scales are built on the host; padded slots
    and columns dequantize to zeros, and real slots to the product."""
    rng = np.random.default_rng(19)
    q = _normed(rng, 3, 20)
    dev = vs._int8_wire_upload(q, (8, 32), 20, torch.device("cpu"))
    assert dev.dtype == torch.float32 and tuple(dev.shape) == (8, 32)
    assert not dev[3:].any() and not dev[:, 20:].any()
    qi, sc = vs._quantize_queries_host(q)
    want = vs._dequant_queries(torch.from_numpy(qi), torch.from_numpy(sc)).float()
    assert torch.equal(dev[:3, :20], want)


@pytest.mark.parametrize("n", [500, 3000])
def test_int8_wire_store_matches_jax(n):
    """The same rows and queries through both packages' int8-wire bf16
    stores, the batch and the many route."""
    rng = np.random.default_rng(20 + n)
    d = 64
    mat = _normed(rng, n, d)
    queries = _normed(rng, 24, d)
    queries[:4] = mat[:4]
    port = port_store(d, dtype="bfloat16", query_wire="int8")
    port.add_embeddings(None, mat)
    jx = jax_store(d, dtype="bfloat16", query_wire="int8")
    jx.add_embeddings(None, mat)
    got = port.fuzzy_lookup_embeddings_batch(queries, max_hits=10)
    want = jx.fuzzy_lookup_embeddings_batch(queries, max_hits=10)
    assert_rows_match(got, want, BF16_TOL)
    for i in range(4):
        assert got[i][0].item == i
    qb = np.stack([queries[:8], queries[8:16], queries[16:]])
    got_many = port.fuzzy_lookup_embeddings_many(qb, max_hits=5)
    want_many = jx.fuzzy_lookup_embeddings_many(qb, max_hits=5)
    for g, w in zip(got_many, want_many):
        assert_rows_match(g, w, BF16_TOL)
