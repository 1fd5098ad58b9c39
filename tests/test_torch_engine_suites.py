"""The JAX package's device-engine suites, run against the port.

``test_postings.py``, ``test_device_executor.py``,
``test_device_vm_differential.py``, ``test_nl_device_coverage.py`` and
``test_engine_batcher.py`` are read from their source with their imports
pointed at ``typeagent_tpu_torch`` (and at the mirrored query suites they
import from), as ``test_torch_query_suites.py`` does, and each test is put
into this module under ``test_<suite>__<test>``: the port's
``ops/postings.py``, ``knowpro/device_executor.py``,
``knowpro/engine_batcher.py`` and ``search.py`` routing held to the JAX
package's own tests, on CPU tensors. The tests the port cannot run are in
:data:`EXCLUDED`, each with its reason.

Fourteen of them set or read the JAX package's TPU knobs, which the port
does not have: the compact transfer of ``lookup_ops`` (``_COMPACT_CAP``,
``_COMPACT_FETCH_BUCKETS``, ``_fetch_hint``), the tunnel's dense-below gate
``_SPARSE_MIN_CAP`` and the COO result buckets ``_COO_BUCKETS``. Each stands
in :data:`EXCLUDED` and is adapted below under its mirrored name: the same
behaviour held on the port's single sorted pass, the knob taken out.
"""

import numpy as np
import pytest
import torch

from test_torch_query_suites import check_mirrored, mirror

SUITES = (
    "test_postings.py",
    "test_device_executor.py",
    "test_device_vm_differential.py",
    "test_nl_device_coverage.py",
    "test_engine_batcher.py",
)
_KNOBS = (
    "sets or reads a TPU knob the port does not have (_COMPACT_CAP, "
    "_COMPACT_FETCH_BUCKETS, _fetch_hint, _SPARSE_MIN_CAP, _COO_BUCKETS): "
    "lookup_ops downloads the sorted core's runs once and the COO route "
    "answers at every size and run count; adapted below under its name"
)
ADAPTED = (
    ("test_postings.py", "test_lookup_ops_compact_path_matches_dense"),
    ("test_postings.py", "test_lookup_ops_compact_overflow_falls_back"),
    ("test_postings.py", "test_coo_sparse_matches_dense_randomized"),
    ("test_postings.py", "test_coo_sparse_overflow_grows_buckets"),
    ("test_postings.py", "test_coo_sparse_runs_past_last_bucket_fall_back"),
    ("test_postings.py", "test_coo_sparse_key_packing_overflow_falls_back"),
    ("test_postings.py", "test_coo_sparse_wide_leaf_positions_fall_back"),
    ("test_postings.py", "test_mid_size_conversation_routes_sparse_by_default"),
    ("test_postings.py", "test_compact_route_preserves_active_semref_zero"),
    ("test_postings.py", "test_lookup_ops_compact_refetch_bucket_above_cap"),
    ("test_device_vm_differential.py", "test_differential_through_compact_transfer"),
    ("test_device_vm_differential.py", "test_differential_compact_no_overflow"),
    ("test_device_vm_differential.py", "test_differential_through_sparse_union_combine"),
    ("test_device_vm_differential.py", "test_differential_under_tiny_device_budgets"),
    ("test_postings.py", "test_coo_sparse_dp_matches_single"),
    ("test_postings.py", "test_coo_sparse_dp_single_rank_delegates"),
)
EXCLUDED = {
    **{name: _KNOBS for name in ADAPTED},
    ("test_device_executor.py", "test_dropped_plan_falls_back_to_host"): (
        "asserts that a plan _run_plan_group drops (too large even alone) is "
        "answered by the host VM; the port's guard decides packing only, a "
        "plan over it alone gets a device call of its own, so no plan is "
        "dropped; adapted below under its name"
    ),
    ("test_engine_batcher.py", "test_device_dispatch_failure_falls_back_to_host"): (
        "asserts the JAX package's catch-and-answer-from-the-host on an engine "
        "exception; the port lets engine errors propagate by design (knowpro/"
        "search.py's docstring), which test_torch_search_route.py checks"
    ),
}

MIRRORED = mirror(SUITES, EXCLUDED, globals())

from port_mirror_test_device_executor import build_conversation  # noqa: E402
from port_mirror_test_device_vm_differential import run_differential  # noqa: E402
from port_mirror_test_postings import _random_ops_setup  # noqa: E402

from typeagent_tpu_torch.knowpro import device_executor as DE  # noqa: E402
from typeagent_tpu_torch.knowpro.interfaces import SearchTerm, SearchTermGroup, Term  # noqa: E402
from typeagent_tpu_torch.ops import postings as P  # noqa: E402


def _index(n_semrefs: int, hot: int = 0, extra=()) -> P.DevicePostingsIndex:
    """An index whose term "hot" posts semrefs 0..hot-1 (score 0.9)."""
    index = P.DevicePostingsIndex("cpu")
    index.add_terms_batch([("hot", s, 0.9) for s in range(hot)] + list(extra))
    index.add_term("pad", n_semrefs - 1, 0.5)
    index.build()
    return index


def _dense_of(index, ops, n_seg, ktype, scopes=None, boost=1.0):
    """The dense form of one call, from accumulate_postings_segmented."""
    operands, statics = index._prepare_operands(ops, n_seg, ktype, scopes, boost)
    window = max(index._max_postings, 1)
    out = P.accumulate_postings_segmented(*operands, window=window, **statics)
    n = index._n_semrefs
    return [x.numpy()[:, :n] for x in out[:4]] + [out[4].numpy()]


def test_postings__test_lookup_ops_compact_path_matches_dense():
    """Adapted: lookup_ops (one pass of the sorted core, its runs scattered
    on the host) returns the device dense form's arrays."""
    index, ops, ktype = _random_ops_setup(np.random.default_rng(7))
    got = index.lookup_ops(ops, 4, ktype)
    for a, b in zip(got, _dense_of(index, ops, 4, ktype)):
        np.testing.assert_array_equal(a, b)


def test_postings__test_lookup_ops_compact_overflow_falls_back():
    """Adapted: a segment matching 1,000 semrefs comes back whole (the
    port has no compact cap to overflow)."""
    index = _index(1000, hot=1000, extra=[("cold", 3, 0.7)])
    ktype = np.zeros(1000, np.int8)
    ops = [(index.lookup("hot"), 1.0, 0, 0, 0, -1, 0), (index.lookup("cold"), 2.0, 1, 0, 1, -1, 0)]
    escore, ehits, _, _, op_hit = index.lookup_ops(ops, 2, ktype)
    assert (ehits[0] > 0).sum() == 1000
    assert escore[1, 3] == pytest.approx(1.4, rel=1e-5)
    assert list(op_hit) == [True, True]


def test_postings__test_coo_sparse_matches_dense_randomized():
    """Adapted (no gate to open): the COO route reproduces the dense form
    across random ops with first-adder masking, boost membership, gates
    and scope rows."""
    rng = np.random.default_rng(11)
    index, ops, ktype = _random_ops_setup(rng)
    n_semrefs = len(ktype)
    ops.append((ops[0][0], 1.0, 1, P.OP_BOOST, 0, -1, 0))
    ops.append((ops[3][0], 2.0, 2, P.OP_EXACT, 30, 2, 0))
    scope = np.zeros(n_semrefs, dtype=bool)
    scope[: n_semrefs // 2] = True
    ops.append((ops[5][0], 1.5, 3, P.OP_RELATED, 31, -1, 1))
    scopes = [None, scope]
    cols, packed, counts, op_hit_s = index.lookup_ops_sparse(ops, 4, ktype, scopes, boost_factor=10.0)
    es, eh, rs, rh, op_hit_d = _dense_of(index, ops, 4, ktype, scopes, 10.0)
    np.testing.assert_array_equal(op_hit_s, op_hit_d)
    for s in range(4):
        c = counts[s]
        active = np.flatnonzero((eh[s] > 0) | (rh[s] > 0))
        assert (np.diff(cols[s, :c]) > 0).all()
        np.testing.assert_array_equal(cols[s, :c], active)
        for a, block in enumerate((es, eh, rs, rh)):
            np.testing.assert_array_equal(packed[a, s, :c], block[s, active])


@pytest.mark.parametrize("n_runs", [300, 70_000])
def test_postings__test_coo_sparse_overflow_grows_buckets(n_runs):
    """Adapted: any number of active runs comes back from one call (the
    port sizes the result from the run count, no bucket retry)."""
    index = _index(n_runs, hot=n_runs)
    sparse = index.lookup_ops_sparse([(index.lookup("hot"), 1.0, 0, P.OP_EXACT, 0, -1, 0)], 1, np.zeros(n_runs, np.int8))
    cols, packed, counts, _ = sparse
    assert counts[0] == n_runs
    np.testing.assert_array_equal(cols[0, :n_runs], np.arange(n_runs))
    np.testing.assert_array_equal(packed[1, 0, :n_runs], 1.0)


def test_postings__test_coo_sparse_runs_past_last_bucket_fall_back():
    """Adapted: past the JAX package's largest COO bucket (262,144 runs)
    the port's COO route still answers, and agrees with lookup_ops."""
    n = 262_144 + 1000
    index = _index(n, hot=n)
    ktype = np.zeros(n, np.int8)
    ops = [(index.lookup("hot"), 1.0, 0, P.OP_EXACT, 0, -1, 0)]
    cols, packed, counts, op_hit = index.lookup_ops_sparse(ops, 1, ktype)
    escore, ehits, _, _, dense_hit = index.lookup_ops(ops, 1, ktype)
    assert counts[0] == (ehits[0] > 0).sum() == n
    np.testing.assert_array_equal(packed[0, 0], escore[0, cols[0]])
    assert list(op_hit) == list(dense_hit) == [True]


def test_postings__test_coo_sparse_key_packing_overflow_falls_back():
    """Adapted (no gate to open): n_seg * (semref_cap + 1) >= 2**30 cannot
    ride the sort key's run field: lookup_ops_sparse returns None instead
    of dropping the high segments' runs."""
    index = _index(100, hot=100)
    ops = [(index.lookup("hot"), 1.0, 0, P.OP_EXACT, 0, -1, 0)]
    n_seg_over = 2**30 // (index._semref_cap + 1) + 1
    assert index.lookup_ops_sparse(ops, n_seg_over, np.zeros(100, np.int8)) is None


def test_postings__test_coo_sparse_wide_leaf_positions_fall_back():
    """Adapted (no gate to open): an op position past the key's position
    field takes the dense path; at the boundary the COO route is exact."""
    index = _index(100, hot=100)
    ktype = np.zeros(100, np.int8)
    tid = index.lookup("hot")
    assert index.lookup_ops_sparse([(tid, 1.0, 0, P.OP_RELATED, P._POS_P - 1, -1, 0)], 1, ktype) is None
    sparse = index.lookup_ops_sparse([(tid, 1.0, 0, P.OP_RELATED, P._POS_P - 2, -1, 0)], 1, ktype)
    assert sparse is not None and sparse[2][0] == 100


@pytest.mark.parametrize("n_semrefs", [300, 3000])
def test_postings__test_mid_size_conversation_routes_sparse_by_default(n_semrefs):
    """Adapted: the COO route answers at every semref capacity, below the
    JAX package's 2,048 gate too, and agrees with lookup_ops."""
    rng = np.random.default_rng(13)
    index, ops, ktype = _random_ops_setup(rng, n_terms=80, n_semrefs=n_semrefs, n_postings=2 * n_semrefs)
    cols, packed, counts, op_hit_s = index.lookup_ops_sparse(ops, 4, ktype)
    es, eh, rs, rh, op_hit_d = index.lookup_ops(ops, 4, ktype)
    np.testing.assert_array_equal(op_hit_s, op_hit_d)
    for s in range(4):
        active = np.flatnonzero((eh[s] > 0) | (rh[s] > 0))
        np.testing.assert_array_equal(cols[s, : counts[s]], active)
        np.testing.assert_array_equal(packed[0, s, : counts[s]], es[s, active])


def test_postings__test_compact_route_preserves_active_semref_zero():
    """Adapted: lookup_ops' host scatter keeps an active semref 0 at a
    semref capacity far past the number of active semrefs."""
    index = _index(5001, extra=[("alpha", 0, 1.0), ("alpha", 1, 1.0)])
    ktype = np.zeros(index._n_semrefs, np.int32)
    es, eh, rs, rh, _ = index.lookup_ops([(index.lookup("alpha"), 1.0, 0, P.OP_EXACT, 0, -1, 0)], 1, ktype)
    assert es[0, 0] == 1.0 and eh[0, 0] == 1.0
    assert es[0, 1] == 1.0
    assert es[0, 2:].sum() == 0.0


def test_postings__test_lookup_ops_compact_refetch_bucket_above_cap():
    """Adapted: a semref capacity between the JAX fetch buckets (2,048)
    with a six-semref list: lookup_ops equals the dense form."""
    index = _index(2000, hot=6, extra=[("cold", 30, 0.7)])
    kt = np.zeros(2000, np.int8)
    ops = [(index.lookup("hot"), 1.0, 0, 0, 0, -1, 0)]
    for a, b in zip(index.lookup_ops(ops, 1, kt), _dense_of(index, ops, 1, kt)):
        np.testing.assert_array_equal(a, b)


def _count_calls(monkeypatch, name: str) -> list:
    """Record each DevicePostingsIndex.<name> call's result."""
    real = getattr(P.DevicePostingsIndex, name)
    calls: list = []

    def counting(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(P.DevicePostingsIndex, name, counting)
    return calls


@pytest.mark.parametrize("seed", [31337, 777])
async def test_device_vm_differential__test_differential_through_compact_transfer(monkeypatch, seed):
    """Adapted: with the COO route declined, every call takes lookup_ops
    (one pass, runs scattered on the host) and results equal the host VM's."""
    monkeypatch.setattr(P.DevicePostingsIndex, "lookup_ops_sparse", lambda self, *a, **k: None)
    calls = _count_calls(monkeypatch, "lookup_ops")
    covered, total = await run_differential(seed, 25)
    assert covered >= int(0.85 * total), (covered, total)
    assert calls


async def test_device_vm_differential__test_differential_compact_no_overflow(monkeypatch):
    """Adapted: the dense route under TAT_GROUP_THREADS=1 (lookup_ops on
    worker threads, the index's device passed explicitly)."""
    monkeypatch.setenv("TAT_GROUP_THREADS", "1")
    monkeypatch.setattr(P.DevicePostingsIndex, "lookup_ops_sparse", lambda self, *a, **k: None)
    calls = _count_calls(monkeypatch, "lookup_ops")
    covered, total = await run_differential(777, 25)
    assert covered >= int(0.85 * total), (covered, total)
    assert calls


async def test_device_vm_differential__test_differential_through_sparse_union_combine(monkeypatch):
    """Adapted (no knobs): the COO route and the union combine answer every
    call at the default constants, and results equal the host VM's."""
    calls = _count_calls(monkeypatch, "lookup_ops_sparse")
    covered, total = await run_differential(2024, 25)
    assert covered >= int(0.85 * total), (covered, total)
    assert calls and all(out is not None for out in calls)


@pytest.mark.parametrize("budgets", [(8 * 1024, 16 * 1024, 4 * 1024), (1, 1, 1)])
async def test_device_vm_differential__test_differential_under_tiny_device_budgets(monkeypatch, budgets):
    """Adapted: budget pressure changes call shapes only, never results or
    routes: under tiny budgets (the JAX suite's, and one slot and one
    posting a call; threads on) the engine answers exactly the queries it
    answers at the reckoned budgets."""
    free_covered, total = await run_differential(4242, 25)
    monkeypatch.setenv("TAT_GROUP_THREADS", "1")
    for knob, value in zip(("_MAX_DENSE_ENTRIES", "_MAX_SPARSE_ENTRIES", "_MAX_GATHER_ELEMENTS"), budgets):
        monkeypatch.setattr(DE, knob, value)
    covered, total = await run_differential(4242, 25)
    assert total == 25 and covered == free_covered


def test_every_engine_suite_test_is_mirrored_or_excluded():
    """Each test of each suite is a case here or stands in EXCLUDED with
    its reason; nothing else is left out."""
    check_mirrored(SUITES, EXCLUDED, MIRRORED)


async def test_device_executor__test_dropped_plan_falls_back_to_host(monkeypatch):
    """Adapted: a plan over every budget alone is not dropped to the host
    VM: it runs as a device call of its own and answers as it does at the
    reckoned budgets."""
    conv = await build_conversation()
    group = SearchTermGroup(boolean_op="or", terms=[SearchTerm(Term("Bach"))])
    executor = DE.DeviceQueryExecutor(conv)
    await executor.sync()
    free = await executor.search(group)
    for knob in ("_MAX_DENSE_ENTRIES", "_MAX_SPARSE_ENTRIES", "_MAX_GATHER_ELEMENTS"):
        monkeypatch.setattr(DE, knob, 1)
    groups: list = []
    real = executor._run_plan_group
    monkeypatch.setattr(executor, "_run_plan_group", lambda plans, *a, **k: groups.append(plans) or real(plans, *a, **k))
    tiny = await executor.search(group)
    assert groups and free is not None
    assert tiny.keys() == free.keys()
    for ktype in free:
        assert tiny[ktype].semantic_ref_matches == free[ktype].semantic_ref_matches


def _cpu_mesh(n_shard: int, n_dp: int):
    from typeagent_tpu_torch.parallel import create_mesh

    return create_mesh(n_shard=n_shard, n_dp=n_dp, devices=[torch.device("cpu")] * (n_shard * n_dp))


def test_postings__test_coo_sparse_dp_matches_single():
    """Adapted (no _SPARSE_MIN_CAP; the mesh on CPU devices): the COO
    route over a (dp=4, shard=2) mesh reproduces the one-call result:
    segments split over the ranks, postings replicated, global segment
    numbering reassembled."""
    rng = np.random.default_rng(13)
    index, ops, ktype = _random_ops_setup(rng)
    tid0 = ops[0][0]
    ops.append((tid0, 1.0, 1, P.OP_BOOST, 0, -1, 0))
    scope = np.zeros(len(ktype), dtype=bool)
    scope[: len(ktype) // 2] = True
    ops.append((ops[5][0], 1.5, 3, P.OP_RELATED, 31, -1, 1))
    scopes = [None, scope]
    single = index.lookup_ops_sparse(ops, 4, ktype, scopes, boost_factor=10.0)
    dp = index.lookup_ops_sparse_dp(ops, 4, ktype, scopes, boost_factor=10.0, mesh=_cpu_mesh(2, 4))
    assert single is not None and dp is not None and index.dp_calls == 1
    cols_s, packed_s, counts_s, oh_s = single
    cols_d, packed_d, counts_d, oh_d = dp
    np.testing.assert_array_equal(counts_d, counts_s)
    np.testing.assert_array_equal(oh_d, oh_s)
    for s in range(4):
        c = counts_s[s]
        np.testing.assert_array_equal(cols_d[s, :c], cols_s[s, :c])
        np.testing.assert_array_equal(packed_d[:, s, :c], packed_s[:, s, :c])


def test_postings__test_coo_sparse_dp_single_rank_delegates():
    """Adapted (no _SPARSE_MIN_CAP): a dp=1 mesh, or None, is the one-call
    route."""
    rng = np.random.default_rng(14)
    index, ops, ktype = _random_ops_setup(rng)
    single = index.lookup_ops_sparse(ops, 4, ktype)
    for mesh in (_cpu_mesh(8, 1), None):
        dp = index.lookup_ops_sparse_dp(ops, 4, ktype, mesh=mesh)
        for a, b in zip(dp, single):
            np.testing.assert_array_equal(a, b)
    assert index.dp_calls == 0
