"""The roofline's counts against hand-worked cases."""

from __future__ import annotations

import pytest

from portbench.roofline import counts


def test_k2_over_the_ada_shadow_is_bound_by_its_read():
    peak = counts.peaks()
    w = counts.bucket_maxima_bf16(5_000_000, 1536)
    assert w.bytes == pytest.approx(15.36e9, rel=1e-3)  # the shadow, plus one query's maxima
    assert w.bound_s(peak) == pytest.approx(4.585e-3, rel=1e-3)
    assert w.bound_side(peak) == "bytes"
    # Even a full coalesced dispatch (256 queries) stays under the read.
    assert counts.bucket_maxima_bf16(5_000_000, 1536, b=256).bound_side(peak) == "bytes"


def test_k1_over_the_cohere_corpus_is_bound_by_its_operations():
    peak = counts.peaks()
    w = counts.scan_f32(64, 10_000_000, 768)
    assert w.ops == 2 * 64 * 10_000_000 * 768
    assert w.bound_s(peak) == pytest.approx(14.67e-3, rel=1e-3)
    assert w.bound_side(peak) == "ops"


def test_a_scoped_scan_counts_only_the_rows_in_scope():
    peak = counts.peaks()
    whole = counts.scan_f32(64, 10_000_000, 768)
    scope = counts.scan_f32(64, 1_390_000, 768, mask=True)
    assert scope.bound_s(peak) == pytest.approx(whole.bound_s(peak) * 0.139, rel=1e-6)
    assert scope.bytes - counts.scan_f32(64, 1_390_000, 768).bytes == 1_390_000 * 4


def test_peaks_are_the_published_h100_sxm_numbers():
    peak = counts.peaks()
    assert (peak["bf16_flops"], peak["fp32_flops"], peak["hbm_bytes_per_s"]) == (989e12, 67e12, 3.35e12)
    assert peak["power_limit_w"] == 700


def test_a_scan_share_takes_the_least_bound_of_its_kind_and_needs_no_pairing():
    from types import SimpleNamespace as NS

    import numpy as np

    from portbench.roofline.scans import scan_roofline

    peak = counts.peaks()
    cfg, rows = {"dim": 768, "rows": 10_000_000}, {None: 10_000_000, (20, 2000): 9_900_000}
    one = np.zeros((1, 768), np.float32)
    reqs = [NS(queries=one, scope=(20, 2000)), NS(queries=one, scope=None), NS(queries=one, scope=(20, 2000))]
    k4 = counts.scan_f32(1, 9_900_000, 768).bound_s(peak)
    events = [NS(label="K4", dur_ns=int(2 * k4 * 1e9)), NS(label="merge", dur_ns=10**6),
              NS(label="K4", dur_ns=int(2 * k4 * 1e9))]  # one K4 the profiler missed
    ctx = NS(trace=NS(events=events), stretch_requests=reqs, scope_rows=lambda s: rows[s],
             cell=NS(cfg=cfg, mix={"k": 10}))
    assert scan_roofline(ctx, "K4") == pytest.approx(50.0, rel=1e-6)
    assert scan_roofline(ctx, "K1") is None  # a global request, but no K1 launch
    assert scan_roofline(NS(trace=None), "K4") is None


@pytest.mark.parametrize("mask", [False, True])
def test_k6_and_k7_count_the_codes_scales_bf16_queries_and_the_real_batch(mask):
    peak = counts.peaks()
    w = counts.scan_int8(1, 1_000_000, 768, mask=mask)
    assert w.ops == 2 * 1 * 1_000_000 * 768 and w.rate == "bf16_flops"
    assert w.bytes == 768_000_000 + 4_000_000 + 768 * 2 + (4_000_000 if mask else 0) + 10 * 8
    assert w.bound_side(peak) == "bytes"
    assert w.bound_s(peak) == pytest.approx(w.bytes / 3.35e12, rel=1e-12)
    # The padded query block does not count: 64 queries' work is 64 times one's.
    assert counts.scan_int8(64, 1_000_000, 768, mask=mask).ops == 64 * w.ops


@pytest.mark.parametrize("label,name", [
    ("K6", "void tat::topk_mma_kernel<false, true>(signed char const*, float const*, "
           "__nv_bfloat16 const*, long, int, int, long, int, long, int, int const*, int const*, "
           "int const*, float*, int*)"),
    ("K6", "void tat::topk_mma_kernel<false, false>(signed char const*, float const*)"),
    ("K7", "void tat::topk_mma_kernel<true, true>(signed char const*, float const*)"),
    ("K7", "void tat::topk_mma_kernel<true, false>(signed char const*, float const*)"),
])
def test_k6_and_k7_are_named_apart(label, name):
    from portbench import trace

    table = trace.kernel_table()
    assert trace.label_of(name, table) == label
    other = {"K6": "K7", "K7": "K6"}[label]
    pattern = dict(table)[other]
    assert not pattern.search(name)
    assert "K6/K7" not in dict(table)
