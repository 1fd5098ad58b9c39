#!/usr/bin/env python3
"""Drive the PyTorch port (``typeagent_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, one JSON line each:

  0. device and build: torch version, the card's name and power limit,
     seconds to build the kernels from ``typeagent_tpu_torch/csrc``;
  1. each kernel (K1 top-k, K2 bucket maxima, K2' bucket argmax, K3
     rescore, K4 interval top-k, K5 row-masked top-k, K6 int8 top-k, K7
     int8 row-masked top-k, K8 int8-shadow bucket maxima, K9 packed-int4
     bucket maxima) against its plain PyTorch version on the card,
     over d, b, k, dtype, a ragged count, exact duplicate rows across split,
     bucket and interval edges and inside one bucket, 1, 8 and 9 intervals
     (overlapping, (0, 0)-padded, one holding the count watermark), a
     one-bucket cluster and a store of one bucket, at 65,536 rows and
     (K4-K7) at 1M x 384 (later phases check each kernel again at their
     shapes; K8 and K9 at d = 128, 384 and 1024 (query strips streamed),
     and 100 and 2048 for K9, b = 1, 8, 256, a ragged watermark, a store
     of one bucket and a dead one, K9 over the live depth with the whole
     width's bits); then the
     listed scans at 1M x 384, b = 1, 8, 64, 256, k = 1, 10, 32: K6 and K7
     over int8 rows, K4 (interval table) and K5 (row mask) over f32 and
     bf16 rows, over scopes that make them skip tiles: in-scope tiles with
     wholly out-of-scope tiles between them, in-scope rows only in the last
     tile of one split and the first of the next, duplicates on both sides
     of a skipped tile, an empty scope and a scope whose only rows lie past
     the count (both must give only (-3, -1)), and the whole store; at
     every scope, the listing kernels (``interval_tiles`` from the table,
     ``scope_tiles`` from the row mask) give their plain versions' lists;
  2. the main path at full width: a 1M x 384 f32 store ingested in 10
     chunks while it answers lookups, then served through LookupBatcher
     (64 concurrent requests), one batch-256 sync lookup and one keyed
     lookup; every answer is held against the plain f32 top-k on the card,
     no certificate may miss, and the launch counts show which kernels the
     run went through; then a batch-8 lookup (K2 at the small batch);
  3. the one-phase route: a 100k-row store and a 1M-row exact1 store, each
     at b = 256 and b = 8 (K1 at phase 3's shapes: the kernels line's
     topk_100k, topk_100k_b8 and topk_b8 entries);
  4. a 1M-row bf16 store (plain exact2: K2 over the store, K3 on bf16 rows);
  5. a 1M-row int8 store (K6), served b=256 k=10 through LookupBatcher;
     its answers against its plain route, recall@10 against the f32 ones;
     K6 at this store at b = 256 and 8 (the kernels line's topk_q_1m_b256
     and topk_q_1m_b8 entries, each counted from a lookup at its batch);
  6. the multi-conversation corpus, f32, at the repo's 10M-fragment probe
     layout: 9,984,000 x 384 rows made on the card in 24 interleaved
     segments over three conversations, b=64 k=10, searched globally (K1),
     scoped to one conversation (8 intervals, K4), to two (9 intervals
     after merging, row mask + K5) and to a 100k-row subset (K5), with the
     tiles K4 and K5 read beside the live ones and the time of the listing
     kernel that listed them (its plain version's list must be the same);
  7. the int8 corpus at 30,000,000 x 384 in the same layout (the f32 one
     freed first): global (K6), one and two conversations (row mask, K7),
     with the tiles K7 read beside the live ones;
  8. search_mode="approx" at 1M x 384, f32 and bf16 stores, b=256 k=10,
     served through LookupBatcher and sync (the K2' bucket route), and a
     100k-row store (the K1 route); recall@10 against the plain exact
     top-k, K2' against its plain version at these shapes, and batch
     latency beside the exact route on the same rows;
  9. search_mode="ivf" on the clustered corpus of bench.py section B, made
     on the card: 1,000,000 x 384 bf16, 1,000 topics, sigma 0.35, 2%
     isotropic background, topic queries, ivf_build(outlier_frac=0.03,
     rows_per_cluster=512): build seconds and buckets; recall@10 against
     the exact1 oracle, certificate rate and batch-256 latency at B = 8, 12,
     16; certified answers held to the oracle; 10% more rows appended
     (the suffix rides K4 and is found; the tiles it read, K4's time on it
     and the b=256 lookup's), a background rebuild swapped in;
     b=256 served through LookupBatcher. Then 10,000,000 x 384 with 10,000
     topics: build seconds, recall and B=16 latency beside exact1, and the
     certified pipeline. Each scale warms its serving routes first
     (warm_serving: every batch bucket, the escalation pass, the rerun);
 10. the int8-selection hybrid exact search (K8 + K3,
     ``cosine_topk_exact2_hybrid_i8``) at the shape of
     tools/tpu_exact2_probe.py hybrid-i8: 1,000,000 x 384 unit f32 rows
     made on the card, the int8 shadow from quantize_rows_device, 1,024
     queries in 4 batches of 256, k=10, slack 14 and 22: recall@10 against
     the plain f32 top-k, certificate rate, every certified answer equal
     to it up to ties within 2e-6, batch-256 latency beside the bf16-shadow
     hybrid on the same rows;
 11. int4 selection (K9 + K3, ``cosine_topk_exact2_i4``) at the shape of
     tools/tpu_int4_probe.py: the same rows, the packed shadow from
     quantize_rows_int4_device, bf16 (as the probe) and f32 rescore
     buffers, slack 2, 6 and 14: recall@10, the certificate rate (a
     heuristic, not a proof), batch-256 latency.

Each corpus search is checked three ways: the API's hits are the kernel's
output on the same operands, that output agrees with the plain version
(raw values within tolerance, indices equal except at ties), and every hit
lies in its scope; a probe row from each conversation finds itself.

The line before the last holds every kernel's launches, error and time
beside its plain version's (K1 also at 100k rows and at b = 8, K2 at b =
8, K6 at 1M rows and b = 256 and 8, as entries of their own; the two
listing kernels at phase 6's first scopes), its bound on this card (the larger of the
bytes it must move over 3.35 TB/s and its operations over the peak of
their type: 67 TFLOP/s f32, 989 bf16; rows a scope excludes are not
counted), the share of that bound it reaches, and the time of
``torch.matmul`` of the same operands in the kernel's product type
(``product_ms``: the product alone, not the same function, over the depth
the kernel walks (K9: the live depth, not the packing's padding), null for
the listing kernels, which multiply nothing; no single
PyTorch call computes any of these kernels' functions, so ``library_ms``
is null); the last line is the device summary. Any
failed check exits non-zero. There is no CPU mode: without a CUDA device
the script exits non-zero.

Plain versions run with ``torch.backends.cuda.matmul.allow_tf32 = False``
(full f32 products, as the kernels compute).
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
D_MAIN = 384
N_MAIN = 1_000_000
K_MAIN = 10
TOL_F32 = 2e-6  # raw f32 scores: summation order differs, no TF32
TOL_BF16 = 1e-5  # bf16 stores: exact bf16 products, f32 sums
TOL_INT8 = 1e-5  # int8 stores: exact bf16 x int8 products, f32 sums, x scale
# The corpus layout of tools/tpu_corpus10m_probe.py --fragmented.
CORPUS_NAMES = ("podcast", "mailbox", "wiki")
CORPUS_LAYOUT = [name for _ in range(8) for name in CORPUS_NAMES]
CORPUS_F32_SEG_ROWS = 416_000  # 24 x 416,000 = 9,984,000 rows
CORPUS_INT8_SEG_ROWS = 1_250_000  # 24 x 1,250,000 = 30,000,000 rows
CORPUS_CHUNK = 500_000  # rows made on the card per append_device
CORPUS_B = 64
KERNELS = ("topk", "bucket_maxima", "bucket_argmax", "rescore", "topk_iv", "topk_mask", "topk_q",
           "topk_mq", "bucket_maxima_q", "bucket_maxima_q4", "interval_tiles", "scope_tiles")
# Further entries of the kernels line: a kernel at another of its paths'
# shapes (K1 at phase 3's 100k-row store, K1 and K2 at b = 8, the store's
# smallest padded batch, K6 at phase 5's 1M-row int8 store at b = 256 and
# 8), each with the kernel counter its launches read.
SHAPE_ENTRIES = {"topk_100k": "topk", "topk_100k_b8": "topk", "topk_b8": "topk",
                 "bucket_maxima_b8": "bucket_maxima", "topk_q_1m_b256": "topk_q",
                 "topk_q_1m_b8": "topk_q"}
ENTRIES = KERNELS + tuple(SHAPE_ENTRIES)
# bench.py section B's clustered corpus: (rows, topics) per scale.
SIGMA_C, BG_C = 0.35, 0.02
IVF_SCALES = ((1_000_000, 1_000), (10_000_000, 10_000))
IVF_BS = (8, 12, 16)
IVF_QUERIES = 1024  # 4 batches of 256
IVF_CHUNK = 500_000  # rows made on the card per step
# Phases 10-11: the probes' operating point.
SEL_QUERIES = 1024  # 4 batches of 256
I8_SLACKS = (14, 22)
I4_SLACKS = (2, 6, 14)
# An H100 SXM's published peaks (dense): f32 outside the tensor cores (the
# f32 scans must score at full f32, so no TF32), bf16 tensor cores (bf16,
# int8 and int4 rows meet bf16 queries), device memory.
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
HBM_BPS = 3.35e12


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def normed(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    m = rng.standard_normal((n, d), dtype=np.float32)
    m /= np.linalg.norm(m, axis=1, keepdims=True)
    return m


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from typeagent_tpu_torch.models.adapters import create_test_embedding_model
    from typeagent_tpu_torch.ops import _build, int4, ivf, topk
    from typeagent_tpu_torch.parallel import CorpusVectorStore
    from typeagent_tpu_torch.serve import LookupBatcher
    from typeagent_tpu_torch.utils.metrics import METRICS
    from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    kernel_err = dict.fromkeys(ENTRIES, 0.0)
    kernel_ms: dict[str, tuple[float, float]] = {}
    kernel_bound: dict[str, tuple[float, str]] = {}  # (bound ms, "bytes" | "operations")
    kernel_product_ms: dict[str, float] = {}
    # Launches of each main path, each counted from a reset just before the
    # path to a read just after it (comparison launches come later); a
    # shape entry counts the launches of the one path run at its shape.
    path_launches = dict.fromkeys(ENTRIES, 0)

    def add_path_launches(counts):
        for name in KERNELS:
            path_launches[name] += counts[name]

    # ---------------------------------------------------------------- helpers

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def pad_dev(m_dev: torch.Tensor, n_pad: int, dtype) -> torch.Tensor:
        buf = torch.zeros((n_pad, m_dev.shape[1]), dtype=dtype, device=dev)
        buf[: m_dev.shape[0]] = m_dev
        return buf

    def padded_store(m: np.ndarray, n_pad: int, dtype) -> torch.Tensor:
        return pad_dev(to_dev(m), n_pad, dtype)

    def cuda_ms(fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000 / iters

    def in_turns(timer, kernel_fn, plain_fn) -> tuple[float, float]:
        """Plain, kernel, kernel, plain; mean of each pair."""
        p1 = timer(plain_fn)
        k1 = timer(kernel_fn)
        k2 = timer(kernel_fn)
        p2 = timer(plain_fn)
        return (k1 + k2) / 2, (p1 + p2) / 2

    def bound_of(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
        """The least time the card could take: operations over the peak of
        their type or bytes over the memory rate, whichever is larger."""
        ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
        return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")

    def scan_bound(rows: int, d_pad: int, itemsize: int, b: int, out_bytes: int, peak: float,
                   extra_bytes: int = 0) -> tuple[float, str]:
        """A scan of ``rows`` rows against b f32 queries: each row read
        once (plus ``extra_bytes``: scales, a mask), the queries once, the
        output written once; 2*b*rows*d_pad operations."""
        nbytes = rows * d_pad * itemsize + extra_bytes + b * d_pad * 4 + out_bytes
        return bound_of(2.0 * b * rows * d_pad, nbytes, peak)

    def live_rows(count: int) -> int:
        """Rows of the buckets that hold a live row: what the kernels read,
        and the row count of the ``torch.matmul`` yardsticks (a multiple
        of 128, so cuBLAS keeps its aligned kernels)."""
        return -(-count // 128) * 128

    def record(name, ms_pair, bound, product_ms):
        kernel_ms[name], kernel_bound[name], kernel_product_ms[name] = ms_pair, bound, product_ms

    plain_of = {
        "fused_topk": topk.topk_plain, "bucket_maxima": topk.bucket_maxima_plain,
        "bucket_argmax": topk.bucket_argmax_plain,
        "rescore_selected": topk.rescore_selected_plain, "fused_topk_iv": topk.topk_iv_plain,
        "fused_topk_masked": topk.topk_masked_plain, "fused_topk_q": topk.topk_q_plain,
        "fused_topk_mq": topk.topk_mq_plain, "bucket_maxima_q": topk.bucket_maxima_q_plain,
    }

    @contextlib.contextmanager
    def plain_kernels():
        """Route the stores' searches through the plain versions on the card."""
        saved = {name: getattr(topk, name) for name in plain_of}
        for name, fn in plain_of.items():
            setattr(topk, name, fn)
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(topk, name, fn)

    def picked_raw(emb, scales, q, idx):
        """Raw scores of the picked rows, recomputed row by row."""
        ids = idx.clamp(min=0).long()
        qq = q.to(torch.bfloat16 if scales is not None else emb.dtype).float()
        raw = torch.einsum("bkd,bd->bk", emb[ids].float(), qq)
        return raw * scales[ids] if scales is not None else raw

    def check_scan(got, ref, emb, scales, q, count, in_scope, tol, what):
        """A top-k scan against its plain version: values within tol, the
        same number of filled slots, distinct live in-scope picks whose
        recomputed scores match, and any pick the plain version did not
        make tying with its k-th value. Returns the max value error."""
        (gv, gi), (pv, pi) = got, ref
        err = (gv - pv).abs().max().item()
        require(err <= tol, f"{what}: max value error {err} > {tol}")
        filled = gi >= 0
        require(bool((filled.sum(1) == (pi >= 0).sum(1)).all()), f"{what}: wrong number of filled slots")
        require(bool((gi < count).all()), f"{what}: a row past the watermark surfaced")
        require(bool(in_scope(gi.clamp(min=0))[filled].all()), f"{what}: a pick outside the scope")
        true = picked_raw(emb, scales, q, gi)
        require(bool(((true - gv).abs() <= tol)[filled].all()), f"{what}: a reported score is not the row's")
        kth = torch.where(pi >= 0, pv, 3.0).min(dim=1, keepdim=True).values
        other = filled & ~(gi[:, :, None] == pi[:, None, :]).any(dim=2)
        require(bool((gv >= kth - tol)[other].all()), f"{what}: a pick outside the plain top-k")
        for row in gi.cpu().numpy():
            live = row[row >= 0]
            require(len(set(live.tolist())) == live.size, f"{what}: duplicate index")
        return err

    def check_tile_list(name, operand, count, n_rows, what, timed=True):
        """A listing kernel (``interval_tiles`` from an interval table,
        ``scope_tiles`` from a row mask) against its plain version: the
        same list and count, entry for entry. Timed, it runs in turns with
        its plain version, and its first timed shape gives the kernels
        line's entry, bound by the table or the mask's rows below the count
        read once and the list written once. Returns (listed tiles, ms or
        None)."""
        if name == "interval_tiles":
            kern = lambda: topk.interval_tiles(operand, count, n_rows)  # noqa: E731
            plain = lambda: topk.interval_tiles_plain(operand, count, n_rows)  # noqa: E731
        else:
            kern = lambda: topk.scope_tiles(operand, count)  # noqa: E731
            plain = lambda: topk.scope_tiles_plain(operand, count)  # noqa: E731
        (got, got_n), (ref, ref_n) = kern(), plain()
        require(torch.equal(got, ref) and torch.equal(got_n, ref_n), f"{what}: the tile list differs from plain")
        if not timed:
            return int(got_n.item()), None
        ms_pair = in_turns(lambda fn: cuda_ms(fn, iters=10), kern, plain)
        if name not in kernel_ms:
            live_count = min(count, n_rows)
            read = operand.numel() * 4 if name == "interval_tiles" else live_count * 4
            record(name, ms_pair, bound_of(0.0, read + -(-live_count // 128) * 4 + 4, PEAK_F32), None)
        return int(got_n.item()), ms_pair[0]

    def quantized_store(m_dev, n_pad):
        """int8 rows and scales of unit rows ``m_dev``, padded to n_pad."""
        q_rows, scales = topk.quantize_rows_device(m_dev)
        emb = torch.zeros((n_pad, m_dev.shape[1]), dtype=torch.int8, device=dev)
        emb[: m_dev.shape[0]] = q_rows
        sc = torch.ones((n_pad,), device=dev)
        sc[: m_dev.shape[0]] = scales
        return emb, sc

    def check_raw_topk(emb, q, count, k, got_v, got_i, ref_v, tol, what):
        """Kernel top-k vs plain: values within tol; every pick distinct,
        live, and scoring within tol of the plain k-th value (ties)."""
        err = (got_v - ref_v).abs().max().item()
        require(err <= tol, f"{what}: max value error {err} > {tol}")
        true = topk._raw_scores(emb, q, count).gather(1, got_i.clamp(min=0).long())
        valid = got_i >= 0
        require(bool((valid.sum(1) == min(k, count)).all()), f"{what}: wrong number of filled slots")
        require(bool((got_i < count).all()), f"{what}: a row past the watermark surfaced")
        kth = ref_v[:, k - 1 : k]
        require(bool(((true >= kth - tol) | ~valid).all()), f"{what}: a pick outside the top-k")
        gi = got_i.cpu().numpy()
        for row in gi:
            live = row[row >= 0]
            require(len(set(live.tolist())) == live.size, f"{what}: duplicate index")
        return err

    def check_argmax(emb, q, count, tol, what):
        """K2' against its plain version: values within tol; dead buckets
        (-3, -1); every reported row live, in its bucket and scoring the
        reported value; rows equal to the plain version's except where the
        bucket's two best raw scores lie within tol. Returns the max value
        error."""
        gv, gi = topk.bucket_argmax(emb, q, count)
        pv, pi = topk.bucket_argmax_plain(emb, q, count)
        err = (gv - pv).abs().max().item()
        require(err <= tol, f"{what}: max value error {err} > {tol}")
        nb = gv.shape[1]
        bucket = torch.arange(nb, device=dev)
        dead = (bucket * 128 >= count)[None, :].expand_as(gi)
        require(bool((gv[dead] == -3.0).all() and (gi[dead] == -1).all()), f"{what}: dead buckets")
        live = ~dead
        require(bool(((gi // 128 == bucket) & (gi < count))[live].all()), f"{what}: a row outside its bucket")
        raw = topk._raw_scores(emb, q, count).view(q.shape[0], nb, 128)
        picked = raw.view(q.shape[0], -1).gather(1, gi.clamp(min=0).long())
        require(bool(((picked - gv).abs() <= tol)[live].all()), f"{what}: a reported value is not the row's")
        top2 = raw.topk(2, dim=2).values
        differ = gi != pi
        require(bool((top2[..., 0] - top2[..., 1] <= tol)[differ].all()),
                f"{what}: argmax differs from the plain version off a near-tie")
        return err

    def check_results(rows, queries, buf, count, k, tol, what):
        """Served ScoredInt rows vs the plain exact f32 top-k on the card:
        recall 1.0 except for ties within tol. Returns (strict recall,
        max score error)."""
        hits = total = 0
        max_err = 0.0
        for s in range(0, queries.shape[0], 256):
            q = torch.zeros((min(256, queries.shape[0] - s), buf.shape[1]), device=dev)
            q[:, : queries.shape[1]] = to_dev(queries[s : s + 256])
            rv, ri = topk._raw_to_score(*topk.topk_plain(buf, q, count, k))
            rv, ri = rv.cpu().numpy(), ri.cpu().numpy()
            for r in range(q.shape[0]):
                got = rows[s + r]
                ref_items = ri[r][ri[r] >= 0]
                require(len(got) == ref_items.size, f"{what}: {len(got)} hits, expected {ref_items.size}")
                g_items = [x.item for x in got]
                g_scores = np.array([x.score for x in got], dtype=np.float64)
                require(len(set(g_items)) == len(g_items), f"{what}: duplicate item")
                if g_scores.size:
                    err = float(np.abs(g_scores - rv[r][: g_scores.size]).max())
                    max_err = max(max_err, err)
                    require(err <= tol, f"{what}: score error {err} > {tol}")
                ref_set = set(ref_items.tolist())
                kth = rv[r][ref_items.size - 1] if ref_items.size else 0.0
                for item, score in zip(g_items, g_scores):
                    if item in ref_set:
                        hits += 1
                    else:
                        require(score >= kth - tol, f"{what}: item {item} not in the exact top-k")
                total += ref_items.size
        return (hits / total if total else 1.0), max_err

    def store_settings(dtype: str = "float32", mode: str = "exact") -> TextEmbeddingIndexSettings:
        return TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(D_MAIN),
            dtype=dtype, search_mode=mode, min_score=0.0, device="cuda",
        )

    # ---------------------------------------------------- 0. device and build
    smi = smi_line()
    t0 = time.perf_counter()
    _build.kernels()
    emit({
        "phase": 0, "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "build_s": round(time.perf_counter() - t0, 3),
    })

    # ------------------------------------------- 1. kernels vs plain versions
    n_pad, checks = 1 << 16, 0
    by_dtype: dict[str, float] = {}  # K1 error by store dtype
    count = n_pad - 333  # ragged: not a multiple of 128; last 2 buckets empty
    for d in (384, 1536):
        m = normed(rng, count, d)
        # Exact duplicates spread across row splits (tie rule, merge).
        dup_rows = list(range(100, count, 5000))[:12]
        m[dup_rows] = m[dup_rows[0]]
        # Duplicates inside one bucket (300, 301, 383) and across a bucket
        # edge (511 | 512): K2''s lowest-row rule.
        m[[301, 383]] = m[300]
        m[512] = m[511]
        qs = normed(rng, 256, d)
        qs[0] = m[dup_rows[0]]
        qs[1], qs[2] = m[300], m[511]
        for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            emb = padded_store(m, n_pad, dtype)
            for b in (1, 8, 256):
                q = to_dev(qs[:b])
                for k in (1, 10, 32):
                    got_v, got_i = topk.fused_topk(emb, q, count, k)
                    ref_v, ref_i = topk.topk_plain(emb, q, count, k)
                    what = f"K1 d={d} b={b} k={k} {dtype}"
                    err = check_raw_topk(emb, q, count, k, got_v, got_i, ref_v, tol, what)
                    kernel_err["topk"] = max(kernel_err["topk"], err)
                    by_dtype[str(dtype)] = max(by_dtype.get(str(dtype), 0.0), err)
                    # Lowest-row tie rule on the duplicate rows (query 0).
                    want = dup_rows[: min(k, len(dup_rows))]
                    require(got_i[0, : len(want)].tolist() == want, f"{what}: tie rule {got_i[0].tolist()}")
                    checks += 1
                got = topk.bucket_maxima(emb, q, count)
                ref = topk.bucket_maxima_plain(emb, q, count)
                err = (got - ref).abs().max().item()
                require(err <= tol, f"K2 d={d} b={b} {dtype}: error {err}")
                require(bool((got[:, -2:] == -3.0).all()), "K2: masked buckets not -3")
                kernel_err["bucket_maxima"] = max(kernel_err["bucket_maxima"], err)
                what = f"K2' d={d} b={b} {dtype}"
                err = check_argmax(emb, q, count, tol, what)
                kernel_err["bucket_argmax"] = max(kernel_err["bucket_argmax"], err)
                if b >= 8:
                    _, gi = topk.bucket_argmax(emb, q, count)
                    require(gi[1, 2].item() == 300 and gi[2, 3].item() == 511 and gi[2, 4].item() == 512,
                            f"{what}: tie rule {gi[1, 2].item()} {gi[2, 3].item()} {gi[2, 4].item()}")
                for B in (1, 24, 46):
                    ids = torch.stack([
                        torch.randperm(n_pad // 128, device=dev)[:B] for _ in range(b)
                    ]).to(torch.int32).contiguous()
                    got = topk.rescore_selected(emb, q, ids)
                    ref = topk.rescore_selected_plain(emb, q, ids)
                    err = (got - ref).abs().max().item()
                    require(err <= TOL_F32, f"K3 d={d} b={b} B={B} {dtype}: error {err}")
                    kernel_err["rescore"] = max(kernel_err["rescore"], err)
                checks += 4
            del emb
    # The adversarial one-bucket cluster: all true top-k in one bucket.
    d, count = 64, 2048
    m = normed(rng, count, d)
    target = normed(rng, 1, d)[0]
    for j in range(32):
        v = target + 0.01 * rng.standard_normal(d).astype(np.float32)
        m[256 + j] = v / np.linalg.norm(v)
    mp = np.zeros((count, 128), np.float32)
    mp[:, :d] = m
    qp = np.zeros((8, 128), np.float32)
    qp[0, :d] = target
    emb = padded_store(mp, count, torch.float32)
    q = to_dev(qp)
    vals, idx, cert = topk.cosine_topk_exact2(emb, q, count, K_MAIN, slack=2)
    ref_v, ref_i = topk.cosine_topk(emb, q, count, K_MAIN)
    require(bool(cert.all()), "cluster: certificate failed")
    require(set(idx[0].tolist()) == set(ref_i[0].tolist()), "cluster: exact2 != exact1")
    require(all(256 <= i < 288 for i in idx[0].tolist()), "cluster: rows outside the cluster")
    checks += 1
    # A store of one bucket, ragged: K2' over 77 live rows of 128.
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        emb = padded_store(normed(rng, 128, D_MAIN), 128, dtype)
        q = to_dev(normed(rng, 8, D_MAIN))
        err = check_argmax(emb, q, 77, tol, f"K2' one bucket {dtype}")
        kernel_err["bucket_argmax"] = max(kernel_err["bucket_argmax"], err)
        checks += 1

    # K4-K7. Query 0 is a row duplicated across row-split and interval
    # edges (and once past the count watermark), so the lowest-row tie rule
    # is checked through every filter.
    def scoped_checks(m_dev, n_pad, count, dupes, tables, bs, ks, tag):
        """``m_dev``: n_pad unit rows, live up to ``count`` (the rows past
        it hold data too, so a scan that ignores the watermark shows)."""
        m_dev[dupes] = m_dev[dupes[0]].clone()
        stores = {
            "float32": (pad_dev(m_dev, n_pad, torch.float32), None, TOL_F32),
            "bfloat16": (pad_dev(m_dev, n_pad, torch.bfloat16), None, TOL_BF16),
            "int8": (*quantized_store(m_dev, n_pad), TOL_INT8),
        }
        qs = torch.nn.functional.normalize(
            torch.randn((max(bs), m_dev.shape[1]), generator=gen, device=dev), dim=1)
        qs[0] = m_dev[dupes[0]]
        n_checks = 0
        for tname, table in tables.items():
            if table is None:
                iv, mask = None, torch.ones((n_pad,), dtype=torch.int32, device=dev)
            else:
                iv = torch.tensor(table, dtype=torch.int32, device=dev)
                mask = topk.intervals_to_rowmask(n_pad, iv)[0].contiguous()
            want = [r for r in dupes if r < count and mask[r].item() > 0]
            check_tile_list("scope_tiles", mask, count, n_pad, f"{tag} {tname}", timed=False)
            if iv is not None:
                check_tile_list("interval_tiles", iv, count, n_pad, f"{tag} {tname}", timed=False)
            for dname, (emb, sc, tol) in stores.items():
                for b in bs:
                    q = qs[:b].contiguous()
                    for k in ks:
                        runs = []
                        if sc is not None and iv is None:
                            runs.append(("topk_q", lambda: topk.fused_topk_q(emb, sc, q, count, k),
                                         lambda: topk.topk_q_plain(emb, sc, q, count, k)))
                        elif sc is not None:
                            runs.append(("topk_mq", lambda: topk.fused_topk_mq(emb, sc, q, count, mask, k),
                                         lambda: topk.topk_mq_plain(emb, sc, q, count, mask, k)))
                        elif iv is not None:
                            runs.append(("topk_mask", lambda: topk.fused_topk_masked(emb, q, count, mask, k),
                                         lambda: topk.topk_masked_plain(emb, q, count, mask, k)))
                            if iv.shape[0] <= topk._PALLAS_MAX_INTERVALS:
                                runs.append(("topk_iv", lambda: topk.fused_topk_iv(emb, q, count, iv, k),
                                             lambda: topk.topk_iv_plain(emb, q, count, iv, k)))
                        for name, kern, plain in runs:
                            got, ref = kern(), plain()
                            what = f"{name} {tag} {tname} {dname} b={b} k={k}"
                            err = check_scan(got, ref, emb, sc, q, count,
                                             lambda idx: mask[idx.long()] > 0, tol, what)
                            kernel_err[name] = max(kernel_err[name], err)
                            top = got[1][0, : min(k, len(want))].tolist()
                            require(top == want[: len(top)], f"{what}: tie rule {got[1][0].tolist()}")
                            n_checks += 1
        return n_checks

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    n_pad, count = 1 << 16, (1 << 16) - 333  # the watermark lies inside [65000, 65536)
    checks += scoped_checks(
        to_dev(normed(rng, n_pad, D_MAIN)), n_pad, count,
        # 255|256 and 1023|1024 straddle row splits (b = 64 and 256), 299|300
        # and 12799|12800 interval edges; 65300 lies past the watermark.
        [255, 256, 299, 300, 1023, 1024, 12799, 12800, 40959, 65100, 65300],
        {
            "none": None,
            "1": [[100, 30000]],
            "8": [[40000, 40960], [0, 300], [250, 700], [65000, 65536],
                  [0, 0], [0, 0], [12000, 12800], [30000, 30001]],
            "9": [[i * 7000 + 200, i * 7000 + 1700] for i in range(9)],
        },
        (1, 64, 256), (1, 10, 32), "65536",
    )
    n_pad, count = (N_MAIN + 1023) // 1024 * 1024, N_MAIN
    m_dev = torch.nn.functional.normalize(torch.randn((n_pad, D_MAIN), generator=gen, device=dev), dim=1)
    checks += scoped_checks(
        # Row splits of 3,840 rows at b = 64 and 15,232 at b = 256.
        m_dev, n_pad, count, [3839, 3840, 15231, 15232, 62499, 62500, 499_999, 500_000, 999_999],
        {
            "none": None,
            "8": [[i * 125_000, i * 125_000 + 62_500] for i in range(7)] + [[499_999, 500_001]],
            "9": [[i * 111_000, i * 111_000 + 55_000] for i in range(8)] + [[999_000, n_pad]],
        },
        (64, 256), (10,), "1M",
    )

    # The listed scans at 1M x 384: K6 and K7 on the tensor-core loop over
    # int8 rows, K4 (the scope's interval table) and K5 (its row mask) on
    # the FFMA tile over f32 and bf16 rows (the global scope is K6, and for
    # K4 and K5 the whole store). Every row of `dupes` is one row (query 0),
    # so each scope's top-k of query 0 starts with its in-scope duplicates
    # in ascending order: through skipped tiles, list shares and row splits
    # (3839 | 3840 at b <= 64, 15231 | 15232 at b = 256).
    t = 128
    dupes = sorted([10 * t + 6, 41 * t + 127, 100 * t, 301 * t - 1, 301 * t + 5, 302 * t, 3839, 3840,
                    15231, 15232, 5000 * t + 3, 999_999, 1_000_100])
    m_dev[dupes] = m_dev[dupes[0]].clone()
    # Rows past the count hold data; the listed f32 cases are held to 1e-6.
    stores = {"int8": (*quantized_store(m_dev, n_pad), TOL_INT8), "float32": (m_dev, None, 1e-6),
              "bfloat16": (m_dev.to(torch.bfloat16), None, TOL_BF16)}
    qs = torch.nn.functional.normalize(torch.randn((256, D_MAIN), generator=gen, device=dev), dim=1)
    qs[0] = m_dev[dupes[0]]
    for b in (1, 8, 64, 256):
        q = qs[:b].contiguous()
        for dname, (emb, sc, tol) in stores.items():
            query_block = 64 if sc is not None else topk.topk_query_block(b)
            edge, _ = topk.scan_geometry(count, n_pad, b, topk._sm_count(0), query_block)
            scopes = {
                "global": None,
                "gaps": [(10 * t + 5, 10 * t + 70), (40 * t, 42 * t), (5000 * t + 3, 5000 * t + 4), (7812 * t, n_pad)],
                "split_edge": [(edge - 64, edge + 64)],
                "skipped_dupes": [(300 * t, 301 * t), (302 * t, 303 * t)],
                "empty": [],
                "past_count": [(count, n_pad)],
            }
            for sname, spans in scopes.items():
                spans = [(0, n_pad)] if spans is None else spans
                mask = torch.zeros((n_pad,), dtype=torch.int32, device=dev)
                for lo, hi in spans:
                    mask[lo:hi] = 1
                table = torch.tensor(spans, dtype=torch.int32, device=dev).reshape(-1, 2)
                want = [r for r in dupes if r < count and mask[r].item() > 0]
                if dname == "float32":
                    for lister, operand in (("interval_tiles", table), ("scope_tiles", mask)):
                        check_tile_list(lister, operand, count, n_pad, f"1M {sname} b={b}", timed=False)
                for k in (1, 10, 32):
                    if sc is None:
                        ref = topk.topk_iv_plain(emb, q, count, table, k)
                        runs = [("topk_iv", topk.fused_topk_iv(emb, q, count, table, k)),
                                ("topk_mask", topk.fused_topk_masked(emb, q, count, mask, k))]
                    elif sname == "global":
                        ref = topk.topk_q_plain(emb, sc, q, count, k)
                        runs = [("topk_q", topk.fused_topk_q(emb, sc, q, count, k))]
                    else:
                        ref = topk.topk_mq_plain(emb, sc, q, count, mask, k)
                        runs = [("topk_mq", topk.fused_topk_mq(emb, sc, q, count, mask, k))]
                    for name, got in runs:
                        what = f"{name} 1M {dname} {sname} b={b} k={k}"
                        err = check_scan(got, ref, emb, sc, q, count, lambda idx: mask[idx.long()] > 0, tol, what)
                        kernel_err[name] = max(kernel_err[name], err)
                        top = got[1][0, : min(k, len(want))].tolist()
                        require(top == want[: len(top)], f"{what}: tie rule {got[1][0].tolist()}")
                        if not want:
                            require(bool((got[0] == -3.0).all()) and bool((got[1] == -1).all()),
                                    f"{what}: an empty scope gave hits")
                        checks += 1
    del m_dev, emb, sc, qs, stores

    # K8 and K9: the int8 and packed-int4 selection shadows of unit rows
    # (codes of both signs in both nibbles), a ragged watermark (the last
    # two buckets dead), a store of one bucket and a dead store; d = 1024
    # and 2048 stream their query strips through the ring. K9 walks the
    # live depth of rows of width d, as the int4 search calls it, and must
    # give the whole width's bits.
    def check_selection(name, got, ref, count, what):
        err = (got - ref).abs().max().item()
        require(err <= TOL_INT8, f"{what}: max value error {err} > {TOL_INT8}")
        dead = torch.arange(got.shape[1], device=dev) * 128 >= count
        require(bool((got[:, dead] == -3.0).all()) and bool((got[:, ~dead] > -2.0).all()),
                f"{what}: dead or live buckets wrong")
        kernel_err[name] = max(kernel_err[name], err)

    n_pad = 1 << 16
    for d in (100, 128, 384, 1024, 2048):
        rows = torch.nn.functional.normalize(torch.randn((n_pad, d), generator=gen, device=dev), dim=1)
        qs = torch.nn.functional.normalize(torch.randn((256, d), generator=gen, device=dev), dim=1)
        emb_q, sc = topk.quantize_rows_device(rows)
        packed, sc4 = int4.quantize_rows_int4_device(rows)
        for n_rows, count, bs in ((n_pad, n_pad - 333, (1, 8, 256)), (128, 77, (8,)), (256, 0, (8,))):
            for b in bs:
                q = qs[:b].contiguous()
                if d % 64 == 0 and d <= 1024:
                    check_selection("bucket_maxima_q",
                                    topk.bucket_maxima_q(emb_q[:n_rows], sc[:n_rows], q, count),
                                    topk.bucket_maxima_q_plain(emb_q[:n_rows], sc[:n_rows], q, count),
                                    count, f"K8 d={d} n={n_rows} count={count} b={b}")
                    checks += 1
                q_split = int4.split_pad_queries(q, d)
                what = f"K9 d={d} n={n_rows} count={count} b={b}"
                got = int4.bucket_maxima_q4(packed[:n_rows], sc4[:n_rows], q_split, count, d=d)
                check_selection("bucket_maxima_q4", got,
                                int4.bucket_maxima_q4_plain(packed[:n_rows], sc4[:n_rows], q_split, count, d=d),
                                count, what)
                whole = int4.bucket_maxima_q4(packed[:n_rows], sc4[:n_rows], q_split, count)
                require(torch.equal(got.view(torch.int32), whole.view(torch.int32)),
                        f"{what}: the live depth changed the whole width's bits")
                checks += 1
        del rows, emb_q, packed
    emit({"phase": 1, "checks": checks, "max_abs_err": kernel_err,
          "topk_err_by_dtype": by_dtype, "ok": True})

    # ------------------------------------------------- 2. the main path, 1M rows
    store = VectorStore(store_settings())
    topk.reset_launch_counts()
    METRICS.counters.clear()
    t_ingest = time.perf_counter()
    chunk = N_MAIN // 10
    probe = normed(rng, 1, D_MAIN)
    for _ in range(10):
        store.add_embeddings(None, normed(rng, chunk, D_MAIN))
        # Serving while ingesting: the lookup flushes the chunk (growth path);
        # the first chunk is below the exact2 crossover and runs K1.
        require(len(store.fuzzy_lookup_embeddings_batch(probe, max_hits=K_MAIN)[0]) == K_MAIN, "probe")
    keys = ["alpha", "beta", "gamma"]
    asyncio.run(store.add_keys(keys))
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t_ingest

    req_sizes = rng.integers(1, 17, size=64)
    requests = [normed(rng, int(s), D_MAIN) for s in req_sizes]
    big = normed(rng, 256, D_MAIN)

    async def serve():
        t = time.perf_counter()
        out = await asyncio.gather(*(
            store.fuzzy_lookup_embeddings_batch_async(r, max_hits=K_MAIN) for r in requests
        ))
        elapsed = time.perf_counter() - t
        key_hits = await store.fuzzy_lookup("beta", max_hits=K_MAIN)
        stats = store._batcher.stats()
        await store._batcher.close()
        return out, elapsed, key_hits, stats

    served, serve_s, key_hits, batcher_stats = asyncio.run(serve())
    big_rows = store.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)
    launches = topk.launch_counts()
    add_path_launches(launches)
    cert_q = METRICS.counters.get("vectorstore.cert_queries", 0)
    cert_miss = METRICS.counters.get("vectorstore.cert_misses", 0)
    for name in ("topk", "bucket_maxima", "rescore"):
        require(launches[name] > 0, f"main path never launched the {name} kernel")
    require(launches["materialized_topk"] == 0, "main path took the k > 32 materialized route")
    # On unit rows a miss cannot come from rounding: each of the B selected
    # buckets holds a row within the bf16 error (~2**-8 by Cauchy-Schwarz)
    # of the B-th selected maximum, so the k-th rescored score is too, and
    # 2**-8 < _CERT_EPS_HYBRID. A miss means K2 or K3 is wrong.
    require(cert_q > 0 and cert_miss == 0, f"certificate misses {cert_miss} of {cert_q}")

    buf, count = store._buf, store._count
    require(count == N_MAIN + len(keys), f"store holds {count} rows")
    recall_s, err_s = check_results(
        [row for res in served for row in res], np.concatenate(requests), buf, count, K_MAIN,
        TOL_F32, "served",
    )
    recall_b, err_b = check_results(big_rows, big, buf, count, K_MAIN, TOL_F32, "batch-256")
    require(key_hits and key_hits[0].item == N_MAIN + 1 and key_hits[0].score >= 1 - 1e-6,
            f"fuzzy_lookup('beta') -> {key_hits[:1]}")

    # Each kernel against its plain version at the main path's shapes
    # (1M rows, b=256, k=10, the B = k + slack buckets K2 selects), then
    # kernel and plain timed in turns. These launches come after the counts
    # were read, so they do not count as the main path's.
    def check_at_main_shapes(emb, selector, q, n, slack, tag):
        """K2 over ``selector`` (the bf16 shadow, or the bf16 store itself)
        and K3 over ``emb`` on the buckets it picks; returns the bucket ids."""
        maxima = topk.bucket_maxima(selector, q, n)
        err = (maxima - topk.bucket_maxima_plain(selector, q, n)).abs().max().item()
        require(err <= TOL_BF16, f"K2 {tag}: error {err} > {TOL_BF16}")
        kernel_err["bucket_maxima"] = max(kernel_err["bucket_maxima"], err)
        ids = torch.topk(maxima, K_MAIN + slack, dim=1).indices.to(torch.int32).contiguous()
        err = (topk.rescore_selected(emb, q, ids) - topk.rescore_selected_plain(emb, q, ids)).abs().max().item()
        require(err <= TOL_F32, f"K3 {tag}: error {err} > {TOL_F32}")
        kernel_err["rescore"] = max(kernel_err["rescore"], err)
        return ids

    qd = torch.zeros((256, buf.shape[1]), device=dev)
    qd[:, :D_MAIN] = to_dev(big)
    shadow = store._shadow(buf, count)
    ids = check_at_main_shapes(buf, shadow, qd, count, topk._HYBRID_SLACK, "1M f32, bf16 shadow")
    got_v, got_i = topk.fused_topk(buf, qd, count, K_MAIN)
    ref_v, _ = topk.topk_plain(buf, qd, count, K_MAIN)
    kernel_err["topk"] = max(kernel_err["topk"], check_raw_topk(
        buf, qd, count, K_MAIN, got_v, got_i, ref_v, TOL_F32, "K1 1M f32"))
    d_pad, nb = buf.shape[1], shadow.shape[0] // 128
    qd_bf16 = qd.to(torch.bfloat16)
    record("bucket_maxima",
           in_turns(cuda_ms, lambda: topk.bucket_maxima(shadow, qd, count),
                    lambda: topk.bucket_maxima_plain(shadow, qd, count)),
           scan_bound(count, d_pad, 2, 256, 256 * nb * 4, PEAK_BF16),
           cuda_ms(lambda: torch.matmul(qd_bf16, shadow[: live_rows(count)].T), iters=3))
    # K3 reads each distinct selected bucket once (the same bucket chosen
    # by several queries comes from L2).
    n_sel = ids.shape[1]
    distinct = torch.unique(ids).numel()
    gathered = buf[topk._bucket_row_ids(ids).long()]  # [256, B*128, d_pad]: the product's operand
    record("rescore",
           in_turns(cuda_ms, lambda: topk.rescore_selected(buf, qd, ids),
                    lambda: topk.rescore_selected_plain(buf, qd, ids)),
           bound_of(2.0 * 256 * n_sel * 128 * d_pad,
                    distinct * 128 * d_pad * 4 + 256 * d_pad * 4 + ids.numel() * 4 + 256 * n_sel * 128 * 4,
                    PEAK_F32),
           cuda_ms(lambda: torch.bmm(gathered, qd[:, :, None]), iters=3))
    del gathered
    record("topk",
           in_turns(cuda_ms, lambda: topk.fused_topk(buf, qd, count, K_MAIN),
                    lambda: topk.topk_plain(buf, qd, count, K_MAIN)),
           scan_bound(count, d_pad, 4, 256, 256 * K_MAIN * 8, PEAK_F32),
           cuda_ms(lambda: torch.matmul(qd, buf[: live_rows(count)].T), iters=3))

    def batch_lookup(s, queries=big):
        return lambda: s.fuzzy_lookup_embeddings_batch(queries, max_hits=K_MAIN)

    def plain_lookup(s, queries=big):
        def run():
            with plain_kernels():
                s.fuzzy_lookup_embeddings_batch(queries, max_hits=K_MAIN)
        return run

    path_ms, path_plain_ms = in_turns(host_ms, batch_lookup(store), plain_lookup(store))

    # b = 8 through the same store (the smallest padded batch of the serving
    # front): the hybrid route's K2 at the small-batch tile geometry.
    q8_host = big[:8]
    topk.reset_launch_counts()
    rows8 = store.fuzzy_lookup_embeddings_batch(q8_host, max_hits=K_MAIN)
    counts8 = topk.launch_counts()
    require(counts8["bucket_maxima"] > 0 and counts8["rescore"] > 0, f"batch-8: route {counts8}")
    path_launches["bucket_maxima_b8"] = counts8["bucket_maxima"]
    recall_8, _ = check_results(rows8, q8_host, buf, count, K_MAIN, TOL_F32, "batch-8")
    q8 = qd[:8]
    err = (topk.bucket_maxima(shadow, q8, count) - topk.bucket_maxima_plain(shadow, q8, count)).abs().max().item()
    require(err <= TOL_BF16, f"K2 b=8: error {err} > {TOL_BF16}")
    kernel_err["bucket_maxima_b8"] = err
    record("bucket_maxima_b8",
           in_turns(cuda_ms, lambda: topk.bucket_maxima(shadow, q8, count),
                    lambda: topk.bucket_maxima_plain(shadow, q8, count)),
           scan_bound(count, d_pad, 2, 8, 8 * nb * 4, PEAK_BF16),
           cuda_ms(lambda: torch.matmul(qd_bf16[:8], shadow[: live_rows(count)].T), iters=3))
    path8_ms, path8_plain_ms = in_turns(host_ms, batch_lookup(store, q8_host), plain_lookup(store, q8_host))
    emit({
        "phase": 2, "rows": count, "d": D_MAIN, "dtype": "float32", "route": "exact2h",
        "ingest_s": round(ingest_s, 3), "launches": launches,
        "cert_hit_rate": 1 - cert_miss / cert_q if cert_q else None,
        "cert_queries": cert_q, "cert_misses": cert_miss,
        "served_requests": len(requests), "served_queries": int(req_sizes.sum()),
        "serve_s": round(serve_s, 4), "batcher": batcher_stats,
        "recall_served": recall_s, "recall_batch256": recall_b,
        "max_score_err": max(err_s, err_b), "materialized_calls": launches["materialized_topk"],
        "ms_per_batch256": path_ms, "plain_ms_per_batch256": path_plain_ms,
        "recall_batch8": recall_8, "launches_batch8": counts8,
        "ms_per_batch8": path8_ms, "plain_ms_per_batch8": path8_plain_ms,
        "k3_distinct_buckets": distinct,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3), "ok": True,
    })

    # ------------------------------------------------- 3. the one-phase route
    out = {"phase": 3}
    rows_dev = buf[:N_MAIN, :D_MAIN]
    # K1's shape entries: (store rows, batch) -> entry; K1 at 1M x b=256 is
    # phase 2's entry.
    k1_entries = {(100_000, 256): "topk_100k", (100_000, 8): "topk_100k_b8", (N_MAIN, 8): "topk_b8"}
    for label, n, mode in (("100k_exact", 100_000, "exact"), ("1m_exact1", N_MAIN, "exact1")):
        s = VectorStore(store_settings(mode=mode))
        s.load_device_rows(rows_dev[:n])
        out[label] = {"rows": s._count}
        for b in (256, 8):
            queries = big[:b]
            topk.reset_launch_counts()
            res = s.fuzzy_lookup_embeddings_batch(queries, max_hits=K_MAIN)
            counts = topk.launch_counts()
            require(counts["topk"] > 0 and counts["bucket_maxima"] == 0, f"{label} b={b}: route {counts}")
            recall, err = check_results(res, queries, s._buf, s._count, K_MAIN, TOL_F32, f"{label} b={b}")
            ms, plain = in_turns(host_ms, batch_lookup(s, queries), plain_lookup(s, queries))
            out[label][f"b{b}"] = {"launches": counts, "recall": recall, "max_score_err": err,
                                   "ms_per_batch": ms, "plain_ms_per_batch": plain}
            entry = k1_entries.get((n, b))
            if entry is None:
                continue
            path_launches[entry] = counts["topk"]
            q = torch.zeros((b, s._buf.shape[1]), device=dev)
            q[:, :D_MAIN] = to_dev(queries)
            got_v, got_i = topk.fused_topk(s._buf, q, s._count, K_MAIN)
            ref_v, _ = topk.topk_plain(s._buf, q, s._count, K_MAIN)
            kernel_err[entry] = check_raw_topk(s._buf, q, s._count, K_MAIN, got_v, got_i, ref_v, TOL_F32,
                                               f"K1 {label} b={b}")
            record(entry,
                   in_turns(cuda_ms, lambda: topk.fused_topk(s._buf, q, s._count, K_MAIN),
                            lambda: topk.topk_plain(s._buf, q, s._count, K_MAIN)),
                   scan_bound(s._count, s._buf.shape[1], 4, b, b * K_MAIN * 8, PEAK_F32),
                   cuda_ms(lambda: torch.matmul(q, s._buf[: live_rows(s._count)].T), iters=3))
        del s
    out["ok"] = True
    emit(out)

    # ------------------------------------------------------ 4. bf16 store, 1M
    s = VectorStore(store_settings(dtype="bfloat16"))
    s.load_device_rows(buf[:N_MAIN, :D_MAIN])
    topk.reset_launch_counts()
    res = s.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)
    counts = topk.launch_counts()
    require(counts["bucket_maxima"] > 0 and counts["rescore"] > 0, f"bf16: route {counts}")
    qb = torch.zeros((256, s._buf.shape[1]), device=dev)
    qb[:, :D_MAIN] = to_dev(big)
    check_at_main_shapes(s._buf, s._buf, qb, s._count, topk._EXACT2_SLACK, "1M bf16 store")
    with plain_kernels():
        ref = s.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)
    worst, same = 0.0, 0
    for a, r in zip(res, ref):
        worst = max(worst, float(np.abs(np.array([x.score for x in a]) - [x.score for x in r]).max()))
        same += len({x.item for x in a} & {x.item for x in r})
        kth = r[-1].score
        require(all(x.item in {y.item for y in r} or x.score >= kth - TOL_BF16 for x in a),
                "bf16: pick outside the plain top-k")
    require(worst <= TOL_BF16, f"bf16: score error {worst}")
    recall_f32 = sum(
        len({x.item for x in a} & {x.item for x in r}) for a, r in zip(res, big_rows)
    ) / (K_MAIN * len(res))
    ms, plain = in_turns(host_ms, batch_lookup(s), plain_lookup(s))
    emit({"phase": 4, "rows": s._count, "dtype": "bfloat16", "route": "exact2",
          "launches": counts, "agree_with_plain": same / (K_MAIN * len(res)),
          "max_score_err_vs_plain": worst, "recall_vs_f32": recall_f32,
          "ms_per_batch256": ms, "plain_ms_per_batch256": plain, "ok": True})
    del s

    # ------------------------------------------------------ 5. int8 store, 1M
    s = VectorStore(store_settings(dtype="int8"))
    s.load_device_rows(buf[:N_MAIN, :D_MAIN])
    requests8 = [big] + [normed(rng, 256, D_MAIN) for _ in range(3)]

    async def serve8():
        batcher = LookupBatcher(s, max_delay_ms=2.0)
        out = await asyncio.gather(*(batcher.lookup(r, max_hits=K_MAIN) for r in requests8))
        stats = batcher.stats()
        await batcher.close()
        return out, stats

    topk.reset_launch_counts()
    served8, stats8 = asyncio.run(serve8())
    counts = topk.launch_counts()
    add_path_launches(counts)
    require(counts["topk_q"] > 0, f"int8 store: route {counts}")
    require(counts["materialized_topk"] == 0, "int8 store took the k > 32 materialized route")
    res = served8[0]
    with plain_kernels():
        ref = s.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)
    worst, same = 0.0, 0
    for a, r in zip(res, ref):
        require(len(a) == len(r) == K_MAIN, "int8: short answer")
        worst = max(worst, float(np.abs(np.array([x.score for x in a]) - [x.score for x in r]).max()))
        same += len({x.item for x in a} & {x.item for x in r})
        kth = r[-1].score
        require(all(x.item in {y.item for y in r} or abs(x.score - kth) <= TOL_INT8 for x in a),
                "int8: pick outside the plain top-k")
    require(worst <= TOL_INT8, f"int8: score error {worst}")
    recall_f32 = sum(
        len({x.item for x in a} & {x.item for x in r}) for a, r in zip(res, big_rows)
    ) / (K_MAIN * len(res))
    got = topk.fused_topk_q(s._buf, s._scales, qd, s._count, K_MAIN)
    ref_raw = topk.topk_q_plain(s._buf, s._scales, qd, s._count, K_MAIN)
    kernel_err["topk_q"] = max(kernel_err["topk_q"], check_scan(
        got, ref_raw, s._buf, s._scales, qd, s._count, lambda idx: idx >= 0, TOL_INT8, "K6 1M int8"))
    ms, plain = in_turns(host_ms, batch_lookup(s), plain_lookup(s))
    # K6's shape entries at this store: b = 256 (the served batches) and 8
    # (the smallest padded batch), each counted from a lookup at its batch.
    codes_bf16 = s._buf[: live_rows(s._count)].to(torch.bfloat16)
    for b, entry in ((256, "topk_q_1m_b256"), (8, "topk_q_1m_b8")):
        topk.reset_launch_counts()
        s.fuzzy_lookup_embeddings_batch(big[:b], max_hits=K_MAIN)
        path_launches[entry] = topk.launch_counts()["topk_q"]
        qe = qd[:b]
        kernel_err[entry] = check_scan(
            topk.fused_topk_q(s._buf, s._scales, qe, s._count, K_MAIN),
            topk.topk_q_plain(s._buf, s._scales, qe, s._count, K_MAIN),
            s._buf, s._scales, qe, s._count, lambda idx: idx >= 0, TOL_INT8, f"K6 1M int8 b={b}")
        record(entry,
               in_turns(cuda_ms, lambda: topk.fused_topk_q(s._buf, s._scales, qe, s._count, K_MAIN),
                        lambda: topk.topk_q_plain(s._buf, s._scales, qe, s._count, K_MAIN)),
               scan_bound(s._count, s._buf.shape[1], 1, b, b * K_MAIN * 8, PEAK_BF16, s._count * 4),
               cuda_ms(lambda: torch.matmul(qe.to(torch.bfloat16), codes_bf16.T), iters=3))
    del codes_bf16
    emit({"phase": 5, "rows": s._count, "dtype": "int8", "route": "quantized (K6)",
          "launches": counts, "batcher": stats8, "served_queries": 256 * len(requests8),
          "agree_with_plain": same / (K_MAIN * len(res)), "max_score_err_vs_plain": worst,
          "recall_vs_f32": recall_f32, "ms_per_batch256": ms, "plain_ms_per_batch256": plain,
          "k6_ms": {e: kernel_ms[e][0] for e in ("topk_q_1m_b256", "topk_q_1m_b8")},
          "ok": True})
    del s, store, buf, shadow, ids, rows_dev

    # ------------------------------------------- 6-7. the multi-conversation corpus
    def corpus_phase(phase, dtype, seg_rows, tol, probe_floor, with_subset):
        """Build the fragmented corpus on the card, drive its searches once
        (the counted main path), then hold each against its kernel and the
        kernel against its plain version. Returns the phase's line."""
        torch.cuda.reset_peak_memory_stats()
        corpus = CorpusVectorStore(D_MAIN, device="cuda", dtype=dtype)
        t0 = time.perf_counter()
        corpus.reserve(seg_rows * len(CORPUS_LAYOUT))
        for name in CORPUS_LAYOUT:
            for done in range(0, seg_rows, CORPUS_CHUNK):
                step = min(CORPUS_CHUNK, seg_rows - done)
                corpus.append_device(name, torch.randn((step, D_MAIN), generator=gen, device=dev))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        store = corpus._store
        emb, sc, count = store.buf, store._scales, store.count
        require(count == seg_rows * len(CORPUS_LAYOUT), f"corpus holds {count} rows")
        # Probes: row 123 of segments 12-14 (podcast, mailbox, wiki).
        probes = [(seg * seg_rows + 123, CORPUS_LAYOUT[seg], (seg // 3) * seg_rows + 123)
                  for seg in (12, 13, 14)]
        q_raw = normed(rng, CORPUS_B, D_MAIN)
        for j, (g, _, _) in enumerate(probes):
            q_raw[j] = store.get_row(g)
        # The query block the store builds from q_raw (corpus.search
        # normalizes as below, the store pads to the dim and to b % 8).
        norms = np.linalg.norm(q_raw, axis=1, keepdims=True)
        qn = q_raw / np.where(norms > 0, norms, 1.0)
        q_dev = torch.zeros((CORPUS_B, emb.shape[1]), device=dev)
        q_dev[:, :D_MAIN] = to_dev(qn)
        subset = rng.choice(count, 100_000, replace=False)
        subset[: len(probes)] = [p[0] for p in probes]
        scopes = {"global": None, "podcast": ["podcast"], "podcast+wiki": ["podcast", "wiki"]}

        def run_search(scope):
            if scope == "subset":
                return store.search_subset(qn, subset, k=K_MAIN)
            return corpus.search(q_raw, k=K_MAIN, conversations=scopes[scope])

        names = list(scopes) + (["subset"] if with_subset else [])
        # The product of the same operands in the scans' product type (the
        # whole store against the b queries), once for the phase.
        if sc is None:
            product_ms = cuda_ms(lambda: torch.matmul(q_dev, emb[: live_rows(count)].T), iters=3)
        else:
            emb_bf16, q_bf16 = emb[: live_rows(count)].to(torch.bfloat16), q_dev.to(torch.bfloat16)
            product_ms = cuda_ms(lambda: torch.matmul(q_bf16, emb_bf16.T), iters=3)
            del emb_bf16
        topk.reset_launch_counts()
        results = {scope: run_search(scope) for scope in names}
        counts = topk.launch_counts()
        add_path_launches(counts)
        require(counts["materialized_topk"] == 0, f"corpus {dtype}: k > 32 materialized route")
        n_rows = emb.shape[0]
        out = {"phase": phase, "rows": count, "dtype": dtype, "segments": len(CORPUS_LAYOUT),
               "b": CORPUS_B, "k": K_MAIN, "build_s": round(build_s, 3), "launches": counts}
        for scope in names:
            if scope == "subset":
                mask = torch.zeros((n_rows,), dtype=torch.int32, device=dev)
                mask[to_dev(subset)] = 1
                n_iv = None
            elif scopes[scope] is None:
                mask, n_iv = None, 0
            else:
                intervals = corpus._segment_intervals(set(scopes[scope]))
                n_iv = len(intervals)
                table = np.zeros((8 if n_iv <= 8 else 32, 2), np.int32)
                table[:n_iv] = intervals
                table_dev = to_dev(table)
                mask = topk.intervals_to_rowmask(n_rows, table_dev)[0].contiguous()
            if sc is not None:
                name = "topk_q" if mask is None else "topk_mq"
                kern = (lambda: topk.fused_topk_q(emb, sc, q_dev, count, K_MAIN)) if mask is None else \
                    (lambda: topk.fused_topk_mq(emb, sc, q_dev, count, mask, K_MAIN))
                plain = (lambda: topk.topk_q_plain(emb, sc, q_dev, count, K_MAIN)) if mask is None else \
                    (lambda: topk.topk_mq_plain(emb, sc, q_dev, count, mask, K_MAIN))
            elif mask is None:
                name = "topk"
                kern = lambda: topk.fused_topk(emb, q_dev, count, K_MAIN)  # noqa: E731
                plain = lambda: topk.topk_plain(emb, q_dev, count, K_MAIN)  # noqa: E731
            elif n_iv is not None and n_iv <= topk._PALLAS_MAX_INTERVALS:
                name = "topk_iv"
                kern = lambda: topk.fused_topk_iv(emb, q_dev, count, table_dev, K_MAIN)  # noqa: E731
                plain = lambda: topk.topk_iv_plain(emb, q_dev, count, table_dev, K_MAIN)  # noqa: E731
            else:
                name = "topk_mask"
                kern = lambda: topk.fused_topk_masked(emb, q_dev, count, mask, K_MAIN)  # noqa: E731
                plain = lambda: topk.topk_masked_plain(emb, q_dev, count, mask, K_MAIN)  # noqa: E731
            require(counts[name] > 0, f"corpus {dtype} {scope}: the {name} kernel never ran")
            what = f"corpus {dtype} {scope} ({name})"
            got = kern()
            in_scope = (lambda idx: idx >= 0) if mask is None else (lambda idx: mask[idx.long()] > 0)
            err = check_scan(got, plain(), emb, sc, q_dev, count, in_scope, tol, what)
            kernel_err[name] = max(kernel_err[name], err)
            # The API answered with exactly this kernel output.
            vals, idx = (t.cpu().numpy() for t in topk._raw_to_score(*got))
            for r, hits in enumerate(results[scope]):
                if scope == "subset":
                    got_ids, got_scores = [i for i, _ in hits], [v for _, v in hits]
                else:
                    got_ids = [h.global_ordinal for h in hits]
                    got_scores = [h.score for h in hits]
                    want = set(scopes[scope] or CORPUS_NAMES)
                    require(all(h.conversation in want for h in hits), f"{what}: hit outside the scope")
                keep = idx[r] >= 0
                require(got_ids == idx[r][keep].tolist(), f"{what}: API hits differ from the kernel's")
                require(np.allclose(got_scores, vals[r][keep], atol=1e-6, rtol=0), f"{what}: API scores")
            for j, (g, conv, local) in enumerate(probes):
                if scope == "subset" or conv in (scopes[scope] or CORPUS_NAMES):
                    top = results[scope][j][0]
                    top_id, top_score = (top if scope == "subset" else (top.global_ordinal, top.score))
                    require(top_id == g and top_score >= probe_floor,
                            f"{what}: probe {conv}:{local} found {top_id} ({top_score})")
                    if scope != "subset":
                        require((top.conversation, top.local_ordinal) == (conv, local),
                                f"{what}: probe resolved to {top.conversation}:{top.local_ordinal}")
            ms, plain_ms = in_turns(lambda fn: cuda_ms(fn, iters=3), kern, plain)

            def plain_run():
                with plain_kernels():
                    run_search(scope)

            api_ms, api_plain_ms = in_turns(
                lambda fn: host_ms(fn, iters=3), lambda: run_search(scope), plain_run)
            # The bound counts the rows the scope needs (live and in
            # scope), their scales, and the whole row mask if the search
            # reads one (K7's wrapper reads it once to list the tiles).
            scope_rows = count if mask is None else int((mask[:count] > 0).sum())
            extra = scope_rows * 4 if sc is not None else 0
            if name in ("topk_mask", "topk_mq"):
                extra += n_rows * 4
            bound = scan_bound(scope_rows, emb.shape[1], emb.element_size(), CORPUS_B,
                               CORPUS_B * K_MAIN * 8, PEAK_F32 if sc is None else PEAK_BF16, extra)
            # K1's entry stays phase 2's (1M x 384, b=256); the others take
            # their first corpus search.
            if name not in kernel_ms:
                record(name, (ms, plain_ms), bound, product_ms)
            if name in ("topk_iv", "topk_mask", "topk_mq"):
                # The tiles the listed scan read (its scope's list) against
                # the live ones, and the listing kernel that made the list.
                lister = "interval_tiles" if name == "topk_iv" else "scope_tiles"
                n_tiles, list_ms = check_tile_list(lister, table_dev if lister == "interval_tiles" else mask,
                                                   count, n_rows, f"{what} list")
                out[scope + "_tiles"] = {"read": n_tiles, "live": -(-count // 128), "list_ms": list_ms}
            out[scope] = {"kernel": name, "intervals": n_iv, "max_abs_err": err,
                          "kernel_ms": ms, "plain_kernel_ms": plain_ms, "scope_rows": scope_rows,
                          "bound_ms": bound[0], "bound_by": bound[1],
                          "ms_per_batch": api_ms, "plain_ms_per_batch": api_plain_ms}
        out["product_ms"] = product_ms
        out["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
        out["ok"] = True
        return out

    gc.collect()
    torch.cuda.empty_cache()
    emit(corpus_phase(6, "float32", CORPUS_F32_SEG_ROWS, TOL_F32, 1 - 1e-6, True))
    gc.collect()  # the f32 corpus is gone before the int8 one is built
    torch.cuda.empty_cache()
    emit(corpus_phase(7, "int8", CORPUS_INT8_SEG_ROWS, TOL_INT8, 0.999, False))
    gc.collect()
    torch.cuda.empty_cache()

    def padded_queries(q_host: np.ndarray, d_pad: int) -> torch.Tensor:
        q = torch.zeros((q_host.shape[0], d_pad), device=dev)
        q[:, : q_host.shape[1]] = to_dev(q_host)
        return q

    def recall_vs(rows, ref_idx: np.ndarray) -> float:
        """Recall@k of served ScoredInt rows against reference indices."""
        hit = sum(len({x.item for x in row} & set(ref.tolist())) for row, ref in zip(rows, ref_idx))
        return hit / ref_idx.size

    def serve_batches(s, batches):
        """The batches concurrently through one LookupBatcher."""
        async def run():
            batcher = LookupBatcher(s, max_delay_ms=2.0)
            out = await asyncio.gather(*(batcher.lookup(r, max_hits=K_MAIN) for r in batches))
            stats = batcher.stats()
            await batcher.close()
            return out, stats
        return asyncio.run(run())

    # -------------------------------------------------- 8. approx, 1M rows
    torch.cuda.reset_peak_memory_stats()
    rows = torch.nn.functional.normalize(torch.randn((N_MAIN, D_MAIN), generator=gen, device=dev), dim=1)
    approx_q = [normed(rng, 256, D_MAIN) for _ in range(4)]
    stores = {}
    for dtype in ("float32", "bfloat16"):
        stores[dtype] = VectorStore(store_settings(dtype=dtype, mode="approx"))
        stores[dtype].load_device_rows(rows)
    small = VectorStore(store_settings(mode="approx"))
    small.load_device_rows(rows[:100_000])
    del rows
    METRICS.counters.clear()
    topk.reset_launch_counts()
    served_a, sync_a, stats_a = {}, {}, {}
    for dtype, s_approx in stores.items():
        served_a[dtype], stats_a[dtype] = serve_batches(s_approx, approx_q)
        sync_a[dtype] = s_approx.fuzzy_lookup_embeddings_batch(approx_q[0], max_hits=K_MAIN)
    counts_1m = topk.launch_counts()
    add_path_launches(counts_1m)
    require(counts_1m["bucket_argmax"] > 0 and counts_1m["topk"] == 0 and counts_1m["bucket_maxima"] == 0,
            f"approx 1M: route {counts_1m}")
    topk.reset_launch_counts()
    small_rows = small.fuzzy_lookup_embeddings_batch(approx_q[0], max_hits=K_MAIN)
    counts_small = topk.launch_counts()
    add_path_launches(counts_small)
    require(counts_small["topk"] > 0 and counts_small["bucket_argmax"] == 0,
            f"approx 100k: route {counts_small}")
    routes = {k: METRICS.counters.get(f"topk.approx_route.{k}", 0) for k in ("bucket", "exact")}
    out8 = {"phase": 8, "rows": N_MAIN, "d": D_MAIN, "b": 256, "k": K_MAIN,
            "launches_1m": counts_1m, "launches_100k": counts_small, "route_choices": routes,
            "batcher": stats_a}
    def lookup_as(s, mode):
        """A batch-256 lookup of the store searched in ``mode``."""
        def run():
            s.settings.search_mode = mode
            s.fuzzy_lookup_embeddings_batch(approx_q[0], max_hits=K_MAIN)
        return run

    qd8 = padded_queries(approx_q[0], stores["float32"]._buf.shape[1])
    for dtype, s_approx in stores.items():
        tol = TOL_F32 if dtype == "float32" else TOL_BF16
        buf, count = s_approx._buf, s_approx._count
        err = check_argmax(buf, qd8, count, tol, f"K2' 1M {dtype}")
        kernel_err["bucket_argmax"] = max(kernel_err["bucket_argmax"], err)
        # Recall against the plain exact top-k of the same rows.
        ref_idx = []
        for q_host in approx_q:
            _, ri = topk.topk_plain(buf, padded_queries(q_host, buf.shape[1]), count, K_MAIN)
            ref_idx.append(ri.cpu().numpy())
        served_rows = [row for batch in served_a[dtype] for row in batch]
        require([[x.item for x in r] for r in served_a[dtype][0]] == [[x.item for x in r] for r in sync_a[dtype]],
                f"approx {dtype}: served and sync answers differ")
        with plain_kernels():
            plain_rows = s_approx.fuzzy_lookup_embeddings_batch(approx_q[0], max_hits=K_MAIN)
        for a, r in zip(sync_a[dtype], plain_rows):
            require(np.allclose([x.score for x in a], [x.score for x in r], atol=tol, rtol=0),
                    f"approx {dtype}: scores differ from the plain route")
        ms_k, ms_p = in_turns(cuda_ms, lambda: topk.bucket_argmax(buf, qd8, count),
                              lambda: topk.bucket_argmax_plain(buf, qd8, count))
        q_op = qd8 if dtype == "float32" else qd8.to(torch.bfloat16)
        product_ms = cuda_ms(lambda: torch.matmul(q_op, buf[: live_rows(count)].T), iters=3)
        nb = buf.shape[0] // 128
        bound = scan_bound(count, buf.shape[1], buf.element_size(), 256, 256 * nb * 8,
                           PEAK_F32 if dtype == "float32" else PEAK_BF16)
        if dtype == "float32":
            record("bucket_argmax", (ms_k, ms_p), bound, product_ms)
        # The exact route on the same store (hybrid exact2 for f32, exact2
        # for bf16) beside the approx route.
        ms_approx, ms_exact = in_turns(host_ms, lookup_as(s_approx, "approx"), lookup_as(s_approx, "exact"))
        s_approx.settings.search_mode = "approx"
        _, ms_plain = in_turns(host_ms, batch_lookup(s_approx), plain_lookup(s_approx))
        out8[dtype] = {
            "recall_served": recall_vs(served_rows, np.concatenate(ref_idx)),
            "recall_sync": recall_vs(sync_a[dtype], ref_idx[0]),
            "k2p_max_abs_err": err, "k2p_ms": ms_k, "k2p_plain_ms": ms_p,
            "k2p_bound_ms": bound[0], "k2p_bound_by": bound[1], "k2p_product_ms": product_ms,
            "ms_per_batch256": ms_approx, "exact_route_ms_per_batch256": ms_exact,
            "plain_ms_per_batch256": ms_plain,
        }
        require(out8[dtype]["recall_served"] >= 0.99, f"approx {dtype}: recall {out8[dtype]['recall_served']}")
    _, small_ref = topk.topk_plain(small._buf, qd8, small._count, K_MAIN)
    out8["recall_100k"] = recall_vs(small_rows, small_ref.cpu().numpy())
    require(out8["recall_100k"] == 1.0, f"approx 100k (exact K1): recall {out8['recall_100k']}")
    out8["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    out8["ok"] = True
    emit(out8)
    del stores, small, s_approx, buf, qd8
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------- 9. IVF on the clustered corpus
    def clustered(n: int, topics: int, n_queries: int):
        """bench.py section B's corpus on the card: unit rows around
        ``topics`` unit centres (sigma 0.35 / sqrt(d) per coordinate), 2%
        isotropic background, bf16; topic queries made the same way and
        rounded to bf16, so the exact1 oracle (which scores bf16 queries
        on a bf16 store) and the rescore (f32 queries) score one query."""
        centers = torch.nn.functional.normalize(torch.randn((topics, D_MAIN), generator=gen, device=dev), dim=1)
        out = torch.empty((n, D_MAIN), dtype=torch.bfloat16, device=dev)
        for s0 in range(0, n, IVF_CHUNK):
            m = min(IVF_CHUNK, n - s0)
            lab = torch.randint(0, topics, (m,), generator=gen, device=dev)
            e = centers[lab] + SIGMA_C * torch.randn((m, D_MAIN), generator=gen, device=dev) / D_MAIN ** 0.5
            bg = torch.rand((m,), generator=gen, device=dev) < BG_C
            e = torch.where(bg[:, None], torch.randn((m, D_MAIN), generator=gen, device=dev), e)
            out[s0 : s0 + m] = torch.nn.functional.normalize(e, dim=1).to(torch.bfloat16)
        lab = torch.randint(0, topics, (n_queries,), generator=gen, device=dev)
        q = centers[lab] + SIGMA_C * torch.randn((n_queries, D_MAIN), generator=gen, device=dev) / D_MAIN ** 0.5
        q = torch.nn.functional.normalize(q, dim=1).to(torch.bfloat16).float()
        return out, q.cpu().numpy()

    def oracle(buf, count, q_host):
        """exact1 (K1 over the store) for every 256-query batch."""
        ids = []
        for s0 in range(0, q_host.shape[0], 256):
            _, i = topk.cosine_topk(buf, padded_queries(q_host[s0 : s0 + 256], buf.shape[1]), count, K_MAIN)
            ids.append(i.cpu().numpy())
        return np.concatenate(ids)

    def certified_equal(rows, q_host, ref_idx, buf, what):
        """Every served answer is the exact1 top-k up to ties within
        TOL_BF16 (raw cosines of the picked rows, recomputed on the card)."""
        require(all(len(r) == K_MAIN for r in rows), f"{what}: short answers")
        got = np.array([[x.item for x in r] for r in rows], dtype=np.int64)
        q = padded_queries(q_host, buf.shape[1])
        raw_got = picked_raw(buf, None, q, to_dev(got))
        raw_kth = picked_raw(buf, None, q, to_dev(ref_idx[:, -1:].astype(np.int64)))
        extra = ~(got[:, :, None] == ref_idx[:, None, :]).any(axis=2)
        ok = (raw_got >= raw_kth - TOL_BF16).cpu().numpy() | ~extra
        require(bool(ok.all()), f"{what}: queries {np.nonzero(~ok.all(axis=1))[0][:8].tolist()} not exact")
        return int(extra.any(axis=1).sum())

    def ivf_scale(n: int, topics: int, full: bool):
        """One clustered scale; ``full`` adds every B, the append, rebuild
        and serving steps (the 1M scale)."""
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rows, q_host = clustered(n, topics, IVF_QUERIES)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        s = VectorStore(store_settings(dtype="bfloat16", mode="ivf"))
        s.settings.ivf_outlier_frac = 0.03
        s.reserve(n + (n // 10 if full else 0))
        s.load_device_rows(rows)
        del rows
        for name in list(METRICS.latencies):
            if name.startswith("ivf.build."):
                del METRICS.latencies[name]
        t0 = time.perf_counter()
        s.build_ivf(rows_per_cluster=512)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        state = s._ivf
        out = {"rows": n, "topics": topics, "gen_s": round(gen_s, 3), "build_s": round(build_s, 3),
               "build_phases_s": {k.split(".")[-1]: round(METRICS.stats(k).total_s, 3)
                                  for k in list(METRICS.latencies) if k.startswith("ivf.build.")},
               "buckets": state.n_buckets, "inliers": state.count_in, "outliers": state.count_out}
        buf, count = s._buf, s._count
        # Serving warm-up: a lookup per batch bucket, then the certificate-
        # miss routes (the 4x-B escalation pass, the exact rerun) once.
        t0 = time.perf_counter()
        s.warm_serving(max_batch=256)
        torch.cuda.synchronize()
        out["warm_serving_s"] = round(time.perf_counter() - t0, 3)
        ref_idx = oracle(buf, count, q_host)
        qd = padded_queries(q_host[:256], buf.shape[1])
        out["exact1_ms_per_batch256"] = cuda_ms(lambda: topk.cosine_topk(buf, qd, count, K_MAIN), iters=3)
        # The approx route on the clustered layout (phase 8 measured it on
        # isotropic rows).
        approx_idx = np.concatenate([
            topk.cosine_topk_bucket(buf, padded_queries(q_host[s0 : s0 + 256], buf.shape[1]), count, K_MAIN)[1]
            .cpu().numpy() for s0 in range(0, IVF_QUERIES, 256)])
        out["approx_recall"] = float(np.mean([len(set(a) & set(b)) / K_MAIN
                                              for a, b in zip(approx_idx.tolist(), ref_idx.tolist())]))
        for B in (IVF_BS if full else IVF_BS[-1:]):
            s.settings.ivf_b = B
            ids, certs = [], []
            for s0 in range(0, IVF_QUERIES, 256):
                _, i, c = ivf.ivf_topk_program(*state, padded_queries(q_host[s0 : s0 + 256], buf.shape[1]),
                                               K_MAIN, B=B)
                ids.append(i.cpu().numpy())
                certs.append(c.cpu().numpy())
            ids = np.concatenate(ids)
            out[f"B{B}"] = {
                "recall": float(np.mean([len(set(a) & set(b)) / K_MAIN for a, b in zip(ids.tolist(), ref_idx.tolist())])),
                "cert_rate": float(np.concatenate(certs).mean()),
                "ms_per_batch256": host_ms(lambda: s.fuzzy_lookup_embeddings_batch(q_host[:256], max_hits=K_MAIN), iters=5),
                "device_ms_per_batch256": cuda_ms(lambda: ivf.ivf_topk_program(*state, qd, K_MAIN, B=B), iters=5),
            }
        # Certified: every answer equals the oracle (misses rerun exactly,
        # past 2M rows after one escalated pass).
        s.settings.ivf_certified = True
        s.settings.ivf_b = 12 if full else 16
        METRICS.counters.clear()
        t0 = time.perf_counter()
        cert_rows = []
        for s0 in range(0, IVF_QUERIES, 256):
            cert_rows += s.fuzzy_lookup_embeddings_batch(q_host[s0 : s0 + 256], max_hits=K_MAIN)
        cert_s = time.perf_counter() - t0
        ties = certified_equal(cert_rows, q_host, ref_idx, buf, f"ivf certified {n}")
        out["certified"] = {
            "answers_differing_from_oracle_by_ties": ties,
            "B": s.settings.ivf_b, "ms_per_batch256": cert_s * 1000 / (IVF_QUERIES // 256),
            "cert_queries": METRICS.counters.get("vectorstore.cert_queries", 0),
            "cert_misses": METRICS.counters.get("vectorstore.cert_misses", 0),
            "escalation_yield_ema": s._esc_ema, "recall": recall_vs(cert_rows, ref_idx),
        }
        s.settings.ivf_certified = False
        if full:
            out.update(ivf_lifecycle(s, n, topics, q_host))
        out["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
        return out

    def ivf_lifecycle(s, n, topics, q_host):
        """The counted main paths of phase 9: serving through LookupBatcher
        on the snapshot and 10% appended (the suffix rides K4, which reads
        only the suffix's tiles, and its rows are found); then, counted
        anew, a background rebuild that swaps in while serving. Between the
        two, uncounted, the suffix lookup and its K4 scan are timed."""
        s.settings.ivf_b = 16
        topk.reset_launch_counts()
        served, stats = serve_batches(s, [q_host[i : i + 256] for i in range(0, IVF_QUERIES, 256)])
        extra, _ = clustered(n // 10, topics, 0)
        s.load_device_rows(extra)
        probes = extra[:64].float().cpu().numpy()
        hits = s.fuzzy_lookup_embeddings_batch(probes, max_hits=K_MAIN)
        suffix_counts = topk.launch_counts()
        add_path_launches(suffix_counts)
        require(suffix_counts["topk_iv"] > 0, f"ivf append: the suffix never ran K4 ({suffix_counts})")
        require(all(h[0].item == n + j and h[0].score >= 0.99 for j, h in enumerate(hits)),
                f"ivf append: appended rows not found {[h[0].item for h in hits[:4]]}")
        # The appended suffix [snapshot count, count): its tiles, K4 on it
        # against its plain version, K4's time and the b=256 lookup's.
        count, buf = s._count, s._buf
        suffix_iv = torch.tensor([[s._ivf_count, count]], dtype=torch.int32, device=dev)
        qd = padded_queries(q_host[:256], buf.shape[1])
        err = check_scan(topk.fused_topk_iv(buf, qd, count, suffix_iv, K_MAIN),
                         topk.topk_iv_plain(buf, qd, count, suffix_iv, K_MAIN), buf, None, qd, count,
                         lambda idx: idx >= s._ivf_count, TOL_BF16, "K4 ivf suffix")
        kernel_err["topk_iv"] = max(kernel_err["topk_iv"], err)
        k4_ms, k4_plain_ms = in_turns(lambda fn: cuda_ms(fn, iters=5),
                                      lambda: topk.fused_topk_iv(buf, qd, count, suffix_iv, K_MAIN),
                                      lambda: topk.topk_iv_plain(buf, qd, count, suffix_iv, K_MAIN))
        bound = scan_bound(count - s._ivf_count, buf.shape[1], buf.element_size(), 256, 256 * K_MAIN * 8,
                           PEAK_F32 if buf.dtype == torch.float32 else PEAK_BF16)
        suffix = {"rows": count - s._ivf_count,
                  "tiles": {"read": int(topk.interval_tiles(suffix_iv, count, buf.shape[0])[1].item()),
                            "live": -(-count // 128)},
                  "k4_ms": k4_ms, "k4_plain_ms": k4_plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
                  "ms_per_batch256": host_ms(
                      lambda: s.fuzzy_lookup_embeddings_batch(q_host[:256], max_hits=K_MAIN), iters=5)}
        topk.reset_launch_counts()
        t0 = time.perf_counter()
        thread = s.build_ivf_background(rows_per_cluster=512)
        during = s.fuzzy_lookup_embeddings_batch(probes, max_hits=K_MAIN)
        thread.join(timeout=600)
        require(not thread.is_alive() and s._ivf_count == n + n // 10,
                f"ivf rebuild: snapshot covers {s._ivf_count} rows")
        rebuild_s = time.perf_counter() - t0
        iv_before = topk.launch_counts()["topk_iv"]
        after = s.fuzzy_lookup_embeddings_batch(probes, max_hits=K_MAIN)
        counts = topk.launch_counts()
        add_path_launches(counts)
        require(counts["topk_iv"] == iv_before, "ivf rebuild: the swapped snapshot still scans a suffix")
        counts = {name: suffix_counts[name] + c for name, c in counts.items()}
        require(counts["rescore"] > 0 and counts["bucket_maxima"] > 0, f"ivf: route {counts}")
        for rows in (during, after):
            require(all(h[0].item == n + j for j, h in enumerate(rows)), "ivf rebuild: appended rows lost")
        return {"launches": counts, "batcher": stats, "served_queries": sum(len(b) for b in served),
                "appended": n // 10, "suffix": suffix, "rebuild_s": round(rebuild_s, 3)}

    out9 = {"phase": 9, "b": 256, "k": K_MAIN, "outlier_frac": 0.03, "rows_per_cluster": 512}
    for (n, topics), full in zip(IVF_SCALES, (True, False)):
        out9[f"{n / 1e6:g}M"] = ivf_scale(n, topics, full)
        gc.collect()
        torch.cuda.empty_cache()
    out9["ok"] = True
    emit(out9)

    # ------------------------- 10-11. int8 and int4 selection, 1M rows
    torch.cuda.reset_peak_memory_stats()
    n_pad = (N_MAIN + 1023) // 1024 * 1024  # the watermark lies inside a bucket
    rows = torch.zeros((n_pad, D_MAIN), device=dev)
    rows[:N_MAIN] = torch.nn.functional.normalize(
        torch.randn((N_MAIN, D_MAIN), generator=gen, device=dev), dim=1)
    sel_q = [to_dev(normed(rng, 256, D_MAIN)) for _ in range(SEL_QUERIES // 256)]
    # The oracle: the plain f32 top-k (what exact1 returns) of every batch.
    oracle = [topk.topk_plain(rows, q, N_MAIN, K_MAIN) for q in sel_q]

    def selection_quality(results, buf, what, require_exact):
        """Recall@10 of (vals, idx, cert) batches against the oracle, the
        certificate rate, and how many certified answers differ from the
        oracle beyond ties within TOL_F32 (required to be none where the
        certificate is a proof). Every answer's scores are its rows' own
        in the rescore buffer ``buf`` (f32 queries, as K3 scores them)."""
        hits = certified = inexact = tie_only = 0
        for (vals, idx, cert), q, (ref_raw, ref_idx) in zip(results, sel_q, oracle):
            require(bool(torch.isfinite(vals).all()) and tuple(idx.shape) == (256, K_MAIN),
                    f"{what}: bad output")
            own = torch.einsum("bkd,bd->bk", buf[idx.long()].float(), q)
            require(bool(((((own + 1) * 0.5).clamp(0, 1) - vals).abs() <= TOL_F32).all()),
                    f"{what}: a score is not its row's")
            raw = picked_raw(rows, None, q, idx)  # the f32 truth
            extra = ~(idx[:, :, None] == ref_idx[:, None, :]).any(dim=2)
            hits += int((~extra).sum())
            beyond_tie = (extra & (raw < ref_raw[:, -1:] - TOL_F32)).any(dim=1)
            certified += int(cert.sum())
            inexact += int((beyond_tie & cert).sum())
            tie_only += int((extra.any(dim=1) & ~beyond_tie & cert).sum())
        if require_exact:
            require(inexact == 0, f"{what}: {inexact} certified answers differ from the oracle")
        return {"recall": hits / (SEL_QUERIES * K_MAIN), "cert_rate": certified / SEL_QUERIES,
                "certified_inexact": inexact, "certified_differing_by_ties": tie_only}

    # 10. the int8-selection hybrid: K8 over the int8 shadow, K3 from f32.
    shadow_q, shadow_s = topk.quantize_rows_device(rows)
    shadow_bf16 = rows.to(torch.bfloat16)
    topk.reset_launch_counts()
    runs = {slack: [topk.cosine_topk_exact2_hybrid_i8(rows, shadow_q, shadow_s, q, N_MAIN, K_MAIN,
                                                      slack=slack) for q in sel_q]
            for slack in I8_SLACKS}
    counts = topk.launch_counts()
    add_path_launches(counts)
    n_calls = len(I8_SLACKS) * len(sel_q)
    require(counts["bucket_maxima_q"] == n_calls and counts["rescore"] == n_calls
            and counts["bucket_maxima"] == 0, f"int8 hybrid: route {counts}")
    out10 = {"phase": 10, "rows": N_MAIN, "d": D_MAIN, "b": 256, "k": K_MAIN,
             "queries": SEL_QUERIES, "launches": counts}
    for slack, res in runs.items():
        out10[f"slack{slack}"] = selection_quality(res, rows, f"int8 hybrid slack {slack}", True)
    q0 = sel_q[0]
    ms_i8, ms_bf16 = in_turns(
        host_ms, lambda: topk.cosine_topk_exact2_hybrid_i8(rows, shadow_q, shadow_s, q0, N_MAIN, K_MAIN),
        lambda: topk.cosine_topk_exact2_hybrid(rows, shadow_bf16, q0, N_MAIN, K_MAIN))
    got = topk.bucket_maxima_q(shadow_q, shadow_s, q0, N_MAIN)
    err = (got - topk.bucket_maxima_q_plain(shadow_q, shadow_s, q0, N_MAIN)).abs().max().item()
    require(err <= TOL_INT8, f"K8 1M: error {err} > {TOL_INT8}")
    kernel_err["bucket_maxima_q"] = max(kernel_err["bucket_maxima_q"], err)
    codes_bf16, q0_bf16 = shadow_q[: live_rows(N_MAIN)].to(torch.bfloat16), q0.to(torch.bfloat16)
    record("bucket_maxima_q",
           in_turns(cuda_ms, lambda: topk.bucket_maxima_q(shadow_q, shadow_s, q0, N_MAIN),
                    lambda: topk.bucket_maxima_q_plain(shadow_q, shadow_s, q0, N_MAIN)),
           scan_bound(N_MAIN, D_MAIN, 1, 256, 256 * (n_pad // 128) * 4, PEAK_BF16, N_MAIN * 4),
           cuda_ms(lambda: torch.matmul(q0_bf16, codes_bf16.T), iters=3))
    del codes_bf16
    out10.update({"ms_per_batch256": ms_i8, "hybrid_bf16_ms_per_batch256": ms_bf16,
                  "k8_max_abs_err": err, "k8_ms": kernel_ms["bucket_maxima_q"][0],
                  "k8_plain_ms": kernel_ms["bucket_maxima_q"][1],
                  "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3), "ok": True})
    emit(out10)
    del shadow_q, shadow_s, runs

    # 11. int4 selection: K9 over the packed shadow, K3 from bf16 or f32.
    packed, p_scales = int4.quantize_rows_int4_device(rows)
    buffers = {"bfloat16": shadow_bf16, "float32": rows}
    topk.reset_launch_counts()
    runs = {(dt, slack): [int4.cosine_topk_exact2_i4(buf, packed, p_scales, q, N_MAIN, K_MAIN, slack=slack)
                          for q in sel_q]
            for dt, buf in buffers.items() for slack in I4_SLACKS}
    counts = topk.launch_counts()
    add_path_launches(counts)
    n_calls = len(runs) * len(sel_q)
    require(counts["bucket_maxima_q4"] == n_calls and counts["rescore"] == n_calls,
            f"int4 selection: route {counts}")
    out11 = {"phase": 11, "rows": N_MAIN, "d": D_MAIN, "packed_width": packed.shape[1], "b": 256,
             "k": K_MAIN, "queries": SEL_QUERIES, "launches": counts,
             "certificate": "heuristic (covers the measured int4 error, not a bound)"}
    for (dt, slack), res in runs.items():
        buf = buffers[dt]
        quality = selection_quality(res, buf, f"int4 {dt} slack {slack}", False)
        quality["ms_per_batch256"] = host_ms(
            lambda: int4.cosine_topk_exact2_i4(buf, packed, p_scales, q0, N_MAIN, K_MAIN, slack=slack), iters=5)
        out11[f"{dt}_slack{slack}"] = quality
    # Selection quality is the algorithm's; a recall this far off means a
    # broken selection (the JAX records give ~0.96 at slack 14).
    require(out11["float32_slack14"]["recall"] >= 0.8, f"int4: recall {out11['float32_slack14']['recall']}")
    q_split = int4.split_pad_queries(q0, D_MAIN)
    got = int4.bucket_maxima_q4(packed, p_scales, q_split, N_MAIN, d=D_MAIN)
    err = (got - int4.bucket_maxima_q4_plain(packed, p_scales, q_split, N_MAIN, d=D_MAIN)).abs().max().item()
    require(err <= TOL_INT8, f"K9 1M: error {err} > {TOL_INT8}")
    kernel_err["bucket_maxima_q4"] = max(kernel_err["bucket_maxima_q4"], err)
    # The product alone over the live depth (2 * 192 = 384 deep at d =
    # 384, the kernel's own work), not the packing's 512-deep padding; the
    # bound counts the d = 384 columns the rows hold.
    dh, live = packed.shape[1], int4.live_depth(D_MAIN)
    lo, hi = int4._nibbles(packed[: live_rows(N_MAIN), :live])
    unpacked = torch.cat([lo, hi], dim=1).to(torch.bfloat16)
    del lo, hi
    q_live = torch.cat([q_split[:, :live], q_split[:, dh : dh + live]], dim=1)
    record("bucket_maxima_q4",
           in_turns(cuda_ms, lambda: int4.bucket_maxima_q4(packed, p_scales, q_split, N_MAIN, d=D_MAIN),
                    lambda: int4.bucket_maxima_q4_plain(packed, p_scales, q_split, N_MAIN, d=D_MAIN)),
           bound_of(2.0 * 256 * N_MAIN * D_MAIN,
                    N_MAIN * packed.shape[1] + N_MAIN * 4 + q_split.numel() * 2 + 256 * (n_pad // 128) * 4,
                    PEAK_BF16),
           cuda_ms(lambda: torch.matmul(q_live, unpacked.T), iters=3))
    del unpacked
    out11.update({"k9_max_abs_err": err, "k9_ms": kernel_ms["bucket_maxima_q4"][0],
                  "k9_plain_ms": kernel_ms["bucket_maxima_q4"][1],
                  "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3), "ok": True})
    emit(out11)
    del rows, shadow_bf16, packed, runs, buffers

    # --------------------------------------------------------------- summary
    for name in ENTRIES:
        require(path_launches[name] > 0, f"no main path launched the {name} kernel")
    sources = {
        "topk": ("csrc/topk.cu", "typeagent_tpu/ops/topk.py:116"),
        "bucket_maxima": ("csrc/bucket_maxima.cu", "typeagent_tpu/ops/topk.py:1064"),
        "bucket_argmax": ("csrc/bucket_maxima.cu", "typeagent_tpu/ops/topk.py:1101"),
        "rescore": ("csrc/rescore.cu", "typeagent_tpu/ops/topk.py:1334"),
        "topk_iv": ("csrc/topk.cu", "typeagent_tpu/ops/topk.py:386"),
        "topk_mask": ("csrc/topk.cu", "typeagent_tpu/ops/topk.py:511"),
        "topk_q": ("csrc/topk.cu", "typeagent_tpu/ops/topk.py:662"),
        "topk_mq": ("csrc/topk.cu", "typeagent_tpu/ops/topk.py:757"),
        "bucket_maxima_q": ("csrc/bucket_maxima.cu", "typeagent_tpu/ops/topk.py:1233"),
        "bucket_maxima_q4": ("csrc/bucket_maxima.cu", "typeagent_tpu/ops/int4.py:215"),
        # The listed scans' tile lists; the TPU kernels test each tile's
        # rows after the product instead (K4's interval compares, K5's mask).
        "interval_tiles": ("csrc/tile_list.cu", "typeagent_tpu/ops/topk.py:413"),
        "scope_tiles": ("csrc/tile_list.cu", "typeagent_tpu/ops/topk.py:536"),
    }
    for entry, kernel in SHAPE_ENTRIES.items():
        sources[entry] = sources[kernel]
    print(smi_line(), flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"typeagent_tpu_torch/{src}", "replaces": rep,
         "launches": path_launches[name], "max_abs_err": kernel_err[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1],
         "bound_ms": kernel_bound[name][0], "bound_by": kernel_bound[name][1],
         "bound_share": kernel_bound[name][0] / kernel_ms[name][0],
         "library_ms": None, "product_ms": kernel_product_ms[name]}
        for name, (src, rep) in sources.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
