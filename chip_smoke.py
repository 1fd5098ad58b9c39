#!/usr/bin/env python3
"""Drive the PyTorch port (``typeagent_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, one JSON line each:

  0. device and build: torch version, the card's name and power limit,
     seconds to build the kernels from ``typeagent_tpu_torch/csrc``;
  1. each kernel (K1 top-k, K2 bucket maxima, K3 rescore) against its plain
     PyTorch version on the card, over d, b, k, dtype, a ragged count, a
     store of exact duplicate rows and a one-bucket cluster (phases 2 and 4
     check each kernel again at the main path's own shapes);
  2. the main path at full width: a 1M x 384 f32 store ingested in 10
     chunks while it answers lookups, then served through LookupBatcher
     (64 concurrent requests), one batch-256 sync lookup and one keyed
     lookup; every answer is held against the plain f32 top-k on the card,
     no certificate may miss, and the launch counts show which kernels the
     run went through;
  3. the one-phase route: a 100k-row store and a 1M-row exact1 store;
  4. a 1M-row bf16 store (plain exact2: K2 over the store, K3 on bf16 rows).

The line before the last holds every kernel's launches, error and time
beside its plain version's; the last line is the device summary. Any
failed check exits non-zero. There is no CPU mode: without a CUDA device
the script exits non-zero.

Plain versions run with ``torch.backends.cuda.matmul.allow_tf32 = False``
(full f32 products, as the kernels compute).
"""

from __future__ import annotations

import asyncio
import contextlib
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
    from typeagent_tpu_torch.ops import _build, topk
    from typeagent_tpu_torch.utils.metrics import METRICS
    from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    kernel_err = {"topk": 0.0, "bucket_maxima": 0.0, "rescore": 0.0}
    kernel_ms: dict[str, tuple[float, float]] = {}

    # ---------------------------------------------------------------- helpers

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def padded_store(m: np.ndarray, n_pad: int, dtype) -> torch.Tensor:
        buf = torch.zeros((n_pad, m.shape[1]), dtype=dtype, device=dev)
        buf[: m.shape[0]].copy_(to_dev(m))
        return buf

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

    @contextlib.contextmanager
    def plain_kernels():
        """Route the store's searches through the plain versions on the card."""
        saved = (topk.fused_topk, topk.bucket_maxima, topk.rescore_selected)
        topk.fused_topk = topk.topk_plain
        topk.bucket_maxima = topk.bucket_maxima_plain
        topk.rescore_selected = topk.rescore_selected_plain
        try:
            yield
        finally:
            topk.fused_topk, topk.bucket_maxima, topk.rescore_selected = saved

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
        qs = normed(rng, 256, d)
        qs[0] = m[dup_rows[0]]
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
    kernel_ms["bucket_maxima"] = in_turns(
        cuda_ms, lambda: topk.bucket_maxima(shadow, qd, count),
        lambda: topk.bucket_maxima_plain(shadow, qd, count))
    kernel_ms["rescore"] = in_turns(
        cuda_ms, lambda: topk.rescore_selected(buf, qd, ids),
        lambda: topk.rescore_selected_plain(buf, qd, ids))
    kernel_ms["topk"] = in_turns(
        cuda_ms, lambda: topk.fused_topk(buf, qd, count, K_MAIN),
        lambda: topk.topk_plain(buf, qd, count, K_MAIN))

    def batch_lookup(s):
        return lambda: s.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)

    def plain_lookup(s):
        def run():
            with plain_kernels():
                s.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)
        return run

    path_ms, path_plain_ms = in_turns(host_ms, batch_lookup(store), plain_lookup(store))
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
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3), "ok": True,
    })

    # ------------------------------------------------- 3. the one-phase route
    out = {"phase": 3}
    rows_dev = buf[:N_MAIN, :D_MAIN]
    for label, n, mode in (("100k_exact", 100_000, "exact"), ("1m_exact1", N_MAIN, "exact1")):
        s = VectorStore(store_settings(mode=mode))
        s.load_device_rows(rows_dev[:n])
        topk.reset_launch_counts()
        res = s.fuzzy_lookup_embeddings_batch(big, max_hits=K_MAIN)
        counts = topk.launch_counts()
        require(counts["topk"] > 0 and counts["bucket_maxima"] == 0, f"{label}: route {counts}")
        recall, err = check_results(res, big, s._buf, s._count, K_MAIN, TOL_F32, label)
        ms, plain = in_turns(host_ms, batch_lookup(s), plain_lookup(s))
        out[label] = {"rows": s._count, "launches": counts, "recall": recall,
                      "max_score_err": err, "ms_per_batch256": ms, "plain_ms_per_batch256": plain}
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

    # --------------------------------------------------------------- summary
    sources = {
        "topk": ("csrc/topk.cu", "typeagent_tpu/ops/topk.py:116"),
        "bucket_maxima": ("csrc/bucket_maxima.cu", "typeagent_tpu/ops/topk.py:1064"),
        "rescore": ("csrc/rescore.cu", "typeagent_tpu/ops/topk.py:1334"),
    }
    print(smi_line(), flush=True)
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"typeagent_tpu_torch/{src}", "replaces": rep,
         "launches": launches[name], "max_abs_err": kernel_err[name],
         "ms": kernel_ms[name][0], "plain_ms": kernel_ms[name][1]}
        for name, (src, rep) in sources.items()
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
