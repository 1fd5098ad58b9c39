#!/usr/bin/env python3
"""Time the PyTorch port's kernels and batch lookups of two trees in turns.

    python3 tools/torch_kernel_ab.py --base DIR [--change DIR] [--out FILE]
                                     [--only TEXT ...] [--profile CASE ...]

Each tree is a checkout holding ``typeagent_tpu_torch/`` (for example the
parent commit unpacked with ``git archive`` into a gitignored directory).
The script runs one child process per tree in the order base, change,
change, base; each child imports the port from its tree, builds its
kernels, makes the same inputs on the card from one seed, and times every
case with CUDA events (kernels) or the host clock around a synchronised
batch lookup (lookups). It prints one JSON line per child and a last line
with, per case, the mean of each tree's two runs, their spread and the
ratio change / base. With --profile, each child also runs the named cases
five times under torch.profiler and reports, per call, the device time by
kernel and in all, beside the wall time (the device's busy share). With
--only, each child times just the cases whose names hold one of the given
texts (and skips the inputs no such case needs). Each child also hashes
the tensors every case returns; the last line's ``same_outputs`` says
whether all four runs returned the same bits. Needs one CUDA card; there
is no CPU mode.

Cases (1M x 384 unit rows unless named, k = 10): K1 f32 at b = 256, 16 and
8, and at 100k rows at b = 256 and 8; K2 over the bf16 shadow at b = 256
and 8, and over the f32 rows at b = 256; K2' f32 and bf16 at b = 256; K3
(unchanged, a control); K4 (8 intervals), K5 (a row mask), K6 and K7 over
int8 rows at b = 64; K4 at b = 256 over a one-interval suffix of the last
100,000 rows (the IVF append path's scan; --only suffix); K6 also at b =
8, 16 and 256, and K7 over a one-third scope of 8 interleaved segments
(one conversation of the corpus layout below); K8 and K9 at b = 256 and 8
(K9 given the rows' width where the tree's K9 takes it, as the int4
search calls it: ``same_outputs`` then says whether skipping the
packing's padding kept the parent's bits); the
IVF program over the rows in bf16 (B = 16, a 3% outlier tail), its tail
and the tail's K2; the batch-256 lookup of a 1M f32 store (hybrid exact2:
K2 + K3) and of a 100k store (K1); scoped searches of a 100k-row store
at b = 8 (host clock) over 8 intervals, the whole store and a 1% subset
(--only scoped); the batch-256 lookup of an IVF snapshot of 900k bf16
rows with 100k appended (the suffix scan, --only appended). Then the f32 corpus of chip_smoke.py
phase 6 (--only f32-corpus), a CorpusVectorStore of 9,984,000 x 384 f32
rows in 24 segments of 416,000 over three conversations, b = 64: K1
(global), K4 scoped to one conversation (8 intervals), K5 to two (9
intervals, a row mask), and the corpus's own search (host clock), global
and for one conversation. Then the int8 corpus of chip_smoke.py phase 7,
30,000,000 x 384 int8 rows in 24 segments of 1,250,000 in the same layout:
K6 (global) and K7 scoped to one conversation (8 segments) and to two
(16), and the corpus's own search, global and for one conversation. In a
tree that lists tiles with a kernel, each scoped corpus case also times
its tile list alone (``interval_tiles ...``, ``scope_tiles ...``); the
last line gives such a case's time with no base where the base tree
lacks it.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import time

SEED = 20261016
N, D, K = 1_000_000, 384, 10
# chip_smoke.py phase 6's and 7's corpora: 24 segments of 416,000 f32 or
# 1,250,000 int8 rows, segment i in conversation CORPUS_NAMES[i % 3].
CORPUS_F32_SEG_ROWS = 416_000
CORPUS_SEG_ROWS, CORPUS_SEGMENTS = 1_250_000, 24
CORPUS_NAMES = ("podcast", "mailbox", "wiki")


def profile(fn, iters: int = 5) -> dict:
    """Device time per call by kernel name (the ten largest), all device
    time per call, and wall time per call, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000 / iters
    by_kernel = {}
    for evt in prof.key_averages():
        # Device-side events only: a host op (aten::*) also reports the
        # time of the kernels it launched, which would count them twice.
        if evt.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0:
            by_kernel[evt.key[:80]] = us / 1000 / iters
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10])
    device_ms = sum(by_kernel.values())
    return {"wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms, "by_kernel_ms": top}


def conversation_mask(n_rows: int, seg_rows: int, convs: tuple) -> "torch.Tensor":
    """[n_rows] int32: the rows of conversations ``convs`` (of 0, 1, 2) in
    the layout segment i -> conversation i % 3."""
    import torch

    seg = torch.arange(n_rows, device="cuda") // seg_rows
    return torch.isin(seg % 3, torch.tensor(convs, device="cuda")).to(torch.int32)


def digest(result) -> str | None:
    """sha256 of the tensors a case returns, in order (None when it returns
    none, as the host lookups do)."""
    import torch

    parts = result if isinstance(result, (tuple, list)) else (result,)
    tensors = [t for t in parts if isinstance(t, torch.Tensor)]
    if not tensors:
        return None
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def child(root: str, profiled: list[str], only: list[str]) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: no CUDA device")
    sys.path.insert(0, os.path.abspath(root))
    from typeagent_tpu_torch.models.adapters import create_test_embedding_model
    from typeagent_tpu_torch.ops import _build, int4, ivf, topk
    from typeagent_tpu_torch.parallel import ShardedVectorStore
    from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.kernels()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def unit(n, d=D):
        return torch.nn.functional.normalize(torch.randn((n, d), generator=gen, device=dev), dim=1)

    n_pad = (N + 1023) // 1024 * 1024
    rows = torch.zeros((n_pad, D), device=dev)
    rows[:N] = unit(N)
    shadow = rows.to(torch.bfloat16)
    q256 = unit(256)
    emb_q, scales = topk.quantize_rows_device(rows)
    packed, sc4 = int4.quantize_rows_int4_device(rows)
    q_split = int4.split_pad_queries(q256, D)
    q_split8 = q_split[:8].contiguous()
    # The rows' width, as the int4 search passes it, in trees whose K9 takes
    # it (the product then skips the packing's padding; same bits).
    k9_width = {"d": D} if "d" in inspect.signature(int4.bucket_maxima_q4).parameters else {}
    ids =torch.topk(topk.bucket_maxima(shadow, q256, N), K + 14, dim=1).indices.to(torch.int32).contiguous()
    iv = torch.tensor([[i * 125_000, i * 125_000 + 62_500] for i in range(8)], dtype=torch.int32, device=dev)
    mask = topk.intervals_to_rowmask(n_pad, iv)[0].contiguous()
    suffix = torch.tensor([[N - 100_000, N]], dtype=torch.int32, device=dev)
    q64 = q256[:64].contiguous()
    # One conversation of three in 24 interleaved segments: 8 segments, a
    # third of the rows.
    third = conversation_mask(n_pad, N // CORPUS_SEGMENTS, (0,))
    wanted = lambda name: not only or any(text in name for text in only)  # noqa: E731

    def cuda_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def host_ms(fn, iters=10):
        """Mean host time of a synchronised call, over at least ``iters``
        calls and about 100 ms (short calls vary most from call to call)."""
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        iters = min(200, max(iters, int(0.1 / max(time.perf_counter() - t0, 1e-6))))
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000 / iters

    def store(n, **settings):
        s = VectorStore(TextEmbeddingIndexSettings(
            embedding_model=create_test_embedding_model(D), min_score=0.0, device="cuda", **settings))
        s.load_device_rows(rows[:n])
        return s

    big, small = store(N), store(100_000)
    # IVF over the same rows in bf16 (chip_smoke.py phase 9's build options):
    # K3 on the selected buckets, K2 + K3 on the 3% outlier tail.
    ivf_store = store(N, dtype="bfloat16", search_mode="ivf")
    ivf_store.settings.ivf_outlier_frac = 0.03
    ivf_store.build_ivf(rows_per_cluster=512)
    state = ivf_store._ivf
    q_host = q256.cpu().numpy()
    cases = {
        "K1 f32 1M b256": lambda: topk.fused_topk(rows, q256, N, K),
        "K1 f32 1M b16": lambda: topk.fused_topk(rows, q256[:16], N, K),
        "K1 f32 1M b8": lambda: topk.fused_topk(rows, q256[:8], N, K),
        "K1 f32 100k b256": lambda: topk.fused_topk(rows, q256, 100_000, K),
        "K1 f32 100k b8": lambda: topk.fused_topk(rows, q256[:8], 100_000, K),
        "K2 bf16 1M b256": lambda: topk.bucket_maxima(shadow, q256, N),
        "K2 bf16 1M b8": lambda: topk.bucket_maxima(shadow, q256[:8], N),
        "K2 f32 1M b256": lambda: topk.bucket_maxima(rows, q256, N),
        "K2' f32 1M b256": lambda: topk.bucket_argmax(rows, q256, N),
        "K2' bf16 1M b256": lambda: topk.bucket_argmax(shadow, q256, N),
        "K3 f32 1M b256 B24": lambda: topk.rescore_selected(rows, q256, ids),
        "K4 f32 1M b64 8 intervals": lambda: topk.fused_topk_iv(rows, q64, N, iv, K),
        "K5 f32 1M b64 mask": lambda: topk.fused_topk_masked(rows, q64, N, mask, K),
        "K4 f32 1M b256 one-interval suffix": lambda: topk.fused_topk_iv(rows, q256, N, suffix, K),
        "K6 int8 1M b8": lambda: topk.fused_topk_q(emb_q, scales, q256[:8], N, K),
        "K6 int8 1M b16": lambda: topk.fused_topk_q(emb_q, scales, q256[:16], N, K),
        "K6 int8 1M b64": lambda: topk.fused_topk_q(emb_q, scales, q64, N, K),
        "K6 int8 1M b256": lambda: topk.fused_topk_q(emb_q, scales, q256, N, K),
        "K7 int8 1M b64 mask": lambda: topk.fused_topk_mq(emb_q, scales, q64, N, mask, K),
        "K7 int8 1M b64 one-third scope": lambda: topk.fused_topk_mq(emb_q, scales, q64, N, third, K),
        "K8 int8 1M b256": lambda: topk.bucket_maxima_q(emb_q, scales, q256, N),
        "K8 int8 1M b8": lambda: topk.bucket_maxima_q(emb_q, scales, q256[:8], N),
        "K9 int4 1M b256": lambda: int4.bucket_maxima_q4(packed, sc4, q_split, N, **k9_width),
        "K9 int4 1M b8": lambda: int4.bucket_maxima_q4(packed, sc4, q_split8, N, **k9_width),
        "IVF 1M bf16 B16 program b256": lambda: ivf.ivf_topk_program(*state, q256, K, B=16),
        "IVF tail exact2 b256": lambda: topk.cosine_topk_exact2(state.out_emb, q256, state.count_out, K),
        "IVF tail K2 b256": lambda: topk.bucket_maxima(state.out_emb, q256, state.count_out),
    }
    cases["lookup 1M f32 b256 (host)"] = lambda: big.fuzzy_lookup_embeddings_batch(q_host, max_hits=K)
    cases["lookup 100k f32 b256 (host)"] = lambda: small.fuzzy_lookup_embeddings_batch(q_host, max_hits=K)
    # Scoped searches where the scan is short beside the host's work: a
    # 100k-row store at b = 8 over 8 intervals (K4), the whole store as one
    # interval (K4, every tile listed) and a 1% subset (a row mask, K5).
    scoped = ShardedVectorStore(D, device="cuda")
    scoped.append_device(rows[:100_000])
    iv100k = np.array([[i * 12_500, i * 12_500 + 6_250] for i in range(8)], np.int32)
    whole = np.array([[0, 100_000]], np.int32)
    subset = np.random.default_rng(SEED).choice(100_000, 1_000, replace=False)
    q8_host = q_host[:8]
    cases["scoped search 100k f32 b8 8 intervals (host)"] = lambda: scoped.search_intervals(q8_host, iv100k, K)
    cases["scoped search 100k f32 b8 whole store (host)"] = lambda: scoped.search_intervals(q8_host, whole, K)
    cases["scoped search 100k f32 b8 1% subset (host)"] = lambda: scoped.search_subset(q8_host, subset, K)
    # chip_smoke.py phase 9's append path at this size: an IVF snapshot of
    # 900k bf16 rows and 100k appended, whose lookup scans the suffix with K4.
    appended = store(N - 100_000, dtype="bfloat16", search_mode="ivf")
    appended.settings.ivf_outlier_frac = 0.03
    appended.build_ivf(rows_per_cluster=512)
    appended.load_device_rows(rows[N - 100_000 : N])
    cases["lookup IVF 900k + 100k appended bf16 b256 (host)"] = (
        lambda: appended.fuzzy_lookup_embeddings_batch(q_host, max_hits=K))
    cases = {name: fn for name, fn in cases.items() if wanted(name)}
    out = {name: (host_ms if name.endswith("(host)") else cuda_ms)(fn) for name, fn in cases.items()}

    def make_corpus(dtype, seg_rows):
        from typeagent_tpu_torch.parallel import CorpusVectorStore

        corpus = CorpusVectorStore(D, device="cuda", dtype=dtype)
        corpus.reserve(seg_rows * CORPUS_SEGMENTS)
        for seg in range(CORPUS_SEGMENTS):
            for done in range(0, seg_rows, 500_000):
                corpus.append_device(CORPUS_NAMES[seg % 3], unit(min(500_000, seg_rows - done)))
        return corpus

    q64_host = q64.cpu().numpy()

    def add_list_case(name, fn):
        """The tile list of a scoped corpus case alone, in trees that list
        with a kernel (``csrc/tile_list.cu``); others lack the case."""
        if hasattr(topk, "interval_tiles_plain"):
            out[name] = cuda_ms(fn, iters=20)
            cases[name] = fn

    f32_cases = {
        "K1 f32-corpus 10M b64 global": None,
        "K4 f32-corpus 10M b64 one conversation": ("podcast",),
        "K5 f32-corpus 10M b64 two conversations": ("podcast", "wiki"),
        "search f32-corpus 10M b64 global (host)": None,
        "search f32-corpus 10M b64 one conversation (host)": ("podcast",),
    }
    f32_cases = {name: convs for name, convs in f32_cases.items() if wanted(name)}
    if f32_cases:
        corpus = make_corpus("float32", CORPUS_F32_SEG_ROWS)
        emb10, n10 = corpus._store.buf, corpus._store.count
        for name, convs in f32_cases.items():
            if name.endswith("(host)"):
                fn = lambda convs=convs: corpus.search(q64_host, k=K, conversations=convs)  # noqa: E731
                out[name] = host_ms(fn, iters=5)
            else:
                if convs is None:
                    fn = lambda: topk.fused_topk(emb10, q64, n10, K)  # noqa: E731
                elif len(convs) == 1:
                    # One conversation: its 8 segments, the corpus's 8-row interval table.
                    table = torch.zeros((8, 2), dtype=torch.int32)
                    spans = corpus._segment_intervals(set(convs))
                    table[: len(spans)] = torch.from_numpy(spans)
                    fn = lambda table=table.to(dev): topk.fused_topk_iv(emb10, q64, n10, table, K)  # noqa: E731
                    add_list_case("interval_tiles " + name[3:],
                                  lambda t=table.to(dev): topk.interval_tiles(t, n10, emb10.shape[0]))
                else:
                    m10 = conversation_mask(emb10.shape[0], CORPUS_F32_SEG_ROWS,
                                            tuple(CORPUS_NAMES.index(c) for c in convs))
                    fn = lambda m10=m10: topk.fused_topk_masked(emb10, q64, n10, m10, K)  # noqa: E731
                    add_list_case("scope_tiles " + name[3:], lambda m10=m10: topk.scope_tiles(m10, n10))
                out[name] = cuda_ms(fn, iters=5)
            cases[name] = fn
    corpus_cases = {
        "K6 int8 30M b64": None,
        "K7 int8 30M b64 one conversation": ("podcast",),
        "K7 int8 30M b64 two conversations": ("podcast", "wiki"),
        "corpus int8 30M b64 global (host)": None,
        "corpus int8 30M b64 one conversation (host)": ("podcast",),
    }
    corpus_cases = {name: convs for name, convs in corpus_cases.items() if wanted(name)}
    if corpus_cases:
        corpus8 = make_corpus("int8", CORPUS_SEG_ROWS)
        codes, sc30, n30 = corpus8._store.buf, corpus8._store._scales, corpus8._store.count
        for name, convs in corpus_cases.items():
            if name.endswith("(host)"):
                fn = lambda convs=convs: corpus8.search(q64_host, k=K, conversations=convs)  # noqa: E731
                out[name] = host_ms(fn, iters=5)
            else:
                if convs is None:
                    fn = lambda: topk.fused_topk_q(codes, sc30, q64, n30, K)  # noqa: E731
                else:
                    m30 = conversation_mask(codes.shape[0], CORPUS_SEG_ROWS,
                                            tuple(CORPUS_NAMES.index(c) for c in convs))
                    fn = lambda m30=m30: topk.fused_topk_mq(codes, sc30, q64, n30, m30, K)  # noqa: E731
                    add_list_case("scope_tiles " + name[3:], lambda m30=m30: topk.scope_tiles(m30, n30))
                out[name] = cuda_ms(fn, iters=5)
            cases[name] = fn
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    return {"root": root, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ms": out,
            "digests": {name: digest(fn()) for name, fn in cases.items()},
            "profiles": {name: profile(cases[name]) for name in profiled if name in cases}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, help="tree timed first and last")
    ap.add_argument("--change", default=".", help="tree timed second and third")
    ap.add_argument("--out", help="also write the child lines and the summary here")
    ap.add_argument("--profile", nargs="*", default=[], metavar="CASE",
                    help="cases to break down by kernel with torch.profiler")
    ap.add_argument("--only", nargs="*", default=[], metavar="TEXT",
                    help="time only the cases whose names hold one of these texts")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.profile, args.only)), flush=True)
        return 0
    runs = []
    for root in (args.base, args.change, args.change, args.base):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--base", args.base, "--child", root,
                              "--profile", *args.profile, "--only", *args.only], capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"torch_kernel_ab: the run of {root} failed ({res.returncode})")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    summary = {}
    for name in runs[1]["ms"]:
        change = [runs[1]["ms"][name], runs[2]["ms"][name]]
        if name not in runs[0]["ms"]:  # a case the base tree lacks
            summary[name] = {"change_ms": sum(change) / 2, "change_runs": change}
            continue
        base = [runs[0]["ms"][name], runs[3]["ms"][name]]
        summary[name] = {"base_ms": sum(base) / 2, "change_ms": sum(change) / 2,
                         "base_runs": base, "change_runs": change,
                         "ratio": (sum(change) / 2) / (sum(base) / 2),
                         # whether both trees returned the same bits (None: not tensors)
                         "same_outputs": None if runs[0]["digests"][name] is None
                         else len({run["digests"][name] for run in runs}) == 1}
    last = {"base": args.base, "change": args.change, "nvidia_smi": runs[0]["nvidia_smi"], "cases": summary}
    if args.out:
        with open(args.out, "w") as f:
            for run in runs:
                f.write(json.dumps(run) + "\n")
            f.write(json.dumps(last) + "\n")
    print(json.dumps(last), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
