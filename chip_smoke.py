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
 12. a conversation on the card through the port's entry points:
     ``create_conversation(None, ConversationMessage, settings=...)`` with
     the test embedding model (d = 384) on the default device, 150,000
     one-chunk messages made from the seed (8-20 words of a 5,000-word
     vocabulary, 50 speakers, 1-3 recipients, ascending timestamps) and a
     deterministic extractor (one entity, two topics per message), ingested
     by 15 calls of ``add_messages_with_indexing``; 150,000 chunk rows put
     the message index past EXACT2_MIN_ROWS, on the K2 + K3 route. Then 64
     single-question ``lookup_messages`` calls (b = 1), one batch of 256
     query embeddings through the index's batched store lookup, and a
     related-terms expansion of 256 terms at the default 50 matches (k > 32:
     the materialized route, counted); every answer against a plain f32
     top-k over the index's own rows (ties within 2e-6); K2 and K3 must have
     launched. K2 and K3 are then held against their plain versions on the
     index's own operands (the 150,000-row bf16 shadow and f32 rows, b = 8
     and 256) and timed in turns with them (CUDA events, beside their
     bounds). A ``_data.json`` + ``_embeddings.bin`` snapshot is written to
     a temporary directory and read into a new conversation on the card,
     which must answer the same. The corpus, extractor and builders are
     those of ``tests/test_torch_conv_corpus.py``. Printed: sizes, ingest
     rate, the route per lookup kind, host ms (b = 1 p50/p90 through the
     async route and called directly, b = 256), launches, K2 and K3 device
     ms, certificate misses, snapshot seconds and bytes, peak device
     memory, the card.
 13. ``ConversationBase.query()`` on phase 12's conversation (not ingested
     again): the 16 questions of ``make_questions`` (stage-1 JSON made
     from the seed out of the corpus's speakers and words: entity terms
     with search terms, date ranges, "say" actions, actions whose verb no
     message has (the verb-scope fallback), two expressions, a pronoun,
     one that matches nothing) through the canned chat model
     (``models/canned.py``), each once in turn and then all 16 with
     ``asyncio.gather``, stage 3 on the default route, the device query
     engine (``knowpro/device_executor.py``): query p50/p90 and the
     concurrent wall ms; each question's route (``_last_engine_route``);
     the engine's first sync seconds (span ``engine.sync``, apart from the
     first query's ms) and its interner, which must be the native one
     (``native/interner.cpp``); the ``EngineBatcher``'s dispatches and batch sizes
     for the 16 asked at once; ms by stage from the spans (translate,
     compile with the related terms, stage-3 eval, the message query with
     its re-rank, answers); every
     launch counter (``materialized_topk`` included); the store calls,
     recorded by wrapping the two stores' lookups on their instances (the
     related-terms expansion at k = 50, the subset re-rank), each held to
     a numpy f32 cosine top-k over the store's rows (ties within 2e-6) and
     timed by CUDA events; device-busy share by those events and by
     ``torch.profiler`` over one more pass; peak device memory. Every
     answer must be non-empty without "Search failed" (the no-match one
     "No answer found"), the concurrent answers the sequential ones, and
     the canned model's stage-1 calls the questions asked. Then a
     6,000-message conversation from the same seed built on the card and
     on the CPU and asked the same questions: the same answers, stage-3
     ordinals equal, scores within 1e-5. Then 10,000 messages streamed
     through ``add_messages_streaming`` in batches of 100 on the card
     against ``add_messages_with_indexing`` over the same batches: semref
     count, term and property index sizes, message rows and ``_data.json``
     (parsed) equal, the related-terms index apart (the JAX package's two
     paths fill it differently); messages/s for both.
 14. The device query engine against the host VM on phase 12's
     conversation: the 16 questions once with ``use_device_executor=
     "host"`` and twice on the default route, then once more under
     ``torch.profiler``. Every device-pass route must be "device" (a
     fallback fails the phase); each question's stage-3 results equal the
     host VM's (per knowledge type and for messages: the same ordinals, in
     the same order except among tied scores, scores within 1e-4); the
     answers equal the host route's; the second device pass gives the same
     bits; no action-scope selector is left to the host selector.
     Printed: per question its kind, route and stage-3 ms on each
     route; the engine's spans (``engine.accumulate``: the device calls and
     their download; ``engine.combine``: the host combine); the profiler's
     top device ops and device-busy share; the engine's peak device memory
     over the resident conversation; the sorted core's peak bytes per
     posting read, which must lie within the memory guard's
     ``_ENTRY_BYTES``, and the budgets the guard reckons; the card.
 15. SQLite storage: phase 12's corpus, extractor and 15 ingest calls into
     ``create_conversation(<file>, ConversationMessage, settings=...)`` on
     the card (a temporary directory), the provider closed and the file
     reopened cold as a new conversation. The related-terms index must
     hold each of the memory conversation's terms once (the memory index
     repeats a term once per ingest call that meets it). Phase 12's 64
     b = 1 lookups (k = 10) and its b = 256 batch on the reopened message
     index must launch K2 and K3 and match a numpy f32 cosine top-k over
     the rows read back from the file's BLOBs (ties within 2e-6). The 16
     questions through ``query()`` on the default route: every route
     "device" (0 fallbacks), and stage 3 (up to ties within 1e-4) and the
     answers equal to phase 13's memory conversation asked again with
     each related term once (the file's terms and rows); the answers as
     phase 13 asked them are counted, not required. Then
     ``python -m typeagent_tpu_torch.tools.ingest_vtt`` on
     ``tests/testdata/mini.vtt`` and ``python -m
     typeagent_tpu_torch.tools.query --search`` as subprocesses on the
     card: exit 0, at least one message found, and the same lines as the
     same search in this process with ``--device cpu``. Printed: ingest
     rate beside phase 12's, file bytes, the open's seconds (BLOB reads of
     the message and related-terms indexes, the upload, the bf16 shadow),
     rows on the card, b = 1 p50/p90 and b = 256 ms, certificate misses
     and K1 launches, the engine's first sync beside phase 13's, ``query()``
     p50/p90 and stage-3 ms beside the memory conversation's, peak device
     memory, the CLIs' seconds and lines, the card.
 16. The front doors, with no model flag anywhere: an OpenAI-compatible
     fake endpoint on 127.0.0.1 (``tests/test_torch_fake_endpoint.py``, a
     stdlib ``ThreadingHTTPServer`` in a process of its own; 1,536-wide
     embeddings from a hash of each input, the default spec's width;
     knowledge extraction answered with one entity and two topics from
     the text, stage 1 and stage 4 with ``models/canned.py``'s logic;
     429 to every 97th request and 503 to every 89th, once each) behind
     ``OPENAI_API_KEY`` and ``OPENAI_BASE_URL``, so the default HTTP
     models serve everything. A mailbox made from the seed (60
     correspondents with display names, 1-4 recipients with Cc, subjects
     of 400 phrases, bodies of 30-300 words of phase 12's vocabulary, 30%
     replies quoting an earlier email, 5% forwards) written with
     ``mailbox.mbox``, split by ``python -m
     typeagent_tpu_torch.tools.mail.dump_mbox`` and ingested into
     ``mail.db`` by ``python -m typeagent_tpu_torch.tools.ingest_email``,
     and two podcast archives (2,000 turns each, cut from 10,000; 30
     speakers, turns of 8-40 words) by ``python -m
     typeagent_tpu_torch.tools.ingest_podcast``: subprocesses on the card,
     extraction through the fake, the three ingests started together.
     Once the archives are in, ``python -m typeagent_tpu_torch.mcp.server
     -d pod_a.db --corpus a=pod_a.db --corpus b=pod_b.db`` on the card is
     driven over stdio beside the mailbox's ingest (``initialize``,
     ``tools/list``, 8 ``query_conversation`` and 8 ``query_corpus``
     calls, its sampling requests answered with the canned logic). After
     the mailbox's ingest, a ``ConversationCorpus``
     over the two files in this process answers 64 searches globally (K1)
     and 64 scoped to each archive (K4), each held to numpy's f32 top-k
     over the files' BLOBs (ties within 2e-6). Then ``mail.db`` reopened
     as ``EmailMemory`` with ``ConversationSettings()`` on the card: 64
     lookups (K1) held to numpy over its BLOBs, and 12 questions (senders,
     recipients, subjects, "sent" actions, a week, two expressions, one
     that matches nothing) through ``query()`` over the HTTP chat model;
     the same file opened on the CPU gives the same answers. Every 429 and
     503 must have been retried. Printed: each CLI's seconds and
     messages/s, the requests served and the errors sent and retried, each
     MCP call's ms, corpus search ms, lookup ms, the reopen's seconds,
     ``query()`` p50/p90 and its stage spans, launches by kernel, peak
     device memory, the card. ``python3 chip_smoke.py --front-doors
     [--turns N]`` builds the kernels and runs this phase alone (with
     ``--turns 10000``, each archive a season of 10,000 turns).
 17. The multi-device layer (``typeagent_tpu_torch/parallel/``) at d = 384,
     every mesh's cells on the machine's cards (cell j on card j mod the
     card count) when it has two or more, else all on ``cuda:0``; the
     line names the grid, and each stage's launches and seconds:
     (a) phase 6's 9,984,000 x 384 f32 corpus made again from the same
     generator state on (dp=1, shard=4), searched globally (K1 per
     shard), scoped to one conversation (K4) and to two (K5) at b = 64,
     k = 10: every hit held to phase 6's one-device store and to the plain
     f32 top-k of each shard merged (ties within 2e-6); (b) a 1M x 384 f32
     store on (2, 2) at b = 256, the dp split's answers held to the
     one-device store's; (c) the same rows as a bf16 store on (1, 4), saved
     (``parallel/checkpoint.py``) and restored on (2, 2) and (1, 1) with
     identical answers, the save's bytes and seconds; (d) a
     ``ConversationCorpus`` on (1, 4) over two 3,000-message
     conversations: global and scoped ``search_text``, 500 messages added
     and a refresh, then ``save`` and ``load`` onto (2, 2) and one device,
     every hit held to a one-device corpus; (e) phase 12's conversation
     with a dp = 2 ``_device_mesh``: the 16 questions' stage 3 and answers
     equal to the one-device engine's, the dp calls and stage-3 ms beside
     one device's; (f) phase 9's clustered 1M x 384 bf16 rows (the same
     generator state) in sharded IVF on (1, 4) beside the one-device IVF:
     recall@10 against the exact top-k and the certificate rate, every
     certified answer exact up to ties within 1e-5, the sharded recall
     at most 0.01 under one device's. ``python3 chip_smoke.py
     --mesh`` builds the kernels and runs this phase alone, with its own
     references (a one-device corpus, a 20,000-message conversation).

 18. The tools (``typeagent_tpu_torch/tools/``) on the card: (a) the golden
     eval (``eval_golden.run_eval(update=False, device="cuda")``) on the
     device engine, the host VM and approx lookups, each against the
     committed ``tests/testdata/golden_eval.json`` (every route must
     return 0), its seconds and launches. (a) launches no hand-written
     kernel: the fixture's indexes hold at most 33 rows, so approx there
     takes the exact route (``approx_uses_buckets``), and every lookup
     asks for k = 50, the materialized route. It holds the goldens on the
     card, not the approx selection (phase 8 holds K2'); (b) the int8 query wire: a
     1,000,000 x 384 bf16 store of unit rows made on the card from the
     seed, b = 256 (the first 8 queries rows of the store), k = 10, the
     float wire and the int8 wire on the same queries, sync and through
     ``LookupBatcher``: self-matches first, recall@10 of the int8 wire
     against the float wire at least 0.95 (``tests/test_query_wire.py``'s
     bound), the int8 wire's answers equal to the plain f32 top-k of the
     same dequantized queries up to ties within 2e-6, the bytes each wire
     uploads per batch, host-clock p50 of each wire, K2 and K3 launches;
     (c) ``benchmark_vectorstore`` and ``benchmark_serve --wire int8`` as
     subprocesses on the card, each exiting 0, their last lines.
     ``python3 chip_smoke.py --tools`` builds the kernels and runs this
     phase alone.

Each phase's line carries ``t_s``, the seconds since the script started.

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
IVF_SHARD_RECALL_MARGIN = 0.01  # phase 17 (f): sharded IVF recall at most this far under one device's
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
# Phase 12: a conversation past EXACT2_MIN_ROWS chunk rows (the message
# index's large-store route), ingested in 15 calls.
CONV_MESSAGES = 150_000
CONV_BATCHES = 15
CONV_VOCAB = 5_000
CONV_SPEAKERS = 50
CONV_SINGLE = 64  # b = 1 lookups: half message texts, half random words
CONV_BATCH = 256
# Phase 13: query() on phase 12's conversation; a CPU twin; streaming ingest.
CPU_TWIN_MESSAGES = 6_000
TOL_TWIN = 1e-5
# Phase 14: the device engine against the host VM (the JAX package's
# Device==VM tolerance, tests/test_torch_query_parity.py TOL_DEVICE).
TOL_ENGINE = 1e-4
STREAM_MESSAGES = 10_000
STREAM_BATCH = 100
# Phase 15: the CLIs' search words (a speaker of tests/testdata/mini.vtt
# and a word of its text).
CLI_WORDS = ("Bob", "music")
# Phase 16: the front doors. A mailbox of about a year of one person's work
# mail and two podcast archives of a season each, through the HTTP models
# of an OpenAI-compatible fake endpoint at the default spec's width.
MAIL_EMAILS = 5_000  # cut from 10,000 (a year) to make room for phase 17
MAIL_CORRESPONDENTS = 60
MAIL_PHRASES = 400
POD_TURNS = 2_000  # cut from 10,000 a season to keep the smoke inside its limit
POD_SPEAKERS = 30
INGEST_BATCH = 100  # messages per commit in the ingest CLIs
FAKE_DIM = 1536  # openai:text-embedding-ada-002, DEFAULT_EMBEDDING_SPEC
FAKE_ERRORS = (97, 89)  # 429 to every 97th request, 503 to every 89th
MCP_CALLS = 8  # each of query_conversation and query_corpus
CORPUS_QUERIES = 64
# Phase 18: the int8 query wire at the serving cell's shape, and the
# recall bound of tests/test_query_wire.py.
WIRE_ROWS = 1_000_000
WIRE_B = 256
WIRE_SELF = 8  # queries that are rows of the store
WIRE_RECALL = 0.95
WIRE_TIMED = 20  # sync lookups per wire for the host-clock p50
WIRE_REQUESTS = 32  # batcher requests of WIRE_B / WIRE_REQUESTS queries


T_START = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))


def emit(obj: dict) -> None:
    if "phase" in obj:  # a phase's line: the seconds since the start
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 1)}
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


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch

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


def rescore_bound(ids, b: int, d_pad: int) -> tuple[float, str]:
    """K3's bound: each distinct selected bucket read once (the same bucket
    chosen by several queries comes from L2), the queries, the ids and the
    [b, B*128] raw scores once; 2*b*B*128*d_pad f32 operations."""
    import torch

    n_sel, distinct = ids.shape[1], torch.unique(ids).numel()
    return bound_of(2.0 * b * n_sel * 128 * d_pad,
                    distinct * 128 * d_pad * 4 + b * d_pad * 4 + ids.numel() * 4 + b * n_sel * 128 * 4,
                    PEAK_F32)


def lookup_probes(raw: list[dict], rng: np.random.Generator) -> tuple[list[str], list[str]]:
    """Phase 12's lookups, drawn from ``rng``: CONV_SINGLE b = 1 texts (half
    message texts, which must find their own message first, half random
    words) and the CONV_BATCH texts of the b = 256 batch."""
    probe = [raw[int(i)]["text"] for i in rng.integers(0, len(raw), CONV_SINGLE // 2)]
    probe += [" ".join(f"word{w}" for w in rng.integers(0, CONV_VOCAB, 12)) for _ in range(CONV_SINGLE // 2)]
    words = [" ".join(f"word{w}" for w in rng.integers(0, CONV_VOCAB, 10)) for _ in range(CONV_BATCH)]
    return probe, words


async def conversation_phase(dev, n_messages: int = CONV_MESSAGES, batches: int = CONV_BATCHES):
    """Phase 12: a conversation built and searched through the port's entry
    points on the card (create_conversation -> add_messages_with_indexing ->
    index lookups -> snapshot -> reload). Returns the phase's line and the
    launches of its lookups."""
    import tempfile

    import torch

    from typeagent_tpu_torch import create_conversation
    from typeagent_tpu_torch.knowpro.universal_message import (
        ConversationMessage,
        ConversationMessageMeta,
    )
    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.utils.metrics import METRICS
    from typeagent_tpu_torch.vectorstore import EXACT2_MIN_ROWS

    # The corpus, extractor and builders of the port's conversation tests
    # (a module that imports no JAX), at this phase's sizes.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_conv_corpus import (
        ChatConversation,
        ingest,
        make_corpus,
        metadata_semrefs,
        port_settings,
        write_snapshot,
    )

    torch.cuda.reset_peak_memory_stats()
    raw = make_corpus(SEED, n_messages, vocab=CONV_VOCAB, speakers=CONV_SPEAKERS)
    rng = np.random.default_rng(SEED + 12)  # the probes, then the related terms
    conv_settings = port_settings(D_MAIN, device=None)  # the card: the default device
    require(conv_settings.device.type == "cuda", f"conversation settings on {conv_settings.device}")
    t0 = time.perf_counter()
    conv, results = await ingest(create_conversation, conv_settings, ConversationMessage,
                                 ConversationMessageMeta, raw, batches)
    ingest_s = time.perf_counter() - t0
    added = {key: sum(getattr(r, key) for r in results)
             for key in ("messages_added", "chunks_added", "semrefs_added")}
    stages = {name: round(METRICS.stats(f"span.ingest.batch/{name}").total_s, 3)
              for name in ("messages", "metadata", "extract", "indexes")}
    # Metadata: the speaker and each recipient (entities) and one "say"
    # action per recipient; the extractor: one entity and two topics.
    semrefs_expected = metadata_semrefs(raw) + 3 * n_messages
    require(added == {"messages_added": n_messages, "chunks_added": n_messages,
                      "semrefs_added": semrefs_expected}, f"conversation ingest: {added}")
    sec = conv.secondary_indexes
    mindex = sec.message_index
    fuzzy = sec.term_to_related_terms_index.fuzzy_index
    store = mindex.text_location_index._embedding_index._vector_base
    require(await mindex.size() == n_messages and await sec.timestamp_index.size() == n_messages,
            "conversation: message or timestamp index short")
    related_rows = await fuzzy.size()

    # The plain reference: an f32 top-k over each index's own rows, on the card.
    msg_rows = torch.from_numpy(store.host_rows(0, n_messages)).to(dev)
    term_rows = torch.from_numpy(fuzzy._vectorbase.host_rows(0, related_rows)).to(dev)

    def plain_topk(rows, queries: np.ndarray, k: int):
        raw_scores = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev) @ rows.T
        vals, idx = torch.topk(((raw_scores + 1) * 0.5).clamp(0, 1), k, dim=1)
        return vals.cpu().numpy(), idx.cpu().numpy(), ((raw_scores + 1) * 0.5).clamp(0, 1)

    def check_hits(got, ref_v, ref_i, min_score, what):
        """(ordinal, score) hits against the plain top-k row: the same count
        above min_score, scores within TOL_F32, any ordinal the plain top-k
        lacks tying with its last score within TOL_F32."""
        keep = ref_v >= min_score
        require(len(got) == int(keep.sum()), f"{what}: {len(got)} hits, plain {int(keep.sum())}")
        if not got:
            return 0.0
        g_scores = np.array([s for _, s in got])
        err = float(np.abs(g_scores - ref_v[: len(got)]).max())
        require(err <= TOL_F32, f"{what}: score error {err}")
        ref_set = set(ref_i[keep].tolist())
        for item, score in got:
            require(item in ref_set or score >= ref_v[len(got) - 1] - TOL_F32, f"{what}: {item} not in plain top-k")
        return err

    def counts_since_reset():
        counts = topk.launch_counts()
        topk.reset_launch_counts()
        return counts

    min_msg = conv_settings.message_text_index_settings.embedding_index_settings.min_score
    probe, words = lookup_probes(raw, rng)
    out = {"phase": 12, "messages": n_messages, "batches": batches, "d": D_MAIN,
           "semrefs": await conv.semantic_refs.size(), "related_terms_rows": related_rows,
           "message_rows": await mindex.size(), "ingest_s": round(ingest_s, 3),
           "ingest_stage_s": stages,
           "messages_per_s": round(n_messages / ingest_s, 1),
           "exact2_min_rows": EXACT2_MIN_ROWS}
    max_err = 0.0
    cert_q0 = METRICS.counters.get("vectorstore.cert_queries", 0)
    cert_m0 = METRICS.counters.get("vectorstore.cert_misses", 0)

    # (a) b = 1: 64 single-question lookups. The first, timed apart, moves
    # the index's rows to the card and starts the batcher.
    t = time.perf_counter()
    await mindex.lookup_messages(probe[0])
    first_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    topk.reset_launch_counts()
    single, single_ms = [], []
    for text in probe:
        t = time.perf_counter()
        hits = await mindex.lookup_messages(text)
        single_ms.append((time.perf_counter() - t) * 1e3)
        single.append([(h.message_ordinal, h.score) for h in hits])
    counts_b1 = counts_since_reset()
    q_single = np.stack([await mindex.generate_embedding(t) for t in probe])
    ref_v, ref_i, _ = plain_topk(msg_rows, q_single, 10)
    for r, hits in enumerate(single):
        max_err = max(max_err, check_hits(hits, ref_v[r], ref_i[r], min_msg, f"b=1 lookup {r}"))
    for r in range(CONV_SINGLE // 2):  # a message's own text finds it first
        require(single[r] and single[r][0][1] >= 1 - 1e-6, f"b=1 lookup {r}: own message not first")
    # The same lookups without the async route: the store's sync batch call
    # on each embedding (the store's LookupBatcher and event loop bypassed).
    direct_ms = []
    for r, text in enumerate(probe):
        t = time.perf_counter()
        embedding = await mindex.generate_embedding(text)
        hits = store.fuzzy_lookup_embeddings_batch(embedding[None, :], max_hits=10, min_score=min_msg)[0]
        direct_ms.append((time.perf_counter() - t) * 1e3)
        require([(h.item, h.score) for h in hits] == single[r], f"b=1 direct lookup {r} differs")
    topk.reset_launch_counts()

    # (b) one batch of 256 query embeddings through the index's batched lookup.
    q_batch = np.stack(await mindex.text_location_index.generate_embeddings(words))
    emb_index = mindex.text_location_index._embedding_index
    batch = emb_index.get_indexes_of_nearest_batch(q_batch, max_matches=10, min_score=0.0)
    counts_b256 = counts_since_reset()
    ref_v, ref_i, _ = plain_topk(msg_rows, q_batch, 10)
    for r, hits in enumerate(batch):
        max_err = max(max_err, check_hits([(h.item, h.score) for h in hits], ref_v[r], ref_i[r], 0.0,
                                          f"b=256 lookup {r}"))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        emb_index.get_indexes_of_nearest_batch(q_batch, max_matches=10, min_score=0.0)
    batch_ms = (time.perf_counter() - t) * 100
    topk.reset_launch_counts()

    # (c) related-terms expansion of 256 terms at the default 50 matches.
    term_texts = [f"word{w}" for w in rng.integers(0, CONV_VOCAB, CONV_BATCH - 16)]
    term_texts += [f"speaker{s}" for s in range(16)]
    t = time.perf_counter()
    expanded = await fuzzy.lookup_terms(term_texts)
    terms_ms = (time.perf_counter() - t) * 1e3
    counts_terms = counts_since_reset()
    rt_settings = conv_settings.related_term_index_settings.embedding_index_settings
    q_terms = np.stack([await fuzzy._vectorbase.get_embedding(t) for t in term_texts])
    # The store's sync batch call alone (no embedding, event loop or Term
    # objects): the device route and the ScoredInt rows.
    t = time.perf_counter()
    store_hits = fuzzy._vectorbase.fuzzy_lookup_embeddings_batch(
        q_terms, max_hits=rt_settings.max_matches, min_score=rt_settings.min_score)
    terms_store_ms = (time.perf_counter() - t) * 1e3
    require([[fuzzy._texts[h.item] for h in r] for r in store_hits] == [[x.text for x in r] for r in expanded],
            "related terms: the store's hits differ")
    topk.reset_launch_counts()
    ref_v, _, all_scores = plain_topk(term_rows, q_terms, rt_settings.max_matches)
    row_of = {}
    for i, text in enumerate(fuzzy._texts):
        row_of.setdefault(text, i)
    all_scores = all_scores.cpu().numpy()
    for r, terms in enumerate(expanded):
        keep = ref_v[r] >= rt_settings.min_score
        require(len(terms) == int(keep.sum()), f"terms {r}: {len(terms)} of {int(keep.sum())}")
        for term in terms:  # each weight is its row's score and inside the plain top-k
            err = abs(term.weight - all_scores[r, row_of[term.text]])
            max_err = max(max_err, err)
            require(err <= TOL_F32 and term.weight >= ref_v[r][len(terms) - 1] - TOL_F32,
                    f"terms {r}: {term.text} {term.weight}")
    del msg_rows, term_rows

    # The message index's lookups ran K2 + K3 (the store's large-store route).
    for what, counts in (("b=1", counts_b1), ("b=256", counts_b256)):
        require(counts["bucket_maxima"] > 0 and counts["rescore"] > 0, f"conversation {what}: route {counts}")
    cert_q = METRICS.counters.get("vectorstore.cert_queries", 0) - cert_q0
    cert_m = METRICS.counters.get("vectorstore.cert_misses", 0) - cert_m0

    # K2 and K3 on the card at this index's shapes, each against its plain
    # version on the same operands and timed in turns with it (CUDA
    # events): b = 8 (a single question's padded batch) and b = 256. These
    # launches come after the lookups' counts were read.
    device = {}
    with store._dispatch_view() as (buf, _, count):
        shadow = store._shadow(buf, count)
        d_pad, nb = buf.shape[1], shadow.shape[0] // 128
        n_sel = min(10 + topk._HYBRID_SLACK, nb)
        for b, queries in ((8, q_single[:1]), (256, q_batch)):
            qd = store._pad_queries(queries)
            require(qd.shape[0] == b, f"padded batch {qd.shape[0]}, expected {b}")
            maxima = topk.bucket_maxima(shadow, qd, count)
            err2 = (maxima - topk.bucket_maxima_plain(shadow, qd, count)).abs().max().item()
            require(err2 <= TOL_BF16, f"conversation K2 b={b}: error {err2} > {TOL_BF16}")
            ids = torch.topk(maxima, n_sel, dim=1).indices.to(torch.int32).contiguous()
            err3 = (topk.rescore_selected(buf, qd, ids) - topk.rescore_selected_plain(buf, qd, ids)).abs().max().item()
            require(err3 <= TOL_F32, f"conversation K3 b={b}: error {err3} > {TOL_F32}")
            for name, err, timed, bound in (
                ("bucket_maxima", err2,
                 in_turns(cuda_ms, lambda: topk.bucket_maxima(shadow, qd, count),
                          lambda: topk.bucket_maxima_plain(shadow, qd, count)),
                 scan_bound(count, d_pad, 2, b, b * nb * 4, PEAK_BF16)),
                ("rescore", err3,
                 in_turns(cuda_ms, lambda: topk.rescore_selected(buf, qd, ids),
                          lambda: topk.rescore_selected_plain(buf, qd, ids)),
                 rescore_bound(ids, b, d_pad)),
            ):
                device[f"{name}_b{b}"] = {"ms": timed[0], "plain_ms": timed[1], "bound_ms": bound[0],
                                          "bound_by": bound[1], "max_abs_err": err}
    del shadow, maxima, ids, qd
    topk.reset_launch_counts()

    # Snapshot: write, read into a new conversation on the card, ask again.
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "chat")
        t = time.perf_counter()
        await write_snapshot(conv, prefix)
        write_s = time.perf_counter() - t
        sizes = {sfx: os.path.getsize(prefix + sfx) for sfx in ("_data.json", "_embeddings.bin")}
        gc.collect()
        t = time.perf_counter()
        again = await ChatConversation.read_from_file(prefix, port_settings(D_MAIN, device=None))
        read_s = time.perf_counter() - t
    require(await again.messages.size() == n_messages
            and await again.semantic_refs.size() == out["semrefs"], "reloaded conversation: sizes")
    reloaded = [[(h.message_ordinal, h.score) for h in await again.secondary_indexes.message_index.lookup_messages(text)]
                for text in probe]
    require(reloaded == single, "reloaded conversation: b=1 lookups differ")
    again_index = again.secondary_indexes.message_index.text_location_index._embedding_index
    again_batch = again_index.get_indexes_of_nearest_batch(q_batch, max_matches=10, min_score=0.0)
    require([[(h.item, h.score) for h in r] for r in again_batch] == [[(h.item, h.score) for h in r] for r in batch],
            "reloaded conversation: b=256 lookups differ")
    again_terms = await again.secondary_indexes.term_to_related_terms_index.fuzzy_index.lookup_terms(term_texts)
    require([[(t.text, t.weight) for t in r] for r in again_terms] == [[(t.text, t.weight) for t in r] for r in expanded],
            "reloaded conversation: related terms differ")
    topk.reset_launch_counts()

    b1 = np.array(single_ms)
    out.update({
        "routes": {
            "lookup_messages_b1": "exact2h (K2 on the bf16 shadow + K3)" if counts_b1["bucket_maxima"] else "K1",
            "batch_b256": "exact2h (K2 on the bf16 shadow + K3)" if counts_b256["bucket_maxima"] else "K1",
            "related_terms_k50": "materialized [b, n] + torch.topk" if counts_terms["materialized_topk"]
            else "kernels"},
        "launches": {"b1": counts_b1, "b256": counts_b256, "related_terms": counts_terms},
        "materialized_topk": counts_terms["materialized_topk"] + counts_b1["materialized_topk"]
        + counts_b256["materialized_topk"],
        "cert_queries": cert_q, "cert_misses": cert_m,
        "b1_ms_p50": float(np.percentile(b1, 50)), "b1_ms_p90": float(np.percentile(b1, 90)),
        "b1_first_ms": first_ms,
        "b1_direct_ms_p50": float(np.percentile(direct_ms, 50)),
        "b1_direct_ms_p90": float(np.percentile(direct_ms, 90)),
        "b256_ms": batch_ms, "related_terms_b256_ms": terms_ms,
        "related_terms_b256_store_ms": terms_store_ms, "device_ms": device,
        "max_score_err": max_err, "snapshot_write_s": round(write_s, 3),
        "snapshot_read_s": round(read_s, 3),
        "snapshot_bytes": sizes, "reloaded_identical": True,
        "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
    })
    total = {name: counts_b1[name] + counts_b256[name] + counts_terms[name] for name in counts_b1}
    return out, total, conv, raw


QUERY_SPANS = {  # the stages of query(), by the spans the port records
    "translate": ("query.translate_and_search/translate",),
    "compile": ("query.translate_and_search/compile", "query.translate_and_search/search.compile"),
    "stage3_eval": ("query.translate_and_search/search.knowledge",),
    "messages_rerank": ("query.translate_and_search/search.messages",),
    "answers": ("query.answers",),
    "query_translate_and_search": ("query.translate_and_search",),
}


def span_marks() -> dict[str, int]:
    from typeagent_tpu_torch.utils.metrics import METRICS

    return {name: len(METRICS.latencies.get(f"span.{name}", ()))
            for names in QUERY_SPANS.values() for name in names}


def span_ms_since(marks: dict[str, int]) -> dict[str, float]:
    """Milliseconds each stage of QUERY_SPANS recorded since ``marks``."""
    from typeagent_tpu_torch.utils.metrics import METRICS

    return {stage: sum(1e3 * x for name in names
                       for x in METRICS.latencies.get(f"span.{name}", [])[marks[name]:])
            for stage, names in QUERY_SPANS.items()}


def check_top(got: list, scores: np.ndarray, k: int, min_score: float, what: str) -> float:
    """A store call's (item, score) hits against a numpy f32 top-k of
    ``scores`` (one query's scores over the rows it searched, items as
    ``items`` index them): the same count at or above min_score, scores in
    rank order within TOL_F32, each hit's score its row's, and any hit the
    plain top-k lacks tying with its last score. Returns the max error."""
    order = np.argsort(-scores, kind="stable")[:k]
    ref_v = scores[order]
    keep = ref_v >= min_score
    require(len(got) == int(keep.sum()), f"{what}: {len(got)} hits, numpy {int(keep.sum())}")
    if not got:
        return 0.0
    g_items = np.array([item for item, _ in got])
    g_scores = np.array([score for _, score in got])
    err = max(float(np.abs(g_scores - ref_v[: len(got)]).max()),
              float(np.abs(g_scores - scores[g_items]).max()))
    require(err <= TOL_F32, f"{what}: score error {err}")
    require(len(set(g_items.tolist())) == len(got), f"{what}: duplicate hit")
    ref_set = set(order[: len(got)].tolist())
    last = ref_v[len(got) - 1]
    for item, score in got:
        require(item in ref_set or score >= last - TOL_F32, f"{what}: {item} not in the numpy top-k")
    return err


def stage3_of(debug) -> list:
    """A query's stage-3 results as plain data: per search result, the
    message (ordinal, score) list and per knowledge type the semref one."""
    return [([(m.message_ordinal, m.score) for m in r.message_matches],
             {ktype: [(x.semantic_ref_ordinal, x.score) for x in k.semantic_ref_matches]
              for ktype, k in sorted(r.knowledge_matches.items())})
            for r in debug.search_results]


STAGE3_SPAN = "query.translate_and_search/search.knowledge"


async def ask(conv, questions, lang, options=None) -> dict[str, list]:
    """Each question once through ``conv.query()`` in turn (``options`` as
    its search options): answers, stage-3 results, ms, the stage-3 span's
    ms and the engine route per question."""
    from typeagent_tpu_torch.utils.metrics import METRICS

    out: dict[str, list] = {"answers": [], "results": [], "ms": [], "stage3_ms": [], "routes": []}
    for question in questions:
        debug = lang.LanguageSearchDebugContext()
        mark = len(METRICS.latencies.get(f"span.{STAGE3_SPAN}", ()))
        t = time.perf_counter()
        out["answers"].append(await conv.query(question, search_options=options, debug_context=debug))
        out["ms"].append((time.perf_counter() - t) * 1e3)
        out["stage3_ms"].append(1e3 * sum(METRICS.latencies.get(f"span.{STAGE3_SPAN}", [])[mark:]))
        out["results"].append(stage3_of(debug))
        out["routes"].append(getattr(conv, "_last_engine_route", None))
    return out


def engine_span_ms(name: str, marks: dict[str, int] | None = None) -> tuple[float, int]:
    """(ms, count) the engine recorded under span ``name`` since ``marks``
    (its spans nest under whichever span launched the engine call)."""
    from typeagent_tpu_torch.utils.metrics import METRICS

    total, count = 0.0, 0
    for key, values in METRICS.latencies.items():
        if key == f"span.{name}" or key.endswith(f"/{name}"):
            new = values[(marks or {}).get(key, 0):]
            total, count = total + 1e3 * sum(new), count + len(new)
    return total, count


def engine_span_marks() -> dict[str, int]:
    from typeagent_tpu_torch.utils.metrics import METRICS

    return {key: len(values) for key, values in METRICS.latencies.items() if "engine." in key}


def use_canned(conv, questions: dict):
    """Stage-1 and stage-4 translators over one canned chat model."""
    from typeagent_tpu_torch.knowpro import answers, searchlang
    from typeagent_tpu_torch.models.canned import CannedChatModel

    model = CannedChatModel(questions)
    conv._query_translator = searchlang.create_search_query_translator(model)
    conv._answer_translator = answers.create_answer_translator(model)
    return model


def check_answers(answers: list[str], what: str) -> None:
    from test_torch_conv_corpus import QUESTION_KINDS

    for kind, answer in zip(QUESTION_KINDS, answers):
        require(bool(answer) and "Search failed" not in answer, f"{what} ({kind}): {answer[:200]!r}")
        require(answer.startswith("No answer found") == (kind == "nothing"),
                f"{what} ({kind}): {answer[:200]!r}")


async def query_phase(dev, conv, raw: list[dict]):
    """Phase 13: ``query()`` on phase 12's conversation, its CPU twin and
    the streaming ingest. Returns the phase's line and the sequential pass
    (answers, stage-3 results) that phase 15 is set beside."""
    import tempfile

    import torch

    from typeagent_tpu_torch import create_conversation
    from typeagent_tpu_torch.knowpro import searchlang
    from typeagent_tpu_torch.knowpro.universal_message import (
        ConversationMessage,
        ConversationMessageMeta,
    )
    from typeagent_tpu_torch.ops import topk
    from test_torch_conv_corpus import (
        QUESTION_KINDS,
        ingest,
        make_corpus,
        make_questions,
        port_settings,
        to_messages,
        write_snapshot,
    )

    torch.cuda.reset_peak_memory_stats()
    questions = make_questions(raw, SEED + 13)
    texts = list(questions)
    model = use_canned(conv, questions)
    asked = 0

    # (c) Every store call query() makes, recorded by wrapping the two
    # stores' lookups on their instances: the related-terms expansion (the
    # fuzzy index at k = 50) and the message re-rank (a subset top-k).
    sec = conv.secondary_indexes
    term_store = sec.term_to_related_terms_index.fuzzy_index._vectorbase
    msg_store = sec.message_index.text_location_index._embedding_index._vector_base
    calls: list[tuple] = []

    def record_calls(store, name: str, kind: str) -> None:
        inner = getattr(store, name)

        async def wrapper(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = await inner(*args, **kwargs)
            end.record()
            calls.append((kind, args, kwargs, out, start, end))
            return out

        setattr(store, name, wrapper)

    record_calls(term_store, "fuzzy_lookup_embeddings_batch_async", "related_terms")
    record_calls(msg_store, "fuzzy_lookup_embedding_in_subset_async", "subset")

    # (b) The first query, timed apart (the stores' batchers start on this
    # event loop, and the device engine builds its postings: the engine.sync
    # span), then each question once in turn, then all at once.
    sync_marks = engine_span_marks()
    t = time.perf_counter()
    await conv.query(texts[0])
    first_ms = (time.perf_counter() - t) * 1e3
    first_sync_ms, syncs = engine_span_ms("engine.sync", sync_marks)
    require(syncs >= 1, "the first query did not sync the device engine")
    interner = type(conv._device_executor._postings._interner).__name__
    require(interner == "NativeInterner", f"the engine's interner is {interner}, not the native one")
    asked += 1
    torch.cuda.synchronize()
    calls.clear()
    topk.reset_launch_counts()
    marks = span_marks()
    seq_run = await ask(conv, texts, searchlang)
    seq_answers, seq_ms = seq_run["answers"], seq_run["ms"]
    torch.cuda.synchronize()
    asked += len(texts)
    counts_seq = topk.launch_counts()
    stages_ms = span_ms_since(marks)
    seq_calls = list(calls)
    check_answers(seq_answers, "query")

    # The EngineBatcher's dispatches for the 16 at once, and each dispatch's
    # batch (the queries one execute_batch call takes), recorded on the
    # executor instance.
    batches: list[int] = []
    executor = conv._device_executor
    inner_batch = executor.execute_batch

    async def counted_batch(queries, context):
        batches.append(len(queries))
        return await inner_batch(queries, context)

    executor.execute_batch = counted_batch
    stats_before = conv._engine_batcher.stats()
    topk.reset_launch_counts()
    t = time.perf_counter()
    gathered = await asyncio.gather(*(conv.query(q) for q in texts))
    gather_ms = (time.perf_counter() - t) * 1e3
    del executor.execute_batch
    stats_after = conv._engine_batcher.stats()
    asked += len(texts)
    counts_gather = topk.launch_counts()
    require(list(gathered) == seq_answers, "concurrent answers differ from the sequential ones")
    batcher = {"dispatches": stats_after["dispatches"] - stats_before["dispatches"],
               "served": stats_after["served"] - stats_before["served"], "batch_sizes": batches}

    # Device time: CUDA events around each store call of the sequential
    # pass, and torch.profiler's device events over one more pass.
    torch.cuda.synchronize()
    store_ms = {kind: [s.elapsed_time(e) for k, _, _, _, s, e in seq_calls if k == kind]
                for kind in ("related_terms", "subset")}
    from torch.profiler import ProfilerActivity

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        await ask(conv, texts, searchlang)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    asked += len(texts)
    kernel_ms: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if us > 0:
            kernel_ms[evt.key[:80]] = us / 1e3
    prof_device_ms = sum(kernel_ms.values())
    require(model.calls["stage1"] == asked, f"canned stage-1 calls {model.calls['stage1']}, asked {asked}")

    # (c) each recorded call against a numpy f32 cosine top-k over the
    # store's own rows (the store's score: (cos + 1) / 2, clipped to [0, 1]).
    term_rows = term_store.host_rows(0, len(term_store))
    msg_rows = msg_store.host_rows(0, len(msg_store))
    max_err = 0.0
    checked = {"related_terms": 0, "subset": 0}
    for n, (kind, args, kwargs, out, _, _) in enumerate(calls):
        if kind == "related_terms":
            queries = np.asarray(args[0], dtype=np.float32)
            k, min_score = kwargs["max_hits"], kwargs["min_score"]
            scores = np.clip((queries @ term_rows.T + 1) * 0.5, 0, 1)
            for r, hits in enumerate(out):
                max_err = max(max_err, check_top([(h.item, h.score) for h in hits], scores[r], k,
                                                 min_score, f"related terms call {n} row {r}"))
                checked[kind] += 1
        else:
            embedding, ordinals, k, min_score = args
            ordinals = np.asarray(ordinals)
            scores = np.clip((msg_rows[ordinals] @ np.asarray(embedding, np.float32) + 1) * 0.5, 0, 1)
            pos = {int(o): i for i, o in enumerate(ordinals)}
            got = [(pos[h.item], h.score) for h in out]
            max_err = max(max_err, check_top(got, scores, k, 0.0 if min_score is None else min_score,
                                             f"subset call {n}"))
            checked[kind] += 1
    require(checked["related_terms"] > 0 and checked["subset"] > 0, f"store calls checked: {checked}")
    require(counts_seq["materialized_topk"] > 0, "the k = 50 related-terms lookups did not materialize")
    del term_rows, msg_rows
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # (d) The CPU twin: one 6,000-message conversation built on the card
    # and on the CPU from the same seed, asked the same questions.
    raw6 = make_corpus(SEED, CPU_TWIN_MESSAGES, vocab=CONV_VOCAB, speakers=CONV_SPEAKERS)
    questions6 = make_questions(raw6, SEED + 13)
    twin = {}
    for device in ("cuda", "cpu"):
        settings = port_settings(D_MAIN, device=device)
        t = time.perf_counter()
        conv6, _ = await ingest(create_conversation, settings, ConversationMessage,
                                ConversationMessageMeta, raw6, 1)
        build_s = time.perf_counter() - t
        use_canned(conv6, questions6)
        run6 = await ask(conv6, list(questions6), searchlang)
        require(set(run6["routes"]) == {"device"}, f"twin on {device}: routes {run6['routes']}")
        twin[device] = {**run6, "build_s": build_s}
        del conv6
    check_answers(twin["cuda"]["answers"], "twin on the card")
    require(twin["cuda"]["answers"] == twin["cpu"]["answers"], "CPU twin: the answers differ")
    twin_err = 0.0
    for q, (a, b) in enumerate(zip(twin["cuda"]["results"], twin["cpu"]["results"])):
        require(len(a) == len(b), f"CPU twin question {q}: {len(a)} results vs {len(b)}")
        for (ma, ka), (mb, kb) in zip(a, b):
            require([o for o, _ in ma] == [o for o, _ in mb], f"CPU twin question {q}: message ordinals")
            require(ka.keys() == kb.keys(), f"CPU twin question {q}: knowledge types")
            pairs = list(zip(ma, mb)) + [p for t in ka for p in zip(ka[t], kb[t])]
            for t in ka:
                require([o for o, _ in ka[t]] == [o for o, _ in kb[t]], f"CPU twin question {q}: {t} ordinals")
            for (_, x), (_, y) in pairs:
                twin_err = max(twin_err, abs(x - y))
    require(twin_err <= TOL_TWIN, f"CPU twin: score error {twin_err} > {TOL_TWIN}")

    # (e) Streaming ingest on the card against add_messages_with_indexing
    # in the same 100-message batches over the same messages.
    raw10 = make_corpus(SEED + 1, STREAM_MESSAGES, vocab=CONV_VOCAB, speakers=CONV_SPEAKERS)
    streamed = await create_conversation(None, ConversationMessage, settings=port_settings(D_MAIN, device=None))

    async def stream():
        for m in to_messages(raw10, ConversationMessage, ConversationMessageMeta):
            yield m

    topk.reset_launch_counts()
    t = time.perf_counter()
    result = await streamed.add_messages_streaming(stream(), batch_size=STREAM_BATCH)
    stream_s = time.perf_counter() - t
    counts_stream = topk.launch_counts()
    require(result.messages_added == STREAM_MESSAGES and result.messages_skipped == 0,
            f"streaming: {result}")
    t = time.perf_counter()
    batched, _ = await ingest(create_conversation, port_settings(D_MAIN, device=None), ConversationMessage,
                              ConversationMessageMeta, raw10, STREAM_MESSAGES // STREAM_BATCH)
    batch_s = time.perf_counter() - t
    sizes = {}
    for name, c in (("streaming", streamed), ("with_indexing", batched)):
        si = c.secondary_indexes
        sizes[name] = {
            "semrefs": await c.semantic_refs.size(), "terms": await c.semantic_ref_index.size(),
            "properties": await si.property_to_semantic_ref_index.size(),
            "message_rows": await si.message_index.size(),
            "related_terms_rows": await si.term_to_related_terms_index.fuzzy_index.size(),
        }
    with tempfile.TemporaryDirectory() as tmp:
        data = {}
        for name, c in (("streaming", streamed), ("with_indexing", batched)):
            await write_snapshot(c, os.path.join(tmp, name))
            with open(os.path.join(tmp, name + "_data.json")) as f:
                data[name] = json.load(f)
    # The JAX package's two ingest paths fill the related-terms index
    # differently (streaming: each chunk's extracted terms; batch: the term
    # index's terms); the port keeps both (ROADMAP Queue 3), so that index
    # and its row count stand apart from the comparison.
    for d in data.values():
        d.pop("relatedTermsIndexData")
        d["embeddingFileHeader"].pop("relatedCount")
    for key in ("semrefs", "terms", "properties", "message_rows"):
        require(sizes["streaming"][key] == sizes["with_indexing"][key], f"streaming {key}: {sizes}")
    require(data["streaming"] == data["with_indexing"], "streaming: _data.json differs from add_messages_with_indexing's")

    seq = np.array(seq_ms)
    seq_total = float(seq.sum())
    device_events_ms = {kind: float(sum(v)) for kind, v in store_ms.items()}
    return seq_run, {
        "phase": 13, "messages": len(raw), "questions": len(texts), "kinds": list(QUESTION_KINDS),
        "first_query_ms": first_ms, "engine_first_sync_ms": first_sync_ms, "interner": interner,
        "routes": seq_run["routes"], "stage3_ms": [round(x, 3) for x in seq_run["stage3_ms"]],
        "concurrent_16_batcher": batcher,
        "query_ms_p50": float(np.percentile(seq, 50)), "query_ms_p90": float(np.percentile(seq, 90)),
        "query_ms_max": float(seq.max()), "query_ms": [round(x, 3) for x in seq_ms],
        "concurrent_16_wall_ms": gather_ms,
        "stage_ms": stages_ms, "sequential_wall_ms": seq_total,
        "launches": {"sequential": counts_seq, "concurrent": counts_gather, "streaming": counts_stream},
        "materialized_topk": counts_seq["materialized_topk"],
        "store_calls": {kind: len(v) for kind, v in store_ms.items()},
        "store_device_ms_events": device_events_ms,
        "device_busy_share_events": sum(device_events_ms.values()) / seq_total,
        "profiler_wall_ms": prof_wall_ms, "profiler_device_ms": prof_device_ms,
        "device_busy_share_profiler": prof_device_ms / prof_wall_ms,
        "profiler_kernels_ms": dict(sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:8]),
        "store_calls_checked": checked, "store_max_score_err": max_err,
        "canned_calls": dict(model.calls), "answers_ok": True,
        "peak_mem_gib": round(peak_gib, 3),
        "cpu_twin": {"messages": CPU_TWIN_MESSAGES, "answers_equal": True, "max_score_err": twin_err,
                     "build_s": {k: round(v["build_s"], 3) for k, v in twin.items()},
                     "query_ms_p50": {k: float(np.percentile(v["ms"], 50)) for k, v in twin.items()}},
        "streaming": {"messages": STREAM_MESSAGES, "batch": STREAM_BATCH, "equal": True, "sizes": sizes,
                      "streaming_msgs_per_s": STREAM_MESSAGES / stream_s,
                      "with_indexing_msgs_per_s": STREAM_MESSAGES / batch_s},
    }


def close_up_to_ties(a: list, b: list, tol: float, what: str) -> None:
    """(ordinal, score) lists: the same length, scores rank by rank within
    ``tol``, each ordinal's score within ``tol`` where both hold it, the
    same ordinals apart from those tying with the last score (a cut at a
    tie may keep either), and where two lists differ at a rank, the two
    ordinals there tie."""
    require(len(a) == len(b), f"{what}: {len(a)} results vs {len(b)}")
    if not a:
        return
    sa, sb = dict(a), dict(b)
    for (oa, x), (ob, y) in zip(a, b):
        require(abs(x - y) <= tol, f"{what}: scores {x} vs {y}")
        if oa != ob and oa in sa and ob in sa:
            require(abs(sa[oa] - sa[ob]) <= tol, f"{what}: {oa} and {ob} swapped without a tie")
    for o in sa.keys() & sb.keys():
        require(abs(sa[o] - sb[o]) <= tol, f"{what}: ordinal {o} {sa[o]} vs {sb[o]}")
    last = min(a[-1][1], b[-1][1])
    clear = lambda d: {o for o, v in d.items() if v > last + tol}  # noqa: E731
    require(clear(sa) == clear(sb), f"{what}: different ordinals above the last score")


async def engine_phase(dev, conv, raw: list[dict]):
    """Phase 14: the device query engine held to the host VM on phase 12's
    conversation. Returns the phase's line."""
    import torch
    from torch.profiler import ProfilerActivity

    from typeagent_tpu_torch.knowpro import device_executor as DE
    from typeagent_tpu_torch.knowpro import searchlang
    from test_torch_conv_corpus import QUESTION_KINDS, make_questions

    questions = make_questions(raw, SEED + 13)
    texts = list(questions)
    use_canned(conv, questions)
    host_options = searchlang.LanguageSearchOptions(
        compile_options=searchlang.LanguageQueryCompileOptions(
            exact_scope=False, verb_scope=True, term_filter=None, apply_scope=True
        ),
        exact_match=False,
        max_message_matches=25,
        use_device_executor="host",
    )
    t = time.perf_counter()
    host = await ask(conv, texts, searchlang, host_options)
    host_wall_ms = (time.perf_counter() - t) * 1e3
    require(set(host["routes"]) == {"host"}, f"host pass routes: {host['routes']}")

    executor = getattr(conv, "_device_executor", None)
    host_selectors = executor.host_scope_selectors if executor is not None else 0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    marks = engine_span_marks()
    t = time.perf_counter()
    device = await ask(conv, texts, searchlang)
    torch.cuda.synchronize()
    device_wall_ms = (time.perf_counter() - t) * 1e3
    engine_peak = torch.cuda.max_memory_allocated() - resident
    spans = {name: engine_span_ms(name, marks) for name in ("engine.sync", "engine.accumulate", "engine.combine")}
    again = await ask(conv, texts, searchlang)

    fallbacks = [(kind, r) for kind, r in zip(list(QUESTION_KINDS) * 2, device["routes"] + again["routes"])
                 if r != "device"]
    require(not fallbacks, f"device passes left the device engine: {fallbacks}")
    # Action scopes: a message-derived scope selector the engine could not
    # express is evaluated by the host selector; none may be.
    executor = conv._device_executor
    host_selectors = executor.host_scope_selectors - host_selectors
    require(host_selectors == 0, f"{host_selectors} action-scope selectors left the device engine")
    require(again["results"] == device["results"] and again["answers"] == device["answers"],
            "a second device pass gave other bits")
    require(device["answers"] == host["answers"], "device-engine answers differ from the host VM's")
    for q, (kind, d_res, h_res) in enumerate(zip(QUESTION_KINDS, device["results"], host["results"])):
        require(len(d_res) == len(h_res), f"question {q} ({kind}): {len(d_res)} results vs {len(h_res)}")
        for (dm, dk), (hm, hk) in zip(d_res, h_res):
            close_up_to_ties(dm, hm, TOL_ENGINE, f"question {q} ({kind}) messages")
            require(dk.keys() == hk.keys(), f"question {q} ({kind}): knowledge types {dk.keys()} vs {hk.keys()}")
            for ktype in dk:
                close_up_to_ties(dk[ktype], hk[ktype], TOL_ENGINE, f"question {q} ({kind}) {ktype}")

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        await ask(conv, texts, searchlang)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3
    device_ops: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CPU:
            continue
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if us > 0:
            device_ops[evt.key[:80]] = us / 1e3
    prof_device_ms = sum(device_ops.values())
    per_posting = engine_bytes_per_posting(executor)
    for reading in per_posting:
        require(reading["bytes_per_posting"] <= DE._ENTRY_BYTES,
                f"the sorted core took {reading} past the memory guard's _ENTRY_BYTES {DE._ENTRY_BYTES}")
    return {
        "phase": 14, "messages": len(raw), "questions": len(texts),
        "per_question": [
            {"kind": kind, "route": route, "stage3_ms_device": round(d_ms, 3), "stage3_ms_host": round(h_ms, 3)}
            for kind, route, d_ms, h_ms in zip(QUESTION_KINDS, device["routes"], device["stage3_ms"], host["stage3_ms"])
        ],
        "stage3_ms_device": sum(device["stage3_ms"]), "stage3_ms_host": sum(host["stage3_ms"]),
        "query_wall_ms_device": device_wall_ms, "query_wall_ms_host": host_wall_ms,
        "engine_spans_ms": {name: {"ms": ms, "count": n} for name, (ms, n) in spans.items()},
        "fallbacks": 0, "results_equal_up_to_ties": True, "tolerance": TOL_ENGINE,
        "answers_equal": True, "second_pass_same_bits": True,
        "profiler_wall_ms": prof_wall_ms, "profiler_device_ms": prof_device_ms,
        "device_busy_share_profiler": prof_device_ms / prof_wall_ms,
        "profiler_device_ops_ms": dict(sorted(device_ops.items(), key=lambda kv: -kv[1])[:12]),
        "engine_peak_mem_mib": round(engine_peak / 2**20, 3),
        "host_scope_selectors": host_selectors,
        "sorted_core_bytes_per_posting": per_posting,
        "guard_entry_bytes": DE._ENTRY_BYTES,
        "guard_budgets": vars(DE._Budgets.reckon(executor.device)),
    }


async def sqlite_phase(dev, raw: list[dict], phase13: dict):
    """Phase 15: phase 12's conversation built into a SQLite file on the
    card, closed, reopened cold as a new conversation; its message index's
    lookups (K2 + K3) held to a numpy f32 top-k over the file's own BLOBs,
    the 16 questions on the device engine held to the host VM on the same
    file, and the ``ingest_vtt`` and ``query --search`` CLIs run as
    subprocesses on the card. Returns the phase's line and the launches of
    its lookups and questions."""
    import io
    import sqlite3
    import tempfile

    import torch

    from typeagent_tpu_torch import create_conversation
    from typeagent_tpu_torch.knowpro import searchlang
    from typeagent_tpu_torch.knowpro.universal_message import (
        ConversationMessage,
        ConversationMessageMeta,
    )
    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.storage.sqlite import SqliteStorageProvider
    from typeagent_tpu_torch.tools import query as query_tool
    from typeagent_tpu_torch.utils.metrics import METRICS
    from test_torch_conv_corpus import QUESTION_KINDS, ingest, make_questions, metadata_semrefs, port_settings

    n = len(raw)
    out = {"phase": 15, "messages": n, "batches": CONV_BATCHES, "d": D_MAIN}
    launches = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "conv.db")

        # (1) Build: phase 12's corpus, extractor and 15 batches, into SQLite.
        settings = port_settings(D_MAIN, device=None)
        require(settings.device.type == "cuda", f"SQLite conversation settings on {settings.device}")
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        conv, results = await ingest(create_conversation, settings, ConversationMessage,
                                     ConversationMessageMeta, raw, CONV_BATCHES, path)
        ingest_s = time.perf_counter() - t
        require(isinstance(conv.settings.storage_provider, SqliteStorageProvider), "not SQLite storage")
        added = {key: sum(getattr(r, key) for r in results)
                 for key in ("messages_added", "chunks_added", "semrefs_added")}
        require(added == {"messages_added": n, "chunks_added": n,
                          "semrefs_added": metadata_semrefs(raw) + 3 * n}, f"SQLite ingest: {added}")
        build_peak = torch.cuda.max_memory_allocated()
        await conv.settings.storage_provider.close()
        del conv, results
        gc.collect()
        torch.cuda.empty_cache()
        file_bytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))

        # (2) Reopen cold: a new conversation over the file. The open reads
        # the BLOBs (spans sqlite.*.load); the rows reach the card at the
        # stores' first flush, the bf16 shadow at the first exact2 lookup:
        # both are forced and timed here, apart.
        load_spans = ("sqlite.message_index.load", "sqlite.related_terms.load")
        marks = {name: len(METRICS.latencies.get(f"span.{name}", ())) for name in load_spans}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        conv = await create_conversation(path, ConversationMessage, settings=port_settings(D_MAIN, device=None))
        open_s = time.perf_counter() - t
        span_s = {name: sum(METRICS.latencies[f"span.{name}"][marks[name]:]) for name in load_spans}
        mindex = conv.secondary_indexes.message_index
        fuzzy = conv.secondary_indexes.term_to_related_terms_index.fuzzy_index
        store = mindex._vectorbase
        t = time.perf_counter()
        store._flush()
        fuzzy._vector_base._flush()
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t
        t = time.perf_counter()
        store._shadow()
        torch.cuda.synchronize()
        shadow_s = time.perf_counter() - t
        require(store._count == n and store._buf.device.type == "cuda",
                f"reopened message index: {store._count} rows on {store._buf.device}")
        require(await conv.messages.size() == n, "reopened conversation: messages")
        terms = list(fuzzy._terms_list)
        require(len(terms) == len(set(terms)) and set(terms) == phase13["related_terms"],
                "the SQLite related-terms index does not hold each of the memory index's terms once")
        out.update({
            "ingest_s": round(ingest_s, 3), "messages_per_s": round(n / ingest_s, 1),
            "memory_ingest_s": phase13["ingest_s"], "memory_messages_per_s": phase13["messages_per_s"],
            "file_bytes": file_bytes, "build_peak_mem_gib": round(build_peak / 2**30, 3),
            "open_s": round(open_s, 3),
            "open_message_index_read_s": round(span_s["sqlite.message_index.load"], 3),
            "open_related_terms_read_s": round(span_s["sqlite.related_terms.load"], 3),
            "upload_s": round(upload_s, 3), "shadow_s": round(shadow_s, 3),
            "rows_on_card": store._count, "related_terms_rows": len(terms),
            "memory_related_terms_rows": phase13["related_terms_rows"],
        })

        # (3) Phase 12's 64 b = 1 lookups (k = 10) and its b = 256 batch on
        # the reopened index, held to a numpy f32 cosine top-k over the
        # rows read back from the file's BLOBs.
        probe, words = lookup_probes(raw, np.random.default_rng(SEED + 12))
        min_msg = settings.message_text_index_settings.embedding_index_settings.min_score
        cert_q0 = METRICS.counters.get("vectorstore.cert_queries", 0)
        cert_m0 = METRICS.counters.get("vectorstore.cert_misses", 0)
        topk.reset_launch_counts()
        single, single_ms = [], []
        for text in probe:
            t = time.perf_counter()
            hits = await mindex.lookup_messages(text, max_matches=K_MAIN)
            single_ms.append((time.perf_counter() - t) * 1e3)
            single.append([(h.message_ordinal, h.score) for h in hits])
        counts_b1 = topk.launch_counts()
        q_batch = np.stack([await mindex.generate_embedding(w) for w in words])
        topk.reset_launch_counts()
        batch = store.fuzzy_lookup_embeddings_batch(q_batch, max_hits=K_MAIN, min_score=0.0)
        counts_b256 = topk.launch_counts()
        launches += [counts_b1, counts_b256]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            store.fuzzy_lookup_embeddings_batch(q_batch, max_hits=K_MAIN, min_score=0.0)
        batch_ms = (time.perf_counter() - t) * 100
        cert_q = METRICS.counters.get("vectorstore.cert_queries", 0) - cert_q0
        cert_m = METRICS.counters.get("vectorstore.cert_misses", 0) - cert_m0
        for what, counts in (("b=1", counts_b1), ("b=256", counts_b256)):
            require(counts["bucket_maxima"] > 0 and counts["rescore"] > 0, f"SQLite {what}: route {counts}")
        db = sqlite3.connect(path)
        stored = db.execute("SELECT msg_id, embedding FROM MessageTextIndex ORDER BY index_position").fetchall()
        db.close()
        require([m for m, _ in stored] == list(range(n)), "MessageTextIndex rows out of message order")
        blob_rows = np.stack([np.frombuffer(blob, dtype=np.float32) for _, blob in stored])
        del stored
        q_single = np.stack([await mindex.generate_embedding(text) for text in probe])
        max_err = 0.0
        for what, queries, got, floor in (("b=1", q_single, single, min_msg),
                                          ("b=256", q_batch, [[(h.item, h.score) for h in r] for r in batch], 0.0)):
            scores = np.clip((queries @ blob_rows.T + 1) * 0.5, 0, 1)
            for r, hits in enumerate(got):
                max_err = max(max_err, check_top(hits, scores[r], K_MAIN, floor, f"SQLite {what} lookup {r}"))
        for r in range(CONV_SINGLE // 2):  # a message's own text finds it first
            require(single[r] and single[r][0][1] >= 1 - 1e-6, f"SQLite b=1 lookup {r}: own message not first")
        del blob_rows
        b1 = np.array(single_ms)
        out.update({
            "launches": {"b1": counts_b1, "b256": counts_b256},
            "cert_queries": cert_q, "cert_misses": cert_m,
            "k1_launches_b1": counts_b1["topk"], "k1_launches_b256": counts_b256["topk"],
            "b1_ms_p50": float(np.percentile(b1, 50)), "b1_ms_p90": float(np.percentile(b1, 90)),
            "b256_ms": batch_ms, "max_score_err": max_err,
        })

        # (4) The 16 questions on the default route (the device engine),
        # then on the host VM over the same file.
        questions = make_questions(raw, SEED + 13)
        texts = list(questions)
        use_canned(conv, questions)
        sync_marks = engine_span_marks()
        topk.reset_launch_counts()
        t = time.perf_counter()
        await conv.query(texts[0])
        first_ms = (time.perf_counter() - t) * 1e3
        first_sync_ms, syncs = engine_span_ms("engine.sync", sync_marks)
        require(syncs >= 1, "the first query did not sync the device engine")
        device = await ask(conv, texts, searchlang)
        launches.append(topk.launch_counts())
        fallbacks = [(kind, r) for kind, r in zip(QUESTION_KINDS, device["routes"]) if r != "device"]
        require(not fallbacks, f"SQLite questions left the device engine: {fallbacks}")
        check_answers(device["answers"], "SQLite query")
        # Phase 13's memory conversation asked again with its related-terms
        # index holding each term once, as the SQLite one does (the file's
        # terms and rows, in its order): the same stage 3 up to ties within
        # 1e-4 and the same answers. As phase 13 asked them, with a term
        # repeated once per ingest call that met it, the k = 50 expansions
        # differ, so those answers are only counted.
        memory = phase13["conv"]
        mem_fuzzy = memory.secondary_indexes.term_to_related_terms_index.fuzzy_index
        mem_fuzzy.clear()
        await mem_fuzzy.add_terms_with_embeddings(terms, list(fuzzy._vector_base.host_rows(0, len(terms))))
        use_canned(memory, questions)
        once = await ask(memory, texts, searchlang)
        require(set(once["routes"]) == {"device"}, f"memory conversation routes: {once['routes']}")
        require(device["answers"] == once["answers"],
                "SQLite answers differ from the memory conversation's with each related term once")
        for q, (kind, s_res, m_res) in enumerate(zip(QUESTION_KINDS, device["results"], once["results"])):
            require(len(s_res) == len(m_res), f"SQLite question {q} ({kind}): {len(s_res)} results vs {len(m_res)}")
            for (sm, sk), (mm, mk) in zip(s_res, m_res):
                close_up_to_ties(sm, mm, TOL_ENGINE, f"SQLite question {q} ({kind}) messages")
                require(sk.keys() == mk.keys(), f"SQLite question {q} ({kind}): knowledge types")
                for ktype in sk:
                    close_up_to_ties(sk[ktype], mk[ktype], TOL_ENGINE, f"SQLite question {q} ({kind}) {ktype}")
        seq = np.array(device["ms"])
        out.update({
            "first_query_ms": first_ms, "engine_first_sync_ms": first_sync_ms,
            "memory_engine_first_sync_ms": phase13["engine_first_sync_ms"],
            "routes": device["routes"], "fallbacks": 0,
            "query_ms_p50": float(np.percentile(seq, 50)), "query_ms_p90": float(np.percentile(seq, 90)),
            "query_ms": [round(x, 3) for x in device["ms"]],
            "stage3_ms": sum(device["stage3_ms"]), "memory_stage3_ms": sum(once["stage3_ms"]),
            "memory_query_ms_p50": float(np.percentile(once["ms"], 50)),
            "memory_query_ms_p90": float(np.percentile(once["ms"], 90)),
            "equal_to_memory_with_terms_once": True, "tolerance": TOL_ENGINE,
            "answers_equal_to_phase13": sum(a == b for a, b in zip(device["answers"], phase13["run"]["answers"])),
            "peak_mem_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
        })
        await conv.settings.storage_provider.close()
        del conv, mindex, fuzzy, store
        gc.collect()

        # (5) The CLIs as subprocesses on the card (their default device),
        # the search's lines held to the same search in this process on the
        # CPU over the same file.
        repo = os.path.dirname(os.path.abspath(__file__))
        talk = os.path.join(tmp, "talk.db")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (repo, os.environ.get("PYTHONPATH")))))
        search = ["-d", talk, "--search", *CLI_WORDS, "--embedding-model", "test"]
        cli = {}
        for name, args in (("ingest_vtt", [os.path.join(repo, "tests", "testdata", "mini.vtt"), "-d", talk,
                                           "--embedding-model", "test"]),
                           ("query", search)):
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", f"typeagent_tpu_torch.tools.{name}", *args],
                                  capture_output=True, text=True, cwd=repo, env=env, timeout=300)
            require(proc.returncode == 0, f"{name} CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
            cli[name] = {"s": round(time.perf_counter() - t, 3), "stdout": proc.stdout.splitlines()}
        lines = cli["query"]["stdout"]
        require(any(line.startswith("messages: ") and line != "messages: 0" for line in lines),
                f"query --search found no message: {lines}")
        argv, sys.argv = sys.argv, ["query", *search, "--device", "cpu"]
        buffer = io.StringIO()
        try:
            with contextlib.redirect_stdout(buffer):
                await query_tool.amain()
        finally:
            sys.argv = argv
        require(buffer.getvalue().splitlines() == lines, "query --search on the card and on the CPU differ")
        gc.collect()
        out["cli"] = {"words": list(CLI_WORDS), "ingest_vtt": cli["ingest_vtt"],
                      "query_search": cli["query"], "same_lines_as_cpu": True}
    total = {name: sum(c[name] for c in launches) for name in launches[0]}
    return out, total


def podcast_archive(seed: int, n_turns: int) -> list[dict]:
    """``n_turns`` seed-made podcast turns: a speaker of POD_SPEAKERS
    (``speaker<i>``), 8-40 words of phase 12's vocabulary, every other
    speaker listening (as the podcast parser assigns listeners)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(8, 41, n_turns)
    word_ids = rng.integers(0, CONV_VOCAB, int(lengths.sum()))
    speakers = rng.integers(0, POD_SPEAKERS, n_turns)
    ends = np.cumsum(lengths)
    return [{"text": " ".join(f"word{w}" for w in word_ids[ends[i] - lengths[i]: ends[i]]),
             "speaker": f"speaker{speakers[i]}",
             "recipients": [f"speaker{j}" for j in range(POD_SPEAKERS) if j != speakers[i]]}
            for i in range(n_turns)]


def blob_rows(path: str) -> np.ndarray:
    """A SQLite conversation's message-index rows, read from its BLOBs in
    index order."""
    import sqlite3

    db = sqlite3.connect(path)
    stored = db.execute("SELECT embedding FROM MessageTextIndex ORDER BY index_position").fetchall()
    db.close()
    return np.stack([np.frombuffer(blob, dtype=np.float32) for (blob,) in stored])


def message_count(path: str) -> int:
    import sqlite3

    db = sqlite3.connect(path)
    (n,) = db.execute("SELECT COUNT(*) FROM Messages").fetchone()
    db.close()
    return n


def unit_scores(queries: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """numpy's f32 (cos + 1) / 2 scores of unit-normalized queries and rows."""
    q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    r = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    return np.clip((q.astype(np.float32) @ r.astype(np.float32).T + 1) * 0.5, 0, 1)


async def run_cli(args: list[str], log: str, env: dict, timeout: float = 900) -> dict:
    """``python -m <args>`` from the repo root, its output to ``log``: its
    exit code, seconds, last line and last 20 lines. The process is
    stopped if the wait ends any other way."""
    t = time.perf_counter()
    with open(log, "w") as f:
        proc = await asyncio.create_subprocess_exec(sys.executable, "-m", *args, stdout=f, stderr=subprocess.STDOUT,
                                                    cwd=REPO, env=env)
        try:
            rc = await asyncio.wait_for(proc.wait(), timeout)
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()
    s = time.perf_counter() - t
    with open(log) as f:
        lines = f.read().splitlines()
    return {"rc": rc, "s": round(s, 3), "last_line": lines[-1] if lines else "", "tail": lines[-20:]}


def cli_ran(what: str, run: dict) -> dict:
    """A :func:`run_cli` result that exited 0 (or the phase fails), as the
    phase's line keeps it."""
    require(run["rc"] == 0, f"{what}: exit {run['rc']}: {run['tail']}")
    return {"s": run["s"], "last_line": run["last_line"]}


@contextlib.contextmanager
def environ(**values: str | None):
    """This process's environment with ``values`` set (None: unset), put
    back on exit."""
    saved = {name: os.environ.get(name) for name in values}
    try:
        for name, value in values.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


async def front_doors_phase(dev, n_mail: int = MAIL_EMAILS, n_turns: int = POD_TURNS):
    """Phase 16: the front doors. The seed-made mailbox and two podcast
    archives; the OpenAI-compatible fake endpoint in a process of its own;
    ``dump_mbox``; ``ingest_email`` and the two ``ingest_podcast`` runs
    started together on the card; once the archives are in, the MCP server
    driven over stdio beside the mailbox's ingest; then a
    ``ConversationCorpus`` over the archives searched globally (K1) and
    scoped (K4), held to numpy over the files' BLOBs; the reopened
    mailbox's lookups (K1) held to numpy and its 12 questions through
    ``query()`` on the card and on the CPU alike. Returns the phase's line
    and the launches of its paths."""
    import mailbox
    import tempfile
    import urllib.request

    import torch

    if os.path.join(REPO, "tests") not in sys.path:  # the seed-made corpora's module (no JAX)
        sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_conv_corpus import email_text, mailbox_questions, make_mailbox, make_questions

    on_card = dev.type == "cuda"
    out = {"phase": 16, "emails": n_mail, "archives": 2, "turns_per_archive": n_turns, "d": FAKE_DIM,
           "errors_every": {"429": FAKE_ERRORS[0], "503": FAKE_ERRORS[1]}}
    launches = []
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="front_doors_") as tmp:

        def path(*parts: str) -> str:
            return os.path.join(tmp, *parts)

        # (0) The data, made from the seed: the mailbox as an mbox, the
        # archives as transcripts, every question's stage-1 JSON.
        t = time.perf_counter()
        mail = make_mailbox(SEED + 16, n_mail, vocab=CONV_VOCAB, correspondents=MAIL_CORRESPONDENTS,
                            phrases=MAIL_PHRASES)
        box = mailbox.mbox(path("mail.mbox"))
        box.lock()
        for m in mail:
            box.add(email_text(m))
        box.flush()
        box.unlock()
        archives = {name: podcast_archive(SEED + 160 + i, n_turns) for i, name in enumerate(("a", "b"))}
        for name, turns in archives.items():
            with open(path(f"pod_{name}.txt"), "w") as f:
                f.writelines(f"{m['speaker'].upper()}: {m['text']}\n" for m in turns)
        mail_questions = mailbox_questions(mail, SEED + 17)
        pod_questions = make_questions(archives["a"], SEED + 18)
        with open(path("stage1.json"), "w") as f:
            json.dump(mail_questions | pod_questions, f)
        out["data_s"] = round(time.perf_counter() - t, 3)
        del mail

        # The fake endpoint, in a process of its own (its serving threads
        # take no time from this process's clocks).
        fake = subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "test_torch_fake_endpoint.py"), "--stage1",
             path("stage1.json"), "--dim", str(FAKE_DIM), "--errors", ",".join(map(str, FAKE_ERRORS))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=tmp,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH"))))))
        try:
            url = fake.stdout.readline().strip()
            require(url.startswith("http://127.0.0.1:"), f"the fake endpoint did not start: {url!r}")
            # The default models of this process and of the CLIs: the fake.
            with environ(OPENAI_API_KEY="sk-smoke", OPENAI_BASE_URL=url, OPENAI_MODEL=None,
                         OPENAI_EMBEDDING_MODEL=None, AZURE_OPENAI_API_KEY=None, AZURE_OPENAI_ENDPOINT=None):
                env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH")))))
                await front_doors(out, launches, dev, env, path, archives, mail_questions, pod_questions)
            # Every error the fake sent was retried, and answered.
            with urllib.request.urlopen(url.removesuffix("/v1") + "/stats", timeout=30) as resp:
                fake_stats = json.loads(resp.read())
            require(fake_stats["unresolved"] == 0
                    and fake_stats["retried"] == fake_stats["sent_429"] + fake_stats["sent_503"],
                    f"fake endpoint: errors not retried: {fake_stats}")
            require(fake_stats["sent_429"] > 0 and fake_stats["sent_503"] > 0, f"fake endpoint: {fake_stats}")
            out["http"] = fake_stats
        finally:
            fake.stdin.close()  # the fake stops at its input's end
            try:
                fake.wait(timeout=60)
            except subprocess.TimeoutExpired:
                fake.kill()
                fake.wait()
    total = {name: sum(c[name] for c in launches) for name in launches[0]}
    out["launches"] = {k: v for k, v in total.items() if v}
    if on_card:
        out["peak_mem_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    return out, total


async def mcp_calls(pod_db: dict, env: dict, cli_device: list, respond, texts: list[str]) -> dict:
    """``python -m typeagent_tpu_torch.mcp.server`` on the archives, driven
    over stdio: ``initialize``, ``tools/list``, then MCP_CALLS
    ``query_conversation`` and MCP_CALLS ``query_corpus`` calls of
    ``texts``, its sampling requests answered by ``respond``. Each call's
    ms on this side of the pipe."""
    from test_torch_fake_endpoint import McpClient

    server = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "typeagent_tpu_torch.mcp.server", "-d", pod_db["a"],
        "--corpus", f"a={pod_db['a']}", "--corpus", f"b={pod_db['b']}", *cli_device,
        stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE, cwd=REPO, env=env)
    client = McpClient(server, respond)
    mcp = {"calls": []}
    try:
        t = time.perf_counter()
        init = await client.request("initialize", {"protocolVersion": "2024-11-05", "capabilities": {},
                                                   "clientInfo": {"name": "chip_smoke"}})
        mcp["initialize_ms"] = (time.perf_counter() - t) * 1e3
        require(init["result"]["serverInfo"]["name"] == "typeagent-tpu", f"MCP initialize: {init}")
        tools = await client.request("tools/list", {})
        names = [tool["name"] for tool in tools["result"]["tools"]]
        require(names == ["query_corpus", "query_conversation"], f"MCP tools: {names}")
        for tool, questions in (("query_conversation", texts[:MCP_CALLS]),
                                ("query_corpus", texts[MCP_CALLS: 2 * MCP_CALLS])):
            for question in questions:
                t = time.perf_counter()
                reply = await client.request("tools/call", {"name": tool, "arguments": {"question": question}})
                ms = (time.perf_counter() - t) * 1e3
                result = reply.get("result", {})
                text = result.get("content", [{}])[0].get("text", "")
                require(result.get("isError") is False and text and "Search failed" not in text,
                        f"MCP {tool} {question!r}: {reply}")
                if tool == "query_corpus":
                    require("[a]" in text and "[b]" in text, f"MCP query_corpus lacks a conversation: {text!r}")
                mcp["calls"].append({"tool": tool, "ms": round(ms, 3), "answered": not text.startswith("No answer")})
        mcp["sampling_requests"] = len(client.sampling)
    finally:
        server.stdin.close()
        try:
            rc = await asyncio.wait_for(server.wait(), 60)
        except TimeoutError:  # a call left awaiting its sampling answer
            server.kill()
            await server.wait()
            raise
    require(rc == 0, f"MCP server exited {rc}")
    for tool in ("query_conversation", "query_corpus"):
        ms = np.array([c["ms"] for c in mcp["calls"] if c["tool"] == tool])
        mcp[f"{tool}_ms_first"] = float(ms[0])
        mcp[f"{tool}_ms_p50_rest"] = float(np.percentile(ms[1:], 50))
    return mcp


async def front_doors(out: dict, launches: list, dev, env: dict, path, archives: dict, mail_questions: dict,
                      pod_questions: dict):
    """Phase 16 from ``dump_mbox`` on, with the fake serving this process
    and ``env``: fills ``out`` and ``launches``."""
    import torch

    from typeagent_tpu_torch.emails import EmailMemory, EmailMessage
    from typeagent_tpu_torch.knowpro.convsettings import ConversationSettings
    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.parallel import ConversationCorpus
    from typeagent_tpu_torch.podcasts.podcast import Podcast, PodcastMessage
    from typeagent_tpu_torch.storage.utils import create_storage_provider
    from test_torch_conv_corpus import MAILBOX_KINDS
    from test_torch_fake_endpoint import canned_responder, hash_embedding

    on_card = dev.type == "cuda"
    # The CLIs and ConversationSettings default to the card; elsewhere (a
    # CPU rehearsal of this phase) the CPU is named.
    cli_device = [] if on_card else ["--device", "cpu"]
    settings_device = {} if on_card else {"device": "cpu"}
    n_mail, n_turns = out["emails"], out["turns_per_archive"]
    cli = out["cli"] = {}

    # (1) mbox -> .eml files; then the mailbox's ingest and the archives'
    # at once, extraction through the fake: every message in its file.
    cli["dump_mbox"] = cli_ran("dump_mbox", await run_cli(
        ["typeagent_tpu_torch.tools.mail.dump_mbox", path("mail.mbox"), path("eml")], path("dump_mbox.log"), env))
    require(len(os.listdir(path("eml"))) == n_mail, "dump_mbox: not one .eml file per email")
    mail_db = path("mail.db")
    pod_db = {name: path(f"pod_{name}.db") for name in archives}

    def ingest(key: str, args: list[str], db: str):
        return run_cli([*args, "-d", db, "--batch-size", str(INGEST_BATCH), *cli_device], path(f"{key}.log"), env)

    def ingested(key: str, run: dict, db: str, want: int) -> None:
        cli[key] = cli_ran(key, run)
        n = message_count(db)
        require(n == want, f"{key}: {n} messages of {want}")
        cli[key]["messages_per_s"] = round(n / cli[key]["s"], 1)

    mail_ingest = asyncio.create_task(ingest("ingest_email", ["typeagent_tpu_torch.tools.ingest_email", path("eml")],
                                             mail_db))
    try:
        runs = await asyncio.gather(*(ingest(f"ingest_podcast_{name}", ["typeagent_tpu_torch.tools.ingest_podcast",
                                                                        path(f"pod_{name}.txt")], pod_db[name])
                                      for name in archives))
        for name, run in zip(archives, runs):
            ingested(f"ingest_podcast_{name}", run, pod_db[name], n_turns)
        # (2) The MCP server on the archives, beside the mailbox's ingest.
        out["mcp"] = await mcp_calls(pod_db, env, cli_device, canned_responder(mail_questions | pod_questions),
                                     list(pod_questions))
        out["mcp"]["beside_ingest_email"] = not mail_ingest.done()
        ingested("ingest_email", await mail_ingest, mail_db, n_mail)
    finally:
        if not mail_ingest.done():  # the phase failed: stop the ingest
            mail_ingest.cancel()
            await asyncio.wait([mail_ingest])

    # (3) A ConversationCorpus over the two archives in this process:
    # 64 searches global (K1) and 64 scoped to each archive (K4), each
    # held to numpy's f32 top-k over the files' BLOBs.
    t = time.perf_counter()
    corpus = ConversationCorpus(dim=FAKE_DIM, **settings_device)
    convs = {}
    for name in archives:
        settings = ConversationSettings(**settings_device)
        settings.storage_provider = await create_storage_provider(
            settings.message_text_index_settings, settings.related_term_index_settings, pod_db[name],
            PodcastMessage)
        convs[name] = await Podcast.create(settings, name=name)
        await corpus.add_conversation(name, convs[name])
    corpus_open_s = time.perf_counter() - t
    rows = {name: blob_rows(pod_db[name]) for name in archives}
    require(all(r.shape == (n_turns, FAKE_DIM) for r in rows.values()), "archive BLOB rows")
    rng = np.random.default_rng(SEED + 19)
    probe = [archives["a"][i]["text"] for i in rng.integers(0, n_turns, CORPUS_QUERIES // 4)]
    probe += [archives["b"][i]["text"] for i in rng.integers(0, n_turns, CORPUS_QUERIES // 4)]
    probe += [" ".join(f"word{w}" for w in rng.integers(0, CONV_VOCAB, 6)) for _ in range(CORPUS_QUERIES // 2)]
    queries = np.stack([hash_embedding(text, FAKE_DIM) for text in probe])
    row_of, base = {}, 0
    for name in archives:
        for r, loc in enumerate(corpus._locations[name]):
            row_of[(name, loc.message_ordinal, loc.chunk_ordinal)] = base + r
        base += len(corpus._locations[name])
    all_rows = np.concatenate([rows[name] for name in archives])
    all_scores = unit_scores(queries, all_rows)
    search, max_err = {}, 0.0
    for scope in (None, ["a"], ["b"]):
        key = "global" if scope is None else f"scoped_{scope[0]}"
        corpus.search_embedding(queries[0], k=K_MAIN, conversations=scope)  # warm
        if on_card:
            torch.cuda.synchronize()
        topk.reset_launch_counts()
        hits, ms = [], []
        for q in queries:
            t = time.perf_counter()
            hits.append(corpus.search_embedding(q, k=K_MAIN, conversations=scope))
            ms.append((time.perf_counter() - t) * 1e3)
        counts = topk.launch_counts()
        launches.append(counts)
        scores = all_scores
        if scope is not None:  # rows outside the scope cannot be found
            lo = 0 if scope[0] == "a" else n_turns
            keep = np.zeros(all_rows.shape[0], dtype=bool)
            keep[lo: lo + n_turns] = True
            scores = np.where(keep[None, :], all_scores, -1.0)
        for r, got in enumerate(hits):
            require(all(h.conversation in (scope or archives) for h in got), f"corpus {key}: out of scope")
            pairs = [(row_of[(h.conversation, h.message_ordinal, h.chunk_ordinal)], h.score) for h in got]
            max_err = max(max_err, check_top(pairs, scores[r], K_MAIN, 0.0, f"corpus {key} query {r}"))
        for r in range(CORPUS_QUERIES // 2):  # a turn's own text finds it first
            own = "a" if r < CORPUS_QUERIES // 4 else "b"
            if scope is None or scope == [own]:
                require(hits[r] and hits[r][0].score >= 1 - 1e-6, f"corpus {key} query {r}: own turn not first")
        search[key] = {"ms_p50": float(np.percentile(ms, 50)), "ms_p90": float(np.percentile(ms, 90)),
                       "launches": {k: v for k, v in counts.items() if v}}
    if on_card:  # (the CPU runs the kernels' plain versions, uncounted)
        require(search["global"]["launches"].get("topk", 0) > 0, f"corpus global: no K1 {search['global']}")
        for key in ("scoped_a", "scoped_b"):
            require(search[key]["launches"].get("topk_iv", 0) > 0, f"corpus {key}: no K4 {search[key]}")
    out["corpus"] = {"open_s": round(corpus_open_s, 3), "rows": int(all_rows.shape[0]),
                     "queries": CORPUS_QUERIES, "k": K_MAIN, "max_score_err": max_err, **search}
    for conv in convs.values():
        await conv.settings.storage_provider.close()
    del corpus, convs, all_rows, all_scores, rows

    # (4) The mailbox reopened as EmailMemory with ConversationSettings()
    # (the default models: the fake) on the card: lookups held to numpy
    # over the file's BLOBs, then 12 questions through query().
    async def open_mailbox(device_kw):
        settings = ConversationSettings(**device_kw)
        settings.storage_provider = await create_storage_provider(
            settings.message_text_index_settings, settings.related_term_index_settings, mail_db, EmailMessage)
        return await EmailMemory.create(settings, name="mailbox")

    if on_card:
        torch.cuda.synchronize()
    t = time.perf_counter()
    memory = await open_mailbox(settings_device)
    reopen_s = time.perf_counter() - t
    mindex = memory.secondary_indexes.message_index
    store = mindex._vectorbase
    require(store._device.type == dev.type, f"mailbox index on {store._device}")
    mrows = blob_rows(mail_db)
    # Half the probes an email's own first chunk (it must come first),
    # half random words of the vocabulary.
    owners = [int(o) for o in rng.integers(0, n_mail, CONV_SINGLE // 2)]
    probe = [(await memory.messages.get_item(o)).text_chunks[0] for o in owners]
    probe += [" ".join(f"word{w}" for w in rng.integers(0, CONV_VOCAB, 5)) for _ in range(CONV_SINGLE // 2)]
    q_mail = np.stack([await mindex.generate_embedding(text) for text in probe])
    topk.reset_launch_counts()
    b1_ms, b1_hits = [], []
    for text in probe:
        t = time.perf_counter()
        b1_hits.append(await mindex.lookup_messages(text, max_matches=K_MAIN))
        b1_ms.append((time.perf_counter() - t) * 1e3)
    counts_lookup = topk.launch_counts()
    launches.append(counts_lookup)
    require(counts_lookup["topk"] > 0 or not on_card, f"mailbox lookups: no K1 {counts_lookup}")
    # The store's rows for the same queries, b = 1 and b = 64, held to
    # numpy (launches outside the path's count).
    rows_b1 = [store.fuzzy_lookup_embedding(q, max_hits=K_MAIN, min_score=0.0) for q in q_mail]
    rows_batch = store.fuzzy_lookup_embeddings_batch(q_mail, max_hits=K_MAIN, min_score=0.0)
    topk.reset_launch_counts()
    scores = unit_scores(q_mail, mrows)
    lookup_err = 0.0
    for r in range(len(probe)):
        for what, got in (("b=1", rows_b1[r]), ("b=64", rows_batch[r])):
            lookup_err = max(lookup_err, check_top([(h.item, h.score) for h in got], scores[r], K_MAIN, 0.0,
                                                   f"mailbox {what} lookup {r}"))
    for r, o in enumerate(owners):
        require(b1_hits[r] and b1_hits[r][0].message_ordinal == o, f"mailbox lookup {r}: own email not first")
    out["mail_lookups"] = {"rows": int(mrows.shape[0]), "probes": len(probe), "own_text": len(owners),
                           "b1_ms_p50": float(np.percentile(b1_ms, 50)),
                           "b1_ms_p90": float(np.percentile(b1_ms, 90)),
                           "max_score_err": lookup_err,
                           "launches": {k: v for k, v in counts_lookup.items() if v}}
    del mrows

    qtexts = list(mail_questions)
    marks = span_marks()
    topk.reset_launch_counts()
    card_answers, q_ms = [], []
    for question in qtexts:
        t = time.perf_counter()
        card_answers.append(await memory.query(question))
        q_ms.append((time.perf_counter() - t) * 1e3)
    launches.append(topk.launch_counts())
    stage_ms = span_ms_since(marks)
    for kind, answer in zip(MAILBOX_KINDS, card_answers):
        require(bool(answer) and "Search failed" not in answer, f"mailbox query ({kind}): {answer[:200]!r}")
        require(answer.startswith("No answer found") == (kind == "nothing"),
                f"mailbox query ({kind}): {answer[:200]!r}")
    await memory.settings.storage_provider.close()
    del memory, mindex, store
    gc.collect()
    # The same file on the CPU: the same answers.
    t = time.perf_counter()
    cpu_memory = await open_mailbox({"device": "cpu"})
    cpu_reopen_s = time.perf_counter() - t
    cpu_answers = [await cpu_memory.query(question) for question in qtexts]
    await cpu_memory.settings.storage_provider.close()
    del cpu_memory
    require(cpu_answers == card_answers, "mailbox answers on the card and the CPU differ")
    out["mail_query"] = {
        "questions": len(qtexts), "kinds": list(MAILBOX_KINDS), "reopen_s": round(reopen_s, 3),
        "cpu_reopen_s": round(cpu_reopen_s, 3), "first_ms": q_ms[0],
        "ms_p50": float(np.percentile(q_ms, 50)), "ms_p90": float(np.percentile(q_ms, 90)),
        "ms": [round(x, 3) for x in q_ms], "stage_ms": stage_ms,
        "answered": sum(not a.startswith("No answer found") for a in card_answers),
        "same_answers_on_cpu": True,
    }


def engine_bytes_per_posting(executor) -> list[dict]:
    """The sorted core's peak device memory per posting it reads, for the
    guard's ``_ENTRY_BYTES``: one COO call over the largest list, and over
    the eight largest as eight segments, every entry live (no gate, no
    scope), measured over what was allocated before the call."""
    import torch

    index = executor._postings
    sizes = np.diff(index._offsets_host)
    out = []
    for n_lists in (1, 8):
        tids = np.argsort(sizes, kind="stable")[-n_lists:]
        ops = [(int(tid), 1.0, seg, 0, 0, -1, 0) for seg, tid in enumerate(tids)]
        index.lookup_ops_sparse(ops, n_lists, executor._semref_ktype)  # the cached ktype row, the scope row
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        index.lookup_ops_sparse(ops, n_lists, executor._semref_ktype)
        torch.cuda.synchronize()
        postings = int(sizes[tids].sum())
        peak = torch.cuda.max_memory_allocated() - before
        out.append({"lists": n_lists, "postings": postings, "peak_bytes": peak,
                    "bytes_per_posting": peak / postings})
    return out


# ---------------------------------------------------------------------------
# Phase 17: the multi-device layer (parallel/: meshes, row-sharded stores,
# sharded IVF, checkpoints, the engine's data-parallel dispatch).
# ---------------------------------------------------------------------------


def mesh_devices(dev, n: int) -> list:
    """``n`` grid cells over the machine's cards (cell j on card j mod the
    card count) when it has 2 or more, else all on ``dev``."""
    import torch

    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        cards = torch.cuda.device_count()
        return [torch.device("cuda", j % cards) for j in range(n)]
    return [dev] * n


def make_mesh(dev, n_dp: int, n_shard: int):
    from typeagent_tpu_torch.parallel import create_mesh

    return create_mesh(n_shard=n_shard, n_dp=n_dp, devices=mesh_devices(dev, n_dp * n_shard))


def sync_all(dev) -> None:
    import torch

    if dev.type == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def clustered_rows(gen, dev, n: int, topics: int, n_queries: int):
    """bench.py section B's corpus on ``dev`` from ``gen``: unit rows around
    ``topics`` unit centres (sigma 0.35 / sqrt(d) per coordinate), 2%
    isotropic background, bf16; topic queries made the same way and
    rounded to bf16, so the exact1 oracle (which scores bf16 queries on a
    bf16 store) and the rescore (f32 queries) score one query."""
    import torch

    normalize = torch.nn.functional.normalize
    centers = normalize(torch.randn((topics, D_MAIN), generator=gen, device=dev), dim=1)
    out = torch.empty((n, D_MAIN), dtype=torch.bfloat16, device=dev)
    for s0 in range(0, n, IVF_CHUNK):
        m = min(IVF_CHUNK, n - s0)
        lab = torch.randint(0, topics, (m,), generator=gen, device=dev)
        e = centers[lab] + SIGMA_C * torch.randn((m, D_MAIN), generator=gen, device=dev) / D_MAIN ** 0.5
        bg = torch.rand((m,), generator=gen, device=dev) < BG_C
        e = torch.where(bg[:, None], torch.randn((m, D_MAIN), generator=gen, device=dev), e)
        out[s0 : s0 + m] = normalize(e, dim=1).to(torch.bfloat16)
    lab = torch.randint(0, topics, (n_queries,), generator=gen, device=dev)
    q = centers[lab] + SIGMA_C * torch.randn((n_queries, D_MAIN), generator=gen, device=dev) / D_MAIN ** 0.5
    q = normalize(q, dim=1).to(torch.bfloat16).float()
    return out, q.cpu().numpy()


def build_corpus(corpus, gen, dev, seg_rows: int, chunk: int) -> None:
    """The fragmented corpus layout (24 interleaved segments over three
    conversations) from ``gen``'s standard normal rows, made on ``dev``."""
    import torch

    corpus.reserve(seg_rows * len(CORPUS_LAYOUT))
    for name in CORPUS_LAYOUT:
        for done in range(0, seg_rows, chunk):
            step = min(chunk, seg_rows - done)
            corpus.append_device(name, torch.randn((step, D_MAIN), generator=gen, device=dev))


CORPUS_SCOPES = {"global": None, "podcast": ["podcast"], "podcast+wiki": ["podcast", "wiki"]}


def corpus_hits(corpus, q_raw: np.ndarray, k: int) -> dict[str, list]:
    """Each scope's corpus search as (global ordinal, score) lists."""
    return {scope: [[(h.global_ordinal, h.score) for h in row]
                    for row in corpus.search(q_raw, k=k, conversations=conversations)]
            for scope, conversations in CORPUS_SCOPES.items()}


# Phase 17's sizes; the CPU rehearsal in tests/test_torch_smoke_mesh.py cuts them.
MESH_SIZES = {
    "corpus_seg_rows": CORPUS_F32_SEG_ROWS,  # (a): 9,984,000 rows, phase 6's layout
    "corpus_chunk": CORPUS_CHUNK,
    "corpus_b": CORPUS_B,
    "store_rows": N_MAIN,  # (b) f32 and (c) bf16
    "store_b": 256,
    "conv_messages": 3_000,  # (d): each of two conversations
    "conv_more": 500,  # (d): then added to one, before a refresh
    "conv_searches": 16,
    "ivf_rows": IVF_SCALES[0][0],  # (f): phase 9's clustered 1M rows
    "ivf_topics": IVF_SCALES[0][1],
    "ivf_queries": IVF_QUERIES,
    "ivf_rows_per_cluster": 512,
    "engine_messages": 20_000,  # (e), run without phase 12's conversation
}


async def mesh_phase(dev, sizes: dict | None = None, phase6: dict | None = None,
                     ivf_gen_state=None, conv_ctx: dict | None = None) -> tuple[dict, dict]:
    """Phase 17: the multi-device layer through its entry points, each
    stage held to its one-device counterpart. ``phase6``: phase 6's
    generator state, queries and hits (else a one-device corpus is built
    here first); ``ivf_gen_state``: the generator state phase 9 made its
    1M rows from; ``conv_ctx``: phase 12's conversation and corpus (else a
    smaller one is built). Returns the phase's line and its launches.

    The cyclic garbage collector is off for the phase: a collection over
    the earlier phases' live objects (phase 12's conversation) takes
    seconds and would land in whichever timed pass crossed its threshold."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        return await _mesh_stages(dev, sizes, phase6, ivf_gen_state, conv_ctx)
    finally:
        if enabled:
            gc.enable()


async def _mesh_stages(dev, sizes, phase6, ivf_gen_state, conv_ctx) -> tuple[dict, dict]:
    import tempfile

    import torch

    from typeagent_tpu_torch import create_conversation
    from typeagent_tpu_torch.knowpro import searchlang
    from typeagent_tpu_torch.knowpro.universal_message import ConversationMessage, ConversationMessageMeta
    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.parallel import ConversationCorpus, CorpusVectorStore, ShardedVectorStore
    from typeagent_tpu_torch.parallel.checkpoint import restore_sharded_store, save_sharded_store

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_conv_corpus import QUESTION_KINDS, ingest, make_corpus, make_questions, port_settings, to_messages

    sizes = {**MESH_SIZES, **(sizes or {})}
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 17)
    counts = {}
    out = {"phase": 17, "cards": torch.cuda.device_count() if on_card else 0,
           "grid_rule": "cell j on card j mod cards" if len(set(mesh_devices(dev, 2))) > 1 else f"every cell on {dev}"}

    def reset():
        topk.reset_launch_counts()

    def take(stage: str, required: tuple[str, ...]) -> dict:
        got = topk.launch_counts()
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
        if on_card:
            for name in required:
                require(got.get(name, 0) > 0, f"phase 17 {stage}: the {name} kernel never ran ({got})")
        return {name: n for name, n in got.items() if n}

    def seconds(t0: float) -> float:
        sync_all(dev)
        return round(time.perf_counter() - t0, 3)

    def timed_ms(fn, iters: int = 3) -> float:
        fn()
        sync_all(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        sync_all(dev)
        return round((time.perf_counter() - t0) * 1e3 / iters, 3)

    def shape_of(mesh) -> dict:
        return {"dp": mesh.shape["dp"], "shard": mesh.shape["shard"],
                "devices": [[str(d) for d in row] for row in mesh.devices.tolist()]}

    # (a) phase 6's 10M f32 corpus on (dp=1, shard=4), held to phase 6's
    # one-device store and to the plain f32 top-k shard by shard.
    t_stage = time.perf_counter()
    seg_rows, k = sizes["corpus_seg_rows"], K_MAIN
    gen = torch.Generator(device=dev)
    if phase6 is None:  # build the one-device reference here, then free it
        gen.manual_seed(SEED + 6)
        state = gen.get_state()
        one = CorpusVectorStore(D_MAIN, device=dev)
        build_corpus(one, gen, dev, seg_rows, sizes["corpus_chunk"])
        q_raw = normed(rng, sizes["corpus_b"], D_MAIN)
        phase6 = {"gen_state": state, "q_raw": q_raw, "hits": corpus_hits(one, q_raw, k)}
        del one
        if on_card:
            torch.cuda.empty_cache()
    gen.set_state(phase6["gen_state"])
    mesh_a = make_mesh(dev, 1, 4)
    corpus = CorpusVectorStore(D_MAIN, mesh=mesh_a)
    t0 = time.perf_counter()
    build_corpus(corpus, gen, dev, seg_rows, sizes["corpus_chunk"])
    build_s = seconds(t0)
    store = corpus._store
    count = store.count
    require(count == seg_rows * len(CORPUS_LAYOUT), f"phase 17 (a): {count} rows")
    q_raw = phase6["q_raw"]
    reset()
    hits = corpus_hits(corpus, q_raw, k)
    launches_a = take("(a)", ("topk", "topk_iv", "topk_mask"))
    qn = q_raw / np.linalg.norm(q_raw, axis=1, keepdims=True)
    q_pad = np.zeros((qn.shape[0], store.dim_pad), np.float32)
    q_pad[:, :D_MAIN] = qn
    exact_equal = {}
    for scope, conversations in CORPUS_SCOPES.items():
        # The plain versions of each shard's scan (the whole shard, masked
        # by the scope's intervals), offset, then one stable sort.
        table = None if conversations is None else corpus._segment_intervals(set(conversations))
        parts_v, parts_i = [], []
        for s, rows in enumerate(store.shard_rows(0)):
            offset = s * store.local_n
            local = max(0, min(count - offset, store.local_n))
            if not local:
                continue
            q_s = torch.from_numpy(q_pad).to(rows.device)
            if table is None:
                v, i = topk.topk_plain(rows, q_s, local, k)
            else:
                iv = torch.from_numpy(np.clip(table - offset, 0, store.local_n).astype(np.int32)).to(rows.device)
                mask = topk.intervals_to_rowmask(store.local_n, iv)[0].contiguous()
                v, i = topk.topk_masked_plain(rows, q_s, local, mask, k)
            parts_v.append(v.to(dev))
            parts_i.append(torch.where(i >= 0, i + offset, -1).to(dev))
        v, i = torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1)
        order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
        vals, idx = (t.cpu().numpy() for t in topk._raw_to_score(v.gather(1, order), i.gather(1, order)))
        for r, row in enumerate(hits[scope]):
            keep = idx[r] >= 0
            close_up_to_ties(row, list(zip(idx[r][keep].tolist(), vals[r][keep].tolist())), TOL_F32,
                             f"phase 17 (a) {scope} query {r} vs plain")
            close_up_to_ties(row, phase6["hits"][scope][r], TOL_F32, f"phase 17 (a) {scope} query {r} vs phase 6")
        exact_equal[scope] = hits[scope] == phase6["hits"][scope]
    out["a_corpus"] = {
        "mesh": shape_of(mesh_a), "rows": count, "local_rows": store.local_n, "b": qn.shape[0], "k": k,
        "build_s": build_s, "launches": launches_a, "bits_equal_to_phase6": exact_equal,
        "ms_per_batch": {scope: timed_ms(lambda c=c: corpus.search(q_raw, k=k, conversations=c))
                         for scope, c in CORPUS_SCOPES.items()},
        "stage_s": seconds(t_stage),
    }
    del corpus, store, hits  # no cycles hold them: freed here, with no gc pass
    if on_card:
        torch.cuda.empty_cache()

    # (b) a 1M x 384 f32 store on (dp=2, shard=2): the dp split's answers
    # are the one-device store's.
    t_stage = time.perf_counter()
    n, b = sizes["store_rows"], sizes["store_b"]
    gen.manual_seed(SEED + 171)
    rows = torch.nn.functional.normalize(torch.randn((n, D_MAIN), generator=gen, device=dev), dim=1)
    mesh_b = make_mesh(dev, 2, 2)
    one = ShardedVectorStore(D_MAIN, device=dev)
    dp_store = ShardedVectorStore(D_MAIN, mesh=mesh_b)
    for s in (one, dp_store):
        s.reserve(n)
        s.append_device(rows)
    q = normed(rng, b, D_MAIN)
    reset()
    got = dp_store.search(q, k)
    launches_b = take("(b)", ("topk",))
    want = one.search(q, k)
    for r in range(b):
        close_up_to_ties(got[r], want[r], TOL_F32, f"phase 17 (b) query {r}")
    out["b_store"] = {"mesh": shape_of(mesh_b), "rows": n, "b": b, "k": k, "launches": launches_b,
                      "bits_equal_to_one_device": got == want,
                      "ms_per_batch": timed_ms(lambda: dp_store.search(q, k)),
                      "one_device_ms_per_batch": timed_ms(lambda: one.search(q, k)),
                      "stage_s": seconds(t_stage)}
    del one, dp_store

    # (c) the same rows as a bf16 store on (1, 4), saved and restored on
    # (2, 2) and (1, 1): identical answers.
    t_stage = time.perf_counter()
    mesh_c = make_mesh(dev, 1, 4)
    bf16 = ShardedVectorStore(D_MAIN, dtype="bfloat16", mesh=mesh_c)
    bf16.reserve(n)
    bf16.append_device(rows)
    del rows
    reset()
    want = bf16.search(q, k)
    launches_c = take("(c)", ("topk",))
    restored_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        save_sharded_store(bf16, path)
        save_s = seconds(t0)
        state_bytes = sum(os.path.getsize(os.path.join(path, "state", f)) for f in os.listdir(os.path.join(path, "state")))
        require(state_bytes >= n * D_MAIN * 2 and state_bytes < n * D_MAIN * 2 * 1.01,
                f"phase 17 (c): {state_bytes} bytes saved for {n} bf16 rows")
        for shape in ((2, 2), (1, 1)):
            t0 = time.perf_counter()
            restored = restore_sharded_store(make_mesh(dev, *shape), path)
            restore_s = seconds(t0)
            again = restored.search(q, k)
            if on_card:  # every shard's K1 sums a row in one order, whatever the layout
                require(again == want, f"phase 17 (c): restored on {shape} answers otherwise")
            else:  # the CPU's plain matmul rounds by operand shape
                for r in range(b):
                    close_up_to_ties(again[r], want[r], TOL_BF16, f"phase 17 (c) restored on {shape} query {r}")
            restored_out[f"{shape[0]}x{shape[1]}"] = {"restore_s": restore_s, "mesh": shape_of(restored.mesh)}
            del restored
    out["c_checkpoint"] = {"saved_from": shape_of(mesh_c), "rows": n, "dtype": "bfloat16", "save_s": save_s,
                           "state_bytes": state_bytes, "restored": restored_out, "answers_identical": on_card,
                           "launches": launches_c, "stage_s": seconds(t_stage)}
    del bf16

    # (d) ConversationCorpus on the mesh: two conversations, global and
    # scoped search_text, a refresh, save / load; held to one device.
    t_stage = time.perf_counter()
    n_conv, more = sizes["conv_messages"], sizes["conv_more"]
    raw_a = make_corpus(SEED + 172, n_conv, vocab=CONV_VOCAB, speakers=CONV_SPEAKERS)
    raw_b = make_corpus(SEED + 173, n_conv + more, vocab=CONV_VOCAB, speakers=CONV_SPEAKERS)
    settings_device = str(dev)
    conv_a, _ = await ingest(create_conversation, port_settings(D_MAIN, settings_device), ConversationMessage,
                             ConversationMessageMeta, raw_a, 1)
    conv_b, _ = await ingest(create_conversation, port_settings(D_MAIN, settings_device), ConversationMessage,
                             ConversationMessageMeta, raw_b[:n_conv], 1)
    mesh_d = make_mesh(dev, 1, 4)
    on_mesh = ConversationCorpus(dim=D_MAIN, mesh=mesh_d)
    on_one = ConversationCorpus(dim=D_MAIN, device=dev)
    for corpus in (on_mesh, on_one):
        await corpus.add_conversation("a", conv_a)
        await corpus.add_conversation("b", conv_b)
    texts = [raw_a[int(i)]["text"] for i in rng.integers(0, n_conv, sizes["conv_searches"] // 2)]
    texts += [raw_b[int(i)]["text"] for i in rng.integers(0, n_conv, sizes["conv_searches"] // 2)]

    async def corpus_search(corpus) -> list:
        found = []
        for text in texts:
            for scope in (None, ["b"]):
                row = await corpus.search_text(text, k=k, conversations=scope)
                found.append([((h.conversation, h.message_ordinal, h.chunk_ordinal), h.score) for h in row])
        return found

    def same_hits(a: list, b: list, what: str) -> None:
        for r, (x, y) in enumerate(zip(a, b, strict=True)):
            close_up_to_ties(x, y, TOL_F32, f"phase 17 (d) {what} search {r}")

    reset()
    first = await corpus_search(on_mesh)
    launches_d = take("(d)", ("topk", "topk_iv"))
    same_hits(first, await corpus_search(on_one), "before the refresh")
    require(all(row and row[0][1] > 0.999 for row in first[::2]), "phase 17 (d): a message did not find itself")
    await conv_b.add_messages_with_indexing(to_messages(raw_b[n_conv:], ConversationMessage, ConversationMessageMeta))
    t0 = time.perf_counter()
    refreshed = await on_mesh.refresh()
    refresh_s = seconds(t0)
    require(refreshed == more and await on_one.refresh() == more, f"phase 17 (d): refresh appended {refreshed}")
    texts += [raw_b[n_conv + int(i)]["text"] for i in rng.integers(0, more, 2)]
    after = await corpus_search(on_mesh)
    same_hits(after, await corpus_search(on_one), "after the refresh")
    require(after[-2][0][0][0] == "b" and after[-2][0][0][1] >= n_conv, "phase 17 (d): a new message not found")
    loaded_out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mirror")
        t0 = time.perf_counter()
        on_mesh.save(path)
        save_s = seconds(t0)
        for name, mesh in (("2x2", make_mesh(dev, 2, 2)), ("one_device", None)):
            t0 = time.perf_counter()
            loaded = ConversationCorpus.load(path, mesh=mesh, device=dev)
            load_s = seconds(t0)
            await loaded.add_conversation("a", conv_a)  # the embedder; rows resume from the watermarks
            await loaded.add_conversation("b", conv_b)
            require(await loaded.refresh() == 0, "phase 17 (d): a loaded mirror appended rows again")
            same_hits(await corpus_search(loaded), after, f"the mirror loaded on {name}")
            loaded_out[name] = {"load_s": load_s}
    out["d_conversation_corpus"] = {
        "mesh": shape_of(mesh_d), "conversations": 2, "messages": [n_conv, n_conv + more],
        "searches": len(texts) * 2, "launches": launches_d, "refresh_rows": refreshed, "refresh_s": refresh_s,
        "save_s": save_s, "loaded": loaded_out, "equal_to_one_device": True, "stage_s": seconds(t_stage),
    }
    del on_mesh, on_one, conv_a, conv_b

    # (e) phase 12's conversation with a dp = 2 engine mesh: the 16
    # questions' stage 3 equals the one-device engine's.
    t_stage = time.perf_counter()
    if conv_ctx is None:
        raw = make_corpus(SEED, sizes["engine_messages"], vocab=CONV_VOCAB, speakers=CONV_SPEAKERS)
        conv, _ = await ingest(create_conversation, port_settings(D_MAIN, settings_device), ConversationMessage,
                               ConversationMessageMeta, raw, 1)
        conv_ctx = {"conv": conv, "raw": raw}
    conv, raw = conv_ctx["conv"], conv_ctx["raw"]
    questions = make_questions(raw, SEED + 13)
    texts = list(questions)
    use_canned(conv, questions)
    await ask(conv, texts, searchlang)  # a pass that syncs the engine if it has not synced
    single = await ask(conv, texts, searchlang)
    executor = conv._device_executor
    mesh_e = make_mesh(dev, 2, 1)
    conv._device_mesh = executor.mesh = mesh_e  # the synced engine takes the mesh
    dp0 = executor._postings.dp_calls
    reset()
    try:
        dp = await ask(conv, texts, searchlang)
    finally:
        conv._device_mesh = executor.mesh = None
    take("(e)", ())
    dp_calls = executor._postings.dp_calls - dp0
    require(dp_calls > 0, "phase 17 (e): no call went data parallel")
    require(set(dp["routes"]) == {"device"} == set(single["routes"]), f"phase 17 (e): routes {dp['routes']}")
    require(dp["results"] == single["results"], "phase 17 (e): stage 3 on the dp mesh differs from one device")
    require(dp["answers"] == single["answers"], "phase 17 (e): answers on the dp mesh differ")
    out["e_engine"] = {
        "mesh": shape_of(mesh_e), "messages": len(raw), "questions": len(texts), "kinds": list(QUESTION_KINDS),
        "dp_calls": dp_calls, "stage3_equal": True, "answers_equal": True,
        "stage3_ms_dp": round(sum(dp["stage3_ms"]), 3), "stage3_ms_one_device": round(sum(single["stage3_ms"]), 3),
        "query_ms_p50_dp": round(float(np.median(dp["ms"])), 3),
        "query_ms_p50_one_device": round(float(np.median(single["ms"])), 3),
        "stage_s": seconds(t_stage),
    }

    # (f) sharded IVF over shard = 4 on phase 9's clustered rows, beside
    # the one-device IVF; every certified answer is the exact top-k, and
    # the sharded recall against the exact oracle keeps up with one device's.
    t_stage = time.perf_counter()
    if ivf_gen_state is not None:
        gen.set_state(ivf_gen_state)
    else:
        gen.manual_seed(SEED + 9)
    n_ivf, n_q = sizes["ivf_rows"], sizes["ivf_queries"]
    rows, q_host = clustered_rows(gen, dev, n_ivf, sizes["ivf_topics"], n_q)
    mesh_f = make_mesh(dev, 1, 4)
    rpc = sizes["ivf_rows_per_cluster"]
    stores = {"one_device": (ShardedVectorStore(D_MAIN, dtype="bfloat16", search_mode="ivf", device=dev), rpc),
              # Each shard as many clusters as the one-device build: rows per
              # cluster over the shard count.
              "sharded": (ShardedVectorStore(D_MAIN, dtype="bfloat16", search_mode="ivf", mesh=mesh_f), rpc // 4)}
    for s, _ in stores.values():
        s.reserve(n_ivf)
        s.append_device(rows)
    del rows
    one = stores["one_device"][0]
    batches = [q_host[s0 : s0 + 256] for s0 in range(0, n_q, 256)]
    oracle = [row for qb in batches for row in one.search(qb, k)]  # exact: no snapshot yet
    ivf_out = {}
    for name, (s, per_cluster) in stores.items():
        t0 = time.perf_counter()
        s.build_ivf(rows_per_cluster=per_cluster, outlier_frac=0.03)
        build_s = seconds(t0)
        if name == "sharded":
            reset()
        res, certs = [], []
        for qb in batches:
            r, c = s.search_ivf(qb, k)
            res += r
            certs += c
        if name == "sharded":
            launches_f = take("(f)", ("rescore",))
        hit = sum(len({i for i, _ in got} & {i for i, _ in ref}) for got, ref in zip(res, oracle))
        for r, (got, ref, cert) in enumerate(zip(res, oracle, certs)):
            if cert:
                close_up_to_ties(got, ref, TOL_BF16, f"phase 17 (f) {name} certified query {r}")
        ivf_out[name] = {"build_s": build_s, "rows_per_cluster": per_cluster, "recall": hit / (k * n_q),
                         "certified": float(np.mean(certs)),
                         "ms_per_batch256": timed_ms(lambda s=s: s.search_ivf(batches[0], k))}
    require(ivf_out["sharded"]["recall"] >= ivf_out["one_device"]["recall"] - IVF_SHARD_RECALL_MARGIN,
            f"phase 17 (f): sharded IVF recall {ivf_out['sharded']['recall']} trails the one-device "
            f"build's {ivf_out['one_device']['recall']} by more than {IVF_SHARD_RECALL_MARGIN}")
    out["f_sharded_ivf"] = {"mesh": shape_of(mesh_f), "rows": n_ivf, "topics": sizes["ivf_topics"], "queries": n_q,
                            "b": 256, "k": k, "B": stores["sharded"][0].ivf_b, "launches": launches_f, **ivf_out,
                            "stage_s": seconds(t_stage)}
    del stores, one
    if on_card:
        torch.cuda.empty_cache()
    out["launches"] = {name: n for name, n in counts.items() if n}
    out["phase_s"] = round(time.perf_counter() - t_phase, 3)
    out["ok"] = True
    return out, counts


# Phase 18: the tools on the card.


async def golden_eval_routes(device: str) -> dict:
    """``eval_golden.run_eval`` against the committed goldens on the device
    engine, the host VM and approx lookups: each route's exit code (0 when
    every query matches), seconds, launches and last printed line. At the
    fixture's 33 rows every route's lookups take the materialized k > 32
    route; approx reaches no bucket kernel."""
    import io

    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.tools import eval_golden

    routes = {"engine": {}, "host_vm": {"use_device_executor": False}, "approx": {"search_mode": "approx"}}
    out = {}
    for name, kwargs in routes.items():
        printed = io.StringIO()
        topk.reset_launch_counts()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = await eval_golden.run_eval(update=False, device=device, **kwargs)
        lines = printed.getvalue().splitlines()
        out[name] = {"rc": rc, "s": round(time.perf_counter() - t, 3),
                     "launches": {k: v for k, v in topk.launch_counts().items() if v},
                     "last_line": lines[-1] if lines else "", "mismatches": lines[:-1][:8]}
    return out


async def int8_wire_check(dev, n_rows: int = WIRE_ROWS, b: int = WIRE_B, k: int = K_MAIN,
                          seed: int = SEED) -> tuple[dict, dict]:
    """The int8 query wire against the float wire on one bf16 store's rows:
    two stores over the same seed-made unit rows, the same queries (the
    first WIRE_SELF of them rows of the store), sync and through
    ``LookupBatcher``. Fails unless the self-matches come first on both
    wires, recall@k of the int8 wire against the float wire is at least
    WIRE_RECALL, every int8-wire answer equals the plain f32 top-k of its
    dequantized query over the bf16 rows up to ties within TOL_F32, and
    the batcher gives each wire's sync answers (ties within TOL_F32).
    Returns the line's numbers and the launches of the int8 wire's sync
    and batcher runs."""
    import torch

    from typeagent_tpu_torch import vectorstore as vs
    from typeagent_tpu_torch.models.adapters import create_test_embedding_model
    from typeagent_tpu_torch.ops import topk
    from typeagent_tpu_torch.serve import LookupBatcher

    gen = torch.Generator(device=dev).manual_seed(seed + 18)
    rows = torch.randn((n_rows, D_MAIN), generator=gen, device=dev)
    rows /= torch.linalg.norm(rows, dim=1, keepdim=True)
    q = torch.randn((b, D_MAIN), generator=gen, device=dev)
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    q[:WIRE_SELF] = rows[:WIRE_SELF]
    queries = q.cpu().numpy()
    stores = {}
    for wire in ("auto", "int8"):
        stores[wire] = vs.VectorStore(vs.TextEmbeddingIndexSettings(
            create_test_embedding_model(D_MAIN), min_score=0.0, dtype="bfloat16", query_wire=wire, device=dev))
        stores[wire].load_device_rows(rows)
    del rows

    def hits(rows_of_hits):
        return [[(h.item, h.score) for h in row] for row in rows_of_hits]

    topk.reset_launch_counts()
    sync = {wire: hits(st.fuzzy_lookup_embeddings_batch(queries, max_hits=k)) for wire, st in stores.items()}
    launches = topk.launch_counts()  # the float wire's and the int8 wire's
    for wire, got in sync.items():
        for i in range(WIRE_SELF):
            require(got[i][0][0] == i, f"phase 18 (b) {wire} wire: query {i} found {got[i][0]} first")
    recall = float(np.mean([len({o for o, _ in a} & {o for o, _ in f}) / k
                            for a, f in zip(sync["int8"], sync["auto"])]))
    require(recall >= WIRE_RECALL, f"phase 18 (b): int8-wire recall@{k} {recall} < {WIRE_RECALL}")

    # The plain version: the same dequantized queries against the store's
    # bf16 rows, f32 products (no TF32), a stable descending sort.
    b_pad, dim_pad = vs._bucket(b), stores["int8"]._dim_pad
    q_deq = vs._int8_wire_upload(queries, (b_pad, dim_pad), D_MAIN, dev)[:b, :D_MAIN]
    buf = stores["int8"]._buf[:n_rows, :D_MAIN].float()
    scores = ((q_deq @ buf.T + 1.0) * 0.5).clamp(0.0, 1.0)
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()
    del buf, scores
    err = 0.0
    for r in range(b):
        want = list(zip(idx[r].tolist(), vals[r].tolist()))
        close_up_to_ties(sync["int8"][r], want, TOL_F32, f"phase 18 (b) int8 wire query {r} vs plain")
        err = max(err, max(abs(x - y) for (_, x), (_, y) in zip(sync["int8"][r], want)))

    async def through_batcher(store):
        batcher = LookupBatcher(store, max_delay_ms=1.0, max_coalesce=8)
        per = b // WIRE_REQUESTS
        try:
            got = await asyncio.gather(*(batcher.lookup(queries[i * per:(i + 1) * per], max_hits=k)
                                         for i in range(WIRE_REQUESTS)))
        finally:
            await batcher.close()
        return [row for group in got for row in hits(group)], batcher.dispatches

    topk.reset_launch_counts()
    served, dispatches = {}, {}
    for wire, st in stores.items():
        served[wire], dispatches[wire] = await through_batcher(st)
        for r in range(b):
            close_up_to_ties(served[wire][r], sync[wire][r], TOL_F32, f"phase 18 (b) {wire} batcher query {r}")
    for name, n in topk.launch_counts().items():
        launches[name] += n
    for name in ("bucket_maxima", "rescore"):
        require(launches[name] > 0, f"phase 18 (b): the {name} kernel never ran ({launches})")

    # Host clock, the two wires in turns (float, int8, int8, float, ...).
    times = {"auto": [], "int8": []}
    for i in range(WIRE_TIMED):
        for wire in (("auto", "int8") if i % 2 == 0 else ("int8", "auto")):
            t = time.perf_counter()
            stores[wire].fuzzy_lookup_embeddings_batch(queries, max_hits=k)
            times[wire].append((time.perf_counter() - t) * 1000)
    out = {
        "rows": n_rows, "b": b, "k": k, "recall_at_k_int8_vs_float": recall,
        "self_matches_first": WIRE_SELF, "max_abs_err_vs_plain": err,
        "upload_bytes_per_batch": {"float": b_pad * dim_pad * 4, "int8": b_pad * dim_pad + b_pad * 4},
        "p50_ms": {"float": float(np.median(times["auto"])), "int8": float(np.median(times["int8"]))},
        "batcher_dispatches": dispatches,
        "launches": {name: n for name, n in launches.items() if n},
    }
    return out, launches


async def tools_phase(dev) -> tuple[dict, dict]:
    """Phase 18: the golden eval's three routes, the int8 query wire, and
    two benchmark tools as subprocesses, on the card. The cyclic garbage
    collector is off for the phase, as for phase 17."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        return await _tools_stages(dev)
    finally:
        if enabled:
            gc.enable()


async def _tools_stages(dev) -> tuple[dict, dict]:
    import tempfile

    import torch

    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    out: dict = {"phase": 18, "name": "tools", "device": name}
    evals = await golden_eval_routes(dev.type)
    for name, run in evals.items():
        require(run["rc"] == 0, f"phase 18 (a): the golden eval on the {name} route: {run}")
    out["a_golden_eval"] = evals
    out["b_int8_wire"], launches = await int8_wire_check(dev)
    env = dict(os.environ)
    with tempfile.TemporaryDirectory() as tmp:
        vec = await run_cli(["typeagent_tpu_torch.tools.benchmark_vectorstore", "--sizes", "100000",
                             "--iterations", "10", "--batch", "1", "256", "--device", "cuda"],
                            os.path.join(tmp, "bench_vectorstore.log"), env, timeout=300)
        serve = await run_cli(["typeagent_tpu_torch.tools.benchmark_serve", "--rows", "1000000", "--r", "8",
                               "--wire", "int8", "--device", "cuda"],
                              os.path.join(tmp, "bench_serve.log"), env, timeout=300)
    out["c_tools"] = {"benchmark_vectorstore": {**cli_ran("phase 18 (c) benchmark_vectorstore", vec),
                                                "tail": vec["tail"][-4:]},
                      "benchmark_serve": {**cli_ran("phase 18 (c) benchmark_serve --wire int8", serve),
                                          "tail": serve["tail"][-6:]}}
    out["phase_s"] = round(time.perf_counter() - t0, 3)
    return out, launches


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description="The port's smoke, on one CUDA card.")
    parser.add_argument("--front-doors", action="store_true", help="build the kernels and run phase 16 alone")
    parser.add_argument("--turns", type=int, default=POD_TURNS, help="phase 16's turns per podcast archive")
    parser.add_argument("--mesh", action="store_true",
                        help="build the kernels and run phase 17 alone (its own references)")
    parser.add_argument("--tools", action="store_true", help="build the kernels and run phase 18 alone")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from typeagent_tpu_torch.models.adapters import create_test_embedding_model
    from typeagent_tpu_torch.ops import _build, int4, ivf, topk
    from typeagent_tpu_torch.parallel import CorpusVectorStore
    from typeagent_tpu_torch.serve import LookupBatcher
    from typeagent_tpu_torch.utils.metrics import METRICS
    from typeagent_tpu_torch.vectorstore import TextEmbeddingIndexSettings, VectorStore

    if args.front_doors:
        print(smi_line(), flush=True)
        _build.kernels()
        out16, _ = asyncio.run(front_doors_phase(torch.device("cuda", 0), n_turns=args.turns))
        out16.update({"nvidia_smi": smi_line(), "ok": True})
        emit(out16)
        return 0
    if args.mesh:
        print(smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.kernels()
        out17, _ = asyncio.run(mesh_phase(torch.device("cuda", 0)))
        out17.update({"nvidia_smi": smi_line(), "ok": True})
        emit(out17)
        return 0
    if args.tools:
        print(smi_line(), flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _build.kernels()
        out18, _ = asyncio.run(tools_phase(torch.device("cuda", 0)))
        out18.update({"nvidia_smi": smi_line(), "ok": True})
        emit(out18)
        return 0

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

    def host_ms(fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1000 / iters

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
    distinct = torch.unique(ids).numel()
    gathered = buf[topk._bucket_row_ids(ids).long()]  # [256, B*128, d_pad]: the product's operand
    record("rescore",
           in_turns(cuda_ms, lambda: topk.rescore_selected(buf, qd, ids),
                    lambda: topk.rescore_selected_plain(buf, qd, ids)),
           rescore_bound(ids, 256, d_pad),
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
    def corpus_phase(phase, dtype, seg_rows, tol, probe_floor, with_subset, keep=None):
        """Build the fragmented corpus on the card, drive its searches once
        (the counted main path), then hold each against its kernel and the
        kernel against its plain version. Returns the phase's line; ``keep``
        (a dict) gets the generator state the rows came from, the queries
        and the hits of the scoped searches, for phase 17."""
        torch.cuda.reset_peak_memory_stats()
        corpus = CorpusVectorStore(D_MAIN, device="cuda", dtype=dtype)
        if keep is not None:
            keep["gen_state"] = gen.get_state()
        t0 = time.perf_counter()
        build_corpus(corpus, gen, dev, seg_rows, CORPUS_CHUNK)
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
        scopes = dict(CORPUS_SCOPES)

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
        if keep is not None:
            keep["q_raw"] = q_raw
            keep["hits"] = {scope: [[(h.global_ordinal, h.score) for h in row] for row in results[scope]]
                            for scope in CORPUS_SCOPES}
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
    phase6: dict = {}  # phase 17 builds the same corpus on a mesh and holds it to these hits
    emit(corpus_phase(6, "float32", CORPUS_F32_SEG_ROWS, TOL_F32, 1 - 1e-6, True, keep=phase6))
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
        return clustered_rows(gen, dev, n, topics, n_queries)

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
    ivf_gen_state = gen.get_state()  # the 1M rows' source, for phase 17
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

    # 12. a conversation on the card through the port's entry points.
    gc.collect()
    torch.cuda.empty_cache()
    out12, counts12, conv, raw = asyncio.run(conversation_phase(dev))
    add_path_launches(counts12)
    out12.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out12)

    # 13. query() on that conversation, its CPU twin, streaming ingest.
    seq13, out13 = asyncio.run(query_phase(dev, conv, raw))
    out13.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out13)

    # 14. the device query engine against the host VM on that conversation.
    out14 = asyncio.run(engine_phase(dev, conv, raw))
    memory_terms = conv.secondary_indexes.term_to_related_terms_index.fuzzy_index._texts
    out14.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out14)

    # 15. the same conversation in SQLite, reopened cold on the card; the CLIs.
    phase13 = {"conv": conv, "run": seq13, "engine_first_sync_ms": out13["engine_first_sync_ms"],
               "ingest_s": out12["ingest_s"], "messages_per_s": out12["messages_per_s"],
               "related_terms": set(memory_terms), "related_terms_rows": len(memory_terms)}
    out15, counts15 = asyncio.run(sqlite_phase(dev, raw, phase13))
    del seq13, phase13, memory_terms  # phase 17 asks the conversation again
    add_path_launches(counts15)
    out15.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out15)

    # 16. the front doors: HTTP models, the email CLIs, query() on a
    # mailbox, the MCP server, the conversation corpus.
    gc.collect()
    torch.cuda.empty_cache()
    out16, counts16 = asyncio.run(front_doors_phase(dev, n_turns=args.turns))
    add_path_launches(counts16)
    out16.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out16)

    # 17. the multi-device layer: meshes, row-sharded stores, sharded IVF,
    # checkpoints across mesh shapes, the engine's dp dispatch. (No gc pass:
    # phase 12's conversation is still alive, and a pass over its millions
    # of objects costs seconds.)
    torch.cuda.empty_cache()
    out17, counts17 = asyncio.run(mesh_phase(dev, phase6=phase6, ivf_gen_state=ivf_gen_state,
                                             conv_ctx={"conv": conv, "raw": raw}))
    del conv, raw
    add_path_launches(counts17)
    out17.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out17)

    # 18. the tools: the golden eval's three routes, the int8 query wire,
    # two benchmark tools as subprocesses.
    torch.cuda.empty_cache()
    out18, counts18 = asyncio.run(tools_phase(dev))
    add_path_launches(counts18)
    out18.update({"nvidia_smi": smi_line(), "ok": True})
    emit(out18)

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
    rc = main()
    # Once the result is printed, skip the interpreter's teardown, which
    # took ~30 s on the card after the last line (the earlier phases' live
    # objects, millions of them in reference cycles, and idle worker
    # threads). Every subprocess has been waited for by now.
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
