"""Device IVF: learned 128-row buckets, an exact outlier tail and a
certified rescore (port of ``typeagent_tpu/ops/ivf.py``).

On clustered corpora (the structure real text embeddings have) a coarse
quantizer prunes almost every row, so a query reads a few buckets instead
of the store:

* Build: k-means (Lloyd on a training sample) assigns every live row to
  one of ``n / rows_per_cluster`` clusters. The ``outlier_frac``
  worst-fitting rows (lowest best-centroid score) are exiled to a tail
  buffer; the rest are reordered by cluster into 128-row buckets, each
  cluster's region padded to a bucket boundary, with per-bucket f32
  centroid ``c`` and radius ``r = max ||x - c||``.
* Query phase 1: ``bound = q.c + r`` per bucket bounds every row score in
  the bucket (Cauchy-Schwarz). Buckets are selected by ``q.c``.
* Query phase 2: the selected buckets are rescored exactly (K3,
  ``ops.topk.rescore_selected``).
* Exact tail: the outliers are searched by the two-phase exact route (K2 +
  K3) and merged.
* Certificate: ``max excluded-bucket bound <= k-th merged score + eps``,
  ANDed with the tail's; a certified answer is the exact top-k up to eps
  ties, on any data.

Differences from the JAX build, none visible in results: cluster sums use
``index_add_`` (the TPU's one-hot matmuls worked around its slow scatter),
the cluster axis is not windowed (a TPU tiling cliff), there are no host
round-trip or memory-budget paths (the card holds the store and its
reordered copy), the k-means sample comes from a ``torch.Generator``
seeded with ``key`` (the JAX PRNG's bits cannot be reproduced), and build
phases are timed in ``utils.metrics.METRICS`` (``ivf.build.*``).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from ..utils.metrics import METRICS
from .append import round_up
from . import topk
from .topk import _BUCKET_ROWS, _NEG, _RAW_NEG, _raw_to_score

__all__ = [
    "IVFState",
    "ivf_build",
    "ivf_build_from_centroids",
    "ivf_topk",
    "ivf_topk_program",
    "adopt_ivf_state",
]

# Phase-1 bound vs phase-2 rescore skew: centroids and radii are f32
# reductions of the rows (exact for bf16/f32 stores) and the rescore
# computes the same f32 dots, so only summation order differs. Compared in
# the public (cos+1)/2 score space.
_CERT_EPS_IVF = 1e-5
_BOUND_DEAD = -3.0e4  # radius of a bucket with no live row

# Rows per step of the build's products: bounds the [chunk, clusters] score
# block (1.25 GB at 10M rows' 19,531 clusters) and the f32 copy of a chunk.
_TRAIN_CHUNK = 8192
_ASSIGN_CHUNK = 16384
_GATHER_CHUNK = 131_072  # rows per reorder-gather step
_SUMMARY_BUCKETS = 512  # buckets per summary step (~100 MB f32 at d=384)


class IVFState(NamedTuple):
    """A built IVF index over a snapshot of the store.

    ``emb_r`` holds the inlier rows reordered by cluster (padding zeroed);
    ``perm[i]`` is the original ordinal of reordered row i (-1 padding).
    ``out_emb``/``out_perm`` are the exiled outliers, searched exactly.
    The nine fields are those of the JAX ``IVFState``, in its order.
    """

    emb_r: torch.Tensor  # [n_in_pad, d_pad] store dtype, cluster-ordered
    perm: torch.Tensor  # [n_in_pad] i32 original ordinals (-1 = padding)
    centroids: torch.Tensor  # [nb, d_pad] f32 bucket means
    radius: torch.Tensor  # [nb] f32 max residual norm (dead: _BOUND_DEAD)
    bucket_fill: torch.Tensor  # [nb] i32 live rows per bucket (a bucket's
    # dead rows are always its tail: cluster regions pack from their start)
    count_in: int  # live inlier rows
    out_emb: torch.Tensor  # [m_pad, d_pad] store dtype outlier rows
    out_perm: torch.Tensor  # [m_pad] i32 original ordinals (-1 = padding)
    count_out: int  # live outlier rows

    @property
    def n_buckets(self) -> int:
        return self.centroids.shape[0]


def adopt_ivf_state(
    arrays, device: str | torch.device, dtype: torch.dtype = torch.float32
) -> IVFState:
    """The port's :class:`IVFState` from the nine arrays of a JAX
    ``IVFState`` (as numpy, in field order), on ``device``; the row arrays
    take the store ``dtype`` (bf16 rows pass through f32 exactly)."""
    (emb_r, perm, centroids, radius, fill, count_in, out_emb, out_perm, count_out) = arrays

    def rows(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)

    def vec(a, np_dtype):
        return torch.from_numpy(np.array(a, dtype=np_dtype)).to(device)

    return IVFState(
        rows(emb_r), vec(perm, np.int32), vec(centroids, np.float32),
        vec(radius, np.float32), vec(fill, np.int32), np.asarray(count_in).item(),
        rows(out_emb), vec(out_perm, np.int32), np.asarray(count_out).item(),
    )


@contextlib.contextmanager
def _timed(name: str, device: torch.device):
    """A ``METRICS`` timer (``ivf.build.<name>``) around one build phase,
    which waits for the phase's device work before it stops."""
    with METRICS.timer(f"ivf.build.{name}"):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _chunked_assign(rows: torch.Tensor, centroids: torch.Tensor, chunk: int):
    """(best cluster, best score) per row, chunk by chunk: no [n, clusters]
    matrix and no f32 copy of a bf16 store is ever whole. Operands are
    rounded to bf16 and multiplied in f32 (exact products, f32 sums), as
    the JAX build's bf16 x bf16 -> f32 product: assignment only
    partitions; soundness comes from the f32 summaries computed after."""
    cc = centroids.to(torch.bfloat16).float()
    best_i = torch.empty((rows.shape[0],), dtype=torch.int64, device=rows.device)
    best_v = torch.empty((rows.shape[0],), dtype=torch.float32, device=rows.device)
    for start in range(0, rows.shape[0], chunk):
        block = rows[start : start + chunk].to(torch.bfloat16).float()
        # max() returns the first maximal cluster, as jnp.argmax.
        v, i = (block @ cc.T).max(dim=1)
        best_v[start : start + chunk] = v
        best_i[start : start + chunk] = i
    return best_i, best_v


def _train_centroids(
    emb: torch.Tensor, count: int, generator: torch.Generator, *,
    train_rows: int, iters: int, nb: int,
) -> torch.Tensor:
    """Lloyd's k-means on ``train_rows`` sampled live rows; ``nb`` unit
    centroids, f32. Empty clusters keep their centroid."""
    dev = emb.device
    high = max(count, 1)
    idx = torch.randint(0, high, (train_rows,), generator=generator, device=dev)
    train = emb[idx].float()  # gather first: never an f32 copy of the store
    init_idx = torch.randint(0, high, (nb,), generator=generator, device=dev)
    centroids = emb[init_idx].float()
    for _ in range(iters):
        assign, _ = _chunked_assign(train, centroids, _TRAIN_CHUNK)
        sums = torch.zeros_like(centroids).index_add_(0, assign, train)
        counts = torch.bincount(assign, minlength=nb).float()
        means = sums / counts.clamp(min=1.0)[:, None]
        c2 = torch.where(counts[:, None] > 0, means, centroids)
        norm = torch.linalg.vector_norm(c2, dim=1, keepdim=True)
        centroids = torch.where(norm > 1e-9, c2 / norm, c2)
    return centroids


def _layout(assign: np.ndarray, fit: np.ndarray, count: int, nb_clusters: int, outlier_frac: float):
    """Host bookkeeping (numpy, as the JAX build): exile the worst-fitting
    rows, order the rest cluster-major (stable), and pad each cluster's
    region to a 128-row boundary. Returns ``(perm, out_perm, n_in, m)``."""
    a = assign[:count].astype(np.int64)
    s = fit[:count]
    m = int(count * outlier_frac)
    order_by_fit = np.argsort(s, kind="stable")  # worst fit first
    out_ids = np.sort(order_by_fit[:m]).astype(np.int32)
    in_mask = np.ones(count, dtype=bool)
    in_mask[out_ids] = False
    in_ids = np.nonzero(in_mask)[0].astype(np.int32)
    in_ids = in_ids[np.argsort(a[in_ids], kind="stable")]  # cluster-major
    a_sorted = a[in_ids]
    # Cluster c's rows land at [aligned_off[c], aligned_off[c] + size[c]);
    # the rest of its region is dead (-1) padding.
    sizes = np.bincount(a_sorted, minlength=nb_clusters).astype(np.int64)
    padded = ((sizes + _BUCKET_ROWS - 1) // _BUCKET_ROWS) * _BUCKET_ROWS
    aligned_off = np.concatenate([[0], np.cumsum(padded)[:-1]])
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    pos_in_cluster = np.arange(len(in_ids), dtype=np.int64) - starts[a_sorted]
    dest = aligned_off[a_sorted] + pos_in_cluster
    n_in_pad = round_up(max(int(padded.sum()), 1), 1024)
    m_pad = round_up(max(m, 1), 1024)
    perm = np.full(n_in_pad, -1, np.int32)
    perm[dest] = in_ids
    out_perm = np.full(m_pad, -1, np.int32)
    out_perm[:m] = out_ids
    return perm, out_perm, len(in_ids), m


def _gather_rows(emb: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Rows by a -1-padded permutation (padding rows zero), chunk by chunk:
    peak memory is the store, the output and one chunk."""
    out = torch.zeros((perm.shape[0], emb.shape[1]), dtype=emb.dtype, device=emb.device)
    for start in range(0, perm.shape[0], _GATHER_CHUNK):
        p = perm[start : start + _GATHER_CHUNK].long()
        rows = emb[p.clamp(min=0)]
        out[start : start + p.shape[0]] = rows.masked_fill((p < 0)[:, None], 0)
    return out


def _bucket_summaries(emb_r: torch.Tensor, perm: torch.Tensor):
    """Per-bucket (centroid, radius, fill) in f32, a block of buckets at a
    time (a whole-store f32 copy never exists)."""
    d_pad = emb_r.shape[1]
    nb = emb_r.shape[0] // _BUCKET_ROWS
    cent = torch.zeros((nb, d_pad), dtype=torch.float32, device=emb_r.device)
    radius = torch.full((nb,), _BOUND_DEAD, dtype=torch.float32, device=emb_r.device)
    fill = torch.zeros((nb,), dtype=torch.int32, device=emb_r.device)
    for b0 in range(0, nb, _SUMMARY_BUCKETS):
        cb = min(_SUMMARY_BUCKETS, nb - b0)
        r0, r1 = b0 * _BUCKET_ROWS, (b0 + cb) * _BUCKET_ROWS
        rows = emb_r[r0:r1].float().view(cb, _BUCKET_ROWS, d_pad)
        valid = (perm[r0:r1] >= 0).view(cb, _BUCKET_ROWS)
        w = valid.float()
        n_live = w.sum(dim=1)
        c = (rows * w[:, :, None]).sum(dim=1) / n_live.clamp(min=1.0)[:, None]
        resid = torch.linalg.vector_norm(rows - c[:, None, :], dim=2)
        r = resid.masked_fill(~valid, float("-inf")).amax(dim=1)
        cent[b0 : b0 + cb] = c
        radius[b0 : b0 + cb] = torch.where(n_live > 0, r, _BOUND_DEAD)
        fill[b0 : b0 + cb] = n_live.to(torch.int32)
    return cent, radius, fill


def _check_memory(emb: torch.Tensor, n_rows: int) -> None:
    """Fail with a clear message when the reordered copy cannot fit next to
    the store (free device memory plus what PyTorch holds cached)."""
    if emb.device.type != "cuda":
        return
    free, _total = torch.cuda.mem_get_info(emb.device)
    cached = torch.cuda.memory_reserved(emb.device) - torch.cuda.memory_allocated(emb.device)
    need = n_rows * emb.shape[1] * emb.element_size()
    if need > free + cached:
        raise RuntimeError(
            f"IVF build needs {need / 1e9:.2f} GB for the reordered rows; "
            f"{(free + cached) / 1e9:.2f} GB free on {emb.device}"
        )


def _check_build_args(emb: torch.Tensor, count: int) -> int:
    n_pad = emb.shape[0]
    if n_pad % _BUCKET_ROWS:
        raise ValueError(f"store padding must be a multiple of {_BUCKET_ROWS}")
    count = int(count)
    if not 0 < count <= n_pad:
        raise ValueError(f"count {count} out of range for buffer {n_pad}")
    return count


def ivf_build_from_centroids(
    emb: torch.Tensor, count: int, centroids: torch.Tensor, *, outlier_frac: float = 0.1
) -> IVFState:
    """Everything after k-means training: assign the live rows to
    ``centroids`` ([clusters, d_pad] f32), exile and lay out (host),
    reorder (device) and summarize the buckets. Given the JAX package's
    centroids it reproduces the JAX build, up to assignment near-ties."""
    count = _check_build_args(emb, count)
    dev = emb.device
    centroids = centroids.to(device=dev, dtype=torch.float32)
    with _timed("assign", dev):
        assign, best = _chunked_assign(emb[:count], centroids, _ASSIGN_CHUNK)
        # Fit scores only order the exile; rounding them to f16 (as the JAX
        # build does before its fetch) keeps the exile order identical.
        a = assign.to(torch.int32).cpu().numpy()
        s = best.to(torch.float16).cpu().numpy()
        del assign, best
    with _timed("layout", dev):
        perm, out_perm, n_in, m = _layout(a, s, count, centroids.shape[0], outlier_frac)
    with _timed("gather", dev):
        _check_memory(emb, perm.shape[0] + out_perm.shape[0])
        perm_d = torch.from_numpy(perm).to(dev)
        out_perm_d = torch.from_numpy(out_perm).to(dev)
        emb_r = _gather_rows(emb, perm_d)
        out_emb = _gather_rows(emb, out_perm_d)
    with _timed("summaries", dev):
        cent, radius, fill = _bucket_summaries(emb_r, perm_d)
    return IVFState(emb_r, perm_d, cent, radius, fill, n_in, out_emb, out_perm_d, m)


def ivf_build(
    emb: torch.Tensor,
    count: int,
    *,
    key: int = 0,
    train_rows: int = 131072,
    iters: int = 8,
    outlier_frac: float = 0.1,
    rows_per_cluster: int = 512,
) -> IVFState:
    """Build an IVF index over the live rows ``[0, count)`` of a padded
    store buffer. ``key`` seeds the k-means sample's ``torch.Generator``.

    Every cluster's region is padded to a 128-row boundary so that no
    bucket straddles two clusters (a straddling bucket's radius balloons
    and poisons selection and certificate); dead rows carry perm -1."""
    count = _check_build_args(emb, count)
    n_pad = emb.shape[0]
    nb_clusters = max(n_pad // rows_per_cluster, 1)
    # Lloyd needs enough sample mass per cluster (>= 16 rows each).
    train_rows = min(max(train_rows, 16 * nb_clusters), n_pad, count)
    generator = torch.Generator(device=emb.device)
    generator.manual_seed(int(key))
    with _timed("train", emb.device):
        centroids = _train_centroids(
            emb, count, generator, train_rows=train_rows, iters=iters, nb=nb_clusters
        )
    return ivf_build_from_centroids(emb, count, centroids, outlier_frac=outlier_frac)


def _ivf_topk(
    emb_r, perm, centroids, radius, bucket_fill, count_in, out_emb, out_perm,
    count_out, queries, *, k: int, B: int,
):
    """Port of ``_ivf_topk_impl``: ``(scores [b, k], ordinals [b, k],
    cert [b])``."""
    del count_in  # the fill counts carry inlier validity
    b = queries.shape[0]
    qs = queries.float()
    qc = qs @ centroids.T  # [b, nb]
    dead = radius <= _BOUND_DEAD
    # Select by raw centroid score (selecting by the bound lets a few
    # large-radius buckets take every query's budget); the bound serves
    # only the certificate, over the excluded buckets.
    sel_key = torch.where(dead[None, :], 2.0 * _BOUND_DEAD, qc)
    bounds = torch.where(dead[None, :], 2.0 * _BOUND_DEAD, qc + radius[None, :])
    nb = centroids.shape[0]
    if B < nb:
        # An exact selection (the JAX package takes lax.approx_max_k past
        # 4,096 buckets); the count guard stays as it is.
        top_qc, sel = torch.topk(sel_key, B, dim=1)
        q_bth = top_qc[:, B - 1 : B]  # weakest selected bucket
        # Buckets strictly below the weakest selected are certainly
        # excluded; boundary ties are ambiguous and refuse certification.
        excl_raw = torch.where(sel_key < q_bth, bounds, 2.0 * _BOUND_DEAD).amax(dim=1)
        ties_ok = (sel_key >= q_bth).sum(dim=1) == B
    else:
        sel = torch.arange(nb, device=qs.device)[None, :].expand(b, nb)
        excl_raw = torch.full((b,), 2.0 * _BOUND_DEAD, device=qs.device)
        ties_ok = torch.ones((b,), dtype=torch.bool, device=qs.device)
        B = nb
    sel = sel.clamp(0, nb - 1).to(torch.int32).contiguous()
    lanes = torch.arange(_BUCKET_ROWS, dtype=torch.int32, device=qs.device)
    row_ids = (sel[:, :, None] * _BUCKET_ROWS + lanes).reshape(b, B * _BUCKET_ROWS)
    raw = topk.rescore_selected(emb_r, queries, sel)
    # Dead rows sit at a bucket's tail: validity is a [b, B] fill gather.
    fill_sel = bucket_fill[sel.long()]
    valid = (lanes[None, None, :] < fill_sel[:, :, None]).reshape(b, B * _BUCKET_ROWS)
    raw = torch.where(valid, raw, _RAW_NEG)
    k_in = min(k, B * _BUCKET_ROWS)
    vals_r, pos = torch.topk(raw, k_in, dim=1)
    sv1, si1 = _raw_to_score(vals_r, row_ids.gather(1, pos))
    si1 = torch.where(si1 >= 0, perm[si1.clamp(0, perm.shape[0] - 1).long()], -1)

    # Exact tail: the outliers through the two-phase exact route (K2 + K3);
    # its certificate ANDs into ours.
    k_out = min(k, out_emb.shape[0])
    sv2, si2, cert_tail = topk.cosine_topk_exact2(out_emb, queries, count_out, k_out)
    si2 = torch.where(si2 >= 0, out_perm[si2.clamp(0, out_perm.shape[0] - 1).long()], -1)

    sv = torch.cat([sv1, sv2], dim=1)
    si = torch.cat([si1, si2], dim=1)
    kk = min(k, sv.shape[1])
    vals, pos = torch.topk(sv, kk, dim=1)
    idx = si.gather(1, pos)

    # Certificate in the public score space (a monotone map; the clip is
    # sound: a bound below -1 beats nothing, above +1 the check fails).
    excl_score = ((excl_raw + 1.0) * 0.5).clamp(0.0, 1.0)
    kth = torch.where(vals[:, kk - 1] > _NEG, vals[:, kk - 1], -1.0)
    cert = cert_tail & ties_ok & (excl_score <= kth + _CERT_EPS_IVF * 0.5)
    return vals, idx, cert


def ivf_topk_program(
    emb_r, perm, centroids, radius, bucket_fill, count_in, out_emb, out_perm,
    count_out, queries: torch.Tensor, k: int, *, B: int = 16,
):
    """IVF top-k over an unpacked :class:`IVFState` and a ``[b, d_pad]``
    f32 query block. Returns ``(scores [b, k], ordinals [b, k], cert [b])``:
    scores in the public (cos+1)/2 space, ordinals the ORIGINAL row ids,
    cert True where the answer is provably the exact top-k (up to eps
    ties)."""
    return _ivf_topk(
        emb_r, perm, centroids, radius, bucket_fill, count_in, out_emb, out_perm,
        count_out, queries, k=k, B=min(B, centroids.shape[0]),
    )


def ivf_topk(state: IVFState, queries: torch.Tensor | np.ndarray, k: int, *, B: int = 16):
    """Top-k over a built IVF index (host entry point); a 1-D query gives
    1-D outputs."""
    if isinstance(queries, np.ndarray):
        queries = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32))
    queries = queries.to(device=state.emb_r.device, dtype=torch.float32)
    if queries.dim() == 1:
        vals, idx, cert = ivf_topk(state, queries[None, :], k, B=B)
        return vals[0], idx[0], cert[0]
    return ivf_topk_program(*state, queries.contiguous(), k, B=B)
