// Fused cosine top-k (k <= 32) over a padded embedding store: K1 and its
// scoped and int8 variants K4-K7, one scan kernel with three template
// parameters (the row type, the row filter and the query block) and one
// merge kernel.
//
// Replaces (typeagent_tpu/ops/topk.py), each with its _mask_and_fold /
// _fold_tile_into_topk:
//   K1 _topk_kernel     (_topk_pallas_impl)     rows f32/bf16, no filter
//   K4 _topk_kernel_iv  (_topk_pallas_iv_impl)  rows f32/bf16, <= 8 intervals
//   K5 _topk_kernel_m   (_topk_pallas_m_impl)   rows f32/bf16, i32 row mask
//   K6 _topk_kernel_q   (_topk_pallas_q_impl)   rows int8 + f32 scales
//   K7 _topk_kernel_mq  (_topk_pallas_mq_impl)  rows int8 + scales + mask
//
// What bounds it on an H100: at serving batches the FP32 FFMA rate. The
//   score tile is plain FFMA because f32 stores must match
//   Precision.HIGHEST (no TF32): 2*b*n*d operations, 197 GFLOP for b=256
//   over 1M x 384, 2.9 ms at the 67 TFLOP/s FP32 peak. At b <= 8 the store
//   read (n*d*itemsize bytes, 0.46 ms for 1M x 384 f32) bounds it instead.
//   The filters cost one compare per row and tile (an i32 read per row for
//   the mask); an int8 row costs a quarter of an f32 row's bytes but the
//   same FFMAs.
//
// Design: the TPU kernel carries its running top-k in a VMEM output block
//   across a grid that runs in order. CTAs run in no order, so the search
//   is two launches. (1) scan: grid = query blocks x row splits, one wave
//   of two CTAs per SM (ops/topk.py scan_geometry); each CTA walks its
//   split with the register-blocked, cp.async-fed tile of tile.cuh
//   (scan_tiles), never writes scores to device memory, and keeps each
//   query's running top-k in registers across one warp (lane j holds entry
//   j): after each tile, warp w reads its TQ queries' 128 scores from the
//   shared score block lane by lane, in ascending row order, at one ballot
//   per query and 32 rows once the list is warm, the counterpart of the
//   JAX kernel's "n_above == 0" tier. It writes [b, splits, k] candidates.
//   (2) merge: one warp per query folds the splits' lists, in split order,
//   into the final [b, k]. Both passes insert equal values in ascending
//   row order, so ties go to the lowest row as in the JAX kernel. Unfilled
//   slots are (-3.0, -1). The query block (8, 16, 32 or 64 queries: TQ =
//   1, 2, 4, 8) follows the batch (ops/topk.py topk_query_block), so a
//   batch of 8 scores no padding queries while b = 256 streams the store 4
//   times.
//
// Filters and scales: a row at or past `count`, or outside the scope, is
//   offered as RAW_NEG and never enters a list. The interval table (K4) is
//   copied to shared memory once per CTA; the mask (K5, K7) is read by the
//   lane that owns the row. An int8 row is upcast exactly and scored against
//   the bf16-rounded query; its scale multiplies the f32 dot afterwards, as
//   the JAX kernel does (raw * s_ref), never the row before the dot.

#include "tile.cuh"

namespace tat {

enum RowFilter { kNoFilter = 0, kIntervals = 1, kMask = 2 };
constexpr int MAX_INTERVALS = 8;  // the JAX _PALLAS_MAX_INTERVALS

// What a filtered or int8 scan reads beside the rows; unused fields are null.
struct ScanExtras {
  const float* scales;     // int8 rows: per-row scale [n_rows]
  const int* intervals;    // kIntervals: [n_intervals, 2] half-open spans
  int n_intervals;
  const int* mask;         // kMask: [n_rows], > 0 = searchable
};

template <typename T, int F, int TQ>
__global__ void __launch_bounds__(THREADS, 2)
    topk_scan_kernel(const T* __restrict__ emb, const float* __restrict__ q,
                     int64_t n_rows, int d_pad, int b, int64_t count, int k,
                     int64_t rows_per_split, int splits, ScanExtras x,
                     float* cand_vals, int* cand_idx) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int iv[2 * MAX_INTERVALS];
  constexpr int QB = FfmaTile<TQ>::QB;
  const int n_qb = (b + QB - 1) / QB;
  const int qb = blockIdx.x % n_qb;
  const int split = blockIdx.x / n_qb;
  const int q0 = qb * QB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (F == kIntervals) {
    if (threadIdx.x < 2 * x.n_intervals) iv[threadIdx.x] = x.intervals[threadIdx.x];
    __syncthreads();
  }

  WarpTopK top[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) top[i].init();

  const int64_t live = count < n_rows ? count : n_rows;
  const int64_t begin = (int64_t)split * rows_per_split;
  int64_t end = begin + rows_per_split;
  if (end > live) end = live;
  // rows_per_split is a multiple of RB, so the split starts on a tile.
  const int64_t t_end = end > begin ? (end + RB - 1) / RB : begin / RB;
  scan_tiles<T, TQ>(emb, q, n_rows, d_pad, b, q0, begin / RB, t_end, smem,
                    [&](int64_t r0, const float* S) {
    bool ok[4];
    float scale[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + lane + 32 * j;
      ok[j] = r < end;
      if constexpr (F == kIntervals) {
        bool in = false;
        for (int t = 0; t < x.n_intervals; ++t)
          in |= r >= iv[2 * t] && r < iv[2 * t + 1];
        ok[j] = ok[j] && in;
      }
      if constexpr (F == kMask) ok[j] = ok[j] && x.mask[r] > 0;
      if constexpr (std::is_same<T, int8_t>::value)
        scale[j] = ok[j] ? x.scales[r] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const float* srow = S + (warp * TQ + i) * SP;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // ascending rows: lane + 32 j
        float v = srow[lane + 32 * j];
        if constexpr (std::is_same<T, int8_t>::value) v *= scale[j];
        top[i].offer(ok[j] ? v : RAW_NEG, (int)(r0 + lane + 32 * j), k, lane);
      }
    }
  });

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int gq = q0 + warp * TQ + i;
    if (gq < b && lane < k) {
      const int64_t o = ((int64_t)gq * splits + split) * k + lane;
      cand_vals[o] = top[i].v;
      cand_idx[o] = top[i].i;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    topk_merge_kernel(const float* __restrict__ cand_vals,
                      const int* __restrict__ cand_idx, int b, int splits,
                      int k, float* out_vals, int* out_idx) {
  const int lane = threadIdx.x & 31;
  const int gq = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (gq >= b) return;  // uniform per warp
  WarpTopK top;
  top.init();
  for (int sp = 0; sp < splits; ++sp) {
    const int64_t o = ((int64_t)gq * splits + sp) * k + lane;
    const float v = lane < k ? cand_vals[o] : RAW_NEG;
    const int i = lane < k ? cand_idx[o] : -1;
    top.offer(v, i, k, lane);
  }
  if (lane < k) {
    out_vals[(int64_t)gq * k + lane] = top.v;
    out_idx[(int64_t)gq * k + lane] = top.i;
  }
}

template <typename T, int F, int TQ>
int launch_scan_tq(const void* emb, const float* q, int64_t n_rows, int d_pad,
                   int b, int64_t count, int k, int64_t rows_per_split,
                   int splits, ScanExtras x, float* cand_vals, int* cand_idx,
                   cudaStream_t stream) {
  constexpr int QB = FfmaTile<TQ>::QB;
  constexpr int smem = FfmaTile<TQ>::SMEM_BYTES;
  auto kernel = topk_scan_kernel<T, F, TQ>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((unsigned)(((b + QB - 1) / QB) * splits));
  kernel<<<grid, THREADS, smem, stream>>>((const T*)emb, q, n_rows, d_pad, b, count, k,
                                         rows_per_split, splits, x, cand_vals, cand_idx);
  return (int)cudaGetLastError();
}

// query_block: 8, 16, 32 or 64 queries per CTA (ops/topk.py topk_query_block).
template <typename T, int F>
int launch_scan(const void* emb, const float* q, int64_t n_rows, int d_pad,
                int b, int64_t count, int k, int64_t rows_per_split,
                int splits, int query_block, ScanExtras x, float* cand_vals,
                int* cand_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (query_block) {
    case 8:
      return launch_scan_tq<T, F, 1>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    case 16:
      return launch_scan_tq<T, F, 2>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    case 32:
      return launch_scan_tq<T, F, 4>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    case 64:
      return launch_scan_tq<T, F, 8>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32 store, 1 = bfloat16 store.
template <int F>
int launch_float_scan(const void* emb, int dtype, const float* q,
                      int64_t n_rows, int d_pad, int b, int64_t count, int k,
                      int64_t rows_per_split, int splits, int query_block,
                      ScanExtras x, float* cand_vals, int* cand_idx, void* stream) {
  if (dtype == 0)
    return launch_scan<float, F>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                 splits, query_block, x, cand_vals, cand_idx, stream);
  return launch_scan<__nv_bfloat16, F>(emb, q, n_rows, d_pad, b, count, k,
                                       rows_per_split, splits, query_block, x,
                                       cand_vals, cand_idx, stream);
}

}  // namespace tat

// Every scan takes the split geometry (rows_per_split, a multiple of 128,
// and splits) and the query block from ops/topk.py scan_geometry and
// topk_query_block; the store and queries are 16-byte aligned with d_pad %
// 32 == 0. Every entry point returns cudaGetLastError() after its launch.

// K1. dtype: 0 = float32 store, 1 = bfloat16 store.
extern "C" int tat_topk_scan(const void* emb, int dtype, const float* q,
                             int64_t n_rows, int d_pad, int b, int64_t count,
                             int k, int64_t rows_per_split, int splits,
                             int query_block, float* cand_vals, int* cand_idx,
                             void* stream) {
  return tat::launch_float_scan<tat::kNoFilter>(
      emb, dtype, q, n_rows, d_pad, b, count, k, rows_per_split, splits,
      query_block, tat::ScanExtras{}, cand_vals, cand_idx, stream);
}

// K4: rows inside any of n_intervals (<= 8) [start, stop) spans.
extern "C" int tat_topk_scan_iv(const void* emb, int dtype, const float* q,
                                int64_t n_rows, int d_pad, int b,
                                int64_t count, int k, int64_t rows_per_split,
                                int splits, int query_block,
                                const int* intervals, int n_intervals,
                                float* cand_vals, int* cand_idx, void* stream) {
  if (n_intervals < 0 || n_intervals > tat::MAX_INTERVALS)
    return (int)cudaErrorInvalidValue;
  tat::ScanExtras x{};
  x.intervals = intervals;
  x.n_intervals = n_intervals;
  return tat::launch_float_scan<tat::kIntervals>(
      emb, dtype, q, n_rows, d_pad, b, count, k, rows_per_split, splits,
      query_block, x, cand_vals, cand_idx, stream);
}

// K5: rows whose i32 mask entry is > 0 (the JAX kernel's m_ref > 0).
extern "C" int tat_topk_scan_mask(const void* emb, int dtype, const float* q,
                                  int64_t n_rows, int d_pad, int b,
                                  int64_t count, int k,
                                  int64_t rows_per_split, int splits,
                                  int query_block, const int* mask,
                                  float* cand_vals, int* cand_idx,
                                  void* stream) {
  tat::ScanExtras x{};
  x.mask = mask;
  return tat::launch_float_scan<tat::kMask>(
      emb, dtype, q, n_rows, d_pad, b, count, k, rows_per_split, splits,
      query_block, x, cand_vals, cand_idx, stream);
}

// K6: int8 rows with per-row scales.
extern "C" int tat_topk_scan_q(const int8_t* emb, const float* scales,
                               const float* q, int64_t n_rows, int d_pad,
                               int b, int64_t count, int k,
                               int64_t rows_per_split, int splits,
                               int query_block, float* cand_vals,
                               int* cand_idx, void* stream) {
  tat::ScanExtras x{};
  x.scales = scales;
  return tat::launch_scan<int8_t, tat::kNoFilter>(
      emb, q, n_rows, d_pad, b, count, k, rows_per_split, splits, query_block,
      x, cand_vals, cand_idx, stream);
}

// K7: int8 rows with per-row scales and an i32 row mask.
extern "C" int tat_topk_scan_mq(const int8_t* emb, const float* scales,
                                const float* q, int64_t n_rows, int d_pad,
                                int b, int64_t count, int k,
                                int64_t rows_per_split, int splits,
                                int query_block, const int* mask,
                                float* cand_vals, int* cand_idx, void* stream) {
  tat::ScanExtras x{};
  x.scales = scales;
  x.mask = mask;
  return tat::launch_scan<int8_t, tat::kMask>(
      emb, q, n_rows, d_pad, b, count, k, rows_per_split, splits, query_block,
      x, cand_vals, cand_idx, stream);
}

extern "C" int tat_topk_merge(const float* cand_vals, const int* cand_idx,
                              int b, int splits, int k, float* out_vals,
                              int* out_idx, void* stream) {
  const int warps = tat::THREADS / 32;
  const dim3 grid((unsigned)((b + warps - 1) / warps));
  tat::topk_merge_kernel<<<grid, tat::THREADS, 0, (cudaStream_t)stream>>>(
      cand_vals, cand_idx, b, splits, k, out_vals, out_idx);
  return (int)cudaGetLastError();
}
