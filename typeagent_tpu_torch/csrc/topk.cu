// K1: one-phase fused cosine top-k (k <= 32) over a padded embedding store.
//
// Replaces: typeagent_tpu/ops/topk.py  _topk_kernel + _mask_and_fold +
//   _fold_tile_into_topk, launched by _topk_pallas_impl.
//
// What bounds it on an H100: at serving batches (b >= 32) the FP32 FFMA
//   rate. The score tile is computed with plain FFMA because f32 stores
//   must match Precision.HIGHEST (no TF32): 2*b*n*d flops, 197 GFLOP for
//   b=256 over 1M x 384, against 67 TFLOP/s FP32 peak. At b = 8 the store
//   read (n*d*itemsize bytes) bounds it instead.
//
// Design: the TPU kernel carries its running top-k in a VMEM output block
//   across a grid that runs in order. CTAs run in no order, so the search
//   is two launches. (1) scan: grid = query blocks x row splits; each CTA
//   walks its split tile by tile, never writes scores to device memory, and
//   keeps each query's running top-k in registers across one warp (lane j
//   holds entry j); a tile costs one ballot per query and column once the
//   list is warm, the counterpart of the JAX kernel's "n_above == 0" tier.
//   It writes [b, splits, k] candidates. (2) merge: one warp per query
//   folds the splits' lists, in split order, into the final [b, k].
//   Both passes insert equal values in ascending row order, so ties go to
//   the lowest row as in the JAX kernel. Unfilled slots are (-3.0, -1).

#include "tile.cuh"

namespace tat {

template <typename T>
__global__ void __launch_bounds__(THREADS)
    topk_scan_kernel(const T* __restrict__ emb, const float* __restrict__ q,
                     int64_t n_rows, int d_pad, int b, int64_t count, int k,
                     int64_t rows_per_split, int splits, float* cand_vals,
                     int* cand_idx) {
  __shared__ TileSmem s;
  const int n_qb = (b + QB - 1) / QB;
  const int qb = blockIdx.x % n_qb;
  const int split = blockIdx.x / n_qb;
  const int q0 = qb * QB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  WarpTopK top[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) top[i].init();

  const int64_t live = count < n_rows ? count : n_rows;
  const int64_t begin = (int64_t)split * rows_per_split;
  int64_t end = begin + rows_per_split;
  if (end > live) end = live;
  float acc[4][4];
  for (int64_t r0 = begin; r0 < end; r0 += RB) {
    score_tile<T>(emb, q, n_rows, d_pad, b, q0, r0, s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t r = r0 + lane + 32 * j;
        const float v = r < end ? acc[i][j] : RAW_NEG;
        top[i].offer(v, (int)r, k, lane);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + warp * 4 + i;
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

}  // namespace tat

// dtype: 0 = float32 store, 1 = bfloat16 store. Returns cudaGetLastError().
extern "C" int tat_topk_scan(const void* emb, int dtype, const float* q,
                             int64_t n_rows, int d_pad, int b, int64_t count,
                             int k, int64_t rows_per_split, int splits,
                             float* cand_vals, int* cand_idx, void* stream) {
  const int n_qb = (b + tat::QB - 1) / tat::QB;
  const dim3 grid((unsigned)(n_qb * splits));
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    tat::topk_scan_kernel<float><<<grid, tat::THREADS, 0, st>>>(
        (const float*)emb, q, n_rows, d_pad, b, count, k, rows_per_split,
        splits, cand_vals, cand_idx);
  } else {
    tat::topk_scan_kernel<__nv_bfloat16><<<grid, tat::THREADS, 0, st>>>(
        (const __nv_bfloat16*)emb, q, n_rows, d_pad, b, count, k,
        rows_per_split, splits, cand_vals, cand_idx);
  }
  return (int)cudaGetLastError();
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
