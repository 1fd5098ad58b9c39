// Shared pieces of the cosine top-k kernels: the [QB queries x RB rows]
// score tile that K1 (topk.cu) and K2 (bucket_maxima.cu) both compute, and
// the warp-held sorted top-k list that K1's scan and merge passes share.
//
// The tile is a plain FP32 FFMA product (no TF32, no tensor cores): the JAX
// kernels score f32 stores at Precision.HIGHEST, and a bf16 store's products
// are exact in f32, so FFMA on upcast operands gives the same sums up to
// summation order. Each thread owns a 4 x 4 block of the tile: queries
// ty*4 .. ty*4+3 (ty = warp) against rows tx, tx+32, tx+64, tx+96
// (tx = lane), so one warp holds all RB scores of its four queries.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tat {

constexpr int QB = 32;        // queries per CTA
constexpr int RB = 128;       // rows per tile (= one exact2 bucket)
constexpr int KC = 32;        // depth of one shared-memory chunk
constexpr int THREADS = 256;  // 8 warps
constexpr float RAW_NEG = -3.0f;  // below any real cosine
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Queries arrive as f32 and are cast to the store dtype first, as the JAX
// kernels do (q.astype(emb.dtype)), then upcast for the f32 product.
template <typename T>
__device__ __forceinline__ float query_in_store_dtype(float x);
template <>
__device__ __forceinline__ float query_in_store_dtype<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float query_in_store_dtype<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct TileSmem {
  float q[KC][QB + 1];  // [depth][query]; +1 keeps the transposing stores
  float e[KC][RB + 1];  // [depth][row]    free of bank conflicts
};

// acc[i][j] = dot(query q0 + ty*4 + i, row r0 + tx + 32*j). Queries at or
// past b and rows at or past n_rows read as zero; the caller masks rows at
// the count watermark. Must be called by all THREADS threads of the CTA.
template <typename T>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ emb, const float* __restrict__ q, int64_t n_rows,
    int d_pad, int b, int q0, int64_t r0, TileSmem& s, float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int d0 = 0; d0 < d_pad; d0 += KC) {
    // A warp reads 32 consecutive depths of one query or row (coalesced)
    // and stores them down a column of the transposed shared tile.
    for (int t = tid; t < QB * KC; t += THREADS) {
      const int qi = t / KC;
      const int c = t % KC;
      const int gq = q0 + qi;
      const float v = gq < b ? q[(int64_t)gq * d_pad + d0 + c] : 0.0f;
      s.q[c][qi] = query_in_store_dtype<T>(v);
    }
    for (int t = tid; t < RB * KC; t += THREADS) {
      const int ri = t / KC;
      const int c = t % KC;
      const int64_t gr = r0 + ri;
      s.e[c][ri] = gr < n_rows ? to_f32(emb[gr * d_pad + d0 + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < KC; ++c) {
      float a[4], e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.q[c][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = s.e[c][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], e[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// A top-k list (k <= 32) held by one warp: lane j < k holds entry j, sorted
// by value descending, and among equal values by row ascending. `theta` is
// entry k-1 (the value a candidate must beat), uniform across the warp.
//
// Inserting candidate (sv, si) places it after every entry >= sv. As long
// as candidates of equal value arrive in ascending row order, this keeps
// ties at the lowest row, the rule of the JAX kernel's extraction
// (ops/topk.py _extract_topk), and no row can enter twice because each
// row is offered once.
struct WarpTopK {
  float v;
  int i;
  float theta;

  __device__ __forceinline__ void init() {
    v = RAW_NEG;
    i = -1;
    theta = RAW_NEG;
  }

  __device__ __forceinline__ void insert(float sv, int si, int k, int lane) {
    const unsigned ge = __ballot_sync(FULL, lane < k && v >= sv);
    const int pos = __popc(ge);
    const float up_v = __shfl_up_sync(FULL, v, 1);
    const int up_i = __shfl_up_sync(FULL, i, 1);
    if (lane > pos) {
      v = up_v;
      i = up_i;
    } else if (lane == pos) {
      v = sv;
      i = si;
    }
    theta = __shfl_sync(FULL, v, k - 1);
  }

  // Offer one candidate per lane (value cv, row ci); lanes are taken in
  // ascending order. Only candidates above theta cost an insertion.
  __device__ __forceinline__ void offer(float cv, int ci, int k, int lane) {
    unsigned m = __ballot_sync(FULL, cv > theta);
    while (m) {
      const int src = __ffs(m) - 1;
      const float sv = __shfl_sync(FULL, cv, src);
      const int si = __shfl_sync(FULL, ci, src);
      insert(sv, si, k, lane);
      m &= ~(1u << src);
      m &= __ballot_sync(FULL, cv > theta);
    }
  }
};

}  // namespace tat
