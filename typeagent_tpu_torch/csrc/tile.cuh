// Shared pieces of the cosine top-k kernels: the FFMA score tile that the
// f32 and bf16 top-k scans (topk.cu: K1, K4, K5) and the f32 bucket kernels
// (bucket_maxima.cu: K2 and K2' on f32 stores) run over a sequence of
// 128-row tiles (a contiguous range, or for the scoped scans K4 and K5 a
// list of the tiles a scope touches), the tile accessors that this loop and
// the tensor-core loop of mma_tile.cuh share, the warp-held sorted top-k
// list that the scan and merge passes share, and the cp.async helpers of
// every staged kernel.
//
// The tile is a plain FP32 FFMA product (no TF32, no tensor cores): the JAX
// kernels score f32 stores at Precision.HIGHEST, and the products of a bf16
// store (bf16 x bf16) are exact in f32, so FFMA on upcast operands gives
// the same sums up to summation order. (int8 rows take the tensor-core
// loop of mma_tile.cuh.)
//
// What bounds it on an H100: the FP32 FFMA rate (67 TFLOP/s) at serving
// batches, 2*b*n*d operations; the store read at b <= 8. The first design
// held a 4 x 4 block per thread fed by 8 scalar shared loads per depth
// step, so the shared-memory pipe, not the FP32 units, set the pace (~16
// TFLOP/s), and it staged each chunk synchronously. This one:
//   * a tile of QB = 8*TQ queries x 128 rows (TQ = 1, 2, 4 or 8: QB 8 to
//     64, chosen by the batch, so the store's padded batches of 8, 16 and
//     32 score no padding queries, and 64 streams the store 4 times at
//     b = 256 instead of 8); each thread owns TQ queries x 4 rows, and one
//     depth step of 4 costs 4 + TQ 16-byte shared loads for 16*TQ FFMAs;
//   * rows and queries staged [row][depth] in 32-deep chunks through a
//     two-slot ring: f32 operands ride 16-byte cp.async copies issued a
//     chunk ahead, so the next chunk's loads overlap this chunk's FFMAs
//     (and the next tile's first chunk overlaps this tile's epilogue);
//     bf16 rows (and the queries they take, rounded to bf16) are loaded
//     into registers a chunk ahead and converted exactly on the store, one
//     barrier per chunk either way;
//   * the [QB x 128] score block leaves the accumulators through shared
//     memory, so that each warp then reads its TQ queries' 128 scores lane
//     by lane in ascending row order (the top-k fold and the bucket
//     reductions need rows across lanes, not the product's layout).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tat {

constexpr int RB = 128;           // rows per tile (= one exact2 bucket)
constexpr int THREADS = 256;      // 8 warps
constexpr float RAW_NEG = -3.0f;  // below any real cosine
constexpr unsigned FULL = 0xffffffffu;
// Every staged kernel is __launch_bounds__(THREADS, 2) with at most this
// much shared memory, so two CTAs fit on an SM (ops/topk.py
// _CTAS_PER_SM sizes its grids by it).
constexpr int SMEM_2CTA = 113 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Queries arrive as f32 and are cast to the store dtype first, as the JAX
// kernels do (q.astype(emb.dtype)), then upcast for the f32 product: an
// f32 store takes them as they are, a bf16 store rounds them to bf16.
__device__ __forceinline__ float bf16_rounded(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

// 16-byte asynchronous copy to shared memory; !valid fills zeros and reads
// nothing (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// The tiles a CTA walks
// ---------------------------------------------------------------------------

// The tiles a CTA walks, in ascending order: tile j of a contiguous range
// is first + j (K1, K2, K2', K6, K8, K9), of a list the index at position
// first + j of `tiles` in device memory (K4, K5, K7). The loops walk a range
// as before and read a list's next index a tile ahead, so that it is in
// hand when the ring starts the next tile's loads.
struct TileRange {
  static constexpr bool LISTED = false;
  int64_t first;
  __device__ __forceinline__ int64_t operator()(int64_t j) const { return first + j; }
};
struct TileList {
  static constexpr bool LISTED = true;
  const int* tiles;
  int64_t first;
  __device__ __forceinline__ int64_t operator()(int64_t j) const { return tiles[first + j]; }
};

// ---------------------------------------------------------------------------
// The FFMA tile
// ---------------------------------------------------------------------------

constexpr int KC = 32;      // depth of one staged chunk
constexpr int KP = KC + 4;  // f32 per staged row: 16-byte reads stay conflict-free
constexpr int SP = RB + 8;  // f32 per score-block row: the scatter stays conflict-free

// Thread (warp w, lane l) owns queries (w >> 2) * 4*TQ + (l >> 3) + 4*i,
// i < TQ, and rows (w & 3) * 32 + (l & 7) + 8*j, j < 4: the strides keep the
// 16-byte shared reads of one instruction on distinct banks.
template <int TQ>
struct FfmaTile {
  static_assert(TQ == 1 || TQ == 2 || TQ == 4 || TQ == 8, "query blocks of 8 to 64");
  static constexpr int QB = 8 * TQ;
  static constexpr int SLOT = (QB + RB) * KP;  // floats: queries, then rows
  static constexpr int SMEM_BYTES = (2 * SLOT + QB * SP) * (int)sizeof(float);
  static_assert(SMEM_BYTES <= SMEM_2CTA, "two CTAs per SM");
};

// Stages chunk [d0, d0 + KC) of query block q0 and tile r0 into a slot:
// queries at [qi * KP], rows at [(QB + ri) * KP]. Queries at or past b and
// rows at or past n_rows read as zero. bf16 rows: fetch loads the chunk
// into registers, put converts it (rows exactly, queries rounded to bf16)
// into the slot.
template <typename T, int TQ>
struct ChunkStager {
  static_assert(sizeof(T) == 2, "bf16 rows; f32 rows have their own stager");
  static constexpr int QB = FfmaTile<TQ>::QB;
  static constexpr int RVEC = 16 / sizeof(T);            // row elements per load
  static constexpr int RLOADS = RB * KC / RVEC / THREADS;  // per thread
  static constexpr int QLOADS = (QB * KC / 4 + THREADS - 1) / THREADS;
  uint4 rows[RLOADS];
  float4 qs[QLOADS];

  __device__ __forceinline__ void fetch(const T* __restrict__ emb, const float* __restrict__ q,
                                        int64_t n_rows, int d_pad, int b, int q0, int64_t r0,
                                        int d0) {
#pragma unroll
    for (int u = 0; u < RLOADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      const int ri = c / (KC / RVEC);
      const int col = (c % (KC / RVEC)) * RVEC;
      const int64_t gr = r0 + ri;
      rows[u] = gr < n_rows ? *reinterpret_cast<const uint4*>(emb + gr * d_pad + d0 + col)
                            : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < QLOADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      const int qi = c / (KC / 4);
      const int gq = q0 + qi;
      qs[u] = c < QB * (KC / 4) && gq < b
                  ? *reinterpret_cast<const float4*>(q + (int64_t)gq * d_pad + d0 + (c % (KC / 4)) * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void put(float* slot) const {
#pragma unroll
    for (int u = 0; u < RLOADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      float* dst = slot + (QB + c / (KC / RVEC)) * KP + (c % (KC / RVEC)) * RVEC;
      const uint32_t w[4] = {rows[u].x, rows[u].y, rows[u].z, rows[u].w};
#pragma unroll
      for (int h = 0; h < 2; ++h)  // the bf16 -> f32 upcast is exact
        *reinterpret_cast<float4*>(dst + 4 * h) = make_float4(
            __uint_as_float(w[2 * h] << 16), __uint_as_float(w[2 * h] & 0xffff0000u),
            __uint_as_float(w[2 * h + 1] << 16), __uint_as_float(w[2 * h + 1] & 0xffff0000u));
    }
#pragma unroll
    for (int u = 0; u < QLOADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      if (c < QB * (KC / 4))
        *reinterpret_cast<float4*>(slot + (c / (KC / 4)) * KP + (c % (KC / 4)) * 4) =
            make_float4(bf16_rounded(qs[u].x), bf16_rounded(qs[u].y), bf16_rounded(qs[u].z),
                        bf16_rounded(qs[u].w));
    }
  }
};

// f32 stores: the chunk rides cp.async straight into the slot.
template <int TQ>
struct ChunkStager<float, TQ> {
  static constexpr int QB = FfmaTile<TQ>::QB;
  float* slot;

  __device__ __forceinline__ void fetch(const float* __restrict__ emb, const float* __restrict__ q,
                                        int64_t n_rows, int d_pad, int b, int q0, int64_t r0,
                                        int d0) {
    for (int c = threadIdx.x; c < RB * (KC / 4); c += THREADS) {
      const int ri = c / (KC / 4), col = (c % (KC / 4)) * 4;
      const int64_t gr = r0 + ri;
      cp_async16(slot + (QB + ri) * KP + col, gr < n_rows ? emb + gr * d_pad + d0 + col : emb,
                 gr < n_rows);
    }
    for (int c = threadIdx.x; c < QB * (KC / 4); c += THREADS) {
      const int qi = c / (KC / 4), col = (c % (KC / 4)) * 4;
      const int gq = q0 + qi;
      cp_async16(slot + qi * KP + col, gq < b ? q + (int64_t)gq * d_pad + d0 + col : q, gq < b);
    }
  }
  __device__ __forceinline__ void put(float*) const {}
};

// Scores query block q0 against the n_tiles 128-row tiles tile_at(0) <
// tile_at(1) < ... (a TileRange or a TileList). After each tile the [QB x
// 128] block sits in shared memory at S[query * SP + row] and every thread
// calls epi(r0, S) with the tile's first row r0; the block stays valid
// until the next tile's epilogue. Must be called by all THREADS threads of
// the CTA with FfmaTile<TQ>::SMEM_BYTES of dynamic shared memory at `smem`.
//
// The ring fetches chunk s+1 while chunk s is multiplied, so at a tile's
// last chunk it fetches the next tile's first one. A range computes each
// chunk's tile from s; a list keeps the tile being multiplied (c_r0) and
// the next listed one (n_r0), read from the list a tile ahead.
template <typename T, int TQ, typename Tiles, typename Epilogue>
__device__ __forceinline__ void scan_tiles(const T* __restrict__ emb,
                                           const float* __restrict__ q, int64_t n_rows,
                                           int d_pad, int b, int q0, int n_tiles, Tiles tile_at,
                                           float* smem, Epilogue&& epi) {
  using Tile = FfmaTile<TQ>;
  float* const S = smem + 2 * Tile::SLOT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qrow = (warp >> 2) * 4 * TQ + (lane >> 3);  // + 4*i
  const int rrow = (warp & 3) * 32 + (lane & 7);        // + 8*j
  const int chunks = d_pad / KC;
  const int64_t steps = (int64_t)n_tiles * chunks;
  if (steps <= 0) return;

  ChunkStager<T, TQ> st;
  auto fetch = [&](int64_t s, int64_t r0, int d0) {
    if constexpr (std::is_same<T, float>::value) st.slot = smem + (s & 1) * Tile::SLOT;
    st.fetch(emb, q, n_rows, d_pad, b, q0, r0, d0);
  };
  // The first tile's first row; a list then keeps it as the tile being
  // multiplied, with its chunk and position and the next listed tile's
  // first row.
  int64_t c_r0 = tile_at(0) * RB;
  int64_t n_r0 = Tiles::LISTED && n_tiles > 1 ? tile_at(1) * RB : 0;
  int c_chunk = 0, c_tile = 0;
  fetch(0, c_r0, 0);
  st.put(smem);
  cp_async_commit();

  float acc[TQ][4];
#pragma unroll
  for (int i = 0; i < TQ; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int64_t s = 0; s < steps; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // chunk s is in its slot; the other slot is free
    const bool more = s + 1 < steps;
    if (more) {
      if constexpr (Tiles::LISTED) {
        const bool next_tile = c_chunk + 1 == chunks;
        fetch(s + 1, next_tile ? n_r0 : c_r0, next_tile ? 0 : (c_chunk + 1) * KC);
      } else {
        fetch(s + 1, tile_at((s + 1) / chunks) * RB, (int)((s + 1) % chunks) * KC);
      }
    }
    cp_async_commit();

    const float* slot = smem + (s & 1) * Tile::SLOT;
    const float* qs = slot + qrow * KP;
    const float* es = slot + (Tile::QB + rrow) * KP;
#pragma unroll
    for (int c = 0; c < KC; c += 4) {
      float4 e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = *reinterpret_cast<const float4*>(es + 8 * j * KP + c);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qs + 4 * i * KP + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a.x, e[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, e[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, e[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, e[j].w, acc[i][j]);
        }
      }
    }
    if (more) st.put(smem + ((s + 1) & 1) * Tile::SLOT);

    bool done;  // uniform: the tile is done
    if constexpr (Tiles::LISTED) {
      done = c_chunk + 1 == chunks;
      c_chunk = done ? 0 : c_chunk + 1;
    } else {
      done = s % chunks == chunks - 1;
    }
    if (done) {
#pragma unroll
      for (int i = 0; i < TQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          S[(qrow + 4 * i) * SP + rrow + 8 * j] = acc[i][j];
          acc[i][j] = 0.0f;
        }
      __syncthreads();
      if constexpr (Tiles::LISTED) {
        epi(c_r0, (const float*)S);
        ++c_tile;
        c_r0 = n_r0;
        if (c_tile + 1 < n_tiles) n_r0 = tile_at(c_tile + 1) * RB;
      } else {
        epi(tile_at(s / chunks) * RB, (const float*)S);
      }
    }
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
