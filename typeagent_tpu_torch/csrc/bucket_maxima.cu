// K2: per-bucket (128 consecutive rows) maximum raw cosine; K2': the same
// with the argmax row of each bucket.
//
// Replaces: typeagent_tpu/ops/topk.py  _topk_bucket_kernel, launched by
//   _bucket_maxima_pallas: with_idx=False (K2, phase 1 of the exact2 and
//   hybrid exact2 searches) and with_idx=True (K2', the bucketed approx
//   search cosine_topk_bucket). Both forms are one template: the argmax
//   code is compiled only into the WITH_IDX=true instances, so a
//   maxima-only launch runs the same code as before K2' existed.
//
// Argmax rule: the lowest row among equal maxima (jnp.argmax in the JAX
//   kernel). Each thread scans its own rows in ascending order keeping the
//   first strict maximum, and every cross-lane or cross-warp combine takes
//   the lower row on equal values, so the rule holds whatever the order of
//   the reduction. A bucket with no live row gives (-3, -1).
//
// What bounds it on an H100: phase 1 reads the store (n*d*itemsize bytes:
//   0.77 GB for the 1M x 384 bf16 shadow, 0.23 ms at 3.35 TB/s) and does
//   2*b*n*d flops (197 GFLOP at b=256). In FP32 FFMA that is about 3 ms at
//   the 67 TFLOP/s peak, so arithmetic bounds it; on the tensor cores
//   (989 TFLOP/s bf16 dense) the product falls under the read time.
//
// Design: one CTA owns one whole bucket for a block of queries, so no
//   reduction crosses CTAs and the TPU kernel's sequential output block
//   (and its lane-roll blend, a Mosaic workaround) has no counterpart.
//   Only the [b, nb] maxima reach device memory. The grid runs the query
//   blocks of one bucket next to each other, so the bucket's rows are read
//   from device memory once and from L2 after. Buckets wholly at or past
//   the watermark skip the product.
//   bf16 stores (the hybrid route's shadow, bf16 stores): the [128 x 64]
//   tile is computed with mma.sync m16n8k16 bf16 -> f32, each of the 8
//   warps owning 16 rows of all 64 queries. Queries arrive already in
//   bf16, so a CTA's query strip is half its row strip. Products of bf16
//   values are exact and sum in f32, as in the JAX kernel's bf16 x bf16 ->
//   f32 MXU pass. Operands are
//   staged through shared memory with row pitches that keep the fragment
//   loads free of bank conflicts.
//   f32 stores: the FFMA score tile of tile.cuh (no TF32: f32 stores must
//   score at Precision.HIGHEST).

#include "tile.cuh"

namespace tat {

// ---------------------------------------------------------------------------
// f32 stores: FFMA tile
// ---------------------------------------------------------------------------

// (value, row) pair of a running argmax: the larger value wins, the lower
// row wins a tie. A pair with no live row is (RAW_NEG, -1); since every
// live score is > RAW_NEG, such a pair never beats a live one.
__device__ __forceinline__ void argmax_combine(float& m, int& r, float om, int orow) {
  if (om > m || (om == m && (unsigned)orow < (unsigned)r)) {
    m = om;
    r = orow;
  }
}

template <bool WITH_IDX>
__global__ void __launch_bounds__(THREADS)
    bucket_maxima_f32_kernel(const float* __restrict__ emb,
                             const float* __restrict__ q, int64_t n_rows,
                             int d_pad, int b, int64_t count, float* out,
                             int* out_idx, int64_t nb) {
  __shared__ TileSmem s;
  const int n_qb = (b + QB - 1) / QB;
  const int qb = (int)(blockIdx.x % n_qb);
  const int64_t bucket = blockIdx.x / n_qb;
  const int q0 = qb * QB;
  const int64_t r0 = bucket * RB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc[4][4];
  const bool live = r0 < count;  // uniform per CTA
  if (live) score_tile<float>(emb, q, n_rows, d_pad, b, q0, r0, s, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float m = RAW_NEG;
    int row = -1;  // argmax row (WITH_IDX only)
    if (live) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // this lane's rows, ascending
        const int64_t r = r0 + lane + 32 * j;
        if (r < count) {
          if (WITH_IDX) {
            if (acc[i][j] > m) {
              m = acc[i][j];
              row = (int)r;
            }
          } else {
            m = fmaxf(m, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(FULL, m, off);
      if (WITH_IDX) {
        argmax_combine(m, row, om, __shfl_xor_sync(FULL, row, off));
      } else {
        m = fmaxf(m, om);
      }
    }
    const int gq = q0 + warp * 4 + i;
    if (lane == 0 && gq < b) {
      out[(int64_t)gq * nb + bucket] = m;
      if (WITH_IDX) out_idx[(int64_t)gq * nb + bucket] = row;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 stores: tensor-core tile
// ---------------------------------------------------------------------------

constexpr int MMA_KC = 64;             // depth per shared-memory stage
constexpr int MMA_PITCH = MMA_KC + 8;  // bf16 per smem row: 144 bytes
constexpr int MMA_QB = 64;             // queries per CTA (8 mma n-tiles)

__device__ __forceinline__ void mma_bf16_16x8x16(float c[4], const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy a [rows x MMA_KC] bf16 strip (rows at or past `limit` read as zero)
// into shared memory with 16-byte loads, 8 threads per 128-byte strip.
template <int ROWS>
__device__ __forceinline__ void stage_strip(
    __nv_bfloat16 (*dst)[MMA_PITCH], const __nv_bfloat16* __restrict__ src,
    int64_t first, int64_t limit, int d_pad, int d0) {
  for (int i = threadIdx.x; i < ROWS * (MMA_KC / 8); i += THREADS) {
    const int ri = i / (MMA_KC / 8);
    const int c8 = (i % (MMA_KC / 8)) * 8;
    const int64_t gr = first + ri;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gr < limit) v = *reinterpret_cast<const uint4*>(src + gr * d_pad + d0 + c8);
    *reinterpret_cast<uint4*>(&dst[ri][c8]) = v;
  }
}

// q: [b, d_pad] bf16 (the wrapper casts the f32 queries once, as the JAX
// kernel casts queries to the store dtype).
template <bool WITH_IDX>
__global__ void __launch_bounds__(THREADS)
    bucket_maxima_bf16_kernel(const __nv_bfloat16* __restrict__ emb,
                              const __nv_bfloat16* __restrict__ q,
                              int64_t n_rows, int d_pad, int b, int64_t count,
                              float* out, int* out_idx, int64_t nb) {
  __shared__ __align__(16) __nv_bfloat16 es[RB][MMA_PITCH];      // rows x depth
  __shared__ __align__(16) __nv_bfloat16 qs[MMA_QB][MMA_PITCH];  // queries x depth
  __shared__ float red[THREADS / 32][MMA_QB];
  __shared__ int red_row[WITH_IDX ? THREADS / 32 : 1][MMA_QB];

  const int n_qb = (b + MMA_QB - 1) / MMA_QB;
  const int qb = (int)(blockIdx.x % n_qb);
  const int64_t bucket = blockIdx.x / n_qb;
  const int q0 = qb * MMA_QB;
  const int64_t r0 = bucket * RB;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group

  if (r0 >= count) {  // uniform: the whole bucket is past the watermark
    if (tid < MMA_QB && q0 + tid < b) {
      out[(int64_t)(q0 + tid) * nb + bucket] = RAW_NEG;
      if (WITH_IDX) out_idx[(int64_t)(q0 + tid) * nb + bucket] = -1;
    }
    return;
  }

  // acc[n][.]: rows warp*16 + {g, g+8}, queries n*8 + 2t + {0, 1}
  float acc[MMA_QB / 8][4];
#pragma unroll
  for (int n = 0; n < MMA_QB / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;

  for (int d0 = 0; d0 < d_pad; d0 += MMA_KC) {
    stage_strip<RB>(es, emb, r0, n_rows, d_pad, d0);
    stage_strip<MMA_QB>(qs, q, q0, b, d_pad, d0);
    __syncthreads();
    const int ra = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < MMA_KC; kk += 16) {
      uint32_t a[4];
      a[0] = ld_pair(&es[ra][kk + 2 * t]);
      a[1] = ld_pair(&es[ra + 8][kk + 2 * t]);
      a[2] = ld_pair(&es[ra][kk + 2 * t + 8]);
      a[3] = ld_pair(&es[ra + 8][kk + 2 * t + 8]);
#pragma unroll
      for (int n = 0; n < MMA_QB / 8; ++n) {
        const uint32_t b0 = ld_pair(&qs[n * 8 + g][kk + 2 * t]);
        const uint32_t b1 = ld_pair(&qs[n * 8 + g][kk + 2 * t + 8]);
        mma_bf16_16x8x16(acc[n], a, b0, b1);
      }
    }
    __syncthreads();
  }

  // Mask rows at the watermark, then max over the warp's 16 rows (lanes
  // sharing t hold the same queries), then over the 8 warps (warp w holds
  // rows 16w .. 16w+15, so the warps run in ascending row order).
  const int lo_row = (int)(r0 + warp * 16 + g);
  const bool lo_live = lo_row < count;
  const bool hi_live = lo_row + 8 < count;
#pragma unroll
  for (int n = 0; n < MMA_QB / 8; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lo = lo_live ? acc[n][h] : RAW_NEG;
      const float hi = hi_live ? acc[n][2 + h] : RAW_NEG;
      float m = fmaxf(lo, hi);
      if (WITH_IDX) {
        int row = hi > lo ? lo_row + 8 : (lo_live ? lo_row : -1);
#pragma unroll
        for (int off = 4; off <= 16; off <<= 1) {
          const float om = __shfl_xor_sync(FULL, m, off);
          argmax_combine(m, row, om, __shfl_xor_sync(FULL, row, off));
        }
        if (g == 0) red_row[warp][n * 8 + 2 * t + h] = row;
      } else {
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 4));
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 8));
        m = fmaxf(m, __shfl_xor_sync(FULL, m, 16));
      }
      if (g == 0) red[warp][n * 8 + 2 * t + h] = m;
    }
  }
  __syncthreads();
  if (tid < MMA_QB && q0 + tid < b) {
    float m = red[0][tid];
    int row = WITH_IDX ? red_row[0][tid] : -1;
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) {
      if (WITH_IDX) {
        argmax_combine(m, row, red[w][tid], red_row[w][tid]);
      } else {
        m = fmaxf(m, red[w][tid]);
      }
    }
    out[(int64_t)(q0 + tid) * nb + bucket] = m;
    if (WITH_IDX) out_idx[(int64_t)(q0 + tid) * nb + bucket] = row;
  }
}

}  // namespace tat

namespace {

template <bool WITH_IDX>
void launch_bucket_maxima(const void* emb, int dtype, const void* q,
                          int64_t n_rows, int d_pad, int b, int64_t count,
                          float* out, int* out_idx, cudaStream_t st) {
  const int64_t nb = n_rows / tat::RB;
  if (dtype == 0) {
    const int n_qb = (b + tat::QB - 1) / tat::QB;
    tat::bucket_maxima_f32_kernel<WITH_IDX>
        <<<(unsigned)(nb * n_qb), tat::THREADS, 0, st>>>(
            (const float*)emb, (const float*)q, n_rows, d_pad, b, count, out,
            out_idx, nb);
  } else {
    const int n_qb = (b + tat::MMA_QB - 1) / tat::MMA_QB;
    tat::bucket_maxima_bf16_kernel<WITH_IDX>
        <<<(unsigned)(nb * n_qb), tat::THREADS, 0, st>>>(
            (const __nv_bfloat16*)emb, (const __nv_bfloat16*)q, n_rows, d_pad,
            b, count, out, out_idx, nb);
  }
}

}  // namespace

// q: [b, d_pad], f32 for an f32 store (dtype 0), bf16 for a bf16 store
// (dtype 1; then d_pad % 64 == 0 and both pointers 16-byte aligned).
// out: [b, nb] f32 with nb = n_rows / 128; out_idx: NULL for K2 (maxima
// only), else [b, nb] int32 for K2' (the argmax rows). Returns
// cudaGetLastError().
extern "C" int tat_bucket_maxima(const void* emb, int dtype, const void* q,
                                 int64_t n_rows, int d_pad, int b,
                                 int64_t count, float* out, int* out_idx,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_idx == nullptr) {
    launch_bucket_maxima<false>(emb, dtype, q, n_rows, d_pad, b, count, out,
                                nullptr, st);
  } else {
    launch_bucket_maxima<true>(emb, dtype, q, n_rows, d_pad, b, count, out,
                               out_idx, st);
  }
  return (int)cudaGetLastError();
}
