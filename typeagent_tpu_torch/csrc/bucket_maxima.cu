// K2: per-bucket (128 consecutive rows) maximum raw cosine; K2': the same
// with the argmax row of each bucket; K8 and K9: K2 over an int8 or a packed
// int4 selection shadow with per-row scales.
//
// Replaces: typeagent_tpu/ops/topk.py  _topk_bucket_kernel, launched by
//   _bucket_maxima_pallas: with_idx=False (K2, phase 1 of the exact2 and
//   hybrid exact2 searches) and with_idx=True (K2', the bucketed approx
//   search cosine_topk_bucket). Both forms are one template: the argmax
//   code is compiled only into the WITH_IDX=true instances, so a
//   maxima-only launch runs the same code as before K2' existed.
// Replaces: typeagent_tpu/ops/topk.py  _bucket_maxima_kernel_q, launched by
//   _bucket_maxima_pallas_q (K8, phase 1 of cosine_topk_exact2_hybrid_i8),
//   and typeagent_tpu/ops/int4.py  _bucket_maxima_kernel_q4, launched by
//   _bucket_maxima_pallas_q4 (K9, phase 1 of cosine_topk_exact2_i4). Both
//   are instances of the bf16 tensor-core template below with another row
//   type: only the staging of a strip and the per-row scale differ.
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
//   (989 TFLOP/s bf16 dense) the product falls under the read time. The
//   int8 shadow reads 0.39 GB and the int4 one 0.26 GB at 1M x 384, so
//   for K8 and K9 the bf16 product (0.2 ms) is the bound.
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
//   int8 shadows (K8): each 16-byte load brings 16 codes, written to
//   shared memory as bf16 (every int8 value is exact in bf16), so the same
//   mma.sync pass computes the JAX kernel's bf16 x (int8 -> bf16) product.
//   Packed int4 shadows (K9): byte [i, c] holds column c (low nibble) and
//   column c + ceil(d/2) (high nibble). A strip takes 32 packed bytes of a
//   row and stages their 32 low nibbles then their 32 high nibbles as one
//   64-deep bf16 strip; its query strip is the matching 32 columns of each
//   split query half. The sum over all strips is the JAX kernel's two
//   half-width dots in one, up to f32 summation order.
//   Both multiply each row's f32 sums by the row's scale, then mask rows
//   at the watermark (scale first, then mask, as the JAX kernels do).
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

// Two bf16 values as the 32-bit pair mma.sync reads (lo at the lower
// column).
__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Row types of the tensor-core tile. Each stages a strip of its RB rows
// into shared memory as MMA_KC bf16 columns (rows at or past `limit` read
// as zero) and says which query columns the strip meets; `width` is a
// row's length in elements of T, `c0` the strip's first element.

// bf16 rows (K2, K2'): copied as they are.
struct RowsBf16 {
  using T = __nv_bfloat16;
  static constexpr int COLS = MMA_KC;  // row elements per strip
  static constexpr bool SCALED = false;
  static constexpr bool SPLIT_QUERIES = false;
  static __device__ __forceinline__ void stage(
      __nv_bfloat16 (*dst)[MMA_PITCH], const T* __restrict__ src,
      int64_t first, int64_t limit, int width, int c0) {
    stage_strip<RB>(dst, src, first, limit, width, c0);
  }
};

// int8 rows (K8): 16 codes per 16-byte load, 4 loads per row strip.
struct RowsI8 {
  using T = int8_t;
  static constexpr int COLS = MMA_KC;
  static constexpr bool SCALED = true;
  static constexpr bool SPLIT_QUERIES = false;
  static __device__ __forceinline__ void stage(
      __nv_bfloat16 (*dst)[MMA_PITCH], const T* __restrict__ src,
      int64_t first, int64_t limit, int width, int c0) {
    for (int i = threadIdx.x; i < RB * (MMA_KC / 16); i += THREADS) {
      const int ri = i / (MMA_KC / 16);
      const int c16 = (i % (MMA_KC / 16)) * 16;
      const int64_t gr = first + ri;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gr < limit) v = *reinterpret_cast<const uint4*>(src + gr * width + c0 + c16);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // byte k of w[j] is column 4j + k
        o[2 * j] = bf16_pair((int8_t)(w[j] & 0xff), (int8_t)((w[j] >> 8) & 0xff));
        o[2 * j + 1] = bf16_pair((int8_t)((w[j] >> 16) & 0xff), (int8_t)(w[j] >> 24));
      }
      *reinterpret_cast<uint4*>(&dst[ri][c16]) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(&dst[ri][c16 + 8]) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
};

// Column-split packed int4 rows (K9): a strip is 32 packed bytes of a row,
// one 16-byte load per half; their low nibbles fill strip columns 0-31 and
// their high nibbles columns 32-63.
struct RowsI4 {
  using T = int8_t;
  static constexpr int COLS = MMA_KC / 2;
  static constexpr bool SCALED = true;
  static constexpr bool SPLIT_QUERIES = true;
  static __device__ __forceinline__ void stage(
      __nv_bfloat16 (*dst)[MMA_PITCH], const T* __restrict__ src,
      int64_t first, int64_t limit, int width, int c0) {
    for (int i = threadIdx.x; i < RB * 2; i += THREADS) {
      const int ri = i / 2;
      const int c16 = (i % 2) * 16;
      const int64_t gr = first + ri;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gr < limit) v = *reinterpret_cast<const uint4*>(src + gr * width + c0 + c16);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // Bytes 2h and 2h+1 of w[j]. On the sign-extended byte p these
          // are the JAX kernel's (p << 28) >> 28 and p >> 4 in int32: the
          // nibble's top bit is moved to bit 31 and shifted back
          // arithmetically.
          const int s0 = 16 * h, s1 = 16 * h + 8;
          lo[2 * j + h] = bf16_pair((int)(w[j] << (28 - s0)) >> 28, (int)(w[j] << (28 - s1)) >> 28);
          hi[2 * j + h] = bf16_pair((int)(w[j] << (24 - s0)) >> 28, (int)(w[j] << (24 - s1)) >> 28);
        }
      }
      *reinterpret_cast<uint4*>(&dst[ri][c16]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(&dst[ri][c16 + 8]) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(&dst[ri][32 + c16]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(&dst[ri][32 + c16 + 8]) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
};

// The query strip of a RowsI4 strip: columns c0 .. c0+31 of each split
// query's low half, then the same columns of its high half (q is
// [b, 2 * half] bf16, the high half starting at column `half`).
__device__ __forceinline__ void stage_split_query_strip(
    __nv_bfloat16 (*dst)[MMA_PITCH], const __nv_bfloat16* __restrict__ q,
    int first, int limit, int half, int c0) {
  for (int i = threadIdx.x; i < MMA_QB * (MMA_KC / 8); i += THREADS) {
    const int qi = i / (MMA_KC / 8);
    const int c8 = (i % (MMA_KC / 8)) * 8;
    const int gq = first + qi;
    const int src = c8 < MMA_KC / 2 ? c0 + c8 : half + c0 + c8 - MMA_KC / 2;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (gq < limit) v = *reinterpret_cast<const uint4*>(q + (int64_t)gq * 2 * half + src);
    *reinterpret_cast<uint4*>(&dst[qi][c8]) = v;
  }
}

// q: [b, width] bf16 for bf16 and int8 rows, [b, 2 * width] (the split
// halves) for packed int4 rows; the wrapper casts the f32 queries once, as
// the JAX kernels' callers cast queries to bf16. scales: [n_rows] f32 for
// the scaled row types, unused for bf16 rows.
template <typename Rows, bool WITH_IDX>
__global__ void __launch_bounds__(THREADS)
    bucket_maxima_mma_kernel(const typename Rows::T* __restrict__ emb,
                             const float* __restrict__ scales,
                             const __nv_bfloat16* __restrict__ q,
                             int64_t n_rows, int width, int b, int64_t count,
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

  for (int c0 = 0; c0 < width; c0 += Rows::COLS) {
    Rows::stage(es, emb, r0, n_rows, width, c0);
    if constexpr (Rows::SPLIT_QUERIES) {
      stage_split_query_strip(qs, q, q0, b, width, c0);
    } else {
      stage_strip<MMA_QB>(qs, q, q0, b, width, c0);
    }
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

  // Scale (int8 and int4 rows), mask rows at the watermark, then max over
  // the warp's 16 rows (lanes sharing t hold the same queries), then over
  // the 8 warps (warp w holds rows 16w .. 16w+15, so the warps run in
  // ascending row order).
  const int lo_row = (int)(r0 + warp * 16 + g);
  const bool lo_live = lo_row < count;
  const bool hi_live = lo_row + 8 < count;
  if constexpr (Rows::SCALED) {
    const float s_lo = lo_live ? scales[lo_row] : 0.0f;
    const float s_hi = hi_live ? scales[lo_row + 8] : 0.0f;
#pragma unroll
    for (int n = 0; n < MMA_QB / 8; ++n) {
      acc[n][0] *= s_lo;
      acc[n][1] *= s_lo;
      acc[n][2] *= s_hi;
      acc[n][3] *= s_hi;
    }
  }
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
    tat::bucket_maxima_mma_kernel<tat::RowsBf16, WITH_IDX>
        <<<(unsigned)(nb * n_qb), tat::THREADS, 0, st>>>(
            (const __nv_bfloat16*)emb, nullptr, (const __nv_bfloat16*)q,
            n_rows, d_pad, b, count, out, out_idx, nb);
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

// K8 (kind 0) and K9 (kind 1): bucket maxima over an int8 shadow
// ([n_rows, width] codes, width % 64 == 0) or a column-split packed int4
// shadow ([n_rows, width] bytes, width % 32 == 0), each row's sums times
// scales[row] ([n_rows] f32). q: bf16, [b, width] for kind 0 and the split
// halves [b, 2 * width] for kind 1; every pointer 16-byte aligned. out:
// [b, nb] f32 with nb = n_rows / 128. Returns cudaGetLastError().
extern "C" int tat_bucket_maxima_q(const int8_t* emb, int kind,
                                   const float* scales, const void* q,
                                   int64_t n_rows, int width, int b,
                                   int64_t count, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t nb = n_rows / tat::RB;
  const unsigned grid = (unsigned)(nb * ((b + tat::MMA_QB - 1) / tat::MMA_QB));
  const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
  if (kind == 0) {
    tat::bucket_maxima_mma_kernel<tat::RowsI8, false>
        <<<grid, tat::THREADS, 0, st>>>(emb, scales, qb, n_rows, width, b,
                                        count, out, nullptr, nb);
  } else {
    tat::bucket_maxima_mma_kernel<tat::RowsI4, false>
        <<<grid, tat::THREADS, 0, st>>>(emb, scales, qb, n_rows, width, b,
                                        count, out, nullptr, nb);
  }
  return (int)cudaGetLastError();
}
