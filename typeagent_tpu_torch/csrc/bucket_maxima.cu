// K2: per-bucket (128 consecutive rows) maximum raw cosine; K2': the same
// with the argmax row of each bucket; K8 and K9: K2 over an int8 or a packed
// int4 selection shadow with per-row scales.
//
// Replaces: typeagent_tpu/ops/topk.py  _topk_bucket_kernel, launched by
//   _bucket_maxima_pallas: with_idx=False (K2, phase 1 of the exact2 and
//   hybrid exact2 searches) and with_idx=True (K2', the bucketed approx
//   search cosine_topk_bucket). Both forms are one template: the argmax
//   code is compiled only into the WITH_IDX=true instances.
// Replaces: typeagent_tpu/ops/topk.py  _bucket_maxima_kernel_q, launched by
//   _bucket_maxima_pallas_q (K8, phase 1 of cosine_topk_exact2_hybrid_i8),
//   and typeagent_tpu/ops/int4.py  _bucket_maxima_kernel_q4, launched by
//   _bucket_maxima_pallas_q4 (K9, phase 1 of cosine_topk_exact2_i4). Both
//   run the wgmma form of the bf16 kernel's strip loop (wgmma_tile.cuh)
//   with a row type that converts its codes while staging, then scale
//   each row's sums.
//
// Argmax rule: the lowest row among equal maxima (jnp.argmax in the JAX
//   kernel). Each thread scans its own rows in ascending order keeping the
//   first strict maximum, and every cross-lane or cross-warp combine takes
//   the lower row on equal values, so the rule holds whatever the order of
//   the reduction. A bucket with no live row gives (-3, -1).
//
// What bounds it on an H100: phase 1 reads the store (n*d*itemsize bytes:
//   0.77 GB for the 1M x 384 bf16 shadow, 0.23 ms at 3.35 TB/s) and does
//   2*b*n*d operations (197 GFLOP at b=256): 0.2 ms on the tensor cores
//   (989 TFLOP/s bf16 dense), so the read is the bound; in FP32 FFMA (f32
//   stores) the product is, at ~3 ms. The int8 shadow reads 0.39 GB and
//   the int4 one 0.26 GB at 1M x 384, so for K8 and K9 the bf16 product
//   (0.2 ms) is the bound. The first design (one CTA per bucket and query
//   block, strips staged through registers between two barriers) left
//   the copies and the mma.sync work unoverlapped and staged the 48 KB
//   query block again for every bucket: 1.5 GB of L2 reads per b=256
//   call, twice the shadow.
//
// Design: only the [b, nb] maxima reach device memory, and one CTA owns
//   each bucket it scores for its block of queries, so no reduction
//   crosses CTAs and the TPU kernel's sequential output block (and its
//   lane-roll blend, a Mosaic workaround) has no counterpart. The grid is
//   one wave of persistent CTAs (two per SM, ops/topk.py bucket_geometry):
//   each owns one query block and walks a contiguous range of live
//   buckets; the query blocks of one range run side by side, so the range
//   is read from device memory once and from L2 after. Buckets wholly at
//   or past the watermark skip the product and are spread over the CTAs.
//   bf16 stores (the hybrid route's shadow, bf16 stores): the tensor-core
//   strip loop of mma_tile.cuh (mma.sync bf16 -> f32 on 32 x 32 warp
//   tiles, queries resident in shared memory, a ring of row strips running
//   ahead across bucket edges), whose epilogue here reduces each finished
//   bucket. A 16 x 64 warp tile read 2.5 KB of fragments per 16-deep step
//   against the 32 x 32 tile's 2 KB, with four times the load
//   instructions.
//   int8 shadows (K8) and packed int4 shadows (K9): the same loop on
//   wgmma (wgmma_tile.cuh: each warpgroup a 64-row x 64-query m64n64k16
//   product from swizzled shared memory); the conversion of their codes
//   to bf16, not the product, sets their pace (wgmma_tile.cuh says how
//   much). Each bucket's scales are loaded a bucket ahead. K9's strips
//   walk only the packed bytes that hold codes (ops/int4.py live_depth:
//   192 of 256 at d = 384): the padding past them meets query columns
//   that split_pad_queries zeroes. Each row's f32 sums are multiplied by
//   the row's scale, then rows at the watermark are masked (scale first,
//   then mask, as the JAX kernels do).
//   f32 stores: the FFMA tile of tile.cuh over the CTA's bucket range (no
//   TF32: f32 stores must score at Precision.HIGHEST).

#include "wgmma_tile.cuh"

namespace tat {

// (value, row) pair of a running argmax: the larger value wins, the lower
// row wins a tie. A pair with no live row is (RAW_NEG, -1); since every
// live score is > RAW_NEG, such a pair never beats a live one.
__device__ __forceinline__ void argmax_combine(float& m, int& r, float om, int orow) {
  if (om > m || (om == m && (unsigned)orow < (unsigned)r)) {
    m = om;
    r = orow;
  }
}

// The CTA's share of the grid: the query block starting at q0, the bucket
// range [t_begin, t_end) of the live_nb live buckets, and its index `cta`
// of the `ctas` CTAs of its query block.
struct BucketRange {
  int q0, cta, ctas;
  int64_t live_nb, t_begin, t_end;

  __device__ __forceinline__ BucketRange(int b, int qb_size, int64_t count,
                                         int64_t buckets_per_cta) {
    const int n_qb = (b + qb_size - 1) / qb_size;
    q0 = (int)(blockIdx.x % n_qb) * qb_size;
    cta = (int)(blockIdx.x / n_qb);
    ctas = (int)(gridDim.x / n_qb);
    live_nb = (count + RB - 1) / RB;
    t_begin = (int64_t)cta * buckets_per_cta;
    t_end = t_begin + buckets_per_cta < live_nb ? t_begin + buckets_per_cta : live_nb;
    if (t_end < t_begin) t_end = t_begin;
  }

  // Buckets wholly at or past the watermark: (-3, -1), strided over the
  // query block's CTAs.
  template <bool WITH_IDX>
  __device__ __forceinline__ void write_dead(float* out, int* out_idx, int b, int qb_size,
                                             int64_t nb) const {
    for (int64_t bucket = live_nb + cta; bucket < nb; bucket += ctas)
      for (int i = threadIdx.x; i < qb_size; i += THREADS)
        if (q0 + i < b) {
          out[(int64_t)(q0 + i) * nb + bucket] = RAW_NEG;
          if (WITH_IDX) out_idx[(int64_t)(q0 + i) * nb + bucket] = -1;
        }
  }
};

// ---------------------------------------------------------------------------
// f32 stores: FFMA tile
// ---------------------------------------------------------------------------

template <int TQ, bool WITH_IDX>
__global__ void __launch_bounds__(THREADS, 2)
    bucket_maxima_f32_kernel(const float* __restrict__ emb,
                             const float* __restrict__ q, int64_t n_rows,
                             int d_pad, int b, int64_t count, float* out,
                             int* out_idx, int64_t nb, int64_t buckets_per_cta) {
  extern __shared__ __align__(16) float smem[];
  constexpr int QB = FfmaTile<TQ>::QB;
  const BucketRange g(b, QB, count, buckets_per_cta);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  scan_tiles<float, TQ>(emb, q, n_rows, d_pad, b, g.q0, (int)(g.t_end - g.t_begin),
                        TileRange{g.t_begin}, smem, [&](int64_t r0, const float* S) {
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int ql = warp * TQ + i;
      float m = RAW_NEG;
      int row = -1;  // argmax row (WITH_IDX only)
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // this lane's rows, ascending
        const int64_t r = r0 + lane + 32 * j;
        if (r < count) {
          const float v = S[ql * SP + lane + 32 * j];
          if (WITH_IDX) {
            if (v > m) {
              m = v;
              row = (int)r;
            }
          } else {
            m = fmaxf(m, v);
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
      const int gq = g.q0 + ql;
      if (lane == 0 && gq < b) {
        out[(int64_t)gq * nb + r0 / RB] = m;
        if (WITH_IDX) out_idx[(int64_t)gq * nb + r0 / RB] = row;
      }
    }
  });
  g.write_dead<WITH_IDX>(out, out_idx, b, QB, nb);
}

// ---------------------------------------------------------------------------
// bf16 stores (K2, K2'): the tensor-core loop of mma_tile.cuh
// ---------------------------------------------------------------------------

constexpr int RED_BYTES = ROW_WARPS * MMA_QB * 4;  // one cross-warp table

// Dynamic shared memory of bucket_maxima_mma_kernel: the cross-warp tables
// (red, then red_row for K2'), then the loop's resident query block and
// ring (MmaLoopSmem).
template <bool RESIDENT, bool WITH_IDX>
struct MmaSmem {
  static constexpr int RED = RED_BYTES * (WITH_IDX ? 2 : 1);
  static __host__ __device__ int bytes(int qw) { return RED + MmaLoopSmem<RowsBf16, RESIDENT>::bytes(qw); }
};

// q: [b, width] bf16; the wrapper casts the f32 queries once, as the JAX
// kernels' callers cast queries to the store's dtype.
template <bool RESIDENT, bool WITH_IDX>
__global__ void __launch_bounds__(THREADS, 2)
    bucket_maxima_mma_kernel(const __nv_bfloat16* __restrict__ emb,
                             const __nv_bfloat16* __restrict__ q,
                             int64_t n_rows, int width, int b, int64_t count,
                             float* out, int* out_idx, int64_t nb,
                             int64_t buckets_per_cta) {
  using Smem = MmaSmem<RESIDENT, WITH_IDX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float(*red)[MMA_QB] = reinterpret_cast<float(*)[MMA_QB]>(smem_raw);
  int(*red_row)[MMA_QB] = reinterpret_cast<int(*)[MMA_QB]>(smem_raw + RED_BYTES);

  const BucketRange g(b, MMA_QB, count, buckets_per_cta);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) % ROW_WARPS;  // row group of 32
  const int wq = (tid >> 5) / ROW_WARPS;  // query half of 32
  const int gr = lane >> 2;  // fragment row group
  const int t = lane & 3;    // thread in group

  mma_tiles<RowsBf16, RESIDENT>(
      emb, q, n_rows, width, b, g.q0, (int)(g.t_end - g.t_begin),
      TileRange{g.t_begin}, smem_raw + Smem::RED,
      [&](int64_t bucket, const float(&acc)[2][4][4]) {
        // Mask rows at the watermark, then the max over the warp's 32 rows
        // (lanes sharing t hold the same queries), then over the 4 row
        // warps (ascending row groups).
        const int row0 = (int)(bucket * RB) + wr * 32 + gr;  // + 8*h2, h2 < 4
        bool live[4];
#pragma unroll
        for (int h2 = 0; h2 < 4; ++h2) live[h2] = row0 + 8 * h2 < count;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // This thread's rows row0 + 8*h2 in ascending order: m-tile
            // h2 >> 1, fragment half h2 & 1.
            float m = RAW_NEG;
            int row = -1;
#pragma unroll
            for (int h2 = 0; h2 < 4; ++h2) {
              const float v = acc[h2 >> 1][n][2 * (h2 & 1) + h];
              if (live[h2]) {
                if (WITH_IDX) {
                  if (v > m) {
                    m = v;
                    row = row0 + 8 * h2;
                  }
                } else {
                  m = fmaxf(m, v);
                }
              }
            }
#pragma unroll
            for (int off = 4; off <= 16; off <<= 1) {
              const float om = __shfl_xor_sync(FULL, m, off);
              if (WITH_IDX) {
                argmax_combine(m, row, om, __shfl_xor_sync(FULL, row, off));
              } else {
                m = fmaxf(m, om);
              }
            }
            if (gr == 0) {
              red[wr][wq * 32 + n * 8 + 2 * t + h] = m;
              if (WITH_IDX) red_row[wr][wq * 32 + n * 8 + 2 * t + h] = row;
            }
          }
        }
        __syncthreads();
        if (tid < MMA_QB && g.q0 + tid < b) {
          float m = red[0][tid];
          int row = WITH_IDX ? red_row[0][tid] : -1;
#pragma unroll
          for (int w = 1; w < ROW_WARPS; ++w) {
            if (WITH_IDX) {
              argmax_combine(m, row, red[w][tid], red_row[w][tid]);
            } else {
              m = fmaxf(m, red[w][tid]);
            }
          }
          out[(int64_t)(g.q0 + tid) * nb + bucket] = m;
          if (WITH_IDX) out_idx[(int64_t)(g.q0 + tid) * nb + bucket] = row;
        }
        // The next bucket's first barrier orders these reads before its
        // writes to red.
      });
  g.write_dead<WITH_IDX>(out, out_idx, b, MMA_QB, nb);
}

// ---------------------------------------------------------------------------
// int8 and int4 shadows (K8, K9): the wgmma loop of wgmma_tile.cuh
// ---------------------------------------------------------------------------

// Dynamic shared memory of bucket_maxima_wgmma_kernel: room to align the
// loop's strips to the swizzle atom, the loop (WgmmaLoopSmem), then the
// cross-warp table [8 warps][64 queries].
template <typename Rows, bool RESIDENT>
struct WgmmaSmem {
  static constexpr int RED = (THREADS / 32) * MMA_QB * 4;
  static __host__ __device__ int loop_bytes(int n_strips) {
    return WgmmaLoopSmem<Rows, RESIDENT>::bytes(n_strips);
  }
  static __host__ __device__ int bytes(int n_strips) { return SW_ALIGN + loop_bytes(n_strips) + RED; }
};

// K8 and K9: K2's maxima over int8 or packed int4 rows, each row's sums
// times its scale, over the first `live` elements of each row (width for
// int8 rows). q: [b, width] bf16, or the split halves [b, 2 * width].
template <typename Rows, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
    bucket_maxima_wgmma_kernel(const typename Rows::T* __restrict__ emb,
                               const float* __restrict__ scales,
                               const __nv_bfloat16* __restrict__ q, int64_t n_rows, int width,
                               int live, int b, int64_t count, float* out, int64_t nb,
                               int64_t buckets_per_cta) {
  using Smem = WgmmaSmem<Rows, RESIDENT>;
  extern __shared__ __align__(16) unsigned char smem_wg[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_wg);
  unsigned char* const loop = smem_wg + ((SW_ALIGN - (raw & (SW_ALIGN - 1))) & (SW_ALIGN - 1));
  float(*red)[MMA_QB] =
      reinterpret_cast<float(*)[MMA_QB]>(loop + Smem::loop_bytes(live / Rows::COLS));

  const BucketRange g(b, MMA_QB, count, buckets_per_cta);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gr = lane >> 2;  // accumulator row group
  const int t = lane & 3;    // thread in group

  // This thread's rows of a bucket: warp w holds rows 16w + gr + {0, 8}
  // (warpgroup w / 4 its rows 64 * (w / 4) + ..., warp w % 4 of it 16 of
  // them). Their scales are loaded a bucket ahead, so the epilogue does
  // not wait out a load.
  auto row_of = [&](int64_t bucket, int h2) { return (int)(bucket * RB) + 16 * warp + gr + 8 * h2; };
  float next_scale[2];
  auto load_scales = [&](int64_t bucket) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2)
      next_scale[h2] = row_of(bucket, h2) < count ? scales[row_of(bucket, h2)] : 0.0f;
  };
  load_scales(g.t_begin);

  wgmma_tiles<Rows, RESIDENT>(
      emb, q, n_rows, width, live, b, g.q0, (int)(g.t_end - g.t_begin), TileRange{g.t_begin},
      loop, [&](int64_t bucket, const float(&acc)[32]) {
        // Scale, mask rows at the watermark, then the max over the warp's
        // 16 rows (lanes sharing t hold the same queries), then over the 8
        // warps.
        bool live_row[2];
        float scale[2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          live_row[h2] = row_of(bucket, h2) < count;
          scale[h2] = next_scale[h2];
        }
        load_scales(bucket + 1);
#pragma unroll
        for (int n = 0; n < MMA_QB / 8; ++n) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float m = RAW_NEG;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const float v = acc[4 * n + 2 * h2 + h] * scale[h2];
              if (live_row[h2]) m = fmaxf(m, v);
            }
#pragma unroll
            for (int off = 4; off <= 16; off <<= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
            if (gr == 0) red[warp][n * 8 + 2 * t + h] = m;
          }
        }
        __syncthreads();
        if (tid < MMA_QB && g.q0 + tid < b) {
          float m = red[0][tid];
#pragma unroll
          for (int w = 1; w < THREADS / 32; ++w) m = fmaxf(m, red[w][tid]);
          out[(int64_t)(g.q0 + tid) * nb + bucket] = m;
        }
        // The next strip's barrier orders these reads before the next
        // bucket's writes to red.
      });
  g.write_dead<false>(out, nullptr, b, MMA_QB, nb);
}

template <typename Rows>
int launch_wgmma(const int8_t* emb, const float* scales, const __nv_bfloat16* q,
                 int64_t n_rows, int width, int live, int b, int64_t count,
                 int64_t buckets_per_cta, int ctas_per_qb, float* out, cudaStream_t st) {
  if (live <= 0 || live > width || live % Rows::COLS) return (int)cudaErrorInvalidValue;
  const int n_strips = live / Rows::COLS;
  const dim3 grid((unsigned)(((b + MMA_QB - 1) / MMA_QB) * ctas_per_qb));
  // Resident queries where two CTAs still share an SM, else streamed.
  int smem = WgmmaSmem<Rows, true>::bytes(n_strips);
  auto kernel = bucket_maxima_wgmma_kernel<Rows, true>;
  if (smem > SMEM_2CTA) {
    smem = WgmmaSmem<Rows, false>::bytes(n_strips);
    kernel = bucket_maxima_wgmma_kernel<Rows, false>;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, st>>>(emb, scales, q, n_rows, width, live, b, count, out,
                                      n_rows / RB, buckets_per_cta);
  return (int)cudaGetLastError();
}

template <bool WITH_IDX>
int launch_mma(const __nv_bfloat16* emb, const __nv_bfloat16* q, int64_t n_rows, int width,
               int b, int64_t count, int64_t buckets_per_cta, int ctas_per_qb, float* out,
               int* out_idx, cudaStream_t st) {
  const dim3 grid((unsigned)(((b + MMA_QB - 1) / MMA_QB) * ctas_per_qb));
  // Resident queries where two CTAs still share an SM, else streamed.
  int smem = MmaSmem<true, WITH_IDX>::bytes(width);
  auto kernel = bucket_maxima_mma_kernel<true, WITH_IDX>;
  if (smem > SMEM_2CTA) {
    smem = MmaSmem<false, WITH_IDX>::bytes(width);
    kernel = bucket_maxima_mma_kernel<false, WITH_IDX>;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, st>>>(emb, q, n_rows, width, b, count, out, out_idx,
                                      n_rows / RB, buckets_per_cta);
  return (int)cudaGetLastError();
}

template <int TQ, bool WITH_IDX>
int launch_f32_tq(const float* emb, const float* q, int64_t n_rows, int d_pad, int b,
                  int64_t count, int64_t buckets_per_cta, int ctas_per_qb, float* out,
                  int* out_idx, cudaStream_t st) {
  constexpr int smem = FfmaTile<TQ>::SMEM_BYTES;
  auto kernel = bucket_maxima_f32_kernel<TQ, WITH_IDX>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((unsigned)(((b + FfmaTile<TQ>::QB - 1) / FfmaTile<TQ>::QB) * ctas_per_qb));
  kernel<<<grid, THREADS, smem, st>>>(emb, q, n_rows, d_pad, b, count, out, out_idx,
                                      n_rows / RB, buckets_per_cta);
  return (int)cudaGetLastError();
}

template <bool WITH_IDX>
int launch_bucket_maxima(const void* emb, int dtype, const void* q, int64_t n_rows,
                         int d_pad, int b, int64_t count, int64_t buckets_per_cta,
                         int ctas_per_qb, int query_block, float* out, int* out_idx,
                         cudaStream_t st) {
  if (dtype == 1) {
    if (query_block != MMA_QB) return (int)cudaErrorInvalidValue;
    return launch_mma<WITH_IDX>((const __nv_bfloat16*)emb, (const __nv_bfloat16*)q, n_rows,
                                d_pad, b, count, buckets_per_cta, ctas_per_qb, out, out_idx, st);
  }
  const float* e = (const float*)emb;
  const float* qf = (const float*)q;
  switch (query_block) {
    case 8:
      return launch_f32_tq<1, WITH_IDX>(e, qf, n_rows, d_pad, b, count, buckets_per_cta,
                                        ctas_per_qb, out, out_idx, st);
    case 16:
      return launch_f32_tq<2, WITH_IDX>(e, qf, n_rows, d_pad, b, count, buckets_per_cta,
                                        ctas_per_qb, out, out_idx, st);
    case 32:
      return launch_f32_tq<4, WITH_IDX>(e, qf, n_rows, d_pad, b, count, buckets_per_cta,
                                        ctas_per_qb, out, out_idx, st);
    case 64:
      return launch_f32_tq<8, WITH_IDX>(e, qf, n_rows, d_pad, b, count, buckets_per_cta,
                                        ctas_per_qb, out, out_idx, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tat

// q: [b, d_pad], f32 for an f32 store (dtype 0), bf16 for a bf16 store
// (dtype 1; then d_pad % 64 == 0). Every pointer 16-byte aligned, d_pad %
// 32 == 0. out: [b, nb] f32 with nb = n_rows / 128; out_idx: NULL for K2
// (maxima only), else [b, nb] int32 for K2' (the argmax rows). The grid
// geometry (buckets_per_cta, ctas_per_qb; query_block 8, 16, 32 or 64 for f32
// stores, 64 for bf16) comes from ops/topk.py bucket_geometry. Returns
// cudaGetLastError().
extern "C" int tat_bucket_maxima(const void* emb, int dtype, const void* q,
                                 int64_t n_rows, int d_pad, int b,
                                 int64_t count, int64_t buckets_per_cta,
                                 int ctas_per_qb, int query_block, float* out,
                                 int* out_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (out_idx == nullptr)
    return tat::launch_bucket_maxima<false>(emb, dtype, q, n_rows, d_pad, b, count,
                                            buckets_per_cta, ctas_per_qb, query_block, out,
                                            nullptr, st);
  return tat::launch_bucket_maxima<true>(emb, dtype, q, n_rows, d_pad, b, count,
                                         buckets_per_cta, ctas_per_qb, query_block, out,
                                         out_idx, st);
}

// K8 (kind 0) and K9 (kind 1): bucket maxima over an int8 shadow
// ([n_rows, width] codes, width % 64 == 0) or a column-split packed int4
// shadow ([n_rows, width] bytes, width % 32 == 0), each row's sums times
// scales[row] ([n_rows] f32). q: bf16, [b, width] for kind 0 and the split
// halves [b, 2 * width] for kind 1; every pointer 16-byte aligned. live:
// the depth the product walks, width for kind 0; for kind 1 the packed
// bytes that hold codes (ops/int4.py live_depth, a multiple of 32 up to
// width), whose query columns past it must be zero. out: [b, nb] f32 with
// nb = n_rows / 128; geometry as tat_bucket_maxima's (query blocks of 64).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a bad live.
extern "C" int tat_bucket_maxima_q(const int8_t* emb, int kind,
                                   const float* scales, const void* q,
                                   int64_t n_rows, int width, int live, int b,
                                   int64_t count, int64_t buckets_per_cta,
                                   int ctas_per_qb, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
  if (kind == 0)
    return tat::launch_wgmma<tat::RowsI8>(emb, scales, qb, n_rows, width, live, b, count,
                                          buckets_per_cta, ctas_per_qb, out, st);
  return tat::launch_wgmma<tat::RowsI4>(emb, scales, qb, n_rows, width, live, b, count,
                                        buckets_per_cta, ctas_per_qb, out, st);
}
