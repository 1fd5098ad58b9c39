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
//   bf16 stores (the hybrid route's shadow, bf16 stores): the [128 x 64]
//   tile is computed with mma.sync m16n8k16 bf16 -> f32, each of the 8
//   warps owning a 32-row x 32-query tile whose fragments come from
//   shared memory by ldmatrix (2 KB per 16-deep step for 8 mma.sync; a
//   16 x 64 warp tile read 2.5 KB with four times the load instructions).
//   The 64 bf16 queries (cast once by the wrapper) stay in shared memory
//   for the whole depth (48 KB at d = 384) while 64-deep row strips stream
//   through a ring of three 16-byte cp.async stages, copies running two
//   strips ahead of the mma.sync across bucket edges, so a bucket's
//   epilogue overlaps the next bucket's loads; the strip loop keeps its
//   positions in incremental counters (no 64-bit division per strip).
//   Rows too wide for resident queries (the kernel's shared memory must
//   let two CTAs share an SM) stream the query strip in the same ring.
//   Products of bf16 values are exact and sum in f32, as in the JAX
//   kernel's bf16 x bf16 -> f32 MXU pass. Row pitches keep the fragment
//   loads free of bank conflicts.
//   int8 shadows (K8): each 16-byte load brings 16 codes, written to
//   shared memory as bf16 (every int8 value is exact in bf16), so the same
//   mma.sync pass computes the JAX kernel's bf16 x (int8 -> bf16) product.
//   Packed int4 shadows (K9): byte [i, c] holds column c (low nibble) and
//   column c + ceil(d/2) (high nibble). A strip takes 32 packed bytes of a
//   row and stages their 32 low nibbles then their 32 high nibbles as one
//   64-deep bf16 strip; it meets the matching 32 columns of each split
//   query half. The sum over all strips is the JAX kernel's two half-width
//   dots in one, up to f32 summation order.
//   Both convert while they stage, so their strips cannot ride a raw
//   cp.async: they are loaded into registers a strip ahead and converted
//   into a two-slot ring after the strip before is multiplied. Both
//   multiply each row's f32 sums by the row's scale, then mask rows at the
//   watermark (scale first, then mask, as the JAX kernels do).
//   f32 stores: the FFMA tile of tile.cuh over the CTA's bucket range (no
//   TF32: f32 stores must score at Precision.HIGHEST).

#include "tile.cuh"

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

  scan_tiles<float, TQ>(emb, q, n_rows, d_pad, b, g.q0, g.t_begin, g.t_end, smem,
                        [&](int64_t r0, const float* S) {
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
// bf16, int8 and int4 shadows: tensor-core tile
// ---------------------------------------------------------------------------

constexpr int MMA_KC = 64;             // depth per strip
constexpr int MMA_PITCH = MMA_KC + 8;  // bf16 per smem row: 144 bytes
constexpr int MMA_QB = 64;             // queries per CTA (8 mma n-tiles)
// Warp w owns rows (w & 3) * 32 .. +31 (two m-tiles) of all its CTA's
// queries (w >> 2) * 32 .. +31 (four n-tiles): a 32 x 32 warp tile reads
// 2 KB of fragments per 16-deep step for its 8 mma.sync.
constexpr int ROW_WARPS = 4;
constexpr int RED_BYTES = ROW_WARPS * MMA_QB * 4;  // one cross-warp table

__device__ __forceinline__ void mma_bf16_16x8x16(float c[4], const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; register j gets matrix j in the mma.sync
// fragment layout (row lane / 4, columns 2 * (lane % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// Two bf16 values as the 32-bit pair mma.sync reads (lo at the lower
// column).
__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Row types of the tensor-core tile. Each stages a strip of RB rows into a
// ring slot as MMA_KC bf16 columns (rows at or past `limit` read as zero):
// Regs::fetch starts the strip's loads and Regs::put finishes it after the
// strip before has been multiplied. `width` is a row's length in elements
// of T, `c0` the strip's first element; qcol(c0, x, width) is the query
// column that strip column x meets.

// bf16 rows (K2, K2'): 16-byte cp.async copies, three stages in flight.
struct RowsBf16 {
  using T = __nv_bfloat16;
  static constexpr int COLS = MMA_KC;  // row elements per strip
  static constexpr int STAGES = 3;
  static constexpr bool SCALED = false;
  static constexpr bool SPLIT_QUERIES = false;
  static __device__ __forceinline__ int qcol(int c0, int x, int) { return c0 + x; }
  struct Regs {
    __device__ __forceinline__ void fetch(__nv_bfloat16 (*dst)[MMA_PITCH], const T* __restrict__ src,
                                          int64_t first, int64_t limit, int width, int c0) {
      for (int i = threadIdx.x; i < RB * (MMA_KC / 8); i += THREADS) {
        const int ri = i / (MMA_KC / 8), c8 = (i % (MMA_KC / 8)) * 8;
        const int64_t gr = first + ri;
        cp_async16(&dst[ri][c8], gr < limit ? src + gr * width + c0 + c8 : src, gr < limit);
      }
    }
    __device__ __forceinline__ void put(__nv_bfloat16 (*)[MMA_PITCH]) const {}
  };
};

// int8 rows (K8): 16 codes per 16-byte load, 4 loads per row strip.
struct RowsI8 {
  using T = int8_t;
  static constexpr int COLS = MMA_KC;
  static constexpr int STAGES = 2;
  static constexpr bool SCALED = true;
  static constexpr bool SPLIT_QUERIES = false;
  static __device__ __forceinline__ int qcol(int c0, int x, int) { return c0 + x; }
  struct Regs {
    static constexpr int LOADS = RB * (MMA_KC / 16) / THREADS;
    uint4 v[LOADS];
    __device__ __forceinline__ void fetch(__nv_bfloat16 (*)[MMA_PITCH], const T* __restrict__ src,
                                          int64_t first, int64_t limit, int width, int c0) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = threadIdx.x + u * THREADS;
        const int64_t gr = first + i / (MMA_KC / 16);
        v[u] = gr < limit ? *reinterpret_cast<const uint4*>(src + gr * width + c0 + (i % (MMA_KC / 16)) * 16)
                          : make_uint4(0, 0, 0, 0);
      }
    }
    __device__ __forceinline__ void put(__nv_bfloat16 (*dst)[MMA_PITCH]) const {
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = threadIdx.x + u * THREADS;
        const int ri = i / (MMA_KC / 16), c16 = (i % (MMA_KC / 16)) * 16;
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
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
};

// Column-split packed int4 rows (K9): a strip is 32 packed bytes of a row,
// one 16-byte load per half; their low nibbles fill strip columns 0-31 and
// their high nibbles columns 32-63, which meet the same columns of the
// split queries' low and high halves (q is [b, 2 * width], the high half
// starting at column `width`).
struct RowsI4 {
  using T = int8_t;
  static constexpr int COLS = MMA_KC / 2;
  static constexpr int STAGES = 2;
  static constexpr bool SCALED = true;
  static constexpr bool SPLIT_QUERIES = true;
  static __device__ __forceinline__ int qcol(int c0, int x, int width) {
    return x < MMA_KC / 2 ? c0 + x : width + c0 + x - MMA_KC / 2;
  }
  struct Regs {
    uint4 v;
    __device__ __forceinline__ void fetch(__nv_bfloat16 (*)[MMA_PITCH], const T* __restrict__ src,
                                          int64_t first, int64_t limit, int width, int c0) {
      static_assert(RB * 2 == THREADS, "one load per thread");
      const int64_t gr = first + threadIdx.x / 2;
      v = gr < limit ? *reinterpret_cast<const uint4*>(src + gr * width + c0 + (threadIdx.x % 2) * 16)
                     : make_uint4(0, 0, 0, 0);
    }
    __device__ __forceinline__ void put(__nv_bfloat16 (*dst)[MMA_PITCH]) const {
      const int ri = threadIdx.x / 2, c16 = (threadIdx.x % 2) * 16;
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
  };
};

// Dynamic shared memory of bucket_maxima_mma_kernel, in this order: the
// cross-warp tables (red, then red_row for K2'), the resident query block
// [MMA_QB][qw + 8] (RESIDENT only), then Rows::STAGES ring slots, each a
// row strip [RB][MMA_PITCH] and, without resident queries, a query strip
// [MMA_QB][MMA_PITCH]. qw is the query width in bf16.
template <typename Rows, bool RESIDENT, bool WITH_IDX>
struct MmaSmem {
  static constexpr int RED = RED_BYTES * (WITH_IDX ? 2 : 1);
  static constexpr int SLOT = (RB + (RESIDENT ? 0 : MMA_QB)) * MMA_PITCH;  // bf16
  static __host__ __device__ int q_pitch(int qw) { return qw + 8; }
  static __host__ __device__ int bytes(int qw) {
    return RED + (RESIDENT ? MMA_QB * q_pitch(qw) * 2 : 0) + Rows::STAGES * SLOT * 2;
  }
};

// q: [b, width] bf16 for bf16 and int8 rows, [b, 2 * width] (the split
// halves) for packed int4 rows; the wrapper casts the f32 queries once, as
// the JAX kernels' callers cast queries to bf16. scales: [n_rows] f32 for
// the scaled row types, unused for bf16 rows.
template <typename Rows, bool RESIDENT, bool WITH_IDX>
__global__ void __launch_bounds__(THREADS, 2)
    bucket_maxima_mma_kernel(const typename Rows::T* __restrict__ emb,
                             const float* __restrict__ scales,
                             const __nv_bfloat16* __restrict__ q,
                             int64_t n_rows, int width, int b, int64_t count,
                             float* out, int* out_idx, int64_t nb,
                             int64_t buckets_per_cta) {
  using Smem = MmaSmem<Rows, RESIDENT, WITH_IDX>;
  using Strip = __nv_bfloat16 (*)[MMA_PITCH];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float(*red)[MMA_QB] = reinterpret_cast<float(*)[MMA_QB]>(smem_raw);
  int(*red_row)[MMA_QB] = reinterpret_cast<int(*)[MMA_QB]>(smem_raw + RED_BYTES);
  const int qw = Rows::SPLIT_QUERIES ? 2 * width : width;
  const int qp = RESIDENT ? Smem::q_pitch(qw) : MMA_PITCH;
  __nv_bfloat16* const qres = reinterpret_cast<__nv_bfloat16*>(smem_raw + Smem::RED);
  __nv_bfloat16* const ring = qres + (RESIDENT ? MMA_QB * qp : 0);

  const BucketRange g(b, MMA_QB, count, buckets_per_cta);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) % ROW_WARPS;  // row group of 32
  const int wq = (tid >> 5) / ROW_WARPS;  // query half of 32
  const int gr = lane >> 2;  // fragment row group
  const int t = lane & 3;    // thread in group
  const int n_strips = width / Rows::COLS;
  const int steps = (int)(g.t_end - g.t_begin) * n_strips;

  if (steps > 0) {
    if constexpr (RESIDENT) {  // the query block, once, with the first strip
      for (int i = tid; i < MMA_QB * (qw / 8); i += THREADS) {
        const int qi = i / (qw / 8), c8 = (i % (qw / 8)) * 8;
        const int gq = g.q0 + qi;
        cp_async16(qres + qi * qp + c8, gq < b ? q + (int64_t)gq * qw + c8 : q, gq < b);
      }
    }
    // The next strip to fetch: its index, ring slot, depth offset and rows.
    int f = 0, f_slot = 0, f_c0 = 0;
    int64_t f_r0 = g.t_begin * RB;
    // Starts the loads of strip f into its slot (regs keeps them for put
    // when Rows converts while staging) and moves on to the next strip.
    auto fetch_next = [&](typename Rows::Regs& regs) {
      __nv_bfloat16* const slot = ring + f_slot * Smem::SLOT;
      regs.fetch(reinterpret_cast<Strip>(slot), emb, f_r0, n_rows, width, f_c0);
      if constexpr (!RESIDENT) {
        __nv_bfloat16* const qs = slot + RB * MMA_PITCH;
        for (int i = tid; i < MMA_QB * (MMA_KC / 8); i += THREADS) {
          const int qi = i / (MMA_KC / 8), c8 = (i % (MMA_KC / 8)) * 8;
          const int gq = g.q0 + qi;
          cp_async16(qs + qi * MMA_PITCH + c8,
                     gq < b ? q + (int64_t)gq * qw + Rows::qcol(f_c0, c8, width) : q, gq < b);
        }
      }
      ++f;
      f_slot = f_slot + 1 == Rows::STAGES ? 0 : f_slot + 1;
      f_c0 += Rows::COLS;
      if (f_c0 == width) {
        f_c0 = 0;
        f_r0 += RB;
      }
      return reinterpret_cast<Strip>(slot);
    };
#pragma unroll
    for (int p = 0; p < Rows::STAGES - 1; ++p) {
      if (f < steps) {
        typename Rows::Regs regs;
        regs.put(fetch_next(regs));
      }
      cp_async_commit();
    }

    // acc[m][n][.]: rows wr*32 + m*16 + {gr, gr+8}, queries wq*32 + n*8 +
    // 2t + {0, 1}.
    float acc[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

    // The strip being multiplied: its ring slot, depth offset and bucket.
    int c_slot = 0, c_c0 = 0;
    int64_t bucket = g.t_begin;
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<Rows::STAGES - 2>();
      __syncthreads();  // strip s is in its slot; the slot of strip s-1 is free
      typename Rows::Regs regs;
      Strip pending = nullptr;
      if (f < steps) pending = fetch_next(regs);
      cp_async_commit();

      const __nv_bfloat16* const es = ring + c_slot * Smem::SLOT;
      const __nv_bfloat16* const qbase = RESIDENT ? qres : es + RB * MMA_PITCH;
      // ldmatrix addresses: A rows (lane & 15) of each m-tile at column
      // (lane >> 4) * 8; B query rows (lane & 7) of n-tile 2p + (lane >> 4)
      // at column ((lane >> 3) & 1) * 8.
      const __nv_bfloat16* const a_row = es + (wr * 32 + (lane & 15)) * MMA_PITCH + (lane >> 4) * 8;
      const __nv_bfloat16* const b_row =
          qbase + (wq * 32 + (lane >> 4) * 8 + (lane & 7)) * qp + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < MMA_KC; kk += 16) {
        uint32_t a[2][4], bq[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) ldsm_x4(a[m], a_row + m * 16 * MMA_PITCH + kk);
        const int qc = RESIDENT ? Rows::qcol(c_c0, kk, width) : kk;
#pragma unroll
        for (int p = 0; p < 2; ++p) ldsm_x4(bq[p], b_row + p * 16 * qp + qc);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16_16x8x16(acc[m][n], a[m], bq[n >> 1][2 * (n & 1)], bq[n >> 1][2 * (n & 1) + 1]);
      }
      if (pending != nullptr) regs.put(pending);

      c_slot = c_slot + 1 == Rows::STAGES ? 0 : c_slot + 1;
      c_c0 += Rows::COLS;
      if (c_c0 != width) continue;  // uniform: the bucket is not done
      c_c0 = 0;

      // Scale (int8 and int4 rows), mask rows at the watermark, then the
      // max over the warp's 32 rows (lanes sharing t hold the same
      // queries), then over the 4 row warps (ascending row groups).
      const int row0 = (int)(bucket * RB) + wr * 32 + gr;  // + 8*h2, h2 < 4
      bool live[4];
      float scale[4];
#pragma unroll
      for (int h2 = 0; h2 < 4; ++h2) {
        live[h2] = row0 + 8 * h2 < count;
        if constexpr (Rows::SCALED) scale[h2] = live[h2] ? scales[row0 + 8 * h2] : 0.0f;
      }
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
            float v = acc[h2 >> 1][n][2 * (h2 & 1) + h];
            if constexpr (Rows::SCALED) v *= scale[h2];
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
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;
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
      ++bucket;
      // The next bucket's first barrier orders these reads before its
      // writes to red.
    }
  }
  g.write_dead<WITH_IDX>(out, out_idx, b, MMA_QB, nb);
}

template <typename Rows, bool WITH_IDX>
int launch_mma(const typename Rows::T* emb, const float* scales, const __nv_bfloat16* q,
               int64_t n_rows, int width, int b, int64_t count, int64_t buckets_per_cta,
               int ctas_per_qb, float* out, int* out_idx, cudaStream_t st) {
  const int qw = Rows::SPLIT_QUERIES ? 2 * width : width;
  const dim3 grid((unsigned)(((b + MMA_QB - 1) / MMA_QB) * ctas_per_qb));
  // Resident queries where two CTAs still share an SM, else streamed.
  int smem = MmaSmem<Rows, true, WITH_IDX>::bytes(qw);
  auto kernel = bucket_maxima_mma_kernel<Rows, true, WITH_IDX>;
  if (smem > SMEM_2CTA) {
    smem = MmaSmem<Rows, false, WITH_IDX>::bytes(qw);
    kernel = bucket_maxima_mma_kernel<Rows, false, WITH_IDX>;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, st>>>(emb, scales, q, n_rows, width, b, count, out, out_idx,
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
    return launch_mma<RowsBf16, WITH_IDX>((const __nv_bfloat16*)emb, nullptr,
                                          (const __nv_bfloat16*)q, n_rows, d_pad, b, count,
                                          buckets_per_cta, ctas_per_qb, out, out_idx, st);
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
// halves [b, 2 * width] for kind 1; every pointer 16-byte aligned. out:
// [b, nb] f32 with nb = n_rows / 128; geometry as tat_bucket_maxima's
// (query blocks of 64). Returns cudaGetLastError().
extern "C" int tat_bucket_maxima_q(const int8_t* emb, int kind,
                                   const float* scales, const void* q,
                                   int64_t n_rows, int width, int b,
                                   int64_t count, int64_t buckets_per_cta,
                                   int ctas_per_qb, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
  if (kind == 0)
    return tat::launch_mma<tat::RowsI8, false>(emb, scales, qb, n_rows, width, b, count,
                                               buckets_per_cta, ctas_per_qb, out, nullptr, st);
  return tat::launch_mma<tat::RowsI4, false>(emb, scales, qb, n_rows, width, b, count,
                                             buckets_per_cta, ctas_per_qb, out, nullptr, st);
}
