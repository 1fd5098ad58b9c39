// The tensor-core strip loop shared by the bf16 bucket kernels
// (bucket_maxima.cu: K2, K2' on bf16 stores) and the int8 top-k scans
// (topk.cu: K6, K7), and the row types that it and its wgmma form
// (wgmma_tile.cuh: K8, K9) stage: a persistent CTA multiplies its
// 64-query block against a sequence of 128-row tiles and hands each
// finished tile's accumulators to an epilogue (bucket maxima, argmax, or a
// top-k fold).
//
// The product is mma.sync m16n8k16 bf16 -> f32. Each of the 8 warps owns
// a 32-row x 32-query tile whose fragments come from shared memory by
// ldmatrix (2 KB per 16-deep step for 8 mma.sync). The 64 bf16 queries
// (cast once by the wrapper) stay in shared memory for the whole depth
// (48 KB at d = 384) while 64-deep row strips stream through a ring of
// slots, copies running ahead of the mma.sync across tile edges, so a
// tile's epilogue overlaps the next tile's loads; the loop keeps its
// positions in incremental counters (no 64-bit division per strip). Rows
// too wide for resident queries (the kernel's shared memory must let two
// CTAs share an SM) stream the query strip in the same ring. Products of
// bf16 values are exact and sum in f32, as in the JAX kernels' bf16 x bf16
// -> f32 MXU pass. Row pitches keep the fragment loads free of bank
// conflicts.
//
// Row types (how a strip reaches its ring slot as 64 bf16 columns):
//   bf16 rows: 16-byte cp.async copies, three stages in flight;
//   int8 rows: each 16-byte load brings 16 codes, written to shared memory
//     as bf16 (every int8 value is exact in bf16), so the same pass
//     computes the JAX kernels' bf16 x (int8 -> bf16) product;
//   packed int4 rows: byte [i, c] holds column c (low nibble) and column
//     c + ceil(d/2) (high nibble); a strip takes 32 packed bytes of a row
//     and stages their 32 low nibbles then their 32 high nibbles as one
//     64-deep strip, which meets the matching 32 columns of each split
//     query half (the JAX kernel's two half-width dots in one, up to f32
//     summation order); only the wgmma loop stages them.
//   The int8 and int4 rows convert while they stage, so their strips
//   cannot ride a raw cp.async: they are loaded into registers a strip
//   ahead and converted into a two-slot ring after the strip before is
//   multiplied.

#pragma once

#include "tile.cuh"

namespace tat {

constexpr int MMA_KC = 64;             // depth per strip
constexpr int MMA_PITCH = MMA_KC + 8;  // bf16 per smem row: 144 bytes
constexpr int MMA_QB = 64;             // queries per CTA (8 mma n-tiles)
// Warp w owns rows (w & 3) * 32 .. +31 (two m-tiles) of all its CTA's
// queries (w >> 2) * 32 .. +31 (four n-tiles): a 32 x 32 warp tile reads
// 2 KB of fragments per 16-deep step for its 8 mma.sync.
constexpr int ROW_WARPS = 4;

__device__ __forceinline__ void mma_bf16_16x8x16(float c[4], const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory (a shared-window address),
// lane l giving the address of row l % 8 of matrix l / 8; register j gets
// matrix j in the mma.sync fragment layout (row lane / 4, columns 2 *
// (lane % 4) + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two bf16 values as the 32-bit pair mma.sync reads (lo at the lower
// column).
__device__ __forceinline__ uint32_t bf16_pair(int lo, int hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t x) {
  return *reinterpret_cast<const __nv_bfloat162*>(&x);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The packed int4 codes of bytes 2h, 2h + 1 of w as bf16 pairs: their low
// nibbles as lo[h], their high nibbles as hi[h] (the JAX kernel's (p << 28)
// >> 28 and p >> 4 on the sign-extended byte p), exactly and without int
// -> float conversions (on an H100, K9 at 1M x 384 and b = 256 took
// 0.858 ms with them, 0.829 without; for int8 codes, which need two
// nibbles' worth of this, the conversions won). A nibble offset to u =
// c + 8 is written into the mantissa of 128.0 (bf16 0x4300, whose 7
// mantissa bits count units): 0x4300 | u is 136 + c, and 0x4300 | (u <<
// 3) is 192 + 8c; one bf16 add or fma of small integers then gives c,
// every step exact.
__device__ __forceinline__ void i4x8_to_bf16(uint32_t w, uint32_t (&lo)[2], uint32_t (&hi)[2]) {
  const uint32_t u = w ^ 0x88888888u;  // nibbles c + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t p = __byte_perm(u, 0, h ? 0x4342 : 0x4140);  // one byte per half
    // (136 + c) - 136; (192 + 8c) / 8 - 24
    lo[h] = as_u32(__hadd2(as_bf162((p & 0x000F000Fu) | 0x43004300u), as_bf162(0xC308C308u)));
    hi[h] = as_u32(__hfma2(as_bf162(((p >> 1) & 0x00780078u) | 0x43004300u),
                           as_bf162(0x3E003E00u), as_bf162(0xC1C0C1C0u)));
  }
}

// Where 16-byte chunk c (bf16 columns 8c .. 8c + 7) of row r of a staged
// strip lies in shared memory: here, rows of MMA_PITCH bf16 (the ldmatrix
// reads stay free of bank conflicts); wgmma_tile.cuh's Sw128Strip is the
// wgmma loop's swizzled layout.
struct PitchStrip {
  __nv_bfloat16* base;
  __device__ __forceinline__ void* at(int r, int c) const { return base + r * MMA_PITCH + c * 8; }
};

// Row types of the loop. Each stages a strip of RB rows into a ring slot
// (a PitchStrip or an Sw128Strip) as MMA_KC bf16 columns (rows at or past
// `limit` read as zero): Regs::fetch starts the strip's loads and
// Regs::put finishes it after the strip before has been multiplied.
// `width` is a row's length in elements of T, `c0` the strip's first
// element; qcol(c0, x, width) is the query column that strip column x
// meets.

// bf16 rows (K2, K2'): 16-byte cp.async copies, three stages in flight.
struct RowsBf16 {
  using T = __nv_bfloat16;
  static constexpr int COLS = MMA_KC;  // row elements per strip
  static constexpr int STAGES = 3;
  static constexpr bool SPLIT_QUERIES = false;
  static __device__ __forceinline__ int qcol(int c0, int x, int) { return c0 + x; }
  struct Regs {
    template <typename Strip>
    __device__ __forceinline__ void fetch(Strip dst, const T* __restrict__ src, int64_t first,
                                          int64_t limit, int width, int c0) {
      for (int i = threadIdx.x; i < RB * (MMA_KC / 8); i += THREADS) {
        const int ri = i / (MMA_KC / 8), c = i % (MMA_KC / 8);
        const int64_t gr = first + ri;
        cp_async16(dst.at(ri, c), gr < limit ? src + gr * width + c0 + 8 * c : src, gr < limit);
      }
    }
    template <typename Strip>
    __device__ __forceinline__ void put(Strip) const {}
  };
};

// int8 rows (K6, K7, K8): 16 codes per 16-byte load, 4 loads per row strip.
struct RowsI8 {
  using T = int8_t;
  static constexpr int COLS = MMA_KC;
  static constexpr int STAGES = 2;
  static constexpr bool SPLIT_QUERIES = false;
  static __device__ __forceinline__ int qcol(int c0, int x, int) { return c0 + x; }
  struct Regs {
    static constexpr int LOADS = RB * (MMA_KC / 16) / THREADS;
    uint4 v[LOADS];
    template <typename Strip>
    __device__ __forceinline__ void fetch(Strip, const T* __restrict__ src, int64_t first,
                                          int64_t limit, int width, int c0) {
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = threadIdx.x + u * THREADS;
        const int64_t gr = first + i / (MMA_KC / 16);
        v[u] = gr < limit ? *reinterpret_cast<const uint4*>(src + gr * width + c0 + (i % (MMA_KC / 16)) * 16)
                          : make_uint4(0, 0, 0, 0);
      }
    }
    template <typename Strip>
    __device__ __forceinline__ void put(Strip dst) const {
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
        *reinterpret_cast<uint4*>(dst.at(ri, c16 / 8)) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(dst.at(ri, c16 / 8 + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
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
  static constexpr bool SPLIT_QUERIES = true;
  static __device__ __forceinline__ int qcol(int c0, int x, int width) {
    return x < MMA_KC / 2 ? c0 + x : width + c0 + x - MMA_KC / 2;
  }
  struct Regs {
    uint4 v;
    template <typename Strip>
    __device__ __forceinline__ void fetch(Strip, const T* __restrict__ src, int64_t first,
                                          int64_t limit, int width, int c0) {
      static_assert(RB * 2 == THREADS, "one load per thread");
      const int64_t gr = first + threadIdx.x / 2;
      v = gr < limit ? *reinterpret_cast<const uint4*>(src + gr * width + c0 + (threadIdx.x % 2) * 16)
                     : make_uint4(0, 0, 0, 0);
    }
    template <typename Strip>
    __device__ __forceinline__ void put(Strip dst) const {
      const int ri = threadIdx.x / 2, c16 = (threadIdx.x % 2) * 16;
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      uint32_t lo[4][2], hi[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) i4x8_to_bf16(w[j], lo[j], hi[j]);  // byte k of w[j]: column 4j + k
      *reinterpret_cast<uint4*>(dst.at(ri, c16 / 8)) = make_uint4(lo[0][0], lo[0][1], lo[1][0], lo[1][1]);
      *reinterpret_cast<uint4*>(dst.at(ri, c16 / 8 + 1)) =
          make_uint4(lo[2][0], lo[2][1], lo[3][0], lo[3][1]);
      *reinterpret_cast<uint4*>(dst.at(ri, 4 + c16 / 8)) =
          make_uint4(hi[0][0], hi[0][1], hi[1][0], hi[1][1]);
      *reinterpret_cast<uint4*>(dst.at(ri, 4 + c16 / 8 + 1)) =
          make_uint4(hi[2][0], hi[2][1], hi[3][0], hi[3][1]);
    }
  };
};

// Shared memory of the loop, at the address it is given (a kernel keeps
// its epilogue's tables in front of it): the resident query block
// [MMA_QB][qw + 8] (RESIDENT only), then Rows::STAGES ring slots, each a
// row strip [RB][MMA_PITCH] and, without resident queries, a query strip
// [MMA_QB][MMA_PITCH]. qw is the query width in bf16.
template <typename Rows, bool RESIDENT>
struct MmaLoopSmem {
  static constexpr int SLOT = (RB + (RESIDENT ? 0 : MMA_QB)) * MMA_PITCH;  // bf16
  static __host__ __device__ int q_pitch(int qw) { return qw + 8; }
  static __host__ __device__ int bytes(int qw) {
    return (RESIDENT ? MMA_QB * q_pitch(qw) * 2 : 0) + Rows::STAGES * SLOT * 2;
  }
};

// The CTA's query block q0 .. q0 + 63 (q: [b, width] bf16, or the split
// halves [b, 2 * width] for packed int4 rows) against the n_tiles 128-row
// tiles tile_at(0) < tile_at(1) < ... (a TileRange or a TileList of
// tile.cuh; the loop walks a range with incremental counters) of emb
// ([n_rows, width] elements of Rows::T). After the last strip of tile j
// every thread calls epi(tile_at(j), acc), then the accumulators restart
// from zero. acc[m][n]
// [.] holds rows wr*32 + m*16 + {gr, gr+8} and queries wq*32 + n*8 + 2t +
// {0, 1} of the tile (warp (wr, wq) = (w % 4, w / 4), gr = lane / 4, t =
// lane % 4); fragment element j is row gr + 8*(j >> 1), query 2t + (j & 1).
// The epilogue may use any shared memory outside the loop's
// MmaLoopSmem<Rows, RESIDENT>::bytes at `smem`; every tile's strips start
// with a barrier, so an epilogue's reads of its tables are ordered before
// the next epilogue's writes. Must be called by all THREADS threads.
template <typename Rows, bool RESIDENT, typename Tiles, typename Epilogue>
__device__ __forceinline__ void mma_tiles(const typename Rows::T* __restrict__ emb,
                                          const __nv_bfloat16* __restrict__ q, int64_t n_rows,
                                          int width, int b, int q0, int n_tiles, Tiles tile_at,
                                          unsigned char* smem, Epilogue&& epi) {
  using Smem = MmaLoopSmem<Rows, RESIDENT>;
  const int qw = Rows::SPLIT_QUERIES ? 2 * width : width;
  const int qp = RESIDENT ? Smem::q_pitch(qw) : MMA_PITCH;
  __nv_bfloat16* const qres = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const ring = qres + (RESIDENT ? MMA_QB * qp : 0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wr = (tid >> 5) % ROW_WARPS;  // row group of 32
  const int wq = (tid >> 5) / ROW_WARPS;  // query half of 32
  const int n_strips = width / Rows::COLS;
  const int steps = n_tiles * n_strips;
  if (steps <= 0) return;

  if constexpr (RESIDENT) {  // the query block, once, with the first strip
    for (int i = tid; i < MMA_QB * (qw / 8); i += THREADS) {
      const int qi = i / (qw / 8), c8 = (i % (qw / 8)) * 8;
      const int gq = q0 + qi;
      cp_async16(qres + qi * qp + c8, gq < b ? q + (int64_t)gq * qw + c8 : q, gq < b);
    }
  }
  // The next strip to fetch: its index, ring slot, depth offset, tile
  // (position in a list) and first row; a listed tile's first row is read
  // a tile ahead, so its index is in hand when its loads start.
  int f = 0, f_slot = 0, f_c0 = 0, f_tile = 0;
  int64_t f_r0 = tile_at(0) * RB;
  int64_t f_next_r0 = Tiles::LISTED && n_tiles > 1 ? tile_at(1) * RB : 0;
  // Starts the loads of strip f into its slot (regs keeps them for put
  // when Rows converts while staging) and moves on to the next strip.
  auto fetch_next = [&](typename Rows::Regs& regs) {
    __nv_bfloat16* const slot = ring + f_slot * Smem::SLOT;
    regs.fetch(PitchStrip{slot}, emb, f_r0, n_rows, width, f_c0);
    if constexpr (!RESIDENT) {
      __nv_bfloat16* const qs = slot + RB * MMA_PITCH;
      for (int i = tid; i < MMA_QB * (MMA_KC / 8); i += THREADS) {
        const int qi = i / (MMA_KC / 8), c8 = (i % (MMA_KC / 8)) * 8;
        const int gq = q0 + qi;
        cp_async16(qs + qi * MMA_PITCH + c8,
                   gq < b ? q + (int64_t)gq * qw + Rows::qcol(f_c0, c8, width) : q, gq < b);
      }
    }
    ++f;
    f_slot = f_slot + 1 == Rows::STAGES ? 0 : f_slot + 1;
    f_c0 += Rows::COLS;
    if (f_c0 == width) {
      f_c0 = 0;
      if constexpr (Tiles::LISTED) {
        ++f_tile;
        f_r0 = f_next_r0;
        if (f_tile + 1 < n_tiles) f_next_r0 = tile_at(f_tile + 1) * RB;
      } else {
        f_r0 += RB;
      }
    }
    return slot;
  };
#pragma unroll
  for (int p = 0; p < Rows::STAGES - 1; ++p) {
    if (f < steps) {
      typename Rows::Regs regs;
      regs.put(PitchStrip{fetch_next(regs)});
    }
    cp_async_commit();
  }

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

  // This lane's ldmatrix addresses in slot 0 (shared window, bytes): A
  // rows (lane & 15) of each m-tile at column (lane >> 4) * 8; B query rows
  // (lane & 7) of n-tile 2p + (lane >> 4) at column ((lane >> 3) & 1) * 8,
  // in the resident block or slot 0's query strip. A strip adds its slot's
  // offset (and, for resident queries, its depth) to these.
  const uint32_t a_lane = (uint32_t)__cvta_generic_to_shared(
      ring + (wr * 32 + (lane & 15)) * MMA_PITCH + (lane >> 4) * 8);
  const uint32_t b_lane = (uint32_t)__cvta_generic_to_shared(
      (RESIDENT ? qres : ring + RB * MMA_PITCH) +
      (wq * 32 + (lane >> 4) * 8 + (lane & 7)) * qp + ((lane >> 3) & 1) * 8);

  // The strip being multiplied: its ring slot, depth offset, and tile (its
  // position in a list, or its index in a range).
  int c_slot = 0, c_c0 = 0, c_tile = 0;
  int64_t c_range_tile = tile_at(0);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<Rows::STAGES - 2>();
    __syncthreads();  // strip s is in its slot; the slot of strip s-1 is free
    typename Rows::Regs regs;
    __nv_bfloat16* pending = nullptr;
    if (f < steps) pending = fetch_next(regs);
    cp_async_commit();

    const uint32_t slot_bytes = (uint32_t)(c_slot * Smem::SLOT * 2);
    const uint32_t a_row = a_lane + slot_bytes;
    const uint32_t b_row = b_lane + (RESIDENT ? 0u : slot_bytes);
#pragma unroll
    for (int kk = 0; kk < MMA_KC; kk += 16) {
      uint32_t a[2][4], bq[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) ldsm_x4(a[m], a_row + (m * 16 * MMA_PITCH + kk) * 2);
      const int qc = RESIDENT ? Rows::qcol(c_c0, kk, width) : kk;
#pragma unroll
      for (int p = 0; p < 2; ++p) ldsm_x4(bq[p], b_row + (p * 16 * qp + qc) * 2);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16_16x8x16(acc[m][n], a[m], bq[n >> 1][2 * (n & 1)], bq[n >> 1][2 * (n & 1) + 1]);
    }
    if (pending != nullptr) regs.put(PitchStrip{pending});

    c_slot = c_slot + 1 == Rows::STAGES ? 0 : c_slot + 1;
    c_c0 += Rows::COLS;
    if (c_c0 != width) continue;  // uniform: the tile is not done
    c_c0 = 0;
    if constexpr (Tiles::LISTED) {
      epi(tile_at(c_tile), acc);
      ++c_tile;
    } else {
      epi(c_range_tile, acc);
      ++c_range_tile;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;
  }
}

}  // namespace tat
