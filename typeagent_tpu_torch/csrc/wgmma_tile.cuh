// The wgmma form of mma_tile.cuh's strip loop, for the row types that
// convert while they stage (int8 rows: K8; packed int4 rows: K9). It keeps
// mma_tiles' contract: a persistent CTA multiplies its 64-query block
// against a sequence of 128-row tiles, 64-deep row strips stream through a
// two-slot ring that runs ahead across tile edges, the queries stay
// resident in shared memory where two CTAs still fit an SM (else a query
// strip rides each ring slot), and each finished tile's accumulators go to
// an epilogue.
//
// What changes is the product. Each of the CTA's two warpgroups owns 64
// rows of the tile against all 64 queries and issues four
// wgmma.mma_async m64n64k16 bf16 -> f32 per strip, one commit group, both
// operands read from shared memory by descriptor: no ldmatrix traffic
// through the registers (mma.sync's 32 x 32 warp tiles read 2 KB of
// fragments per 16-deep step for 8 mma.sync, which held K8 and K9 to
// 16-22% of the card's 989 TFLOP/s), and wgmma is the only path to
// Hopper's dense rate. Products of bf16 values are exact and sum in f32,
// as before.
//
// Shared layout: a 64-deep bf16 strip row is 128 bytes, one row of the
// 128-byte swizzle atom (8 rows, 1 KB). 16-byte chunk c of row r lies at
// r * 128 + ((c ^ (r & 7)) << 4) in a 1024-byte aligned block: wgmma's
// K-major SWIZZLE_128B layout, whose descriptor strides 1024 bytes from
// one 8-row group to the next and moves its start 32 bytes per k16 step.
// The converting row types write this layout with their st.shared stores
// and the queries' cp.async copies do too, so no TMA is needed.
//
// The ring's rule: strip s+1's codes, loaded into registers one strip
// earlier, are converted into the other slot while strip s's wgmma group
// runs, and strip s+2's loads start before it (two register sets; with
// the loads one strip ahead K8 and K9 ran ~3% slower on an H100). The
// group is waited for before the next barrier, so a slot is refilled only
// after both warpgroups' products that read it are done, and the
// accumulators are read only after wgmma.wait_group 0. Generic stores
// that wgmma reads are made visible to it by fence.proxy.async before the
// barrier, and wgmma.fence orders the registers before each group.
//
// What bounds it on an H100 (clock64 phase timers, K8 at 1M x 384, b =
// 256): a strip takes ~2,200 cycles a CTA, half of them converting the
// next strip's codes, a quarter issuing the loads and the wgmma group
// (the tensor cores are busy about a fifth of the time). Each code is
// converted once per 64-query block, four times at b = 256; converting it
// once per batch (a wider query block, or converted codes kept for
// several blocks) is the next lever, not the product.

#pragma once

#include "mma_tile.cuh"

namespace tat {

constexpr int WG_ROWS = 64;                 // tile rows per warpgroup (wgmma M)
constexpr int SW_ROW = MMA_KC * 2;          // bytes per strip row: one swizzle atom row
constexpr int WG_QSTRIP = MMA_QB * SW_ROW;  // a [64][64] query strip: 8 KB
constexpr int WG_RSTRIP = RB * SW_ROW;      // a [128][64] row strip: 16 KB
constexpr int SW_ALIGN = 1024;              // the swizzle atom: every strip starts on one

// Chunk c of row r of a [rows][64] bf16 strip in the SWIZZLE_128B layout.
struct Sw128Strip {
  unsigned char* base;
  __device__ __forceinline__ void* at(int r, int c) const {
    return base + r * SW_ROW + ((c ^ (r & 7)) << 4);
  }
};

// Shared-memory matrix descriptor of a K-major SWIZZLE_128B operand at the
// shared-window address `addr` (16-byte units): start address, leading
// byte offset 1 (unused by this layout), stride byte offset 1024 bytes
// (64), layout type 1 (128-byte swizzle). Adding 2 moves the start 32
// bytes: the next k16 slice.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(SW_ALIGN >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before later reads by the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product (its issue and its wait).
__device__ __forceinline__ void fence_acc(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major bf16 in shared
// memory; scale_d = 0 starts the sums afresh. Thread (warp w of the
// warpgroup, lane l) holds d[4n + j] = row 16w + l/4 + 8(j >> 1), column
// 8n + 2(l % 4) + (j & 1), n < 8.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Shared memory of the loop, at a 1024-byte aligned address: the resident
// query block, one [64][64] strip per row strip of a tile (RESIDENT only),
// then Rows::STAGES ring slots, each a row strip [128][64] and, without
// resident queries, a query strip [64][64].
template <typename Rows, bool RESIDENT>
struct WgmmaLoopSmem {
  static constexpr int SLOT = WG_RSTRIP + (RESIDENT ? 0 : WG_QSTRIP);
  static __host__ __device__ int bytes(int n_strips) {
    return (RESIDENT ? n_strips * WG_QSTRIP : 0) + Rows::STAGES * SLOT;
  }
};

// mma_tiles' contract (mma_tile.cuh) with a wgmma product: the CTA's
// query block q0 .. q0 + 63 against the n_tiles 128-row tiles tile_at(0) <
// tile_at(1) < ... of emb, over the first `live` elements of each row.
// `smem` is 1024-byte aligned. After the last strip of tile j every
// thread calls epi(tile_at(j), acc), acc in wgmma_64x64x16's layout for
// rows 64 * (threadIdx.x / 128) + ... of the tile; the epilogue may use
// shared memory past WgmmaLoopSmem<Rows, RESIDENT>::bytes(live /
// Rows::COLS), and each strip starts with a barrier. Must be called by all
// THREADS threads.
template <typename Rows, bool RESIDENT, typename Tiles, typename Epilogue>
__device__ __forceinline__ void wgmma_tiles(const typename Rows::T* __restrict__ emb,
                                            const __nv_bfloat16* __restrict__ q, int64_t n_rows,
                                            int width, int live, int b, int q0, int n_tiles,
                                            Tiles tile_at, unsigned char* smem, Epilogue&& epi) {
  static_assert(Rows::STAGES == 2, "a converting row type: strip s+1 stages while s is multiplied");
  using Smem = WgmmaLoopSmem<Rows, RESIDENT>;
  const int qw = Rows::SPLIT_QUERIES ? 2 * width : width;  // a query row in q
  const int n_strips = live / Rows::COLS;
  const int steps = n_tiles * n_strips;
  if (steps <= 0) return;
  unsigned char* const qres = smem;
  unsigned char* const ring = smem + (RESIDENT ? n_strips * WG_QSTRIP : 0);
  const int tid = threadIdx.x;

  // The query columns that the strip at depth c0 meets, as a [64][64]
  // strip (chunk c holds strip columns 8c .. 8c + 7).
  auto stage_queries = [&](unsigned char* dst, int c0) {
    for (int i = tid; i < MMA_QB * (MMA_KC / 8); i += THREADS) {
      const int qi = i / (MMA_KC / 8), c = i % (MMA_KC / 8);
      const int gq = q0 + qi;
      cp_async16(Sw128Strip{dst}.at(qi, c),
                 gq < b ? q + (int64_t)gq * qw + Rows::qcol(c0, 8 * c, width) : q, gq < b);
    }
  };
  if constexpr (RESIDENT) {  // the query block, once, with the first strip
    for (int s = 0; s < n_strips; ++s) stage_queries(qres + s * WG_QSTRIP, s * Rows::COLS);
  }
  // The next strip to load, as in mma_tiles: its index, depth offset,
  // tile (position in a list) and first row. Strip x stages into slot x % 2.
  int f = 0, f_c0 = 0, f_tile = 0;
  int64_t f_r0 = tile_at(0) * RB;
  int64_t f_next_r0 = Tiles::LISTED && n_tiles > 1 ? tile_at(1) * RB : 0;
  auto slot_of = [&](int x) { return ring + (x & 1) * Smem::SLOT; };
  // Starts the loads of strip f into regs and moves on to the next strip.
  auto load_next = [&](typename Rows::Regs& regs) {
    regs.fetch(Sw128Strip{slot_of(f)}, emb, f_r0, n_rows, width, f_c0);
    ++f;
    f_c0 += Rows::COLS;
    if (f_c0 == live) {
      f_c0 = 0;
      if constexpr (Tiles::LISTED) {
        ++f_tile;
        f_r0 = f_next_r0;
        if (f_tile + 1 < n_tiles) f_next_r0 = tile_at(f_tile + 1) * RB;
      } else {
        f_r0 += RB;
      }
    }
  };
  // Two register sets: the loads run two strips ahead of the product, so
  // a strip's codes arrive while the strip before it is multiplied (one
  // strip ahead, a wgmma strip is too short to cover the loads' latency).
  typename Rows::Regs ra, rb;
  load_next(ra);
  ra.put(Sw128Strip{slot_of(0)});
  if constexpr (!RESIDENT) stage_queries(slot_of(0) + WG_RSTRIP, 0);
  cp_async_commit();
  if (f < steps) load_next(rb);

  // Warpgroup wg multiplies rows 64 * wg .. + 63 of each row strip.
  const int wg = tid / (THREADS / 2);
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  const uint32_t qres_addr = (uint32_t)__cvta_generic_to_shared(qres);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  // The strip being multiplied: its strip of the tile, and tile (its
  // position in a list, or its index in a range).
  int c_strip = 0, c_tile = 0;
  int64_t c_range_tile = tile_at(0);
  // Strip s: loads strip s + 2 into `load`, multiplies strip s, and
  // converts strip s + 1 from `put` into the other slot meanwhile.
  auto strip = [&](int s, typename Rows::Regs& load, typename Rows::Regs& put) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // strip s is in its slot; no product reads the other slot
    if (f < steps) load_next(load);
    const bool next = s + 1 < steps;
    if constexpr (!RESIDENT) {
      if (next)
        stage_queries(slot_of(s + 1) + WG_RSTRIP,
                      c_strip + 1 == n_strips ? 0 : (c_strip + 1) * Rows::COLS);
    }
    cp_async_commit();

    const uint32_t slot_addr = ring_addr + (uint32_t)((s & 1) * Smem::SLOT);
    const uint64_t desc_a = sw128_desc(slot_addr + (uint32_t)(wg * WG_ROWS * SW_ROW));
    const uint64_t desc_b =
        sw128_desc(RESIDENT ? qres_addr + (uint32_t)(c_strip * WG_QSTRIP) : slot_addr + WG_RSTRIP);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < MMA_KC / 16; ++k)
      wgmma_64x64x16(acc, desc_a + 2 * k, desc_b + 2 * k, (c_strip | k) != 0);
    wgmma_commit();
    if (next) put.put(Sw128Strip{slot_of(s + 1)});  // overlaps the product
    wgmma_wait_all();
    fence_acc(acc);

    if (++c_strip != n_strips) return;  // uniform: the tile is not done
    c_strip = 0;
    if constexpr (Tiles::LISTED) {
      epi(tile_at(c_tile), acc);
      ++c_tile;
    } else {
      epi(c_range_tile, acc);
      ++c_range_tile;
    }
  };
  for (int s = 0; s < steps; s += 2) {
    strip(s, ra, rb);
    if (s + 1 < steps) strip(s + 1, rb, ra);
  }
}

}  // namespace tat
