// K6 and K7 at narrow batches (b <= 16 queries): the int8 top-k scans for
// one or two 8-query tiles. Wider batches take topk.cu's 64-query loop,
// and so do rows too wide for any plan below (d > 4800 at 8 queries, d >
// 3584 at 16): ops/topk.py int8_query_block picks by the shape, from
// narrow_plan, its mirror of plan().
//
// Replaces (typeagent_tpu/ops/topk.py), with topk.cu above 16 queries:
//   K6 _topk_kernel_q  (:662, _topk_pallas_q_impl :689)   int8 rows + f32 scales
//   K7 _topk_kernel_mq (:757, _topk_pallas_mq_impl :786)  the same + an i32 row mask
// It computes what ops/topk.py topk_q_plain and topk_mq_plain compute: bf16
// queries times int8 codes summed in f32, times the row's f32 scale, then
// the count test and the mask (RAW_NEG), the top k with ties to the lowest
// row, as the [b, splits, k] candidates that topk.cu's merge kernel folds.
//
// What bounds it on an H100: the read of the codes. One caller's search
// (the corpus pads it to 8 queries) over 100M x 768 codes reads 76.8 GB of
// codes and 0.4 GB of scales, 23.0 ms at 3.35 TB/s, against 1.2 TFLOP of
// products (~1.2 ms at the bf16 tensor-core peak). topk.cu's loop held
// such a search to ~40% of the read bound: it multiplies 64 queries where
// 8 were sent, turns each code into bf16 by I2F + F2F (16 a clock per SM,
// ~31 ms of issue for 76.8G codes), and keeps ~16 KB per SM in flight
// through registers.
//
// Design:
//   * A ring of raw codes. One producer thread (lane 0 of the CTA's last
//     warp) keeps cp.async.bulk copies of raw int8 slabs in flight into
//     shared memory, each completing on an mbarrier. A slab is one m-tile:
//     16 rows of a 128-row tile (12 KB at d = 768) and their 16 scales.
//     Each of the W consumer warps (8; 4 or 2, of two slabs or one, for
//     rows too wide to give 8 warps two slabs each: at d = 1024-4096 these
//     still beat the loop, PERF.md) owns a ring of `stages` slabs (2 at d = 768,
//     4 at d = 384: ~200 KB, one CTA per SM, up to 16 slabs per SM in
//     flight) and takes m-tiles w, w + W, ... of each tile, so its rows
//     arrive in ascending order. A slab lands as rows 0-7, the 64 bytes of
//     scales, rows 8-15, so that the two halves start 64 bytes apart
//     modulo 128: the rows of a [n, 768] block all start on the same bank,
//     and the reads below take one row of each half per 8 lanes, free of
//     bank conflicts.
//   * Each code converted once, exactly, without int -> float
//     conversions. For the codes c in bytes 0 and 2 of a word x,
//     (x & 0x007F007F) | 0x43004300 is the bf16 pair 128 + (c & 127) and
//     (x & 0x00800080) | 0x43004300 the pair 128 or 256 by c's sign bit;
//     their bf16x2 difference is c, exact (|c| <= 128 has at most 8
//     significant bits, so the subtraction rounds nothing). Bytes 1 and 3
//     take the same after a shift: 4 LOP3, a shift and 2 HSUB2 per 4
//     codes, and no conversion pipe.
//   * Depth permuted, operands in registers. Lane (gr, t) of a warp reads
//     16 consecutive codes of each of its two rows per 64-deep strip (two
//     16-byte shared loads); word j of them is mma k-step j, its even
//     bytes the A fragment's k slots 2t, 2t + 1 and its odd bytes 2t + 8,
//     2t + 9. The wrapper permutes the bf16 queries the same way once
//     (ops/topk.py narrow_query_operand), into the B fragments' order, so
//     each lane reads its B operand as 16-byte words too.
//   * A query block that follows the batch: NT = 1 or 2 n-tiles of 8
//     queries, mma.sync m16n8k16 with the slab's 16 rows as M. Each warp
//     folds its rows' scores into one WarpTopK per query (rows ascending,
//     so ties stay at the lowest row); at the end the W lists of each query
//     merge in (value descending, row ascending) order.
//   * The split geometry of topk.cu's scans (ops/topk.py scan_geometry at
//     one CTA per SM): K6's CTA walks a contiguous range of live tiles, K7's
//     its scope_share of the device tile list, reading the mask per row.

#include "mma_tile.cuh"

namespace tat {
namespace narrow {

constexpr int MT = 16;          // rows per slab: one mma m-tile
constexpr int MAX_WARPS = 8;    // consumer warps
constexpr int MAX_STAGES = 8;   // slabs per consumer warp
constexpr int BARRIERS = 2 * MAX_WARPS * MAX_STAGES * 8;  // bytes: full, then empty
constexpr int SMEM_MAX = 232448;  // an H100 block's dynamic shared memory

// ---------------------------------------------------------------------------
// mbarriers and bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred p;\n"
      " WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void consumers_sync(int warps) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(warps * 32) : "memory");
}

// ---------------------------------------------------------------------------
// Codes to bf16, exactly
// ---------------------------------------------------------------------------

// The int8 codes in bytes 0 and 2 of x as a bf16 pair (byte 0 in the low
// half): (128 + (c & 127)) - (128 or 256 by c's sign bit) = c.
__device__ __forceinline__ uint32_t codes02_bf16(uint32_t x) {
  const uint32_t low7 = (x & 0x007F007Fu) | 0x43004300u;
  const uint32_t sign = (x & 0x00800080u) | 0x43004300u;
  return as_u32(__hsub2(as_bf162(low7), as_bf162(sign)));
}

// ---------------------------------------------------------------------------
// The launch plan: consumer warps, slabs per warp, shared memory
// ---------------------------------------------------------------------------

// Shared memory: the mbarriers, the permuted query block (16 * NT * width
// bytes), then the ring of warps x stages slabs of slab_bytes(width); after
// the scan the ring holds the warps' lists for the final merge.
__host__ __device__ inline int slab_bytes(int width) { return MT * width + MT * 4; }
__host__ __device__ inline int query_bytes(int width, int nt) { return 16 * nt * width; }

// The most consumer warps (8, 4 or 2) that still get two slabs each (up to
// MAX_STAGES) under SMEM_MAX, else 8 warps of one slab, else fewer; returns
// the shared memory bytes, or -1 if no plan fits.
inline int plan(int width, int nt, int* warps, int* stages) {
  const int avail = SMEM_MAX - BARRIERS - query_bytes(width, nt);
  const int slab = slab_bytes(width);
  const int lists = MAX_WARPS * nt * 8 * 32 * 8;
  const int tries[6][2] = {{8, 2}, {4, 2}, {2, 2}, {8, 1}, {4, 1}, {2, 1}};
  for (const auto& tr : tries) {
    int s = avail / (tr[0] * slab);
    if (s > MAX_STAGES) s = MAX_STAGES;
    if (s < tr[1]) continue;
    *warps = tr[0];
    *stages = s;
    const int ring = tr[0] * s * slab;
    return BARRIERS + query_bytes(width, nt) + (ring > lists ? ring : lists);
  }
  return -1;
}

// ---------------------------------------------------------------------------
// The final merge: (value descending, row ascending) over the warps' lists
// ---------------------------------------------------------------------------

struct Entry {
  float v;
  int i;
};

// A top-k list held by one warp, as WarpTopK, that takes candidates in any
// row order: (sv, si) goes after every entry above it and every equal entry
// of a lower row. Only real scores (> RAW_NEG) enter.
struct OrderedTopK {
  float v, kv;
  int i, ki;  // entry k-1 (the one to beat)

  __device__ __forceinline__ void init() {
    v = kv = RAW_NEG;
    i = ki = -1;
  }
  __device__ __forceinline__ bool beats(float sv, int si) const {
    return sv > RAW_NEG && (sv > kv || (sv == kv && si < ki));
  }
  __device__ __forceinline__ void offer(float cv, int ci, int k, int lane) {
    unsigned m = __ballot_sync(FULL, beats(cv, ci));
    while (m) {
      const int src = __ffs(m) - 1;
      const float sv = __shfl_sync(FULL, cv, src);
      const int si = __shfl_sync(FULL, ci, src);
      const int pos = __popc(__ballot_sync(FULL, lane < k && (v > sv || (v == sv && i < si))));
      const float up_v = __shfl_up_sync(FULL, v, 1);
      const int up_i = __shfl_up_sync(FULL, i, 1);
      if (lane > pos) {
        v = up_v;
        i = up_i;
      } else if (lane == pos) {
        v = sv;
        i = si;
      }
      kv = __shfl_sync(FULL, v, k - 1);
      ki = __shfl_sync(FULL, i, k - 1);
      m &= ~(1u << src);
      m &= __ballot_sync(FULL, beats(cv, ci));
    }
  }
};

// ---------------------------------------------------------------------------
// The scan
// ---------------------------------------------------------------------------

// emb: [n_rows, width] int8 codes; scales: [n_rows] f32; qp: the bf16
// query block of 8 * NT queries in B-fragment order (ops/topk.py
// narrow_query_operand: [NT][width / 64][2][32 lanes] 16-byte words).
// CTA `split` of `splits`: K6 (!SCOPED) walks tiles [split*per,
// (split+1)*per) below the live count, per = rows_per_split / 128; K7
// (SCOPED) its share [n*split/splits, n*(split+1)/splits) of the n =
// *n_tiles ascending tile indices in `tiles`, offering only rows whose
// mask entry is > 0. blockDim = 32 * (consumer warps + 1).
template <bool SCOPED, int NT>
__global__ void __launch_bounds__(32 * (MAX_WARPS + 1), 1)
    topk_mma_kernel(const int8_t* __restrict__ emb, const float* __restrict__ scales,
                    const uint4* __restrict__ qp, int64_t n_rows, int width, int b,
                    int64_t count, int k, int64_t rows_per_split, int splits, int stages,
                    const int* __restrict__ mask, const int* __restrict__ tiles,
                    const int* __restrict__ n_tiles, float* cand_vals, int* cand_idx) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_addr(smem);                         // [warp][stage]
  const uint32_t empty0 = full0 + MAX_WARPS * MAX_STAGES * 8;    // [warp][stage]
  uint4* const qs = reinterpret_cast<uint4*>(smem + BARRIERS);
  unsigned char* const ring = smem + BARRIERS + query_bytes(width, NT);
  const int slab = slab_bytes(width);
  const int W = (int)(blockDim.x >> 5) - 1;
  const int per = MAX_WARPS / W;  // m-tiles a warp takes from each tile
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x;

  // This CTA's tiles: K7 its share of the list, K6 its range of the live tiles.
  int64_t first;
  int mine;
  if constexpr (SCOPED) {
    const int64_t n = *n_tiles;
    first = n * split / splits;
    mine = (int)(n * (split + 1) / splits - first);
  } else {
    const int64_t live_nt = (count + RB - 1) / RB, per_split = rows_per_split / RB;
    first = (int64_t)split * per_split;
    const int64_t last = first + per_split < live_nt ? first + per_split : live_nt;
    mine = last > first ? (int)(last - first) : 0;
  }
  using Tiles = typename std::conditional<SCOPED, TileList, TileRange>::type;
  Tiles tile_at;
  if constexpr (SCOPED) {
    tile_at = TileList{tiles, first};
  } else {
    tile_at = TileRange{first};
  }

  for (int i = threadIdx.x; i < query_bytes(width, NT) / 16; i += blockDim.x) qs[i] = qp[i];
  if (threadIdx.x == 0) {
    for (int j = 0; j < W * MAX_STAGES; ++j) {
      mbar_init(full0 + 8 * j, 1);
      mbar_init(empty0 + 8 * j, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == W) {  // the producer
    if (lane == 0 && mine > 0) {
      int64_t next = tile_at(0);
      int round = 0;  // slabs issued per consumer warp so far
      for (int j = 0; j < mine; ++j) {
        const int64_t tile = next;
        if (j + 1 < mine) next = tile_at(j + 1);  // a listed tile's index, a tile ahead
        for (int mm = 0; mm < per; ++mm, ++round) {
          const int slot = round % stages;
          const uint32_t free_parity = ((round / stages) & 1) ^ 1;
          for (int w = 0; w < W; ++w) {
            const uint32_t full = full0 + 8 * (w * MAX_STAGES + slot);
            mbar_wait(empty0 + 8 * (w * MAX_STAGES + slot), free_parity);
            const int64_t r0 = tile * RB + (int64_t)(mm * W + w) * MT;
            const uint32_t dst = smem_addr(ring + (w * stages + slot) * slab);
            mbar_expect_tx(full, slab);
            bulk_copy(dst, emb + r0 * width, 8 * width, full);
            bulk_copy(dst + 8 * width, scales + r0, MT * 4, full);
            bulk_copy(dst + 8 * width + MT * 4, emb + (r0 + 8) * width, 8 * width, full);
          }
        }
      }
    }
    return;
  }

  // A consumer. Lane (gr, t) holds m-tile rows gr and gr + 8: slab rows p0
  // and p1 = p0 + 4, where logical rows 2u and 2u + 1 sit in different
  // halves of the slab (the 8 lanes of one 16-byte load read one row of
  // each half).
  const int gr = lane >> 2, t = lane & 3;
  const int p0 = (gr & 1) * 8 + (gr >> 1), p1 = p0 + 4;
  const int off0 = p0 * width + (p0 >= 8 ? MT * 4 : 0) + 16 * t;
  const int off1 = p1 * width + (p1 >= 8 ? MT * 4 : 0) + 16 * t;
  // Slab row `lane` (< 16) of a fold: the lane that holds it and whether as
  // its second row.
  const int fold_src = (2 * (lane & 3) + ((lane >> 3) & 1)) * 4;
  const bool fold_hi = (lane >> 2) & 1;
  const int strips = width / 64;

  WarpTopK top[NT * 8];
#pragma unroll
  for (int q = 0; q < NT * 8; ++q) top[q].init();

  int round = 0;
  int64_t next = mine > 0 ? tile_at(0) : 0;
  for (int j = 0; j < mine; ++j) {
    const int64_t tile = next;
    if (j + 1 < mine) next = tile_at(j + 1);
    for (int mm = 0; mm < per; ++mm, ++round) {
      const int slot = round % stages;
      const int64_t r0 = tile * RB + (int64_t)(mm * W + warp) * MT;
      // This lane's rows at or past the count or out of scope go to RAW_NEG
      // (the mask is read before the wait, so its latency overlaps it).
      bool ok0 = r0 + p0 < count, ok1 = r0 + p1 < count;
      if constexpr (SCOPED) {
        ok0 = ok0 && mask[r0 + p0] > 0;
        ok1 = ok1 && mask[r0 + p1] > 0;
      }
      mbar_wait(full0 + 8 * (warp * MAX_STAGES + slot), (round / stages) & 1);
      const unsigned char* const sl = ring + (warp * stages + slot) * slab;

      float acc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
#pragma unroll 2
      for (int s = 0; s < strips; ++s) {
        const uint4 xa = *reinterpret_cast<const uint4*>(sl + off0 + 64 * s);
        const uint4 xb = *reinterpret_cast<const uint4*>(sl + off1 + 64 * s);
        uint4 bq[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) bq[n][h] = qs[((n * strips + s) * 2 + h) * 32 + lane];
        const uint32_t wa[4] = {xa.x, xa.y, xa.z, xa.w};
        const uint32_t wb[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t a[4] = {codes02_bf16(wa[kk]), codes02_bf16(wb[kk]),
                                 codes02_bf16(wa[kk] >> 8), codes02_bf16(wb[kk] >> 8)};
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const uint4 v = bq[n][kk >> 1];
            mma_bf16_16x8x16(acc[n], a, (kk & 1) ? v.z : v.x, (kk & 1) ? v.w : v.y);
          }
        }
      }
      // Scale, then mask (raw * s_ref, then ok): acc[n][0..1] are row p0's
      // queries 8n + 2t, + 1; acc[n][2..3] row p1's. Then the slab is free.
      const float* const sc = reinterpret_cast<const float*>(sl + 8 * width);
      const float s0 = sc[p0], s1 = sc[p1];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] = ok0 ? acc[n][0] * s0 : RAW_NEG;
        acc[n][1] = ok0 ? acc[n][1] * s0 : RAW_NEG;
        acc[n][2] = ok1 ? acc[n][2] * s1 : RAW_NEG;
        acc[n][3] = ok1 ? acc[n][3] * s1 : RAW_NEG;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * (warp * MAX_STAGES + slot));
      // Lane r < 16 offers slab row r to each query's list, in row order.
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float lo = __shfl_sync(FULL, acc[n][q & 1], fold_src + (q >> 1));
          const float hi = __shfl_sync(FULL, acc[n][(q & 1) + 2], fold_src + (q >> 1));
          top[n * 8 + q].offer(lane < MT ? (fold_hi ? hi : lo) : RAW_NEG, (int)(r0 + lane), k, lane);
        }
    }
  }

  // Merge the warps' lists of each query; the ring is free once every
  // consumer has passed its last slab.
  Entry* const lists = reinterpret_cast<Entry*>(ring);  // [warp][query][lane]
  consumers_sync(W);
#pragma unroll
  for (int q = 0; q < NT * 8; ++q) lists[(warp * NT * 8 + q) * 32 + lane] = Entry{top[q].v, top[q].i};
  consumers_sync(W);
  for (int q = warp; q < NT * 8 && q < b; q += W) {
    OrderedTopK m;
    m.init();
    for (int w = 0; w < W; ++w) {
      const Entry e = lists[(w * NT * 8 + q) * 32 + lane];
      m.offer(lane < k ? e.v : RAW_NEG, e.i, k, lane);
    }
    if (lane < k) {
      const int64_t o = ((int64_t)q * splits + split) * k + lane;
      cand_vals[o] = m.v;
      cand_idx[o] = m.i;
    }
  }
}

template <bool SCOPED>
int launch(const int8_t* emb, const float* scales, const void* qp, int64_t n_rows, int width,
           int b, int64_t count, int k, int64_t rows_per_split, int splits, int query_block,
           const int* mask, const int* tiles, const int* n_tiles, float* cand_vals,
           int* cand_idx, void* stream) {
  if ((query_block != 8 && query_block != 16) || b > query_block || width % 64)
    return (int)cudaErrorInvalidValue;
  const int nt = query_block / 8;
  int warps = 0, stages = 0;
  const int smem = plan(width, nt, &warps, &stages);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  auto kernel = nt == 1 ? topk_mma_kernel<SCOPED, 1> : topk_mma_kernel<SCOPED, 2>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<splits, 32 * (warps + 1), smem, (cudaStream_t)stream>>>(
      emb, scales, (const uint4*)qp, n_rows, width, b, count, k, rows_per_split, splits, stages,
      mask, tiles, n_tiles, cand_vals, cand_idx);
  return (int)cudaGetLastError();
}

}  // namespace narrow
}  // namespace tat

// The entry points take topk.cu's K6 and K7 arguments, but q is the
// permuted bf16 query block (ops/topk.py narrow_query_operand) and
// query_block is 8 or 16 (b <= query_block); scales must be 16-byte
// aligned, and splits are ops/topk.py scan_geometry's at one CTA per SM.

// The launch plan at a width and query block (8 or 16): the shared memory
// bytes, with *warps and *stages set, or -1 where no plan fits.
// ops/topk.py narrow_plan mirrors it to pick the route.
extern "C" int tat_topk_narrow_plan(int width, int query_block, int* warps, int* stages) {
  if ((query_block != 8 && query_block != 16) || width <= 0 || width % 64) return -1;
  return tat::narrow::plan(width, query_block / 8, warps, stages);
}

// K6 at b <= 16.
extern "C" int tat_topk_scan_q_narrow(const int8_t* emb, const float* scales, const void* qp,
                                      int64_t n_rows, int d_pad, int b, int64_t count, int k,
                                      int64_t rows_per_split, int splits, int query_block,
                                      float* cand_vals, int* cand_idx, void* stream) {
  return tat::narrow::launch<false>(emb, scales, qp, n_rows, d_pad, b, count, k,
                                    rows_per_split, splits, query_block, nullptr, nullptr,
                                    nullptr, cand_vals, cand_idx, stream);
}

// K7 at b <= 16: tiles and n_tiles as topk.cu's tat_topk_scan_mq takes them.
extern "C" int tat_topk_scan_mq_narrow(const int8_t* emb, const float* scales, const void* qp,
                                       int64_t n_rows, int d_pad, int b, int64_t count, int k,
                                       int64_t rows_per_split, int splits, int query_block,
                                       const int* mask, const int* tiles, const int* n_tiles,
                                       float* cand_vals, int* cand_idx, void* stream) {
  if (!tiles || !n_tiles) return (int)cudaErrorInvalidValue;
  return tat::narrow::launch<true>(emb, scales, qp, n_rows, d_pad, b, count, k,
                                   rows_per_split, splits, query_block, mask, tiles, n_tiles,
                                   cand_vals, cand_idx, stream);
}
