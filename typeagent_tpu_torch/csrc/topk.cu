// Fused cosine top-k (k <= 32) over a padded embedding store: K1 and its
// scoped and int8 variants K4-K7, one merge kernel, and two scan kernels:
// the FFMA tile of tile.cuh for f32 and bf16 rows (K1, K4, K5) and the
// tensor-core loop of mma_tile.cuh for int8 rows (K6, K7).
//
// Replaces (typeagent_tpu/ops/topk.py), each with its _mask_and_fold /
// _fold_tile_into_topk:
//   K1 _topk_kernel     (_topk_pallas_impl)     rows f32/bf16, no filter
//   K4 _topk_kernel_iv  (_topk_pallas_iv_impl)  rows f32/bf16, <= 8 intervals
//   K5 _topk_kernel_m   (_topk_pallas_m_impl)   rows f32/bf16, i32 row mask
//   K6 _topk_kernel_q   (_topk_pallas_q_impl)   rows int8 + f32 scales
//   K7 _topk_kernel_mq  (_topk_pallas_mq_impl)  rows int8 + scales + mask
//
// What bounds it on an H100: for f32 and bf16 rows at serving batches the
//   FP32 FFMA rate. The score tile is plain FFMA because f32 stores must
//   match Precision.HIGHEST (no TF32): 2*b*n*d operations, 197 GFLOP for
//   b=256 over 1M x 384, 2.9 ms at the 67 TFLOP/s FP32 peak. At b <= 8 the
//   store read (n*d*itemsize bytes, 0.46 ms for 1M x 384 f32) bounds it
//   instead. For int8 rows the product of a bf16 query and an int8 code is
//   exact in bf16 x bf16 -> f32, so K6 and K7 run on the tensor cores
//   (989 TFLOP/s): the read of the codes bounds them (11.5 GB for 30M x
//   384, 3.4 ms), where FFMA over upcast codes needed 22 ms of FP32 peak
//   at b=64. The filters cost one compare per row and tile (an i32 read
//   per row for the mask).
//
// Design: the TPU kernel carries its running top-k in a VMEM output block
//   across a grid that runs in order. CTAs run in no order, so the search
//   is two launches. (1) scan: one wave of two CTAs per SM per query
//   block (ops/topk.py scan_geometry); each CTA walks a contiguous,
//   ascending range of 128-row tiles, never writes scores to device
//   memory, and keeps each query's running top-k in registers across one
//   warp (lane j holds entry j): after each tile the scores sit in a shared
//   block and each warp reads its queries' 128 scores lane by lane, in
//   ascending row order, at one ballot per query and 32 rows once the list
//   is warm, the counterpart of the JAX kernel's "n_above == 0" tier. It
//   writes [b, splits, k] candidates. (2) merge: one warp per query folds
//   the splits' lists, in split order, into the final [b, k]. Both passes
//   insert equal values in ascending row order, so ties go to the lowest
//   row as in the JAX kernel. Unfilled slots are (-3.0, -1).
//   FFMA scans: the query block (8, 16, 32 or 64 queries: TQ = 1, 2, 4, 8)
//   follows the batch (ops/topk.py topk_query_block), so a batch of 8
//   scores no padding queries while b = 256 streams the store 4 times.
//   int8 scans: 64-query blocks of bf16 queries (cast once by the wrapper,
//   as the JAX callers cast them) on K8's loop; the accumulators of a tile
//   leave through a shared score block. With resident queries (d <= 448)
//   that block holds 32 queries, so the 64 are folded in two passes: the
//   whole block beside the resident queries and the two-slot ring would
//   need 121,856 bytes at d = 384, past the 115,712 that let two CTAs
//   share an SM. Wider rows stream their query strips and fold in one
//   pass. The scoped scans' CTAs (K4, K5, K7) walk only the tiles that
//   hold an in-scope row: the wrapper lists them on the device (ops/topk.py
//   interval_tiles from K4's table, scope_tiles from a row mask; no host
//   synchronisation) and each CTA takes a contiguous share of the list
//   (scope_share), so a one-conversation scope reads a third of the store.
//   The grid stays the unscoped scan's (fixed from the count, before the
//   list's length is known); a CTA whose share is empty writes (-3, -1).
//
// Filters and scales: a row at or past `count`, or outside the scope, is
//   offered as RAW_NEG and never enters a list (a listed tile may hold
//   such rows beside in-scope ones). The interval table (K4) is copied to
//   shared memory once per CTA; the mask (K5, K7) is read by the thread
//   that owns the row. An int8 row's scale multiplies its f32 dot
//   afterwards, before the mask, as the JAX kernel does (raw * s_ref, then
//   ok), never the row before the dot.

#include "mma_tile.cuh"

namespace tat {

enum RowFilter { kNoFilter = 0, kIntervals = 1, kMask = 2 };
constexpr int MAX_INTERVALS = 8;  // the JAX _PALLAS_MAX_INTERVALS

// What a filtered scan reads beside the rows; unused fields are null.
struct ScanExtras {
  const int* intervals;    // kIntervals: [n_intervals, 2] half-open spans
  int n_intervals;
  const int* mask;         // kMask: [n_rows], > 0 = searchable
  const int* tiles;        // filtered scans: the ascending listed tiles
  const int* n_tiles;      // and a device int holding how many
};

// CTA (query block blockIdx % n_qb, split blockIdx / n_qb). K1 (no
// filter): split i walks tiles [i*per, (i+1)*per) below the live count,
// per = rows_per_split / 128. K4 and K5: split i walks its share
// [n*i/splits, n*(i+1)/splits) of the n = *n_tiles ascending tile indices
// in x.tiles (ops/topk.py interval_tiles, scope_tiles, scope_share), and
// offers only the rows below the count that its filter keeps.
template <typename T, int F, int TQ>
__global__ void __launch_bounds__(THREADS, 2)
    topk_scan_kernel(const T* __restrict__ emb, const float* __restrict__ q,
                     int64_t n_rows, int d_pad, int b, int64_t count, int k,
                     int64_t rows_per_split, int splits, ScanExtras x,
                     float* cand_vals, int* cand_idx) {
  constexpr bool LISTED = F != kNoFilter;
  extern __shared__ __align__(16) float smem[];
  __shared__ int iv[2 * MAX_INTERVALS];
  constexpr int QB = FfmaTile<TQ>::QB;
  const int n_qb = (b + QB - 1) / QB;
  const int qb = blockIdx.x % n_qb;
  const int split = blockIdx.x / n_qb;
  const int q0 = qb * QB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (F == kIntervals) {
    if (threadIdx.x < 2 * x.n_intervals) iv[threadIdx.x] = x.intervals[threadIdx.x];
    __syncthreads();
  }

  WarpTopK top[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) top[i].init();

  const int64_t live = count < n_rows ? count : n_rows;
  // Rows at or past `end` are offered as RAW_NEG: the split's end (K1) or
  // the live count (listed tiles).
  int64_t end, first;
  int mine;
  if constexpr (LISTED) {
    const int64_t n = *x.n_tiles;
    first = n * split / splits;
    mine = (int)(n * (split + 1) / splits - first);
    end = live;
  } else {
    const int64_t begin = (int64_t)split * rows_per_split;
    end = begin + rows_per_split;
    if (end > live) end = live;
    // rows_per_split is a multiple of RB, so the split starts on a tile.
    first = begin / RB;
    mine = (int)((end > begin ? (end + RB - 1) / RB : first) - first);
  }
  using Tiles = typename std::conditional<LISTED, TileList, TileRange>::type;
  Tiles tile_at;
  if constexpr (LISTED) {
    tile_at = TileList{x.tiles, first};
  } else {
    tile_at = TileRange{first};
  }
  scan_tiles<T, TQ>(emb, q, n_rows, d_pad, b, q0, mine, tile_at, smem,
                    [&](int64_t r0, const float* S) {
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + lane + 32 * j;
      ok[j] = r < end;
      if constexpr (F == kIntervals) {
        bool in = false;
        for (int t = 0; t < x.n_intervals; ++t)
          in |= r >= iv[2 * t] && r < iv[2 * t + 1];
        ok[j] = ok[j] && in;
      }
      if constexpr (F == kMask) ok[j] = ok[j] && x.mask[r] > 0;
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const float* srow = S + (warp * TQ + i) * SP;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // ascending rows: lane + 32 j
        const float v = srow[lane + 32 * j];
        top[i].offer(ok[j] ? v : RAW_NEG, (int)(r0 + lane + 32 * j), k, lane);
      }
    }
  });

#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int gq = q0 + warp * TQ + i;
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

// ---------------------------------------------------------------------------
// K6, K7: int8 rows on the tensor-core loop, with a top-k epilogue
// ---------------------------------------------------------------------------

constexpr int MMA_SP = RB + 4;  // f32 per score row: the fragment scatter is conflict-free

// Dynamic shared memory of topk_mma_kernel: the score block of one fold
// pass ([QPASS][MMA_SP] f32), then the loop's (MmaLoopSmem). Resident
// queries leave room for the scores of half the query block (two passes),
// streamed query strips for all of it (one pass).
template <bool RESIDENT>
struct TopkMmaSmem {
  static constexpr int QPASS = RESIDENT ? MMA_QB / 2 : MMA_QB;
  static constexpr int SCORES = QPASS * MMA_SP * 4;
  static __host__ __device__ int bytes(int width) {
    return SCORES + MmaLoopSmem<RowsI8, RESIDENT>::bytes(width);
  }
};

// emb: [n_rows, width] int8 codes; scales: [n_rows] f32; q: [b, width]
// bf16. CTA (query block blockIdx % n_qb, split blockIdx / n_qb). K6
// (!SCOPED): split i walks tiles [i*per, (i+1)*per) below the live count,
// per = rows_per_split / 128. K7 (SCOPED): split i walks its share
// [n*i/splits, n*(i+1)/splits) of the n = *n_tiles ascending tile indices
// in `tiles`, and offers only rows whose mask entry is > 0.
template <bool SCOPED, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 2)
    topk_mma_kernel(const int8_t* __restrict__ emb, const float* __restrict__ scales,
                    const __nv_bfloat16* __restrict__ q, int64_t n_rows, int width, int b,
                    int64_t count, int k, int64_t rows_per_split, int splits,
                    const int* __restrict__ mask, const int* __restrict__ tiles,
                    const int* __restrict__ n_tiles, float* cand_vals, int* cand_idx) {
  using Smem = TopkMmaSmem<RESIDENT>;
  constexpr int QPASS = Smem::QPASS;
  constexpr int PASSES = MMA_QB / QPASS;
  constexpr int QW = QPASS / 8;  // queries each warp folds per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const S = reinterpret_cast<float*>(smem_raw);
  const int n_qb = (b + MMA_QB - 1) / MMA_QB;
  const int q0 = (int)(blockIdx.x % n_qb) * MMA_QB;
  const int split = (int)(blockIdx.x / n_qb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = warp % ROW_WARPS, wq = warp / ROW_WARPS;  // the loop's warp tile
  const int gr = lane >> 2, t = lane & 3;                  // fragment row group, thread

  // Warp w folds queries p*QPASS + w*QW + i of the block in pass p.
  WarpTopK top[PASSES * QW];
#pragma unroll
  for (int i = 0; i < PASSES * QW; ++i) top[i].init();

  // This split's tiles: K7 its share of the list (ops/topk.py
  // scope_share), K6 its range of the live tiles (scan_geometry).
  int64_t first;
  int mine;
  if constexpr (SCOPED) {
    const int64_t n = *n_tiles;
    first = n * split / splits;
    mine = (int)(n * (split + 1) / splits - first);
  } else {
    const int64_t live_nt = (count + RB - 1) / RB, per = rows_per_split / RB;
    first = (int64_t)split * per;
    const int64_t last = first + per < live_nt ? first + per : live_nt;
    mine = last > first ? (int)(last - first) : 0;
  }
  using Tiles = typename std::conditional<SCOPED, TileList, TileRange>::type;
  Tiles tile_at;
  if constexpr (SCOPED) {
    tile_at = TileList{tiles, first};
  } else {
    tile_at = TileRange{first};
  }
  mma_tiles<RowsI8, RESIDENT>(
      emb, q, n_rows, width, b, q0, mine, tile_at, smem_raw + Smem::SCORES,
      [&](int64_t tile, const float(&acc)[2][4][4]) {
        const int64_t r0 = tile * RB;
        // This thread's rows r0 + wr*32 + gr + 8*h2 (m-tile h2 >> 1,
        // fragment half h2 & 1): scale the sums, then mask rows at or past
        // the count or out of scope to RAW_NEG (raw * s_ref, then ok).
        bool ok[4];
        float sc[4];
#pragma unroll
        for (int h2 = 0; h2 < 4; ++h2) {
          const int64_t r = r0 + wr * 32 + gr + 8 * h2;
          ok[h2] = r < count;
          if constexpr (SCOPED) ok[h2] = ok[h2] && mask[r] > 0;
          sc[h2] = ok[h2] ? scales[r] : 0.0f;
        }
#pragma unroll
        for (int p = 0; p < PASSES; ++p) {
          if (PASSES == 1 || wq == p) {
            float* const s = S + (wq * 32 - p * QPASS + 2 * t) * MMA_SP + wr * 32 + gr;
#pragma unroll
            for (int m = 0; m < 2; ++m)
#pragma unroll
              for (int n = 0; n < 4; ++n)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const int h2 = 2 * m + (j >> 1);
                  s[(n * 8 + (j & 1)) * MMA_SP + m * 16 + 8 * (j >> 1)] =
                      ok[h2] ? acc[m][n][j] * sc[h2] : RAW_NEG;
                }
          }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < QW; ++i) {
            const float* const srow = S + (warp * QW + i) * MMA_SP;
#pragma unroll
            for (int j = 0; j < 4; ++j)  // ascending rows: lane + 32 j
              top[p * QW + i].offer(srow[lane + 32 * j], (int)(r0 + lane + 32 * j), k, lane);
          }
          // The second pass writes the block the first has just read; the
          // next tile's first barrier orders the last pass's reads.
          if (p + 1 < PASSES) __syncthreads();
        }
      });

#pragma unroll
  for (int p = 0; p < PASSES; ++p)
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const int gq = q0 + p * QPASS + warp * QW + i;
      if (gq < b && lane < k) {
        const int64_t o = ((int64_t)gq * splits + split) * k + lane;
        cand_vals[o] = top[p * QW + i].v;
        cand_idx[o] = top[p * QW + i].i;
      }
    }
}

template <bool SCOPED>
int launch_topk_mma(const int8_t* emb, const float* scales, const void* q, int64_t n_rows,
                    int width, int b, int64_t count, int k, int64_t rows_per_split, int splits,
                    int query_block, const int* mask, const int* tiles, const int* n_tiles,
                    float* cand_vals, int* cand_idx, void* stream) {
  if (query_block != MMA_QB || width % MMA_KC) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((b + MMA_QB - 1) / MMA_QB) * splits));
  // Resident queries where two CTAs still share an SM, else streamed.
  int smem = TopkMmaSmem<true>::bytes(width);
  auto kernel = topk_mma_kernel<SCOPED, true>;
  if (smem > SMEM_2CTA) {
    smem = TopkMmaSmem<false>::bytes(width);
    kernel = topk_mma_kernel<SCOPED, false>;
  }
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      emb, scales, (const __nv_bfloat16*)q, n_rows, width, b, count, k, rows_per_split, splits,
      mask, tiles, n_tiles, cand_vals, cand_idx);
  return (int)cudaGetLastError();
}

template <typename T, int F, int TQ>
int launch_scan_tq(const void* emb, const float* q, int64_t n_rows, int d_pad,
                   int b, int64_t count, int k, int64_t rows_per_split,
                   int splits, ScanExtras x, float* cand_vals, int* cand_idx,
                   cudaStream_t stream) {
  constexpr int QB = FfmaTile<TQ>::QB;
  constexpr int smem = FfmaTile<TQ>::SMEM_BYTES;
  auto kernel = topk_scan_kernel<T, F, TQ>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((unsigned)(((b + QB - 1) / QB) * splits));
  kernel<<<grid, THREADS, smem, stream>>>((const T*)emb, q, n_rows, d_pad, b, count, k,
                                         rows_per_split, splits, x, cand_vals, cand_idx);
  return (int)cudaGetLastError();
}

// query_block: 8, 16, 32 or 64 queries per CTA (ops/topk.py topk_query_block).
template <typename T, int F>
int launch_scan(const void* emb, const float* q, int64_t n_rows, int d_pad,
                int b, int64_t count, int k, int64_t rows_per_split,
                int splits, int query_block, ScanExtras x, float* cand_vals,
                int* cand_idx, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (query_block) {
    case 8:
      return launch_scan_tq<T, F, 1>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    case 16:
      return launch_scan_tq<T, F, 2>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    case 32:
      return launch_scan_tq<T, F, 4>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    case 64:
      return launch_scan_tq<T, F, 8>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                     splits, x, cand_vals, cand_idx, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32 store, 1 = bfloat16 store.
template <int F>
int launch_float_scan(const void* emb, int dtype, const float* q,
                      int64_t n_rows, int d_pad, int b, int64_t count, int k,
                      int64_t rows_per_split, int splits, int query_block,
                      ScanExtras x, float* cand_vals, int* cand_idx, void* stream) {
  if (dtype == 0)
    return launch_scan<float, F>(emb, q, n_rows, d_pad, b, count, k, rows_per_split,
                                 splits, query_block, x, cand_vals, cand_idx, stream);
  return launch_scan<__nv_bfloat16, F>(emb, q, n_rows, d_pad, b, count, k,
                                       rows_per_split, splits, query_block, x,
                                       cand_vals, cand_idx, stream);
}

}  // namespace tat

// Every scan takes the split geometry (rows_per_split, a multiple of 128,
// and splits) and the query block from ops/topk.py scan_geometry and
// topk_query_block; the store and queries are 16-byte aligned with d_pad %
// 32 == 0. Every entry point returns cudaGetLastError() after its launch.

// K1. dtype: 0 = float32 store, 1 = bfloat16 store.
extern "C" int tat_topk_scan(const void* emb, int dtype, const float* q,
                             int64_t n_rows, int d_pad, int b, int64_t count,
                             int k, int64_t rows_per_split, int splits,
                             int query_block, float* cand_vals, int* cand_idx,
                             void* stream) {
  return tat::launch_float_scan<tat::kNoFilter>(
      emb, dtype, q, n_rows, d_pad, b, count, k, rows_per_split, splits,
      query_block, tat::ScanExtras{}, cand_vals, cand_idx, stream);
}

// K4 and K5 read only listed tiles. tiles: the ascending indices of the
// 128-row tiles that hold an in-scope row below the count, and n_tiles: a
// device int holding how many (ops/topk.py interval_tiles for K4,
// scope_tiles for K5). splits: CTAs per query block (scan_geometry over
// the count; rows_per_split is unused).

// K4: rows inside any of n_intervals (<= 8) [start, stop) spans.
extern "C" int tat_topk_scan_iv(const void* emb, int dtype, const float* q,
                                int64_t n_rows, int d_pad, int b,
                                int64_t count, int k, int64_t rows_per_split,
                                int splits, int query_block,
                                const int* intervals, int n_intervals,
                                const int* tiles, const int* n_tiles,
                                float* cand_vals, int* cand_idx, void* stream) {
  if (n_intervals < 0 || n_intervals > tat::MAX_INTERVALS || !tiles || !n_tiles)
    return (int)cudaErrorInvalidValue;
  tat::ScanExtras x{};
  x.intervals = intervals;
  x.n_intervals = n_intervals;
  x.tiles = tiles;
  x.n_tiles = n_tiles;
  return tat::launch_float_scan<tat::kIntervals>(
      emb, dtype, q, n_rows, d_pad, b, count, k, rows_per_split, splits,
      query_block, x, cand_vals, cand_idx, stream);
}

// K5: rows whose i32 mask entry is > 0 (the JAX kernel's m_ref > 0).
extern "C" int tat_topk_scan_mask(const void* emb, int dtype, const float* q,
                                  int64_t n_rows, int d_pad, int b,
                                  int64_t count, int k,
                                  int64_t rows_per_split, int splits,
                                  int query_block, const int* mask,
                                  const int* tiles, const int* n_tiles,
                                  float* cand_vals, int* cand_idx,
                                  void* stream) {
  if (!tiles || !n_tiles) return (int)cudaErrorInvalidValue;
  tat::ScanExtras x{};
  x.mask = mask;
  x.tiles = tiles;
  x.n_tiles = n_tiles;
  return tat::launch_float_scan<tat::kMask>(
      emb, dtype, q, n_rows, d_pad, b, count, k, rows_per_split, splits,
      query_block, x, cand_vals, cand_idx, stream);
}

// K6: int8 rows ([n_rows, d_pad] codes, d_pad % 64 == 0) with per-row
// scales ([n_rows] f32); q: [b, d_pad] bf16 (the f32 queries rounded once
// by the wrapper); query_block 64.
extern "C" int tat_topk_scan_q(const int8_t* emb, const float* scales,
                               const void* q, int64_t n_rows, int d_pad,
                               int b, int64_t count, int k,
                               int64_t rows_per_split, int splits,
                               int query_block, float* cand_vals,
                               int* cand_idx, void* stream) {
  return tat::launch_topk_mma<false>(emb, scales, q, n_rows, d_pad, b, count, k,
                                     rows_per_split, splits, query_block, nullptr,
                                     nullptr, nullptr, cand_vals, cand_idx, stream);
}

// K7: K6 over the rows whose i32 mask entry is > 0. tiles: the ascending
// indices of the 128-row tiles that hold such a row below the count, and
// n_tiles: a device int holding how many (ops/topk.py scope_tiles); only
// listed tiles are read. splits: CTAs per query block (scan_geometry over
// the count; rows_per_split is unused).
extern "C" int tat_topk_scan_mq(const int8_t* emb, const float* scales,
                                const void* q, int64_t n_rows, int d_pad,
                                int b, int64_t count, int k,
                                int64_t rows_per_split, int splits,
                                int query_block, const int* mask,
                                const int* tiles, const int* n_tiles,
                                float* cand_vals, int* cand_idx, void* stream) {
  return tat::launch_topk_mma<true>(emb, scales, q, n_rows, d_pad, b, count, k,
                                    rows_per_split, splits, query_block, mask, tiles,
                                    n_tiles, cand_vals, cand_idx, stream);
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
