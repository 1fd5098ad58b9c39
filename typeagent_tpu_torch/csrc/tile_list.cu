// The tile lists of the scoped scans K4, K5 and K7 (topk.cu): the
// ascending indices of the 128-row tiles that hold an in-scope row below
// the count, then -1, and a device int holding how many.
//
// Replaces: the TPU kernels walk every tile of the store and test each
//   row's scope after the product (typeagent_tpu/ops/topk.py
//   _topk_kernel_iv's interval compares, _topk_kernel_m's and
//   _topk_kernel_mq's mask test). The H100 scans read only the listed
//   tiles; these kernels list them. Their plain versions are ops/topk.py
//   interval_tiles_plain and scope_tiles_plain (a flag per tile, a running
//   count and a scatter, about fifteen torch ops launched from Python).
//
// What bounds it on an H100: for a row mask, the mask read (4 bytes a row:
//   120 MB, 36 us, for 30M rows); for an interval table, the list's write
//   (4 bytes a tile), far below a launch's own cost.
//
// Design: the list is built on the device, so the host never learns its
//   length and a scoped search never waits; each list is one call from
//   Python. Tiles are flagged 32 to a word (bit j of word w: tile 32w+j).
//   One CTA of 1024 threads compacts the words: warp i takes a contiguous
//   run of words, counts their bits, an exclusive scan of the 32 warps'
//   counts gives its first position, and it writes its tiles from there,
//   word by word, each word's listed tiles in one contiguous store (one
//   thread per tile), so the list ascends. A table's words are computed where they
//   are read: an interval sets one contiguous run of bits in a word, so a
//   word costs one test per interval. A row mask's words come from a first
//   launch, one warp per word: each lane reads one tile's 128 entries in
//   16-byte loads, and one ballot makes the word.

#include "tile.cuh"

namespace tat {

constexpr int LIST_THREADS = 1024;  // the compaction's one CTA
constexpr int WORD_TILES = 32;      // tiles flagged per word
constexpr int FLAG_WARPS = 8;       // words per CTA of the mask's flags

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// words[w] bit j = 1 iff a row r < count of tile 32w + j has mask[r] > 0.
// Lane j reads tile 32w + j's 128 entries, 16 bytes at a time when the
// mask is 16-byte aligned, so each lane keeps many independent loads in
// flight; one ballot makes the word.
__global__ void __launch_bounds__(FLAG_WARPS * 32)
    mask_words_kernel(const int* __restrict__ mask, int64_t count, int64_t n_words,
                      unsigned* __restrict__ words) {
  const int64_t w = (int64_t)blockIdx.x * FLAG_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= n_words) return;  // uniform per warp
  const int64_t r0 = (w * WORD_TILES + lane) * RB;
  bool hit = false;
  if (r0 + RB <= count && ((uintptr_t)mask & 15) == 0) {
    const int4* row = reinterpret_cast<const int4*>(mask + r0);
#pragma unroll 8
    for (int i = 0; i < RB / 4; ++i) {
      const int4 v = __ldg(row + i);
      hit |= (v.x > 0) | (v.y > 0) | (v.z > 0) | (v.w > 0);
    }
  } else {
    for (int64_t r = r0; r < min64(r0 + RB, count); ++r) hit |= mask[r] > 0;
  }
  const unsigned bits = __ballot_sync(FULL, hit);
  if (lane == 0) words[w] = bits;
}

// Word w, read from the mask's words.
struct StoredWords {
  const unsigned* words;
  __device__ unsigned operator()(int64_t w) const { return words[w]; }
};

// Word w from the table: each non-empty [start, stop) clipped to the
// word's rows below the count sets the bits of the tiles it meets.
struct IntervalWords {
  const int* intervals;
  int n_intervals;
  int64_t count;
  __device__ unsigned operator()(int64_t w) const {
    const int64_t lo = w * WORD_TILES * RB, hi = min64(lo + WORD_TILES * RB, count);
    unsigned bits = 0;
    for (int i = 0; i < n_intervals; ++i) {
      const int64_t a = max64(intervals[2 * i], lo), b = min64(intervals[2 * i + 1], hi);
      if (a < b) {
        const int first = (int)((a - lo) / RB), last = (int)((b - 1 - lo) / RB);
        const unsigned upto = last == WORD_TILES - 1 ? FULL : (1u << (last + 1)) - 1;
        bits |= upto & ~((1u << first) - 1);
      }
    }
    return bits;
  }
};

template <typename Words>
__global__ void __launch_bounds__(LIST_THREADS)
    compact_tiles_kernel(Words word, int64_t live, int* __restrict__ tiles,
                         int* __restrict__ n_tiles) {
  constexpr int WARPS = LIST_THREADS / 32;
  __shared__ int warp_base[WARPS];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_words = (live + WORD_TILES - 1) / WORD_TILES;
  const int64_t per = (n_words + WARPS - 1) / WARPS;
  const int64_t begin = min64((int64_t)warp * per, n_words);
  const int64_t end = min64(begin + per, n_words);
  // This warp's listed tiles: lane l counts words begin + l, + 32, ...
  int mine = 0;
  for (int64_t w = begin + lane; w < end; w += 32) mine += __popc(word(w));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(FULL, mine, o);
  if (lane == 0) warp_base[warp] = mine;
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the warps' counts
    const int c = warp_base[lane];
    int inc = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += v;
    }
    warp_base[lane] = inc - c;
    if (lane == 31) total = inc;
  }
  __syncthreads();
  // Words 32 at a time, one per lane; then word by word, lane l writes
  // tile 32w + l if listed, after the word's lower listed tiles, so each
  // word's tiles leave in one contiguous store.
  int pos = warp_base[warp];
  const unsigned below = (1u << lane) - 1;
  for (int64_t w0 = begin; w0 < end; w0 += 32) {
    const unsigned mine_word = w0 + lane < end ? word(w0 + lane) : 0u;
    const int n = (int)min64(32, end - w0);
    for (int j = 0; j < n; ++j) {
      const unsigned bits = __shfl_sync(FULL, mine_word, j);
      if ((bits >> lane) & 1u)
        tiles[pos + __popc(bits & below)] = (int)((w0 + j) * WORD_TILES + lane);
      pos += __popc(bits);
    }
  }
  for (int64_t p = total + threadIdx.x; p < live; p += LIST_THREADS) tiles[p] = -1;
  if (threadIdx.x == 0) *n_tiles = total;
}

}  // namespace tat

// Both entries write tiles ([live] int32, live = ceil(count / 128)) and
// n_tiles ([1] int32) on the stream, with count already clamped to the
// store by the caller, and return cudaGetLastError() after the last launch.

// From an interval table: [n_intervals, 2] int32 half-open spans,
// unsorted or overlapping; empty spans select nothing. One launch.
extern "C" int tat_interval_tiles(const int* intervals, int n_intervals, int64_t count,
                                  int* tiles, int* n_tiles, void* stream) {
  if (n_intervals < 0 || count < 0) return (int)cudaErrorInvalidValue;
  const int64_t live = (count + tat::RB - 1) / tat::RB;
  tat::compact_tiles_kernel<<<1, tat::LIST_THREADS, 0, (cudaStream_t)stream>>>(
      tat::IntervalWords{intervals, n_intervals, count}, live, tiles, n_tiles);
  return (int)cudaGetLastError();
}

// From a row mask ([>= live * 128] int32, > 0 = in scope); words:
// [ceil(live / 32)] 32-bit words of scratch. Two launches.
extern "C" int tat_scope_tiles(const int* mask, int64_t count, unsigned* words, int* tiles,
                               int* n_tiles, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  const int64_t live = (count + tat::RB - 1) / tat::RB;
  const int64_t n_words = (live + tat::WORD_TILES - 1) / tat::WORD_TILES;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_words > 0) {
    const dim3 grid((unsigned)((n_words + tat::FLAG_WARPS - 1) / tat::FLAG_WARPS));
    tat::mask_words_kernel<<<grid, tat::FLAG_WARPS * 32, 0, st>>>(mask, count, n_words, words);
  }
  tat::compact_tiles_kernel<<<1, tat::LIST_THREADS, 0, st>>>(tat::StoredWords{words}, live,
                                                             tiles, n_tiles);
  return (int)cudaGetLastError();
}
