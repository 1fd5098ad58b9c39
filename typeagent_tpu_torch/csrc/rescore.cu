// K3: exact f32 rescore of each query's selected 128-row buckets.
//
// Replaces: typeagent_tpu/ops/topk.py  _rescore_kernel, launched by
//   _rescore_selected_pallas (phase 2 of exact2 and hybrid exact2).
//
// What bounds it on an H100: device-memory bytes. Each (query, bucket)
//   pair reads its 128 rows (128*d*itemsize bytes, 192 KB at d=384 f32)
//   and does only 2 flops per element read, so the gathered rows, b*B*128
//   of them, set the time; rows that several queries select come from L2.
//
// Design: one CTA per (query, selected bucket). The CTA loads its own
//   bucket id, which replaces the TPU kernel's scalar-prefetch index maps,
//   so any B works: the TPU caps (_RESCORE_MAX_B, the VMEM budget) and the
//   XLA gather fallback have no counterpart. The query row sits in shared
//   memory in f32 (the JAX kernel rescores with the f32 query); each warp
//   takes 32 of the bucket's rows, its lanes read a row's depth in
//   coalesced 128-byte strips, bf16 rows are upcast, and a shuffle tree
//   finishes each dot. Output is [b, B*128] raw cosines, which the caller
//   masks at the watermark and reduces with top-k.

#include "tile.cuh"

namespace tat {

constexpr int RESCORE_THREADS = 128;  // 4 warps x 32 rows = one bucket

template <typename T>
__global__ void __launch_bounds__(RESCORE_THREADS)
    rescore_kernel(const T* __restrict__ emb, const float* __restrict__ q,
                   const int* __restrict__ bucket_ids, int64_t n_rows,
                   int d_pad, int B, float* out) {
  extern __shared__ float qs[];  // [d_pad]
  const int64_t pair = blockIdx.x;  // = query * B + slot
  const int64_t query = pair / B;
  const float* qrow = q + query * d_pad;
  for (int c = threadIdx.x; c < d_pad; c += RESCORE_THREADS) qs[c] = qrow[c];
  __syncthreads();

  const int64_t bucket = bucket_ids[pair];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* orow = out + pair * RB;
  for (int rr = 0; rr < 32; ++rr) {
    const int local = warp * 32 + rr;
    const int64_t r = bucket * RB + local;
    float acc = 0.0f;
    if (r < n_rows) {
      const T* erow = emb + r * d_pad;
      for (int c = lane; c < d_pad; c += 32)
        acc = fmaf(to_f32(erow[c]), qs[c], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) orow[local] = acc;
  }
}

}  // namespace tat

// q: [b, d_pad] f32; bucket_ids: [b, B] i32 in [0, n_rows/128);
// out: [b, B*128] f32. Returns cudaGetLastError().
extern "C" int tat_rescore(const void* emb, int dtype, const float* q,
                           const int* bucket_ids, int64_t n_rows, int d_pad,
                           int b, int B, float* out, void* stream) {
  const dim3 grid((unsigned)((int64_t)b * B));
  const size_t smem = (size_t)d_pad * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    tat::rescore_kernel<float><<<grid, tat::RESCORE_THREADS, smem, st>>>(
        (const float*)emb, q, bucket_ids, n_rows, d_pad, B, out);
  } else {
    tat::rescore_kernel<__nv_bfloat16>
        <<<grid, tat::RESCORE_THREADS, smem, st>>>(
            (const __nv_bfloat16*)emb, q, bucket_ids, n_rows, d_pad, B, out);
  }
  return (int)cudaGetLastError();
}
