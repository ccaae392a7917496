// Device helpers of the delta-pricing kernels (tile_delta_gate.cu,
// tile_delta.cu): the quantizer and the byte estimate, which both use, and
// tile_delta.cu's integer block reduction.
//
// The quantizer is the one place the stats' bits are decided:
// q = round_half_even((cur - prev) / qstep) in float32, with every rounding
// written out (__fsub_rn, __fdiv_rn, rintf) so that the library, built
// without --use_fast_math, matches numpy and jnp.round bit for bit.
#pragma once
#include <cuda_runtime.h>

namespace tile_delta_common {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int quantize(float cur, float prev, float qstep) {
  return static_cast<int>(rintf(__fdiv_rn(__fsub_rn(cur, prev), qstep)));
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums each of K per-thread integer counters over the block (kThreads
// threads) into s[] on thread 0: per warp with shuffles, then across warps
// by thread 0.  Exact in any order, no atomics.  Every thread must call it.
template <int K>
__device__ __forceinline__ void block_sum(long long (&v)[K],
                                          long long (*part)[K],
                                          long long (&s)[K]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < K; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) part[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 0; k < K; ++k) s[k] = 0;
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < K; ++k) s[k] += part[w][k];
  }
}

// ceil((nnz * coef_bits + runs * run_bits) / 8): the byte estimate.
__device__ __forceinline__ int est_bytes(long long nnz, long long runs,
                                         int coef_bits, int run_bits) {
  return static_cast<int>((nnz * coef_bits + runs * run_bits + 7) / 8);
}

}  // namespace tile_delta_common
