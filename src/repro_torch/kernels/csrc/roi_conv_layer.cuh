// The register-blocked 3x3 conv layer body of roi_conv_stack.cu (B3's
// ring route and B6) and roi_conv_layers.cu (B3's layer-by-layer route),
// and the persistent-grid sizing of their launchers; the design is set out
// in roi_conv_stack.cu.  Everything here is internal to each source that
// includes it.  The routes are sources of their own so that the ring
// route's translation unit, and with it the machine code of the detector's
// stack, stays as it was before the layer-by-layer route existed
// (ab_kernels.py prints a digest of that code for two checkouts).
#pragma once
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCo = 16;                      // output channels per pass

__host__ __device__ constexpr int pad_co(int c) {
  return (c + kCo - 1) / kCo * kCo;
}

// A compile-time extent where the instance fixes one, else the runtime one.
template <int V>
__device__ __forceinline__ int pick(int rt) {
  return V ? V : rt;
}

// The 3x3 region (0..2 per axis) of a pixel at (y, x) relative to the tile
// body, and whether its slot is live.
__device__ __forceinline__ bool live_at(const int* slot_of, int y, int x,
                                        int th, int tw) {
  const int ry = y < 0 ? 0 : (y < th ? 1 : 2);
  const int rx = x < 0 ? 0 : (x < tw ? 1 : 2);
  return slot_of[ry * 3 + rx] >= 0;
}

// ReLU where RELU is set, else the value as it is.
template <bool RELU>
__device__ __forceinline__ float relu_if(float v) {
  return RELU ? fmaxf(v, 0.f) : v;
}

// One 3x3 conv layer over the CTA's region.  ``in``: cin planes of
// (ho + 2) x win, channel-major; the output is ho x wo (wo = win - 2).  Not
// last: conv + ReLU, cout planes of ho x wo into ``nxt``, zero on ring
// pixels (r_out from the tile body) whose slot is -1.  Last: NHWC rows of
// the tile into ``out``, ReLU'd when RELU is set.  ``w``: (3, 3, cin, cop)
// with zeros past cout.  Each thread takes P pixels (j, j + kThreads, ...)
// of the flattened output at a time.
template <int P, int CIN, int COUT, int WIN, int HO, bool RELU = true>
__device__ __forceinline__ void conv_layer(
    const float* __restrict__ in, const float* __restrict__ w,
    float* __restrict__ nxt, float* __restrict__ out,
    const int* __restrict__ slot_of, int cin_rt, int cout_rt, int win_rt,
    int ho_rt, int r_out, int th, int tw, bool last) {
  const int cin = pick<CIN>(cin_rt), cout = pick<COUT>(cout_rt);
  const int cop = COUT ? pad_co(COUT) : pad_co(cout_rt);
  const int win = pick<WIN>(win_rt), ho = pick<HO>(ho_rt);
  const int wo = win - 2, plane = (ho + 2) * win, pixels = ho * wo;
  for (int co0 = 0; co0 < cop; co0 += kCo) {
    for (int base = threadIdx.x; base < pixels; base += kThreads * P) {
      int off[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = min(base + k * kThreads, pixels - 1);
        const int y = j / wo;
        off[k] = y * win + (j - y * wo);
      }
      float acc[P][kCo];
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int c = 0; c < kCo; ++c) acc[k][c] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* src = in + dy * win + dx;
          const float* wt = w + (dy * 3 + dx) * cin * cop + co0;
          // 8 input channels at a time; 4 for B6's 8 -> 16 body (P = 2),
          // whose whole 72-tap unroll spills registers
#pragma unroll (CIN == 8 && P == 2 ? 4 : 8)
          for (int ci = 0; ci < cin; ++ci) {
            float4 wv[kCo / 4];
#pragma unroll
            for (int c4 = 0; c4 < kCo / 4; ++c4)
              wv[c4] = reinterpret_cast<const float4*>(wt + ci * cop)[c4];
            float xv[P];
#pragma unroll
            for (int k = 0; k < P; ++k) xv[k] = src[ci * plane + off[k]];
#pragma unroll
            for (int k = 0; k < P; ++k) {
#pragma unroll
              for (int c4 = 0; c4 < kCo / 4; ++c4) {
                acc[k][4 * c4 + 0] = fmaf(xv[k], wv[c4].x, acc[k][4 * c4 + 0]);
                acc[k][4 * c4 + 1] = fmaf(xv[k], wv[c4].y, acc[k][4 * c4 + 1]);
                acc[k][4 * c4 + 2] = fmaf(xv[k], wv[c4].z, acc[k][4 * c4 + 2]);
                acc[k][4 * c4 + 3] = fmaf(xv[k], wv[c4].w, acc[k][4 * c4 + 3]);
              }
            }
          }
        }
      }
      const int nc = min(kCo, cout - co0);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = base + k * kThreads;
        if (j >= pixels) continue;
        const int y = j / wo, x = j - y * wo;
        if (last) {
          float* o = out + (static_cast<size_t>(y) * tw + x) * cout + co0;
          if (COUT % 4 == 0 && COUT != 0 && nc == kCo) {
#pragma unroll
            for (int c4 = 0; c4 < kCo / 4; ++c4)
              reinterpret_cast<float4*>(o)[c4] = make_float4(
                  relu_if<RELU>(acc[k][4 * c4 + 0]),
                  relu_if<RELU>(acc[k][4 * c4 + 1]),
                  relu_if<RELU>(acc[k][4 * c4 + 2]),
                  relu_if<RELU>(acc[k][4 * c4 + 3]));
          } else {
#pragma unroll
            for (int c = 0; c < kCo; ++c)
              if (c < nc) o[c] = relu_if<RELU>(acc[k][c]);
          }
        } else {
          // ring pixels of an inactive or off-frame neighbour are zero at
          // the next layer's input, as on the zero-scattered frame
          const bool live = live_at(slot_of, y - r_out, x - r_out, th, tw);
#pragma unroll
          for (int c = 0; c < kCo; ++c)
            if (c < nc)
              nxt[(co0 + c) * pixels + j] = live ? fmaxf(acc[k][c], 0.f) : 0.f;
        }
      }
    }
  }
}

// Opts ``kernel`` in, once per device, to all the shared memory a CTA may
// hold beside its static slot table (so any plan fits without asking
// again), then sizes the persistent grid: as many CTAs of ``smem`` bytes
// as fit on the card at once, at most ``n``.
template <typename K>
cudaError_t persistent_grid(K kernel, std::atomic<uint32_t>& opted,
                            size_t smem, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint32_t bit = 1u << (dev & 31);
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return e;
    opted.fetch_or(bit, std::memory_order_release);
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = static_cast<long long>(sms) * per_sm;
  *grid = static_cast<int>(n < fit ? n : fit);
  return cudaSuccess;
}

}  // namespace
