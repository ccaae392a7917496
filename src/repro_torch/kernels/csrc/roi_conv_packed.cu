// roi_conv_packed: one 3x3 conv layer over the packed tiles, no ReLU -- a
// layer of the per-layer chain.
//
// Replaces the TPU kernel repro/kernels/roi_conv.py::roi_conv_packed (body
// _roi_conv_packed_kernel, strips _halo_strip).  Each tile's 1-pixel halo
// comes from its 8 neighbours' facing edges through the (n, 8) slot table
// (NW, N, NE, W, E, SW, S, SE) and is zero where the slot is -1 -- the same
// as scattering the packed tiles onto zeros, running a SAME conv and
// gathering them back.  The caller applies the ReLU between layers.
//
// What bounds it on the H100: operations.  For the default detector's
// 16 -> 16 layer a 16x16 tile does 1.18 MFLOP against 16 KB read (its own
// tile; the halo strips are 1.1 KB more) and 16 KB written, ~36 FLOP per
// byte, above the float32 line of ~20; the 8 -> 16 layer ~24.  The products
// are float32 FMAs.
//
// Design: one CTA per tile, as roi_conv_stack.cu with a ring of one pixel.
// The haloed (th+2, tw+2, Cin) window, assembled from the 9 slots, and the
// weights go to shared memory; pixels sit at an odd channel stride, so the
// 32 threads of a warp, which take 32 neighbouring pixels, read 32
// different banks.  Each thread computes one output pixel for a chunk of 8
// output channels.  Each output element accumulates its taps from 0 in the
// fixed order dy, dx, then input channel, one fmaf each -- the order of
// roi_conv_entry.cu and roi_conv_stack.cu -- so the chain entry + ReLU +
// this layer + ReLU ... gives the stack kernel's bits: every ring pixel the
// stack recomputes reads the same inputs, in the same order, as the owning
// tile's own layer here.  Built without --use_fast_math.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;                    // output channels per pass

__host__ __device__ inline int pixel_stride(int c) {
  return (c % 2 == 0) ? c + 1 : c;           // odd: conflict-free pixels
}

__global__ void __launch_bounds__(kThreads)
roi_conv_packed_kernel(const float* __restrict__ packed,
                       const float* __restrict__ w,
                       const int* __restrict__ nbr, float* __restrict__ out,
                       int n, int th, int tw, int Cin, int Cout) {
  extern __shared__ float smem[];
  __shared__ int slot_of[9];                 // 3x3 region -> packed slot
  const int cs = pixel_stride(Cin), Wp = tw + 2;
  float* win = smem;                         // (th+2) * (tw+2) * cs
  float* w_s = smem + (th + 2) * Wp * cs;    // 9 * Cin * Cout
  const int tile = blockIdx.x;

  if (threadIdx.x < 9) {
    const int code = threadIdx.x;            // (dy+1)*3 + (dx+1)
    int s = tile;
    if (code != 4)
      s = nbr[8 * static_cast<size_t>(tile) + (code < 4 ? code : code - 1)];
    if (s >= n) __trap();                    // a slot outside the launch
    slot_of[code] = s;
  }
  for (int i = threadIdx.x; i < 9 * Cin * Cout; i += kThreads) w_s[i] = w[i];
  __syncthreads();

  for (int e = threadIdx.x; e < (th + 2) * Wp * Cin; e += kThreads) {
    const int pix = e / Cin, ci = e - pix * Cin;
    const int yy = pix / Wp - 1, xx = pix % Wp - 1;
    const int ry = yy < 0 ? 0 : (yy < th ? 1 : 2);
    const int rx = xx < 0 ? 0 : (xx < tw ? 1 : 2);
    const int s = slot_of[ry * 3 + rx];
    float v = 0.f;
    if (s >= 0) {
      const int ly = yy - (ry - 1) * th, lx = xx - (rx - 1) * tw;
      v = packed[((static_cast<size_t>(s) * th + ly) * tw + lx) * Cin + ci];
    }
    win[pix * cs + ci] = v;
  }
  __syncthreads();

  const int pixels = th * tw;
  const int chunks = (Cout + kChunk - 1) / kChunk;
  float* o = out + static_cast<size_t>(tile) * pixels * Cout;
  for (int item = threadIdx.x; item < pixels * chunks; item += kThreads) {
    const int p = item % pixels, co0 = (item / pixels) * kChunk;
    const int py = p / tw, px = p - py * tw;
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const float* src = win + ((py + dy) * Wp + px + dx) * cs;
        const float* wt = w_s + (dy * 3 + dx) * Cin * Cout + co0;
        for (int ci = 0; ci < Cin; ++ci) {
          const float v = src[ci];
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (co0 + k < Cout) acc[k] = fmaf(v, wt[ci * Cout + k], acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (co0 + k < Cout) o[p * Cout + co0 + k] = acc[k];
  }
}

}  // namespace

// Shared memory one CTA needs, in bytes.
extern "C" int roi_conv_packed_smem_bytes(int th, int tw, int Cin, int Cout) {
  return static_cast<int>(
      sizeof(float) * ((th + 2) * (tw + 2) * pixel_stride(Cin) + 9 * Cin * Cout));
}

extern "C" int roi_conv_packed_launch(const void* packed, const void* w,
                                      const void* nbr, void* out, int n,
                                      int th, int tw, int Cin, int Cout,
                                      void* stream) {
  const int smem = roi_conv_packed_smem_bytes(th, tw, Cin, Cout);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roi_conv_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  roi_conv_packed_kernel<<<n, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const float*>(w),
      static_cast<const int*>(nbr), static_cast<float*>(out), n, th, tw, Cin,
      Cout);
  return static_cast<int>(cudaGetLastError());
}
