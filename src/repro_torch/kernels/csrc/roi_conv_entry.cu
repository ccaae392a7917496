// The gather + 3x3 SAME conv family on active tiles: roi_conv_entry (B2,
// with ReLU), roi_conv_fleet (B7, without) and roi_conv (B8, one camera's
// (ty, tx) rows, without ReLU), one kernel template over the ReLU and the
// index width.
//
// Replaces the TPU kernels repro/kernels/roi_conv.py::roi_conv_entry
// (blocked body _roi_conv_entry_block_kernel, per-tile body
// _roi_conv_fleet_kernel with fuse_relu=True), ::roi_conv_fleet (the same
// body with fuse_relu=False) and ::roi_conv (body _roi_conv_kernel).  For
// each tile it reads the haloed (th+2, tw+2, Cin) window at (ty*th - 1,
// tx*tw - 1) of one unpadded (H, W, Cin) frame, reading zero outside the
// frame (JAX pads with jnp.pad), and writes the (th, tw, Cout) conv output,
// ReLU'd in the entry instance.  With (cam, ty, tx) rows the frame is row
// cam of the stacked (C, H, W, Cin) frames.  With (ty, tx) rows the C
// frames share the rows (roi_conv_batched): blockIdx.y is the frame and
// the output is frame-major, (C * n, th, tw, Cout) -- one launch for a
// batch, and one camera's view without an index copy.
//
// What bounds it on the H100: bytes.  With Cin = 3 and Cout = 8 a 16x16
// tile does 110 KFLOP against 3.9 KB read and 8 KB written, about 9 FLOP per
// byte, under the card's float32 line of ~20 FLOP per byte.  Tensor cores
// would buy nothing at Cin = 3, so the products are plain float32 FMAs.
//
// Design: one CTA per tile.  The weights (3, 3, Cin, Cout) and the window go
// to shared memory with coalesced row reads; each thread then computes one
// output pixel for a chunk of 8 output channels and writes them as one
// contiguous run.  Each output element accumulates its taps from 0 in a
// fixed order -- dy, dx, then input channel, one fmaf each -- that does not
// depend on the number of tiles in the launch, on which other tiles are in
// it or on the instance, so a compact launch and a full launch give the
// same bits for the tiles they share, the three instances agree bit for
// bit up to the ReLU, and roi_conv_stack.cu (B3 and B6), which uses the
// same order, continues the chain bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;                    // output channels per pass

template <bool kRelu, int kCols>
__global__ void __launch_bounds__(kThreads)
roi_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const int* __restrict__ idx, float* __restrict__ out, int C,
                int H, int W, int Cin, int Cout, int th, int tw) {
  extern __shared__ float smem[];
  float* w_s = smem;                         // 9 * Cin * Cout
  float* win = smem + 9 * Cin * Cout;        // (th+2) * (tw+2) * Cin
  const int row = blockIdx.x;
  const int cam = kCols == 3 ? idx[3 * row] : static_cast<int>(blockIdx.y);
  const int ty = idx[kCols * row + kCols - 2];
  const int tx = idx[kCols * row + kCols - 1];
  const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x + row;
  if (cam < 0 || cam >= C || ty < 0 || tx < 0 || (ty + 1) * th > H ||
      (tx + 1) * tw > W)
    __trap();                                // a row off the canvas

  for (int i = threadIdx.x; i < 9 * Cin * Cout; i += kThreads) w_s[i] = w[i];
  const int lanes = (tw + 2) * Cin;
  const int y0 = ty * th - 1, x0 = tx * tw - 1;
  for (int e = threadIdx.x; e < (th + 2) * lanes; e += kThreads) {
    const int r = e / lanes, l = e - r * lanes;
    const int col = l / Cin;
    const int y = y0 + r, xx = x0 + col;
    float v = 0.f;
    if (y >= 0 && y < H && xx >= 0 && xx < W)
      v = x[((static_cast<size_t>(cam) * H + y) * W + xx) * Cin + (l - col * Cin)];
    win[e] = v;
  }
  __syncthreads();

  const int pixels = th * tw;
  const int chunks = (Cout + kChunk - 1) / kChunk;
  float* o = out + tile * pixels * Cout;
  for (int item = threadIdx.x; item < pixels * chunks; item += kThreads) {
    const int p = item % pixels, co0 = (item / pixels) * kChunk;
    const int py = p / tw, px = p - py * tw;
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const float* src = win + ((py + dy) * (tw + 2) + px + dx) * Cin;
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
      if (co0 + k < Cout)
        o[p * Cout + co0 + k] = kRelu ? fmaxf(acc[k], 0.f) : acc[k];
  }
}

template <bool kRelu, int kCols>
int launch(const void* x, const void* w, const void* idx, void* out, int n,
           int frames, int C, int H, int W, int Cin, int Cout, int th,
           int tw, void* stream) {
  const size_t smem =
      sizeof(float) * (9 * Cin * Cout + (th + 2) * (tw + 2) * Cin);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roi_conv_kernel<kRelu, kCols>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  roi_conv_kernel<kRelu, kCols>
      <<<dim3(n, frames), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const int*>(idx), static_cast<float*>(out), C, H, W,
          Cin, Cout, th, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B2: (n, 3) rows over the stacked (C, H, W, Cin) frames, with ReLU.
extern "C" int roi_conv_entry_launch(const void* x, const void* w,
                                     const void* idx, void* out, int n, int C,
                                     int H, int W, int Cin, int Cout, int th,
                                     int tw, void* stream) {
  return launch<true, 3>(x, w, idx, out, n, 1, C, H, W, Cin, Cout, th, tw,
                         stream);
}

// B7: as B2, without ReLU.
extern "C" int roi_conv_fleet_launch(const void* x, const void* w,
                                     const void* idx, void* out, int n, int C,
                                     int H, int W, int Cin, int Cout, int th,
                                     int tw, void* stream) {
  return launch<false, 3>(x, w, idx, out, n, 1, C, H, W, Cin, Cout, th, tw,
                          stream);
}

// B8: (n, 2) rows shared by B frames (B, H, W, Cin), without ReLU; out is
// (B * n, th, tw, Cout), frame-major.
extern "C" int roi_conv_launch(const void* x, const void* w, const void* idx,
                               void* out, int n, int B, int H, int W,
                               int Cin, int Cout, int th, int tw,
                               void* stream) {
  return launch<false, 2>(x, w, idx, out, n, B, B, H, W, Cin, Cout, th, tw,
                          stream);
}
