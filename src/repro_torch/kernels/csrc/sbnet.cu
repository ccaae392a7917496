// The SBNet tile copies between packed tiles and frames: sbnet_scatter_fleet
// (B4), sbnet_scatter and sbnet_gather (B9), one kernel template over the
// direction and the index width.
//
// Replaces the TPU kernels repro/kernels/sbnet.py::sbnet_scatter_fleet
// (per-tile BlockSpec body and blocked body _scatter_fleet_block_kernel,
// which also serves sbnet.py::sbnet_scatter_changed), ::sbnet_scatter
// (its in-place body) and ::sbnet_gather (_gather_kernel).
//
// * Scatter: tile i of the packed (n, th, tw, A) tensor is written at
//   (cam, ty*th, tx*tw) of the (C, H, W, A) canvas -- (ty*th, tx*tw) of an
//   (H, W, A) frame for one camera's (ty, tx) rows -- in place; every other
//   byte keeps its value.  The cold step writes every active tile into a
//   fresh canvas, a warm step only the refreshed tiles into the previous
//   step's canvas (the JAX package donated the buffer for the same
//   effect).  Padding rows repeat the last real (row, tile) pair and
//   rewrite the same bytes with the same values, a benign race.
// * Gather: the (th, tw, C) tile at (ty*th, tx*tw) of an (H, W, C) frame
//   into packed slot i.
//
// What bounds it on the H100: bytes (a copy).  Each tile reads th*tw*A
// floats and writes as many.
//
// Design: one CTA per packed tile.  The tile's rows are tw*A contiguous
// floats in both the packed tensor and the frame (640 bytes at tile 16,
// A = 10), so consecutive threads copy consecutive floats: coalesced reads
// and writes, no shared memory, no atomics.  A row whose tile leaves the
// frame traps.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kScatter, int kCols>
__global__ void __launch_bounds__(kThreads)
tile_copy_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                 float* __restrict__ dst, int th, int tw, int A, int C, int H,
                 int W) {
  const int tile = blockIdx.x;
  const int cam = kCols == 3 ? idx[3 * tile] : 0;
  const int ty = idx[kCols * tile + kCols - 2];
  const int tx = idx[kCols * tile + kCols - 1];
  if (cam < 0 || cam >= C || ty < 0 || tx < 0 || (ty + 1) * th > H ||
      (tx + 1) * tw > W)
    __trap();                                // a row off the canvas
  const int row = tw * A;
  const size_t packed0 = static_cast<size_t>(tile) * th * row;
  for (int e = threadIdx.x; e < th * row; e += kThreads) {
    const int r = e / row, l = e - r * row;
    const size_t at =
        ((static_cast<size_t>(cam) * H + ty * th + r) * W + tx * tw) * A + l;
    if (kScatter)
      dst[at] = src[packed0 + e];
    else
      dst[packed0 + e] = src[at];
  }
}

template <bool kScatter, int kCols>
int launch(const void* src, const void* idx, void* dst, int n, int th, int tw,
           int A, int C, int H, int W, void* stream) {
  tile_copy_kernel<kScatter, kCols>
      <<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(src), static_cast<const int*>(idx),
          static_cast<float*>(dst), th, tw, A, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B4: packed (n, th, tw, A) into base (C, H, W, A) at (n, 3) rows.
extern "C" int sbnet_scatter_fleet_launch(const void* packed, const void* idx,
                                          void* base, int n, int th, int tw,
                                          int A, int C, int H, int W,
                                          void* stream) {
  return launch<true, 3>(packed, idx, base, n, th, tw, A, C, H, W, stream);
}

// B9: packed (n, th, tw, A) into base (H, W, A) at (n, 2) rows.
extern "C" int sbnet_scatter_launch(const void* packed, const void* idx,
                                    void* base, int n, int th, int tw, int A,
                                    int H, int W, void* stream) {
  return launch<true, 2>(packed, idx, base, n, th, tw, A, 1, H, W, stream);
}

// B9: x (H, W, A) at (n, 2) rows into out (n, th, tw, A).
extern "C" int sbnet_gather_launch(const void* x, const void* idx, void* out,
                                   int n, int th, int tw, int A, int H, int W,
                                   void* stream) {
  return launch<false, 2>(x, idx, out, n, th, tw, A, 1, H, W, stream);
}

// The name of a CUDA error code, for the wrappers' messages.
extern "C" const char* repro_cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
