// sbnet_scatter: packed head tiles into the persistent (C, H, W, A) canvas.
//
// Replaces the TPU kernel repro/kernels/sbnet.py::sbnet_scatter_fleet
// (per-tile BlockSpec body and blocked body _scatter_fleet_block_kernel),
// which also serves sbnet.py::sbnet_scatter_changed.  Tile i of the packed
// (n, th, tw, A) tensor is written at (cam, ty*th, tx*tw) of camera cam's
// plane; every other canvas byte keeps its value.  The canvas is updated in
// place -- the cold step writes every active tile into a fresh canvas, a
// warm step only the refreshed tiles into the previous step's canvas (the
// JAX package donated the buffer for the same effect).  Padding rows repeat
// the last real (row, tile) pair and rewrite the same bytes with the same
// values, a benign race.
//
// What bounds it on the H100: bytes (a copy).  Each tile reads th*tw*A
// floats and writes as many.
//
// Design: one CTA per packed tile.  The tile's rows are tw*A contiguous
// floats in both the packed tensor and the canvas (640 bytes at tile 16,
// A = 10), so consecutive threads copy consecutive floats: coalesced reads
// and writes, no shared memory, no atomics.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sbnet_scatter_kernel(const float* __restrict__ packed,
                     const int* __restrict__ idx, float* __restrict__ base,
                     int th, int tw, int A, int C, int H, int W) {
  const int tile = blockIdx.x;
  const int cam = idx[3 * tile], ty = idx[3 * tile + 1];
  const int tx = idx[3 * tile + 2];
  if (cam < 0 || cam >= C || ty < 0 || tx < 0 || (ty + 1) * th > H ||
      (tx + 1) * tw > W)
    __trap();                                // a row off the canvas
  const int row = tw * A;
  const float* src = packed + static_cast<size_t>(tile) * th * row;
  for (int e = threadIdx.x; e < th * row; e += kThreads) {
    const int r = e / row, l = e - r * row;
    base[((static_cast<size_t>(cam) * H + ty * th + r) * W + tx * tw) * A + l] =
        src[e];
  }
}

}  // namespace

extern "C" int sbnet_scatter_launch(const void* packed, const void* idx,
                                    void* base, int n, int th, int tw, int A,
                                    int C, int H, int W, void* stream) {
  sbnet_scatter_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const int*>(idx),
      static_cast<float*>(base), th, tw, A, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

// The name of a CUDA error code, for the wrappers' messages.
extern "C" const char* repro_cuda_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}
