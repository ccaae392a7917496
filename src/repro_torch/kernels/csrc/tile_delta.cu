// tile_delta and tile_delta_halo: the edge rate controller's per-tile delta
// pricing on one camera's frame pair.
//
// Replaces the TPU kernels repro/kernels/tile_delta.py::tile_delta (kernel
// body _tile_delta_kernel) and tile_delta_halo (_tile_delta_halo_kernel).
// For every active tile (ty, tx) of an (H, W, C) frame pair it quantizes the
// delta, q = round_half_even((cur - prev) / qstep) in float32, and writes one
// (8,) int32 row [bytes, nnz, zero runs, sum|q|, 0, 0, 0, 0] with
// bytes = ceil((nnz * coef_bits + runs * run_bits) / 8).  A zero run never
// joins across scan rows.  The two kernels differ only in which elements
// they price and how those fall into scan rows:
//   tile_delta       the (th, tw) body: th scan rows of tw*C lanes;
//   tile_delta_halo  the edge ring as 4 strips, each one scan row: the top
//                    and bottom pixel rows (tw*C lanes each), then the left
//                    and right pixel columns (th*C lanes each, y-major,
//                    channel-minor).  Corners sit in a row and a column
//                    strip and count twice.
//
// What bounds it on the H100: bytes.  A 16x16x3 tile reads two 3 KB body
// tiles (the ring: two 0.75 KB rings) and writes 32 bytes, against ~10
// integer operations per element.
//
// Design: one CTA per tile.  A layout functor maps
// the tile's scan-order element e to its frame offset and says whether e
// starts a scan row; threads stride over e, so a warp reads contiguous runs
// of a pixel row (a column strip reads C floats per pixel row).  The
// quantized deltas stay in shared memory for the run scan; all sums are
// integers, exact in any order, no atomics.
#include <cuda_runtime.h>

#include "tile_delta_common.cuh"

namespace {

using namespace tile_delta_common;

// tile_delta: the body, th scan rows of tw*C lanes.
struct Body {
  int th, tw, C, W;
  __host__ __device__ int total() const { return th * tw * C; }
  __device__ bool row_start(int e) const { return e % (tw * C) == 0; }
  __device__ size_t offset(int y0, int x0, int e) const {
    const int lanes = tw * C;
    const int r = e / lanes, l = e - r * lanes;
    return (static_cast<size_t>(y0 + r) * W + x0) * C + l;
  }
};

// tile_delta_halo: top row, bottom row, left column, right column.
struct Ring {
  int th, tw, C, W;
  __host__ __device__ int total() const { return 2 * (tw + th) * C; }
  __device__ bool row_start(int e) const {
    const int row = tw * C, col = th * C;
    return e == 0 || e == row || e == 2 * row || e == 2 * row + col;
  }
  __device__ size_t offset(int y0, int x0, int e) const {
    const int row = tw * C, col = th * C;
    if (e < 2 * row) {                         // a pixel row: contiguous
      const int s = e / row, k = e - s * row;
      const int y = (s == 0) ? y0 : y0 + th - 1;
      return (static_cast<size_t>(y) * W + x0) * C + k;
    }
    e -= 2 * row;                              // a pixel column
    const int s = e / col, k = e - s * col;
    const int x = (s == 0) ? x0 : x0 + tw - 1;
    const int y = k / C, c = k - y * C;
    return (static_cast<size_t>(y0 + y) * W + x) * C + c;
  }
};

template <class Layout>
__global__ void __launch_bounds__(kThreads)
tile_delta_stats_kernel(const float* __restrict__ cur,
                        const float* __restrict__ prev,
                        const int* __restrict__ idx, int* __restrict__ out,
                        Layout L, int H, float qstep, int coef_bits,
                        int run_bits) {
  extern __shared__ int q_s[];                 // L.total() deltas
  __shared__ long long part[kWarps][3];
  const int tile = blockIdx.x;
  const int ty = idx[2 * tile], tx = idx[2 * tile + 1];
  const int y0 = ty * L.th, x0 = tx * L.tw;
  if (ty < 0 || tx < 0 || y0 + L.th > H || x0 + L.tw > L.W)
    __trap();                                  // a tile off the frame
  const int total = L.total();
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const size_t off = L.offset(y0, x0, e);
    q_s[e] = quantize(cur[off], prev[off], qstep);
  }
  __syncthreads();

  long long v[3] = {0, 0, 0};                  // nnz, runs, sum|q|
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int q = q_s[e];
    const bool z = (q == 0);
    v[0] += !z;
    v[1] += z && (L.row_start(e) || q_s[e - 1] != 0);
    v[2] += (q < 0) ? -static_cast<long long>(q) : q;
  }
  long long s[3];
  block_sum<3>(v, part, s);
  if (threadIdx.x == 0) {
    int* o = out + 8 * static_cast<size_t>(tile);
    o[0] = est_bytes(s[0], s[1], coef_bits, run_bits);
    o[1] = static_cast<int>(s[0]);
    o[2] = static_cast<int>(s[1]);
    o[3] = static_cast<int>(s[2]);
    for (int k = 4; k < 8; ++k) o[k] = 0;
  }
}

template <class Layout>
int launch(const void* cur, const void* prev, const void* idx, void* out,
           int n, Layout L, int H, float qstep, int coef_bits, int run_bits,
           void* stream) {
  const size_t smem = sizeof(int) * static_cast<size_t>(L.total());
  tile_delta_stats_kernel<Layout><<<n, kThreads, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), static_cast<const float*>(prev),
      static_cast<const int*>(idx), static_cast<int*>(out), L, H, qstep,
      coef_bits, run_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tile_delta_launch(const void* cur, const void* prev,
                                 const void* idx, void* out, int n, int H,
                                 int W, int C, int th, int tw, float qstep,
                                 int coef_bits, int run_bits, void* stream) {
  return launch(cur, prev, idx, out, n, Body{th, tw, C, W}, H, qstep,
                coef_bits, run_bits, stream);
}

extern "C" int tile_delta_halo_launch(const void* cur, const void* prev,
                                      const void* idx, void* out, int n,
                                      int H, int W, int C, int th, int tw,
                                      float qstep, int coef_bits,
                                      int run_bits, void* stream) {
  return launch(cur, prev, idx, out, n, Ring{th, tw, C, W}, H, qstep,
                coef_bits, run_bits, stream);
}
