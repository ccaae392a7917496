// tile_delta_gate_canvas and tile_delta_gate: the reuse gate of the
// delta-gated fleet step, with the reference on a canvas or packed.
//
// Replaces the TPU kernels repro/kernels/tile_delta.py::
// tile_delta_gate_canvas (kernel body _tile_delta_gate_canvas_kernel) and
// tile_delta_gate (kernel body _tile_delta_gate_kernel).  For every active
// tile (cam, ty, tx) it prices the haloed (th+2, tw+2, Cin) window of the
// current padded frames against the tile's reference window and writes one
// (8,) int32 row:
//   [body bytes, body nnz, body zero runs, body sum|q|,
//    window exact-change count, window bytes, 0, 0]
// with q = round_half_even((cur - prev) / qstep) in float32 and
// bytes = ceil((nnz * coef_bits + runs * run_bits) / 8).  Scan rows are the
// pixel rows of the HWC window (tw*Cin body lanes, (tw+2)*Cin window lanes);
// a zero run never joins across rows.
//
// The reference window comes from one of two places, a template parameter:
// the same window of a (C, H+2, W+2, Cin) reference canvas (canvas mode), or
// row `tile` of a packed (n, th+2, tw+2, Cin) tensor of per-tile windows
// (packed mode).  Packed mode also writes the current window to row `tile`
// of a packed output, the rows a reference advance copies.
//
// What bounds it on the H100: bytes.  A 16x16 tile with Cin = 3 reads two
// 18x18x3 float windows (7.8 KB) and writes 32 bytes (packed mode: and a
// 3.9 KB window), against ~10 integer operations per element, far below the
// card's operations-per-byte line.
//
// Design: one CTA per tile.  Threads stride over the window element by
// element, so each warp reads contiguous runs of a window row (54 floats per
// row at tile 16) -- coalesced loads, every input byte read once; a packed
// reference and the windows output are one contiguous row each.  The
// quantized deltas stay in shared memory for the run scan, which looks only
// at the element to the left.  All sums are integers (tile_delta_common.cuh),
// exact in any order, no atomics.
#include <cuda_runtime.h>

#include "tile_delta_common.cuh"

namespace {

using namespace tile_delta_common;
constexpr int kCounters = 6;

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
tile_delta_gate_kernel(const float* __restrict__ cur,
                       const float* __restrict__ ref,
                       const int* __restrict__ idx, int* __restrict__ out,
                       float* __restrict__ win, int C, int Hp, int Wp,
                       int Cin, int th, int tw, float qstep, int coef_bits,
                       int run_bits) {
  extern __shared__ int q_s[];                 // (th+2) * (tw+2) * Cin
  __shared__ long long part[kWarps][kCounters];
  const int tile = blockIdx.x;
  const int cam = idx[3 * tile], ty = idx[3 * tile + 1];
  const int tx = idx[3 * tile + 2];
  const int y0 = ty * th, x0 = tx * tw;
  if (cam < 0 || cam >= C || ty < 0 || tx < 0 || y0 + th + 2 > Hp ||
      x0 + tw + 2 > Wp)
    __trap();                                  // a row off the canvas
  const int lanes = (tw + 2) * Cin;
  const int total = (th + 2) * lanes;
  const size_t row0 = static_cast<size_t>(tile) * total;  // packed row

  long long exact = 0;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / lanes, l = e - r * lanes;
    const size_t off =
        ((static_cast<size_t>(cam) * Hp + y0 + r) * Wp + x0) * Cin + l;
    const float c = cur[off];
    float p;
    if constexpr (kPacked) {
      p = ref[row0 + e];
      win[row0 + e] = c;
    } else {
      p = ref[off];
    }
    q_s[e] = quantize(c, p, qstep);
    exact += (c != p);                         // float compare: NaN counts
  }
  __syncthreads();

  long long b_nnz = 0, b_runs = 0, b_sabs = 0, w_nnz = 0, w_runs = 0;
  const int b_lo = Cin, b_hi = Cin * (tw + 1);   // body lanes [b_lo, b_hi)
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / lanes, l = e - r * lanes;
    const int q = q_s[e];
    const bool z = (q == 0);
    const bool left_z = (l > 0) && (q_s[e - 1] == 0);
    w_nnz += !z;
    w_runs += z && !(l > 0 && left_z);
    if (r >= 1 && r <= th && l >= b_lo && l < b_hi) {
      b_nnz += !z;
      b_runs += z && !(l > b_lo && left_z);
      b_sabs += (q < 0) ? -static_cast<long long>(q) : q;
    }
  }

  long long v[kCounters] = {b_nnz, b_runs, b_sabs, exact, w_nnz, w_runs};
  long long s[kCounters];
  block_sum<kCounters>(v, part, s);
  if (threadIdx.x == 0) {
    int* o = out + 8 * static_cast<size_t>(tile);
    o[0] = est_bytes(s[0], s[1], coef_bits, run_bits);
    o[1] = static_cast<int>(s[0]);
    o[2] = static_cast<int>(s[1]);
    o[3] = static_cast<int>(s[2]);
    o[4] = static_cast<int>(s[3]);
    o[5] = est_bytes(s[4], s[5], coef_bits, run_bits);
    o[6] = 0;
    o[7] = 0;
  }
}

}  // namespace

extern "C" int tile_delta_gate_canvas_launch(
    const void* cur, const void* ref, const void* idx, void* out, int n,
    int C, int Hp, int Wp, int Cin, int th, int tw, float qstep,
    int coef_bits, int run_bits, void* stream) {
  const size_t smem = sizeof(int) * (th + 2) * (tw + 2) * Cin;
  tile_delta_gate_kernel<false><<<n, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), static_cast<const float*>(ref),
      static_cast<const int*>(idx), static_cast<int*>(out), nullptr, C, Hp,
      Wp, Cin, th, tw, qstep, coef_bits, run_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tile_delta_gate_launch(
    const void* cur, const void* ref_win, const void* idx, void* out,
    void* win, int n, int C, int Hp, int Wp, int Cin, int th, int tw,
    float qstep, int coef_bits, int run_bits, void* stream) {
  const size_t smem = sizeof(int) * (th + 2) * (tw + 2) * Cin;
  tile_delta_gate_kernel<true><<<n, kThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), static_cast<const float*>(ref_win),
      static_cast<const int*>(idx), static_cast<int*>(out),
      static_cast<float*>(win), C, Hp, Wp, Cin, th, tw, qstep, coef_bits,
      run_bits);
  return static_cast<int>(cudaGetLastError());
}
