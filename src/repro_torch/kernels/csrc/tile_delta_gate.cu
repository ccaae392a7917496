// tile_delta_gate_canvas: the delta-gated fleet step's reuse gate.
//
// Replaces the TPU kernel repro/kernels/tile_delta.py::tile_delta_gate_canvas
// (kernel body _tile_delta_gate_canvas_kernel).  For every active tile
// (cam, ty, tx) it prices the haloed (th+2, tw+2, Cin) window of the current
// padded frames against the same window of the reference canvas and writes
// one (8,) int32 row:
//   [body bytes, body nnz, body zero runs, body sum|q|,
//    window exact-change count, window bytes, 0, 0]
// with q = round_half_even((cur - prev) / qstep) in float32 and
// bytes = ceil((nnz * coef_bits + runs * run_bits) / 8).  Scan rows are the
// pixel rows of the HWC window (tw*Cin body lanes, (tw+2)*Cin window lanes);
// a zero run never joins across rows.
//
// What bounds it on the H100: bytes.  A 16x16 tile with Cin = 3 reads two
// 18x18x3 float windows (7.8 KB) and writes 32 bytes, against ~10 integer
// operations per element, far below the card's operations-per-byte line.
//
// Design: one CTA per tile.  Threads stride over the window element by
// element, so each warp reads contiguous runs of a window row (54 floats per
// row at tile 16) -- coalesced loads, every input byte read once.  The
// quantized deltas stay in shared memory for the run scan, which looks only
// at the element to the left.  All sums are integers, reduced per warp with
// shuffles and then across warps by one thread: exact in any order, no
// atomics.  The rounding is written out (__fsub_rn, __fdiv_rn, rintf) and
// the library is built without --use_fast_math, so the stats are bit-exact
// against numpy and jnp.round.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCounters = 6;

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
tile_delta_gate_canvas_kernel(const float* __restrict__ cur,
                              const float* __restrict__ ref,
                              const int* __restrict__ idx,
                              int* __restrict__ out, int C, int Hp, int Wp,
                              int Cin, int th, int tw, float qstep,
                              int coef_bits, int run_bits) {
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

  long long exact = 0;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int r = e / lanes, l = e - r * lanes;
    const size_t off =
        ((static_cast<size_t>(cam) * Hp + y0 + r) * Wp + x0) * Cin + l;
    const float c = cur[off], p = ref[off];
    q_s[e] = static_cast<int>(rintf(__fdiv_rn(__fsub_rn(c, p), qstep)));
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = 0; k < kCounters; ++k) {
    v[k] = warp_sum(v[k]);
    if (lane == 0) part[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s[kCounters] = {0, 0, 0, 0, 0, 0};
    for (int w = 0; w < kWarps; ++w)
      for (int k = 0; k < kCounters; ++k) s[k] += part[w][k];
    int* o = out + 8 * static_cast<size_t>(tile);
    o[0] = static_cast<int>((s[0] * coef_bits + s[1] * run_bits + 7) / 8);
    o[1] = static_cast<int>(s[0]);
    o[2] = static_cast<int>(s[1]);
    o[3] = static_cast<int>(s[2]);
    o[4] = static_cast<int>(s[3]);
    o[5] = static_cast<int>((s[4] * coef_bits + s[5] * run_bits + 7) / 8);
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
  tile_delta_gate_canvas_kernel<<<n, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), static_cast<const float*>(ref),
      static_cast<const int*>(idx), static_cast<int*>(out), C, Hp, Wp, Cin,
      th, tw, qstep, coef_bits, run_bits);
  return static_cast<int>(cudaGetLastError());
}
