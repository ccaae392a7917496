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
// Design: keep many loads in flight and spend few instructions per element.
// * Persistent CTAs, as many as fit on the card at once (at most one per 4
//   tiles), each warp walking the tiles with a stride; a compact set of a
//   few hundred tiles still spreads over the card.
// * One warp per tile.  A window row is walked in chunks of 64 elements,
//   lane k holding elements 2k and 2k+1 of the chunk, so a warp's loads are
//   one contiguous run of the row; row and column come from the loop
//   counters.  An unchanged element (cur == prev) takes q = 0 without the
//   division, which gives 0 for it as well ((x - x) / qstep is +-0 or NaN,
//   and NaN converts to 0); a chunk with no change skips the quantizer.
// * The zero-run scan and the counts are warp-wide bit masks: one ballot of
//   q == 0 (and one of cur != prev) for the even and one for the odd
//   elements; a run starts at a zero whose left neighbour (the previous
//   lane's odd element, or the lane's own even one) is no zero, and the
//   last element of a chunk carries into the next chunk of the same row.
//   The body's runs use the masks restricted to the body's lanes
//   [Cin, Cin*(tw+1)), so a body row starts at lane Cin.  The counts are
//   popcounts of those masks; sum|q| is a per-lane 32-bit unsigned sum
//   added with __reduce_add_sync at the end of the tile.  Every column is
//   its int32 value mod 2^32, as JAX's int32 sums, with no signed overflow
//   and no atomics.
// * The detector's instance (Cin = 3, 16x16 tiles) is compiled in: a row is
//   one chunk of 54 elements, 27 lanes, each lane's pair one 8-byte load,
//   and a warp issues the loads of its whole window (36 a lane) before the
//   scan (fully unrolled over the 18 rows) waits for the first of them.
//   (On the H100 a warp that loaded row by row, as the scan reads them,
//   kept one row in flight and took ~15% longer; 4-byte loads of the
//   up-front window took as long as these.)  A window
//   row starts at an even float of its frame row (tx*48 floats in)
//   whenever a padded frame row is an even number of floats, and a packed
//   row at an even float (972 floats a tile), so the pairs are 8-byte
//   aligned when the tensors start on an 8-byte boundary.  Other extents,
//   odd rows and tensors off an 8-byte boundary take the generic instance:
//   the same scan with runtime extents and 4-byte loads, row by row.
//   fits_detector is the rule; tile_delta_gate_route reports it.
// Every stats row depends on its own tile's windows alone, so a compact
// launch and a full launch give the same bits for the tiles they share, and
// the two instances and the two modes agree.  Built without fast math.
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_delta_common.cuh"

namespace {

using namespace tile_delta_common;

constexpr int kDetCin = 3, kDetTile = 16;   // the detector's instance

struct GateParams {
  int n, C, Hp, Wp, cin, th, tw;
  float qstep;
  int coef_bits, run_bits;
};

// The lanes k < m of a warp (m clamped to [0, 32]).
__device__ __forceinline__ unsigned lanes_below(int m) {
  return m <= 0 ? 0u : m >= 32 ? ~0u : (1u << m) - 1u;
}

// The lanes k whose element o + 2k lies in [a, b): 2k >= a - o and
// 2k < b - o, with ceil(x / 2) = (x + 1) >> 1 for any sign of x.
__device__ __forceinline__ unsigned pair_lanes(int a, int b, int o) {
  return lanes_below((b - o + 1) >> 1) & ~lanes_below((a - o + 1) >> 1);
}

// |q| as an unsigned int, without signed overflow at INT_MIN.
__device__ __forceinline__ unsigned magnitude(int q) {
  const unsigned u = static_cast<unsigned>(q);
  return q < 0 ? 0u - u : u;
}

__device__ __forceinline__ int delta_q(float c, float p, float qstep) {
  return c == p ? 0 : quantize(c, p, qstep);
}

template <bool kPacked, bool kDet>
__global__ void __launch_bounds__(kThreads)
tile_delta_gate_kernel(const float* __restrict__ cur,
                       const float* __restrict__ ref,
                       const int* __restrict__ idx, int* __restrict__ out,
                       float* __restrict__ win, GateParams p) {
  const int th = kDet ? kDetTile : p.th, tw = kDet ? kDetTile : p.tw;
  const int cin = kDet ? kDetCin : p.cin;
  const int rows = th + 2, lanes = (tw + 2) * cin;
  const int b_lo = cin, b_hi = cin * (tw + 1);   // body lanes [b_lo, b_hi)
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kWarps;
  for (int tile = blockIdx.x * kWarps + threadIdx.x / 32; tile < p.n;
       tile += stride) {
    const int cam = idx[3 * tile], ty = idx[3 * tile + 1];
    const int tx = idx[3 * tile + 2];
    const int y0 = ty * th, x0 = tx * tw;
    if (cam < 0 || cam >= p.C || ty < 0 || tx < 0 || y0 + rows > p.Hp ||
        x0 + tw + 2 > p.Wp)
      __trap();                                // a row off the canvas
    const size_t frame0 =
        ((static_cast<size_t>(cam) * p.Hp + y0) * p.Wp + x0) * cin;
    const size_t row0 = static_cast<size_t>(tile) * rows * lanes;
    // the detector's window, each lane's pair of every row, loaded before
    // the scan so that the whole window's loads are in flight at once
    constexpr int kWin = kDet ? kDetTile + 2 : 1;
    float2 c_win[kWin], p_win[kWin];
    if (kDet) {
      const int ec = min(2 * lane, lanes - 2);   // lanes past the row: its end
#pragma unroll
      for (int r = 0; r < kWin; ++r) {
        const size_t f = frame0 + static_cast<size_t>(r) * p.Wp * cin + ec;
        c_win[r] = *reinterpret_cast<const float2*>(cur + f);
        p_win[r] = *reinterpret_cast<const float2*>(
            kPacked ? ref + row0 + r * lanes + ec : ref + f);
      }
    }
    unsigned w_nnz = 0, w_runs = 0, b_nnz = 0, b_runs = 0, exact = 0;
    unsigned sabs = 0;                         // per lane; the rest warp-wide
#pragma unroll (kWin)
    for (int r = 0; r < rows; ++r) {
      const float* c_row =
          cur + frame0 + static_cast<size_t>(r) * p.Wp * cin;
      const float* p_row = kPacked ? ref + row0 + r * lanes
                                   : ref + (c_row - cur);   // generic only
      float* w_row = kPacked ? win + row0 + r * lanes : nullptr;
      const bool body = r >= 1 && r <= th;
      unsigned carry_w = 0, carry_b = 0;   // the previous chunk's last zero
#pragma unroll
      for (int o = 0; o < lanes; o += 64) {
        const unsigned act0 = pair_lanes(0, lanes, o);
        const unsigned act1 = pair_lanes(-1, lanes - 1, o);
        const unsigned bod0 = body ? pair_lanes(b_lo, b_hi, o) : 0u;
        const unsigned bod1 = body ? pair_lanes(b_lo - 1, b_hi - 1, o) : 0u;
        const bool on0 = act0 >> lane & 1u, on1 = act1 >> lane & 1u;
        const int e = o + 2 * lane;
        float c0, c1, p0, p1;
        if (kDet) {                            // an even row: act1 == act0
          const float2 c = c_win[kDet ? r : 0], q = p_win[kDet ? r : 0];
          if (kPacked && on0) *reinterpret_cast<float2*>(w_row + e) = c;
          c0 = c.x;
          c1 = c.y;
          p0 = q.x;
          p1 = q.y;
        } else {
          // lanes past the row load its last element and drop it, so no
          // load waits behind a branch
          const int e0 = min(e, lanes - 1), e1 = min(e + 1, lanes - 1);
          c0 = c_row[e0];
          c1 = c_row[e1];
          p0 = p_row[e0];
          p1 = p_row[e1];
          if (kPacked && on0) w_row[e0] = c0;
          if (kPacked && on1) w_row[e1] = c1;
        }
        if (!on0) c0 = p0 = 0.f;
        if (!on1) c1 = p1 = 0.f;
        // float compares: a NaN counts, -0.0 == 0.0
        const unsigned n0 = __ballot_sync(~0u, c0 != p0);
        const unsigned n1 = __ballot_sync(~0u, c1 != p1);
        exact += __popc(n0) + __popc(n1);
        unsigned z0 = act0, z1 = act1;         // unchanged: every q is 0
        if (n0 | n1) {                         // the warp's choice
          const int q0 = delta_q(c0, p0, p.qstep);
          const int q1 = delta_q(c1, p1, p.qstep);
          z0 = __ballot_sync(~0u, q0 == 0) & act0;
          z1 = __ballot_sync(~0u, q1 == 0) & act1;
          sabs += (bod0 >> lane & 1u ? magnitude(q0) : 0u) +
                  (bod1 >> lane & 1u ? magnitude(q1) : 0u);
        }
        w_nnz += __popc(act0 & ~z0) + __popc(act1 & ~z1);
        w_runs += __popc(z0 & ~(z1 << 1 | carry_w)) + __popc(z1 & ~z0);
        carry_w = z1 >> 31;
        const unsigned y0m = z0 & bod0, y1m = z1 & bod1;
        b_nnz += __popc(bod0 & ~z0) + __popc(bod1 & ~z1);
        b_runs += __popc(y0m & ~(y1m << 1 | carry_b)) + __popc(y1m & ~y0m);
        carry_b = y1m >> 31;
      }
    }
    sabs = __reduce_add_sync(~0u, sabs);
    if (lane == 0) {
      int4* o =
          reinterpret_cast<int4*>(out + 8 * static_cast<size_t>(tile));
      o[0] = make_int4(est_bytes(b_nnz, b_runs, p.coef_bits, p.run_bits),
                       static_cast<int>(b_nnz), static_cast<int>(b_runs),
                       static_cast<int>(sabs));
      o[1] = make_int4(static_cast<int>(exact),
                       est_bytes(w_nnz, w_runs, p.coef_bits, p.run_bits), 0,
                       0);
    }
  }
}

bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

bool fits_detector(int Cin, int th, int tw, int Wp, const void* cur,
                   const void* ref, const void* win) {
  return Cin == kDetCin && th == kDetTile && tw == kDetTile &&
         (Wp * Cin) % 2 == 0 && aligned8(cur) && aligned8(ref) &&
         aligned8(win);
}

template <bool kPacked, bool kDet>
int launch_instance(const void* cur, const void* ref, const void* idx,
                    void* out, void* win, const GateParams& p,
                    void* stream) {
  auto kernel = tile_delta_gate_kernel<kPacked, kDet>;
  // the persistent grid: as many CTAs as fit on the card at once, at most
  // one per kWarps tiles
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int need = (p.n + kWarps - 1) / kWarps, fit = sms * per_sm;
  kernel<<<need < fit ? need : fit, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cur), static_cast<const float*>(ref),
      static_cast<const int*>(idx), static_cast<int*>(out),
      static_cast<float*>(win), p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPacked>
int launch(const void* cur, const void* ref, const void* idx, void* out,
           void* win, int n, int C, int Hp, int Wp, int Cin, int th, int tw,
           float qstep, int coef_bits, int run_bits, void* stream) {
  if (n <= 0) return 0;
  const GateParams p{n, C, Hp, Wp, Cin, th, tw, qstep, coef_bits, run_bits};
  return fits_detector(Cin, th, tw, Wp, cur, ref, win)
             ? launch_instance<kPacked, true>(cur, ref, idx, out, win, p,
                                              stream)
             : launch_instance<kPacked, false>(cur, ref, idx, out, win, p,
                                               stream);
}

}  // namespace

// 1 where the launchers take the detector's compiled-in instance for these
// extents and tensors (win null in canvas mode), else 0 (the generic one).
extern "C" int tile_delta_gate_route(int Cin, int th, int tw, int Wp,
                                     const void* cur, const void* ref,
                                     const void* win) {
  return fits_detector(Cin, th, tw, Wp, cur, ref, win) ? 1 : 0;
}

extern "C" int tile_delta_gate_canvas_launch(
    const void* cur, const void* ref, const void* idx, void* out, int n,
    int C, int Hp, int Wp, int Cin, int th, int tw, float qstep,
    int coef_bits, int run_bits, void* stream) {
  return launch<false>(cur, ref, idx, out, nullptr, n, C, Hp, Wp, Cin, th,
                       tw, qstep, coef_bits, run_bits, stream);
}

extern "C" int tile_delta_gate_launch(
    const void* cur, const void* ref_win, const void* idx, void* out,
    void* win, int n, int C, int Hp, int Wp, int Cin, int th, int tw,
    float qstep, int coef_bits, int run_bits, void* stream) {
  return launch<true>(cur, ref_win, idx, out, win, n, C, Hp, Wp, Cin, th, tw,
                      qstep, coef_bits, run_bits, stream);
}
