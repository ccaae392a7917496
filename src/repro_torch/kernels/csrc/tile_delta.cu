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
// tiles (the ring: two 0.75 KB rings, whose columns touch a 32-byte sector
// for every 12 bytes they use) and writes 32 bytes, against ~10 integer
// operations per element.  One launch prices one camera (~2,600 tiles of
// the fleet's 16x16 at C = 3), a few microseconds of bytes, so the launch
// itself and the first loads' latency weigh as much as the bytes.
//
// Design, the reuse gate's (tile_delta_gate.cu): keep a tile's loads in
// flight together and spend few instructions per element.
// * Persistent CTAs, as many as fit on the card at once (at most one per 4
//   tiles), each warp walking the tiles with a stride.
// * One warp per tile, no shared memory: a tile of any extent fits.  A
//   chunk of a scan row gives each lane K adjacent elements of the row.
//   A pixel row is walked in chunks of 64 elements, lane k holding
//   elements 2k and 2k+1 (K = 2); a ring column in chunks of 32 pixels,
//   lane k holding the C channels of pixel k (K = C).  Pixel, row and
//   channel come from the loop counters.
// * The run scan and the counts are warp-wide bit masks, one ballot of
//   q == 0 for each of a lane's K slots: a run starts at a zero whose left
//   neighbour is no zero -- the lane's previous slot, or for slot 0 the
//   previous lane's last slot, or for lane 0 the last element of the
//   previous chunk of the same row (the carry); a row starts with no
//   carry.  nnz and runs are popcounts, the same in every lane; sum|q| is
//   a per-lane 32-bit unsigned sum added with __reduce_add_sync at the end
//   of the tile.  Every column is its int32 value mod 2^32, as JAX's int32
//   sums, with no signed overflow and no atomics.
// * An unchanged element (cur == prev) takes q = 0 without the division,
//   which gives 0 for it as well ((x - x) / qstep is +-0 or NaN, and NaN
//   converts to 0).  A pixel-row chunk in which no element changed skips
//   the quantizer (one vote of the warp), and so do the ring columns of
//   the detector's instance, where a tile in which no element changed
//   skips the scan as well: each of its scan rows is one zero run.
// * The detector's instance (C = 3, 16x16 tiles) is compiled in, and a
//   warp issues every load of its tile before the scan waits for the first
//   of them: B10's 16 rows of both frames, each lane's pair one 8-byte
//   load; B11's 2 rows the same way, and its 2 columns as one chunk, the 3
//   channels of one pixel a lane, the left column in lanes 0-15 and the
//   right one in lanes 16-31.  A row starts at an even float of its frame
//   row (tx*48 floats in) whenever a frame row is an even number of
//   floats, so the pairs are 8-byte aligned when the frames start on an
//   8-byte boundary.
//   Other extents, odd rows and frames off an 8-byte boundary take the
//   generic instance: runtime extents, 4-byte loads, chunk by chunk.
//   fits_detector is the rule; tile_delta_route reports it.
// Every stats row depends on its own tile's pixels alone, so a compact
// launch and a full launch give the same bits for the tiles they share,
// and the two instances agree.  Built without fast math.
#include <cstdint>
#include <cuda_runtime.h>

#include "tile_delta_common.cuh"

namespace {

using namespace tile_delta_common;

constexpr int kDetC = 3, kDetTile = 16;   // the detector's instance

struct DeltaParams {
  int n, H, W, C, th, tw;
  float qstep;
  int coef_bits, run_bits;
};

// A tile's counts: nnz and runs warp-wide (every lane holds them), sum|q|
// per lane.
struct Counts {
  unsigned nnz, runs, sabs;
};

// The lanes k < m of a warp (m clamped to [0, 32]).
__device__ __forceinline__ unsigned lanes_below(int m) {
  return m <= 0 ? 0u : m >= 32 ? ~0u : (1u << m) - 1u;
}

// The lanes k whose element o + 2k lies in [0, b): 2k < b - o, with
// ceil(x / 2) = (x + 1) >> 1 for any sign of x.
__device__ __forceinline__ unsigned pair_lanes(int b, int o) {
  return lanes_below((b - o + 1) >> 1);
}

// |q| as an unsigned int, without signed overflow at INT_MIN.
__device__ __forceinline__ unsigned magnitude(int q) {
  const unsigned u = static_cast<unsigned>(q);
  return q < 0 ? 0u - u : u;
}

// One chunk of a scan row in which lane k holds K adjacent elements of the
// row: its slots j = 0..K-1 are fed in order, each with the lanes whose
// slot j lies in the row (act), then end() adds the runs that start at
// slot 0.  `carry` is 1 where the element before the chunk is a zero of the
// same row, and becomes the chunk's last element's; the lanes of `cut`
// start a row of their own (two strips in one chunk).  The warp votes once
// whether any of its lanes changed; where none did, every q is 0 and the
// quantizer is skipped.
struct ChunkScan {
  bool changed;
  unsigned first = 0, last = 0;   // slot 0's and the last slot's zero masks

  __device__ __forceinline__ explicit ChunkScan(bool lane_changed)
      : changed(__any_sync(~0u, lane_changed)) {}

  __device__ __forceinline__ void slot(int j, float c, float p,
                                       unsigned act, float qstep,
                                       Counts& s) {
    unsigned z = act;                          // unchanged: every q is 0
    if (changed) {
      const int q = c == p ? 0 : quantize(c, p, qstep);
      z = __ballot_sync(~0u, q == 0) & act;
      s.sabs += (act >> (threadIdx.x % 32) & 1u) ? magnitude(q) : 0u;
    }
    s.nnz += __popc(act & ~z);
    if (j == 0)
      first = z;
    else
      s.runs += __popc(z & ~last);             // left neighbour: slot j - 1
    last = z;
  }

  __device__ __forceinline__ void end(unsigned& carry, Counts& s,
                                      unsigned cut = 0) {
    // slot 0's left neighbour: the previous lane's last slot, or the carry
    s.runs += __popc(first & ~((last << 1 | carry) & ~cut));
    carry = last >> 31;
  }
};

// A pixel row of `lanes` floats at c_row / p_row (the generic instance):
// chunks of 64 elements, lane k holding elements 2k and 2k+1, 4-byte
// loads.  Lanes past the row load its last element and drop it, so no load
// waits behind a branch.
__device__ __forceinline__ void scan_row(const float* c_row,
                                         const float* p_row, int lanes,
                                         float qstep, Counts& s) {
  const int lane = threadIdx.x % 32;
  unsigned carry = 0;
  for (int o = 0; o < lanes; o += 64) {
    const int e0 = min(o + 2 * lane, lanes - 1);
    const int e1 = min(o + 2 * lane + 1, lanes - 1);
    const float c0 = c_row[e0], c1 = c_row[e1];
    const float p0 = p_row[e0], p1 = p_row[e1];
    ChunkScan k(c0 != p0 || c1 != p1);
    k.slot(0, c0, p0, pair_lanes(lanes, o), qstep, s);
    k.slot(1, c1, p1, pair_lanes(lanes - 1, o), qstep, s);
    k.end(carry, s);
  }
}

// A column strip of `len` pixels of C channels, pixel i at c_s + i *
// stride (the generic instance): chunks of 32 pixels, lane k holding the C
// channels of pixel k, 4-byte loads.  Lanes past the strip load its last
// pixel and drop it.
__device__ __forceinline__ void scan_column(const float* c_s,
                                            const float* p_s, int len,
                                            int C, size_t stride,
                                            float qstep, Counts& s) {
  const int lane = threadIdx.x % 32;
  unsigned carry = 0;
  for (int o = 0; o < len; o += 32) {
    const size_t f = static_cast<size_t>(min(o + lane, len - 1)) * stride;
    const unsigned act = lanes_below(len - o);
    ChunkScan k(true);
    for (int j = 0; j < C; ++j)
      k.slot(j, c_s[f + j], p_s[f + j], act, qstep, s);
    k.end(carry, s);
  }
}

// A detector pixel row from its preloaded pairs: one chunk of 48 elements,
// lane k holding elements 2k and 2k+1 (24 lanes; the lanes past the row
// hold the last pair again, so their vote changes nothing).
__device__ __forceinline__ void scan_pair(float2 c, float2 p, float qstep,
                                          Counts& s) {
  constexpr unsigned act = (1u << (kDetTile * kDetC / 2)) - 1u;
  unsigned carry = 0;
  ChunkScan k(c.x != p.x || c.y != p.y);
  k.slot(0, c.x, p.x, act, qstep, s);
  k.slot(1, c.y, p.y, act, qstep, s);
  k.end(carry, s);
}

// The detector's two ring columns from their preloaded pixels: one chunk,
// lane k holding the 3 channels of pixel k % 16 of the left column (k <
// 16) or of the right one (k >= 16), where a strip starts again.
__device__ __forceinline__ void scan_columns(const float (&c)[kDetC],
                                             const float (&p)[kDetC],
                                             float qstep, Counts& s) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < kDetC; ++j) any |= c[j] != p[j];
  unsigned carry = 0;
  ChunkScan k(any);
#pragma unroll
  for (int j = 0; j < kDetC; ++j) k.slot(j, c[j], p[j], ~0u, qstep, s);
  k.end(carry, s, 1u << kDetTile);
}

// B10's body: th scan rows.
template <bool kDet>
__device__ __forceinline__ void body_stats(const float* c0, const float* p0,
                                           int th, int tw, int C,
                                           size_t row_stride, float qstep,
                                           Counts& s) {
  if (kDet) {
    // each lane's pair of every row, loaded before the scan so that the
    // whole tile's loads are in flight at once
    const int lane = threadIdx.x % 32;
    const int ec = min(2 * lane, kDetTile * kDetC - 2);  // past it: its end
    float2 cw[kDetTile], pw[kDetTile];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kDetTile; ++r) {
      const size_t f = r * row_stride + ec;
      cw[r] = *reinterpret_cast<const float2*>(c0 + f);
      pw[r] = *reinterpret_cast<const float2*>(p0 + f);
      any |= cw[r].x != pw[r].x || cw[r].y != pw[r].y;
    }
    if (!__any_sync(~0u, any)) {               // no change: a run a row
      s.runs += kDetTile;
      return;
    }
#pragma unroll
    for (int r = 0; r < kDetTile; ++r) scan_pair(cw[r], pw[r], qstep, s);
  } else {
    for (int r = 0; r < th; ++r)
      scan_row(c0 + r * row_stride, p0 + r * row_stride, tw * C, qstep, s);
  }
}

// B11's ring: the top and bottom rows, then the left and right columns.
template <bool kDet>
__device__ __forceinline__ void ring_stats(const float* c0, const float* p0,
                                           int th, int tw, int C,
                                           size_t row_stride, float qstep,
                                           Counts& s) {
  const size_t bottom = (th - 1) * row_stride;
  const size_t right = static_cast<size_t>(tw - 1) * C;
  if (kDet) {
    const int lane = threadIdx.x % 32;
    const int ec = min(2 * lane, kDetTile * kDetC - 2);
    // lanes 0-15 the left column's pixels, lanes 16-31 the right one's
    const size_t fy = (lane % kDetTile) * row_stride +
                      (lane < kDetTile ? 0 : right);
    float2 cr[2], pr[2];                       // top, bottom: a pair a lane
    float cc[kDetC], pc[kDetC];                // the columns: a pixel a lane
    bool any = false;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const size_t f = (k ? bottom : 0) + ec;
      cr[k] = *reinterpret_cast<const float2*>(c0 + f);
      pr[k] = *reinterpret_cast<const float2*>(p0 + f);
      any |= cr[k].x != pr[k].x || cr[k].y != pr[k].y;
    }
#pragma unroll
    for (int j = 0; j < kDetC; ++j) {
      cc[j] = c0[fy + j];
      pc[j] = p0[fy + j];
      any |= cc[j] != pc[j];
    }
    if (!__any_sync(~0u, any)) {               // no change: a run a strip
      s.runs += 4;
      return;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) scan_pair(cr[k], pr[k], qstep, s);
    scan_columns(cc, pc, qstep, s);
  } else {
    for (int k = 0; k < 2; ++k) {              // top, bottom
      const size_t f = k ? bottom : 0;
      scan_row(c0 + f, p0 + f, tw * C, qstep, s);
    }
    for (int k = 0; k < 2; ++k) {              // left, right
      const size_t f = k ? right : 0;
      scan_column(c0 + f, p0 + f, th, C, row_stride, qstep, s);
    }
  }
}

template <bool kHalo, bool kDet>
__global__ void __launch_bounds__(kThreads)
tile_delta_stats_kernel(const float* __restrict__ cur,
                        const float* __restrict__ prev,
                        const int* __restrict__ idx, int* __restrict__ out,
                        DeltaParams p) {
  const int th = kDet ? kDetTile : p.th, tw = kDet ? kDetTile : p.tw;
  const int C = kDet ? kDetC : p.C;
  const size_t row_stride = static_cast<size_t>(p.W) * C;
  const int lane = threadIdx.x % 32;
  const int stride = gridDim.x * kWarps;
  for (int tile = blockIdx.x * kWarps + threadIdx.x / 32; tile < p.n;
       tile += stride) {
    const int ty = idx[2 * tile], tx = idx[2 * tile + 1];
    const int y0 = ty * th, x0 = tx * tw;
    if (ty < 0 || tx < 0 || y0 + th > p.H || x0 + tw > p.W)
      __trap();                                // a tile off the frame
    const size_t f0 = y0 * row_stride + static_cast<size_t>(x0) * C;
    Counts s{0u, 0u, 0u};
    if (kHalo)
      ring_stats<kDet>(cur + f0, prev + f0, th, tw, C, row_stride, p.qstep,
                       s);
    else
      body_stats<kDet>(cur + f0, prev + f0, th, tw, C, row_stride,
                       p.qstep, s);
    const unsigned sabs = __reduce_add_sync(~0u, s.sabs);
    if (lane == 0) {
      int4* o =
          reinterpret_cast<int4*>(out + 8 * static_cast<size_t>(tile));
      o[0] = make_int4(est_bytes(s.nnz, s.runs, p.coef_bits, p.run_bits),
                       static_cast<int>(s.nnz), static_cast<int>(s.runs),
                       static_cast<int>(sabs));
      o[1] = make_int4(0, 0, 0, 0);
    }
  }
}

bool aligned8(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 8 == 0;
}

bool fits_detector(int C, int th, int tw, int W, const void* cur,
                   const void* prev) {
  return C == kDetC && th == kDetTile && tw == kDetTile && (W * C) % 2 == 0 &&
         aligned8(cur) && aligned8(prev);
}

template <bool kHalo, bool kDet>
int launch_instance(const void* cur, const void* prev, const void* idx,
                    void* out, const DeltaParams& p, void* stream) {
  auto kernel = tile_delta_stats_kernel<kHalo, kDet>;
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
      static_cast<const float*>(cur), static_cast<const float*>(prev),
      static_cast<const int*>(idx), static_cast<int*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <bool kHalo>
int launch(const void* cur, const void* prev, const void* idx, void* out,
           int n, int H, int W, int C, int th, int tw, float qstep,
           int coef_bits, int run_bits, void* stream) {
  if (n <= 0) return 0;
  const DeltaParams p{n, H, W, C, th, tw, qstep, coef_bits, run_bits};
  return fits_detector(C, th, tw, W, cur, prev)
             ? launch_instance<kHalo, true>(cur, prev, idx, out, p, stream)
             : launch_instance<kHalo, false>(cur, prev, idx, out, p, stream);
}

}  // namespace

// 1 where the launchers take the detector's compiled-in instance for these
// extents and frames, else 0 (the generic one).
extern "C" int tile_delta_route(int C, int th, int tw, int W,
                                const void* cur, const void* prev) {
  return fits_detector(C, th, tw, W, cur, prev) ? 1 : 0;
}

extern "C" int tile_delta_launch(const void* cur, const void* prev,
                                 const void* idx, void* out, int n, int H,
                                 int W, int C, int th, int tw, float qstep,
                                 int coef_bits, int run_bits, void* stream) {
  return launch<false>(cur, prev, idx, out, n, H, W, C, th, tw, qstep,
                       coef_bits, run_bits, stream);
}

extern "C" int tile_delta_halo_launch(const void* cur, const void* prev,
                                      const void* idx, void* out, int n,
                                      int H, int W, int C, int th, int tw,
                                      float qstep, int coef_bits,
                                      int run_bits, void* stream) {
  return launch<true>(cur, prev, idx, out, n, H, W, C, th, tw, qstep,
                      coef_bits, run_bits, stream);
}
