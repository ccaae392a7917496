// The gather + 3x3 SAME conv family on active tiles: roi_conv_entry (B2,
// with ReLU), roi_conv_fleet (B7, without) and roi_conv (B8, one camera's
// (ty, tx) rows, without ReLU), one kernel template over the ReLU, the
// index width and the instance.
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
// frames share the rows (roi_conv_batched): work item b * n + row is row
// `row` of frame b and the output is frame-major, (C * n, th, tw, Cout) --
// one launch for a batch, and one camera's view without an index copy.
//
// What bounds it on the H100: bytes.  With Cin = 3 and Cout = 8 a 16x16
// tile does 110 KFLOP against 3.9 KB read and 8 KB written, about 9 FLOP per
// byte, under the card's float32 line of ~20 FLOP per byte.  Tensor cores
// would buy nothing at Cin = 3, so the products are plain float32 FMAs.
// The design keeps the memory system busy and the SM's issue slots free:
// * Persistent CTAs, as many as fit on the card at once (at most one per
//   work item), each striding over the work items; a compact set of a
//   few hundred tiles still puts one tile on every CTA.
// * The weights go to shared memory once per CTA, as 16-byte rows: a tap
//   and an input channel give 8 output channels, two float4, each read by
//   half a warp at one address (a broadcast); Cout is padded with zeros to
//   whole groups of 8.
// * Double-buffered asynchronous window loads: while a CTA computes one
//   tile, cp.async brings the next tile's haloed window into the other
//   buffer, zero-filling (src-size 0) rows above or below the frame and
//   columns left or right of it.
// * The detector's instance (Cin = 3, Cout = 8, 16x16 tiles) is compiled
//   in: a window row is floats [48 tx - 3, 48 tx + 51) of its frame row,
//   which lies inside the 14 aligned 16-byte vectors [48 tx - 4, 48 tx +
//   52) whenever W * Cin is a multiple of 4 and the frames start on a
//   16-byte boundary, so the row is 14 16-byte copies, each wholly inside
//   the frame row or wholly outside it.  Each thread takes 2 vertically
//   adjacent pixels x 4 channels and its neighbour lane the other 4, so a
//   tap costs one broadcast float4 weight read and 2 window reads for 8
//   FMAs (a window row read serves two output rows), 256 threads share a
//   tile at 48 registers, and a warp's float4 stores cover one 512-byte
//   run of a tile row, pixel after pixel.  (On the H100, 4 pixels a
//   thread, 8 channels a lane and a third window buffer were each
//   slower.)
// * Any other Cin, Cout or tile, frames whose rows are not whole 16-byte
//   vectors and frames off a 16-byte boundary take the generic instance:
//   the same loop with runtime extents, 4-byte copies, 2 pixels x 8
//   channels a thread.
//   fits_detector is the rule; roi_conv_entry_route reports it.
//
// Every output element starts at 0.f and accumulates its 27 taps by
// explicit fmaf in the order dy, dx, then input channel, and depends only
// on its own window, so a compact launch and a full launch give the same
// bits for the tiles they share, the CTA and the instance do not change
// them, the three entry points agree bit for bit up to the ReLU, and
// roi_conv_stack.cu (B3 and B6), which uses the same order, continues the
// chain bit for bit.  Built without --use_fast_math.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 8;                    // output channels per pass
constexpr int kGenThreads = 64, kGenP = 2;   // generic: 2 pixels a thread
// the detector's instance: P pixels of one column a thread, 2 lanes a
// pixel (4 of its 8 channels each), so a warp is one row of pixel pairs
constexpr int kDetCin = 3, kDetCout = 8, kDetTile = 16, kDetP = 2;
constexpr int kDetLanes = 2;
constexpr int kDetThreads = kDetTile * kDetTile / kDetP * kDetLanes;
// the window's first float within its first aligned vector, the vectors
// a window row spans, and the shared row pitch in floats
constexpr int kDetLead = (4 - kDetCin % 4) % 4;
constexpr int kDetVecs = (kDetLead + (kDetTile + 2) * kDetCin + 3) / 4;
constexpr int kDetPitch = 4 * kDetVecs;
static_assert(kDetTile * kDetCin % 4 == 0, "tiles must start on a vector");
static_assert(kDetTile % kDetP == 0 && kDetCout == kChunk, "one pass");
static_assert(kDetTile * kDetLanes == 32, "a warp reads one row group");

// threads per CTA, and CTAs per SM ptxas must leave registers for: the
// detector's 5 CTAs of 256 (at most 51 registers a thread), the generic
// instance's 8 of 64 (at most 128, no spills)
template <bool DET>
constexpr int kThreadsOf = DET ? kDetThreads : kGenThreads;
template <bool DET>
constexpr int kMinCtasOf = DET ? 5 : 8;

struct EntryParams {
  int items;                                 // n, or B * n with (ty, tx) rows
  int n, C, H, W, cin, cout, cop, th, tw;
  int pitch;                                 // floats per shared window row
  int buf;                                   // floats per window buffer
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies of 16 or 4 bytes; with ok false
// nothing is read and the destination is zero-filled.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Tile {
  int frame, ty, tx;
};

// Work item -> (frame, ty, tx), as loaded; checked only where it is used,
// so the load's latency overlaps the work before that.
template <int COLS>
__device__ __forceinline__ Tile fetch_tile(const int* __restrict__ idx,
                                           int item, const EntryParams& p) {
  Tile t;
  if (COLS == 3) {
    t.frame = idx[3 * item];
    t.ty = idx[3 * item + 1];
    t.tx = idx[3 * item + 2];
  } else {
    const int b = item / p.n, row = item - b * p.n;
    t.frame = b;
    t.ty = idx[2 * row];
    t.tx = idx[2 * row + 1];
  }
  return t;
}

// Issue the copies of tile t's haloed window into ``win``; a row off the
// canvas traps.
template <bool DET>
__device__ __forceinline__ void load_window(float* win,
                                            const float* __restrict__ x,
                                            Tile t, const EntryParams& p) {
  if (t.frame < 0 || t.frame >= p.C || t.ty < 0 || t.tx < 0 ||
      (t.ty + 1) * p.th > p.H || (t.tx + 1) * p.tw > p.W)
    __trap();                                // a row off the canvas
  const int cin = DET ? kDetCin : p.cin;
  const int rowf = p.W * cin;                // floats per frame row
  const float* frame = x + static_cast<size_t>(t.frame) * p.H * rowf;
  if (DET) {
    const int y0 = t.ty * kDetTile - 1;
    // the first float of the window's first aligned vector
    const int f0 = (t.tx * kDetTile - 1) * kDetCin - kDetLead;
    for (int e = threadIdx.x; e < (kDetTile + 2) * kDetVecs;
         e += kDetThreads) {
      const int r = e / kDetVecs, v = e - r * kDetVecs;
      const int y = y0 + r, f = f0 + 4 * v;
      // rows are whole vectors, so f < rowf keeps all 4 floats inside
      const bool ok = y >= 0 && y < p.H && f >= 0 && f < rowf;
      copy16(win + r * kDetPitch + 4 * v,
             ok ? frame + static_cast<size_t>(y) * rowf + f : x, ok);
    }
  } else {
    const int lanes = (p.tw + 2) * cin;
    const int f0 = (t.tx * p.tw - 1) * cin;
    for (int r = 0; r < p.th + 2; ++r) {
      const int y = t.ty * p.th - 1 + r;
      const bool row_ok = y >= 0 && y < p.H;
      for (int l = threadIdx.x; l < lanes; l += kGenThreads) {
        const int f = f0 + l;
        const bool ok = row_ok && f >= 0 && f < rowf;
        copy4(win + r * p.pitch + l,
              ok ? frame + static_cast<size_t>(y) * rowf + f : x, ok);
      }
    }
  }
}

template <bool RELU>
__device__ __forceinline__ float relu_if(float v) {
  return RELU ? fmaxf(v, 0.f) : v;
}

// The conv of one tile from its window in shared memory into its rows of
// ``out``.  Each thread takes P vertically adjacent pixels of one column x
// CT output channels at a time: the detector's 4 of a pixel's 8 (two
// lanes a pixel, so a warp's float4 stores cover a 512-byte row segment),
// the generic instance a whole chunk of 8.
template <bool RELU, bool DET>
__device__ __forceinline__ void conv_tile(const float* win,
                                          const float* w_s,
                                          float* __restrict__ out, int item,
                                          const EntryParams& p) {
  constexpr int P = DET ? kDetP : kGenP;
  constexpr int LANES = DET ? kDetLanes : 1;
  constexpr int CT = kChunk / LANES;
  const int cin = DET ? kDetCin : p.cin, cout = DET ? kDetCout : p.cout;
  const int cop = DET ? kDetCout : p.cop;
  const int th = DET ? kDetTile : p.th, tw = DET ? kDetTile : p.tw;
  const int pitch = DET ? kDetPitch : p.pitch, lead = DET ? kDetLead : 0;
  const int per_chunk = (th + P - 1) / P * tw;
  float* o_tile = out + static_cast<size_t>(item) * th * tw * cout;
  for (int it = threadIdx.x; it < per_chunk * (cop / kChunk) * LANES;
       it += kThreadsOf<DET>) {
    const int lane = it % LANES, rest = it / LANES;
    const int chunk = rest / per_chunk, g = rest - chunk * per_chunk;
    const int gy = g / tw, px = g - gy * tw;
    const int co0 = chunk * kChunk + lane * CT, py0 = gy * P;
    // the window offset of each pixel's top-left tap; a row past the tile
    // (th not a multiple of P) reads the last row and is not stored
    int off[P];
#pragma unroll
    for (int k = 0; k < P; ++k)
      off[k] = (DET ? py0 + k : min(py0 + k, th - 1)) * pitch + lead +
               px * cin;
    float acc[P][CT];
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int c = 0; c < CT; ++c) acc[k][c] = 0.f;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* src = win + dy * pitch + dx * cin;
        const float* wt = w_s + (dy * 3 + dx) * cin * cop + co0;
#pragma unroll
        for (int ci = 0; ci < cin; ++ci) {
          const float4* wq = reinterpret_cast<const float4*>(wt + ci * cop);
          float wv[CT];
#pragma unroll
          for (int c4 = 0; c4 < CT / 4; ++c4) {
            const float4 q = wq[c4];
            wv[4 * c4] = q.x;
            wv[4 * c4 + 1] = q.y;
            wv[4 * c4 + 2] = q.z;
            wv[4 * c4 + 3] = q.w;
          }
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const float v = src[off[k] + ci];
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[k][c] = fmaf(v, wv[c], acc[k][c]);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int py = py0 + k;
      if (!DET && py >= th) continue;
      float* o = o_tile + (static_cast<size_t>(py) * tw + px) * cout + co0;
      if (DET || (cout % 4 == 0 && co0 + CT <= cout)) {
#pragma unroll
        for (int c4 = 0; c4 < CT / 4; ++c4)
          reinterpret_cast<float4*>(o)[c4] = make_float4(
              relu_if<RELU>(acc[k][4 * c4]), relu_if<RELU>(acc[k][4 * c4 + 1]),
              relu_if<RELU>(acc[k][4 * c4 + 2]),
              relu_if<RELU>(acc[k][4 * c4 + 3]));
      } else {
#pragma unroll
        for (int c = 0; c < CT; ++c)
          if (co0 + c < cout) o[c] = relu_if<RELU>(acc[k][c]);
      }
    }
  }
}

template <bool RELU, int COLS, bool DET>
__global__ void __launch_bounds__(kThreadsOf<DET>, kMinCtasOf<DET>)
roi_conv_entry_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const int* __restrict__ idx, float* __restrict__ out,
                      EntryParams p) {
  extern __shared__ __align__(16) float smem[];
  const int cin = DET ? kDetCin : p.cin, cout = DET ? kDetCout : p.cout;
  const int cop = DET ? kDetCout : p.cop;
  float* w_s = smem;                         // (9 * cin, cop)
  float* buf = smem + 9 * cin * cop;         // two window buffers
  const int step = gridDim.x;                // the grid is at most p.items
  // tile s of this CTA is in buffer s % 2: the copies of tile s + 1 are
  // issued while tile s is computed, and each tile's index row is loaded
  // one tile before its copies are issued
  int item = blockIdx.x, next = item + step;
  load_window<DET>(buf, x, fetch_tile<COLS>(idx, item, p), p);
  commit_copies();
  Tile pending = fetch_tile<COLS>(idx, next < p.items ? next : item, p);
  for (int i = threadIdx.x; i < 9 * cin * cop; i += kThreadsOf<DET>) {
    const int tc = i / cop, co = i - tc * cop;
    w_s[i] = co < cout ? w[tc * cout + co] : 0.f;
  }
  for (int s = 0; item < p.items; ++s, item = next, next += step) {
    if (next < p.items)
      load_window<DET>(buf + ((s + 1) & 1) * p.buf, x, pending, p);
    commit_copies();                         // possibly empty
    if (next + step < p.items)
      pending = fetch_tile<COLS>(idx, next + step, p);
    wait_copies<1>();                        // this tile's window is in
    __syncthreads();
    conv_tile<RELU, DET>(buf + (s & 1) * p.buf, w_s, out, item, p);
    __syncthreads();                         // the buffer is free again
  }
  wait_copies<0>();
}

bool fits_detector(int Cin, int Cout, int th, int tw, int W, const void* x) {
  return Cin == kDetCin && Cout == kDetCout && th == kDetTile &&
         tw == kDetTile && (W * Cin) % 4 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

template <bool RELU, int COLS, bool DET>
int launch_instance(const void* x, const void* w, const void* idx, void* out,
                    EntryParams p, void* stream) {
  auto kernel = roi_conv_entry_kernel<RELU, COLS, DET>;
  constexpr int threads = kThreadsOf<DET>;
  const size_t smem = sizeof(float) * (9 * p.cin * p.cop + 2 * p.buf);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  // the persistent grid: as many CTAs as fit on the card at once, at most
  // one per work item
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int fit = sms * per_sm;
  kernel<<<p.items < fit ? p.items : fit, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(idx), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <bool RELU, int COLS>
int launch(const void* x, const void* w, const void* idx, void* out, int n,
           int frames, int C, int H, int W, int Cin, int Cout, int th,
           int tw, void* stream) {
  const bool det = fits_detector(Cin, Cout, th, tw, W, x);
  EntryParams p;
  p.items = COLS == 3 ? n : frames * n;
  p.n = n;
  p.C = C;
  p.H = H;
  p.W = W;
  p.cin = Cin;
  p.cout = Cout;
  p.cop = (Cout + kChunk - 1) / kChunk * kChunk;
  p.th = th;
  p.tw = tw;
  p.pitch = det ? kDetPitch : (tw + 2) * Cin;
  p.buf = ((th + 2) * p.pitch + 3) / 4 * 4;
  if (p.items <= 0) return 0;
  return det ? launch_instance<RELU, COLS, true>(x, w, idx, out, p, stream)
             : launch_instance<RELU, COLS, false>(x, w, idx, out, p, stream);
}

}  // namespace

// 1 where the launchers take the detector's compiled-in instance for these
// extents and frames, else 0 (the generic instance).
extern "C" int roi_conv_entry_route(int Cin, int Cout, int th, int tw, int W,
                                    const void* x) {
  return fits_detector(Cin, Cout, th, tw, W, x) ? 1 : 0;
}

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
