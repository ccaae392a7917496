// roi_conv_stack: the 3x3 conv layers over the packed tiles -- B3's stack
// (every layer after the entry, conv + ReLU each, in one launch) and B6's
// single layer (no ReLU) -- on one register-blocked layer body.
//
// Replaces the TPU kernels repro/kernels/roi_conv.py::roi_conv_stack (body
// _roi_conv_stack_kernel, rim seed assemble_rims) and ::roi_conv_packed
// (body _roi_conv_packed_kernel, strips _halo_strip).  Semantics: at every
// layer a tile's halo comes from its 8 neighbours through the (n, 8) slot
// table (NW, N, NE, W, E, SW, S, SE) and is zero where the slot is -1 --
// the same as scattering the packed tiles onto zeros, running a SAME conv
// and gathering them back, layer after layer.
//
// The TPU design does not carry over: it runs the grid in order, phase axis
// outer, and keeps activations and rims in memory across grid steps.  CTAs
// have no order.  Two routes, one layer body (conv_layer, in
// roi_conv_layer.cuh):
// * The ring route (roi_conv_stack_kernel).  A tile never needs another
//   tile's result: its CTA loads the tile plus an L-pixel ring of the input
//   from its neighbours (L = number of layers), then recomputes the ring
//   layer by layer -- each layer shrinks it by one pixel -- zeroing after
//   every layer the ring pixels of neighbours whose slot is -1 (inactive or
//   off the frame), exactly as the scatter onto zeros does.  The last layer
//   computes the tile body only.  Exact while L <= the tile size, so the
//   ring only reaches the 8 immediate neighbours; L <= kMaxLayers besides.
//   B6 is this route at L = 1 with the last layer's ReLU off.
// * The layer-by-layer route (roi_conv_layers.cu), for deeper stacks: the
//   TPU kernel's own order.  A cooperative persistent grid runs the
//   one-layer body over every tile of layer l into one of two global
//   ping-pong buffers, waits at a grid-wide barrier, then runs layer
//   l + 1; the last layer writes the output.  One launch at any depth.
//
// What bounds it on the H100: float32 operations.  For the default (8, 16,
// 16) detector a 16x16 tile of the two-layer ring does 1.9 MFLOP against
// 8 KB read and 16 KB written, ~80 FLOP per byte; one 16 -> 16 layer (B6)
// 1.18 MFLOP against 16 KB read and 16 KB written, ~36, and 8 -> 16 ~24:
// all above the float32 line of ~20.  So the design is about keeping the
// FMA pipes fed:
// * Register blocking.  Each thread computes P pixels x 16 output channels
//   (P = 3 on the ring layer, 2 on a 16x16 body), so one (dy, dx, ci) tap
//   costs four float4 weight loads (the same address across the warp: a
//   broadcast) and P activation loads for 16 P FMAs -- 4.8 to 6.9 FMAs per
//   shared-memory load, against one in the first design.
// * Channel-major planes.  Activations sit in shared memory as one (h, w)
//   plane per channel; a thread's pixels are j, j + 128, ... of the layer's
//   flattened output, so the 32 lanes of a warp read 32 neighbouring words.
//   Each pixel's plane offset costs one division, once per layer.
// * An even split: 128 threads cover the 18x18 ring layer in one round of
//   3 pixels (84% of the slots used) and the 16x16 body in one round of 2.
// * Persistent CTAs: as many as fit on the card (4 per SM), each loading its
//   weights once -- padded to whole 16-channel groups with zeros -- and
//   looping over tiles.  On the layer-by-layer route each layer's weights
//   are loaded once per CTA at the start of the layer.
// * Compile-time extents: the detector's widths at tile 16 -- the (8, 16,
//   16) stack, and B6's 8 -> 16 and 16 -> 16 layers -- are template
//   instances of the ring route, so loops unroll, indices fold and the
//   halo loads are float4; any other widths and tiles, and the
//   layer-by-layer route, take the generic code.
// * cudaFuncSetAttribute runs once per kernel and device, not per launch.
//
// Every output element starts at 0.f and accumulates its taps by explicit
// fmaf in the order dy, dx, then input channel -- the order of
// roi_conv_entry.cu -- and depends only on its own inputs, so B6 + ReLU per
// layer, the ring route and the layer-by-layer route give the same bits,
// and a compact launch and a full launch give the same bits for the tiles
// they share.  Blocking over pixels and channels changes no output's order.
// Built without --use_fast_math.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "roi_conv_layer.cuh"

namespace {

constexpr int kMaxLayers = 8;                // the ring route's depth

struct StackParams {
  int n, th, tw, L;
  int chans[kMaxLayers + 1];
  int cop[kMaxLayers];                       // C_{l+1} padded to kCo
  int woff[kMaxLayers];                      // layer l's weights, in floats
  int buf_floats[2];                         // the two activation buffers
  int w_floats;
};

// The ring route.  C0..C2 and TILE fix a compile-time instance on TILE x
// TILE tiles: the detector's (C0 -> C1 -> C2) two-layer stack, or with
// C2 = 0 the one layer C0 -> C1 (B6's two shapes); all 0: the generic
// instance, everything from P.  RELU_LAST: the last layer's ReLU, fixed at
// compile time so the detector's stack compiles to the code it had before
// B6 shared this body.
template <int C0, int C1, int C2, int TILE, bool RELU_LAST>
__global__ void __launch_bounds__(kThreads, 4)
roi_conv_stack_kernel(const float* __restrict__ packed,
                      const float* __restrict__ wcat,
                      const int* __restrict__ nbr, float* __restrict__ out,
                      StackParams P) {
  constexpr bool kFixed = TILE > 0;
  extern __shared__ __align__(16) float smem[];
  __shared__ int slot_of[9];                 // 3x3 region -> packed slot
  float* buf[2] = {smem, smem + P.buf_floats[0]};
  float* w_s = buf[1] + P.buf_floats[1];
  const int L = kFixed ? (C2 ? 2 : 1) : P.L;
  const int th = pick<TILE>(P.th), tw = pick<TILE>(P.tw);
  const int c0 = pick<C0>(P.chans[0]);

  // every layer's weights, once per CTA, padded to whole kCo groups
  for (int l = 0, src = 0; l < L; ++l) {
    const int cout = P.chans[l + 1], cop = P.cop[l];
    const int total = 9 * P.chans[l] * cop;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int tc = i / cop, co = i - tc * cop;
      w_s[P.woff[l] + i] = co < cout ? wcat[src + tc * cout + co] : 0.f;
    }
    src += 9 * P.chans[l] * cout;
  }

  for (int tile = blockIdx.x; tile < P.n; tile += gridDim.x) {
    __syncthreads();                         // the last tile is consumed
    if (threadIdx.x < 9) {
      const int code = threadIdx.x;          // (dy+1)*3 + (dx+1)
      int s = tile;
      if (code != 4)
        s = nbr[8 * static_cast<size_t>(tile) + (code < 4 ? code : code - 1)];
      if (s >= P.n) __trap();                // a slot outside the launch
      slot_of[code] = s;
    }
    __syncthreads();

    // stack input: the tile plus an L-pixel ring, c0 planes
    {
      const int R = L, win = tw + 2 * R, plane = (th + 2 * R) * win;
      for (int e = threadIdx.x; e < plane; e += kThreads) {
        const int py = e / win;
        const int yy = py - R, xx = e - py * win - R;
        const int ry = yy < 0 ? 0 : (yy < th ? 1 : 2);
        const int rx = xx < 0 ? 0 : (xx < tw ? 1 : 2);
        const int s = slot_of[ry * 3 + rx];
        if (s >= 0) {
          const int ly = yy - (ry - 1) * th, lx = xx - (rx - 1) * tw;
          const float* px =
              packed + ((static_cast<size_t>(s) * th + ly) * tw + lx) * c0;
          if (C0 % 4 == 0 && C0 != 0) {
#pragma unroll
            for (int c4 = 0; c4 < C0 / 4; ++c4) {
              const float4 v = reinterpret_cast<const float4*>(px)[c4];
              buf[0][(4 * c4 + 0) * plane + e] = v.x;
              buf[0][(4 * c4 + 1) * plane + e] = v.y;
              buf[0][(4 * c4 + 2) * plane + e] = v.z;
              buf[0][(4 * c4 + 3) * plane + e] = v.w;
            }
          } else {
            for (int ci = 0; ci < c0; ++ci) buf[0][ci * plane + e] = px[ci];
          }
        } else {
          for (int ci = 0; ci < c0; ++ci) buf[0][ci * plane + e] = 0.f;
        }
      }
    }
    __syncthreads();

    float* o = out + static_cast<size_t>(tile) * th * tw * P.chans[L];
    if (kFixed && C2 != 0) {
      conv_layer<3, C0, C1, TILE + 4, TILE + 2>(
          buf[0], w_s + P.woff[0], buf[1], o, slot_of, 0, 0, 0, 0, 1, TILE,
          TILE, false);
      __syncthreads();
      conv_layer<2, C1, C2, TILE + 2, TILE, RELU_LAST>(
          buf[1], w_s + P.woff[1], nullptr, o, slot_of, 0, 0, 0, 0, 0, TILE,
          TILE, true);
    } else if (kFixed) {
      conv_layer<2, C0, C1, TILE + 2, TILE, RELU_LAST>(
          buf[0], w_s, nullptr, o, slot_of, 0, 0, 0, 0, 0, TILE, TILE, true);
    } else {
      for (int l = 0; l < L; ++l) {
        const int r_out = L - l - 1;
        conv_layer<3, 0, 0, 0, 0, RELU_LAST>(
            buf[l % 2], w_s + P.woff[l], buf[(l + 1) % 2], o, slot_of,
            P.chans[l], P.chans[l + 1], tw + 2 * r_out + 2, th + 2 * r_out,
            r_out, th, tw, l == L - 1);
        __syncthreads();
      }
    }
  }
}

// Lays out the ring route's shared memory for ``chans`` (L + 1 widths):
// the two activation buffers (layer l reads buffer l % 2, channel-major
// planes) and every layer's weights, padded to whole kCo output groups.
void plan(const int* chans, int L, int th, int tw, StackParams* P) {
  *P = StackParams{};
  P->th = th;
  P->tw = tw;
  P->L = L;
  for (int l = 0; l <= L; ++l) P->chans[l] = chans[l];
  for (int l = 0; l < L; ++l) {
    const int r = L - l;
    const int in = (th + 2 * r) * (tw + 2 * r) * chans[l];
    int& b = P->buf_floats[l % 2];
    b = b > in ? b : in;
    P->cop[l] = pad_co(chans[l + 1]);
    P->woff[l] = P->w_floats;
    P->w_floats += 9 * chans[l] * P->cop[l];
  }
  // the weights start 16-byte aligned: float4 loads
  for (int i = 0; i < 2; ++i) P->buf_floats[i] = (P->buf_floats[i] + 3) / 4 * 4;
}

size_t smem_bytes(const StackParams& P) {
  return sizeof(float) *
         static_cast<size_t>(P.buf_floats[0] + P.buf_floats[1] + P.w_floats);
}

// One ring-route instance's launch on its persistent grid.
template <int C0, int C1, int C2, int TILE, bool RELU_LAST>
int launch(const float* packed, const float* wcat, const int* nbr, float* out,
           const StackParams& P, cudaStream_t stream) {
  static std::atomic<uint32_t> opted{0};
  auto kernel = roi_conv_stack_kernel<C0, C1, C2, TILE, RELU_LAST>;
  const size_t smem = smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(kernel, opted, smem, P.n, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(packed, wcat, nbr, out, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one ring-route CTA needs for ``chans`` (L + 1 widths), in
// bytes; -1 past the ring route's depth.
extern "C" int roi_conv_stack_smem_bytes(const int* chans, int L, int th,
                                         int tw) {
  if (L < 1 || L > kMaxLayers) return -1;
  StackParams P;
  plan(chans, L, th, tw, &P);
  return static_cast<int>(smem_bytes(P));
}

// The ring route: L conv layers, each with its ReLU but the last one's
// when ``relu_last`` is 0 (B6 is L = 1 without it).
extern "C" int roi_conv_stack_launch(const void* packed, const void* wcat,
                                     const int* chans, const void* nbr,
                                     void* out, int n, int th, int tw, int L,
                                     int relu_last, void* stream) {
  if (L < 1 || L > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  StackParams P;
  plan(chans, L, th, tw, &P);
  P.n = n;
  const float* x = static_cast<const float*>(packed);
  const float* w = static_cast<const float*>(wcat);
  const int* nb = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (th == 16 && tw == 16) {
    if (relu_last && L == 2 && chans[0] == 8 && chans[1] == 16 &&
        chans[2] == 16)
      return launch<8, 16, 16, 16, true>(x, w, nb, o, P, st);  // the detector
    if (!relu_last && L == 1 && chans[0] == 8 && chans[1] == 16)
      return launch<8, 16, 0, 16, false>(x, w, nb, o, P, st);  // B6's layers
    if (!relu_last && L == 1 && chans[0] == 16 && chans[1] == 16)
      return launch<16, 16, 0, 16, false>(x, w, nb, o, P, st);
  }
  if (relu_last) return launch<0, 0, 0, 0, true>(x, w, nb, o, P, st);
  return launch<0, 0, 0, 0, false>(x, w, nb, o, P, st);
}

