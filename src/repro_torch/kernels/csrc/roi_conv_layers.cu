// roi_conv_layers: B3's layer-by-layer route -- a stack of 3x3 conv + ReLU
// layers over the packed tiles, too deep for roi_conv_stack.cu's ring
// route (more layers than min(tile, 8)), in one launch.
//
// Replaces, for those depths, the TPU kernel
// repro/kernels/roi_conv.py::roi_conv_stack, in its own order: phase axis
// outer, every tile of layer l done before layer l + 1.  CTAs have no order,
// so the launch is cooperative (every CTA resident) and a grid-wide barrier
// separates the layers.  Each CTA loops over its tiles: the tile plus a
// 1-pixel ring of the layer's input from its 8 neighbours through the (n, 8)
// slot table, zero where the slot is -1 (as on the zero-scattered frame),
// then the one-layer body of roi_conv_layer.cuh with its ReLU.  Layer l
// writes one of two global ping-pong buffers; the last writes the output.
// The layer widths come from a device array and the shared memory is sized
// for the widest layer, so nothing caps the depth.  Generic code only: no
// configuration runs a stack this deep, so no width or tile is compiled in.
//
// Each output accumulates its taps in the body's fixed fmaf order, so this
// route gives the bits of the B6 + ReLU chain, and of the ring route where
// both apply.  Built without --use_fast_math.
#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "roi_conv_layer.cuh"

namespace cg = cooperative_groups;

namespace {

struct LayersParams {
  int n, th, tw, L;
  int win_floats;                            // the window, then the weights
};

// ``chans``: the L + 1 widths, on the card.  Layer l < L - 1 writes (n, th,
// tw, C_{l+1}) to act0 (l even) or act1 (l odd).  ``packed`` and the
// activations are not __restrict__: the activations are written in this
// launch, so no load of them may take the read-only path.
__global__ void __launch_bounds__(kThreads, 4)
roi_conv_layers_kernel(const float* packed, const float* __restrict__ wcat,
                       const int* __restrict__ nbr,
                       const int* __restrict__ chans, float* act0,
                       float* act1, float* out, LayersParams P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int slot_of[9];                 // 3x3 region -> packed slot
  float* win = smem;
  float* w_s = smem + P.win_floats;
  const int th = P.th, tw = P.tw, ww = tw + 2, plane = (th + 2) * ww;
  cg::grid_group grid = cg::this_grid();
  for (int l = 0, woff = 0; l < P.L; ++l) {
    const int cin = chans[l], cout = chans[l + 1], cop = pad_co(cout);
    const float* in = l == 0 ? packed : (l % 2 ? act0 : act1);
    float* dst = l == P.L - 1 ? out : (l % 2 ? act1 : act0);
    // this layer's weights, padded to whole kCo groups
    for (int i = threadIdx.x; i < 9 * cin * cop; i += kThreads) {
      const int tc = i / cop, co = i - tc * cop;
      w_s[i] = co < cout ? wcat[woff + tc * cout + co] : 0.f;
    }
    woff += 9 * cin * cout;
    for (int tile = blockIdx.x; tile < P.n; tile += gridDim.x) {
      __syncthreads();             // the weights are in, the last tile used
      if (threadIdx.x < 9) {
        const int code = threadIdx.x;        // (dy+1)*3 + (dx+1)
        int s = tile;
        if (code != 4)
          s = nbr[8 * static_cast<size_t>(tile) +
                  (code < 4 ? code : code - 1)];
        if (s >= P.n) __trap();              // a slot outside the launch
        slot_of[code] = s;
      }
      __syncthreads();
      // the tile plus a 1-pixel ring, cin channel-major planes
      for (int e = threadIdx.x; e < plane; e += kThreads) {
        const int py = e / ww;
        const int yy = py - 1, xx = e - py * ww - 1;
        const int ry = yy < 0 ? 0 : (yy < th ? 1 : 2);
        const int rx = xx < 0 ? 0 : (xx < tw ? 1 : 2);
        const int s = slot_of[ry * 3 + rx];
        if (s >= 0) {
          const int ly = yy - (ry - 1) * th, lx = xx - (rx - 1) * tw;
          const float* px =
              in + ((static_cast<size_t>(s) * th + ly) * tw + lx) * cin;
          for (int ci = 0; ci < cin; ++ci) win[ci * plane + e] = px[ci];
        } else {
          for (int ci = 0; ci < cin; ++ci) win[ci * plane + e] = 0.f;
        }
      }
      __syncthreads();
      conv_layer<3, 0, 0, 0, 0>(
          win, w_s, nullptr, dst + static_cast<size_t>(tile) * th * tw * cout,
          slot_of, cin, cout, ww, th, 0, th, tw, true);
    }
    if (l + 1 < P.L) grid.sync();  // layer l is written on every tile
  }
}

// The shared memory for ``chans`` (L + 1 widths): the widest layer's
// window and the largest layer's padded weights.  Returns its size in
// bytes.
size_t plan_layers(const int* chans, int L, int th, int tw,
                   LayersParams* P) {
  *P = LayersParams{0, th, tw, L, 0};
  size_t w_floats = 0;
  for (int l = 0; l < L; ++l) {
    const int in = (th + 2) * (tw + 2) * chans[l];
    const size_t w = 9 * static_cast<size_t>(chans[l]) * pad_co(chans[l + 1]);
    P->win_floats = P->win_floats > in ? P->win_floats : in;
    w_floats = w_floats > w ? w_floats : w;
  }
  P->win_floats = (P->win_floats + 3) / 4 * 4;   // the weights: float4 loads
  return sizeof(float) * (P->win_floats + w_floats);
}

}  // namespace

// Shared memory one layer-by-layer CTA needs, in bytes.
extern "C" int roi_conv_layers_smem_bytes(const int* chans, int L, int th,
                                          int tw) {
  if (L < 1) return -1;
  LayersParams P;
  return static_cast<int>(plan_layers(chans, L, th, tw, &P));
}

// L conv + ReLU layers in one cooperative launch.  ``chans`` on the host,
// ``chans_dev`` the same L + 1 ints on the card; act0 / act1 hold (n, th,
// tw, max inner width) floats each (act1 unused below 3 layers, both below
// 2).  A refused cooperative launch (too many CTAs, no support) returns its
// error.
extern "C" int roi_conv_layers_launch(const void* packed, const void* wcat,
                                      const int* chans, const void* chans_dev,
                                      const void* nbr, void* act0, void* act1,
                                      void* out, int n, int th, int tw, int L,
                                      void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<uint32_t> opted{0};
  LayersParams P;
  const size_t smem = plan_layers(chans, L, th, tw, &P);
  P.n = n;
  int grid = 0;
  cudaError_t e = persistent_grid(roi_conv_layers_kernel, opted, smem, n,
                                  &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* x = static_cast<const float*>(packed);
  const float* w = static_cast<const float*>(wcat);
  const int* nb = static_cast<const int*>(nbr);
  const int* ch = static_cast<const int*>(chans_dev);
  float* a0 = static_cast<float*>(act0);
  float* a1 = static_cast<float*>(act1);
  float* o = static_cast<float*>(out);
  void* args[] = {&x, &w, &nb, &ch, &a0, &a1, &o, &P};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&roi_conv_layers_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(e != cudaSuccess ? e : last);
}
