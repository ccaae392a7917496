// roi_conv_stack: every layer after the entry (3x3 conv + ReLU each) over
// the packed tiles, in one launch.
//
// Replaces the TPU kernel repro/kernels/roi_conv.py::roi_conv_stack (body
// _roi_conv_stack_kernel, rim seed assemble_rims).  Semantics: at every
// layer a tile's halo comes from its 8 neighbours through the (n, 8) slot
// table (NW, N, NE, W, E, SW, S, SE) and is zero where the slot is -1 --
// the same as scattering the packed tiles onto zeros, running a SAME conv
// and gathering them back, layer after layer.
//
// The TPU design does not carry over: it runs the grid in order, phase axis
// outer, and keeps activations and rims in memory across grid steps.  CTAs
// have no order.  Here a tile never needs another tile's result: its CTA
// loads the tile plus an L-pixel ring of the entry output from its
// neighbours (L = number of layers here), then recomputes the ring layer by
// layer -- each layer shrinks it by one pixel -- zeroing after every layer
// the ring pixels of neighbours whose slot is -1 (inactive or off the
// frame), exactly as the scatter onto zeros does.  The last layer computes
// the tile body only.  Exact while L <= the tile size, so the ring only
// reaches the 8 immediate neighbours; the wrapper refuses anything else.
//
// What bounds it on the H100: float32 operations.  For the default (8, 16,
// 16) detector a 16x16 tile does 1.9 MFLOP with the recomputed ring against
// 8 KB read and 16 KB written, ~80 FLOP per byte, far above the float32
// line of ~20.  So the design is about keeping the FMA pipes fed:
// * Register blocking.  Each thread computes P pixels x 16 output channels
//   (P = 3 on the ring layer, 2 on the body), so one (dy, dx, ci) tap costs
//   four float4 weight loads (the same address across the warp: a
//   broadcast) and P activation loads for 16 P FMAs -- 4.8 to 6.9 FMAs per
//   shared-memory load, against one in the first design.
// * Channel-major planes.  Activations sit in shared memory as one (h, w)
//   plane per channel; a thread's pixels are j, j + 128, ... of the layer's
//   flattened output, so the 32 lanes of a warp read 32 neighbouring words.
//   Each pixel's plane offset costs one division, once per layer.
// * An even split: 128 threads cover the 18x18 ring layer in one round of
//   3 pixels (84% of the slots used) and the 16x16 body in one round of 2.
// * Persistent CTAs: as many as fit on the card (4 per SM at 47 KB of
//   shared memory), each loading every layer's weights once -- padded to
//   whole 16-channel groups with zeros -- and looping over tiles.
// * Compile-time extents: the detector's widths, tile 16, are one template
//   instance, so loops unroll and indices fold; any other widths, tiles and
//   layer counts take one generic instance of the same code.
// * cudaFuncSetAttribute runs once per instance and device, not per launch.
//
// Every output element starts at 0.f and accumulates its taps by explicit
// fmaf in the order dy, dx, then input channel -- the order of
// roi_conv_packed.cu -- and depends only on this tile's ring, so the stack
// equals the per-layer chain (B6 + ReLU) bit for bit, and a compact launch
// and a full launch give the same bits for the tiles they share.  Blocking
// over pixels and channels changes no output's order.  Built without
// --use_fast_math.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCo = 16;                      // output channels per pass
constexpr int kMaxLayers = 8;

struct StackParams {
  int n, th, tw, L;
  int chans[kMaxLayers + 1];
  int cop[kMaxLayers];                       // C_{l+1} padded to kCo
  int woff[kMaxLayers];                      // layer l's weights, in floats
  int buf_floats[2];                         // the two activation buffers
  int w_floats;
};

__host__ __device__ constexpr int pad_co(int c) {
  return (c + kCo - 1) / kCo * kCo;
}

// A compile-time extent where the instance fixes one, else the runtime one.
template <int V>
__device__ __forceinline__ int pick(int rt) {
  return V ? V : rt;
}

// The 3x3 region (0..2 per axis) of a pixel at (y, x) relative to the tile
// body, and whether its slot is live.
__device__ __forceinline__ bool live_at(const int* slot_of, int y, int x,
                                        int th, int tw) {
  const int ry = y < 0 ? 0 : (y < th ? 1 : 2);
  const int rx = x < 0 ? 0 : (x < tw ? 1 : 2);
  return slot_of[ry * 3 + rx] >= 0;
}

// One 3x3 conv + ReLU layer over the CTA's region.  ``in``: cin planes of
// (ho + 2) x win, channel-major; the output is ho x wo (wo = win - 2).  Not
// last: cout planes of ho x wo into ``nxt``, zero on ring pixels (r_out
// from the tile body) whose slot is -1.  Last: NHWC rows of the tile into
// ``out``.  ``w``: (3, 3, cin, cop) with zeros past cout.  Each thread takes
// P pixels (j, j + kThreads, ...) of the flattened output at a time.
template <int P, int CIN, int COUT, int WIN, int HO>
__device__ __forceinline__ void conv_layer(
    const float* __restrict__ in, const float* __restrict__ w,
    float* __restrict__ nxt, float* __restrict__ out,
    const int* __restrict__ slot_of, int cin_rt, int cout_rt, int win_rt,
    int ho_rt, int r_out, int th, int tw, bool last) {
  const int cin = pick<CIN>(cin_rt), cout = pick<COUT>(cout_rt);
  const int cop = COUT ? pad_co(COUT) : pad_co(cout_rt);
  const int win = pick<WIN>(win_rt), ho = pick<HO>(ho_rt);
  const int wo = win - 2, plane = (ho + 2) * win, pixels = ho * wo;
  for (int co0 = 0; co0 < cop; co0 += kCo) {
    for (int base = threadIdx.x; base < pixels; base += kThreads * P) {
      int off[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = min(base + k * kThreads, pixels - 1);
        const int y = j / wo;
        off[k] = y * win + (j - y * wo);
      }
      float acc[P][kCo];
#pragma unroll
      for (int k = 0; k < P; ++k)
#pragma unroll
        for (int c = 0; c < kCo; ++c) acc[k][c] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* src = in + dy * win + dx;
          const float* wt = w + (dy * 3 + dx) * cin * cop + co0;
#pragma unroll 8
          for (int ci = 0; ci < cin; ++ci) {
            float4 wv[kCo / 4];
#pragma unroll
            for (int c4 = 0; c4 < kCo / 4; ++c4)
              wv[c4] = reinterpret_cast<const float4*>(wt + ci * cop)[c4];
            float xv[P];
#pragma unroll
            for (int k = 0; k < P; ++k) xv[k] = src[ci * plane + off[k]];
#pragma unroll
            for (int k = 0; k < P; ++k) {
#pragma unroll
              for (int c4 = 0; c4 < kCo / 4; ++c4) {
                acc[k][4 * c4 + 0] = fmaf(xv[k], wv[c4].x, acc[k][4 * c4 + 0]);
                acc[k][4 * c4 + 1] = fmaf(xv[k], wv[c4].y, acc[k][4 * c4 + 1]);
                acc[k][4 * c4 + 2] = fmaf(xv[k], wv[c4].z, acc[k][4 * c4 + 2]);
                acc[k][4 * c4 + 3] = fmaf(xv[k], wv[c4].w, acc[k][4 * c4 + 3]);
              }
            }
          }
        }
      }
      const int nc = min(kCo, cout - co0);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int j = base + k * kThreads;
        if (j >= pixels) continue;
        const int y = j / wo, x = j - y * wo;
        if (last) {
          float* o = out + (static_cast<size_t>(y) * tw + x) * cout + co0;
          if (COUT % 4 == 0 && COUT != 0 && nc == kCo) {
#pragma unroll
            for (int c4 = 0; c4 < kCo / 4; ++c4)
              reinterpret_cast<float4*>(o)[c4] = make_float4(
                  fmaxf(acc[k][4 * c4 + 0], 0.f),
                  fmaxf(acc[k][4 * c4 + 1], 0.f),
                  fmaxf(acc[k][4 * c4 + 2], 0.f),
                  fmaxf(acc[k][4 * c4 + 3], 0.f));
          } else {
#pragma unroll
            for (int c = 0; c < kCo; ++c)
              if (c < nc) o[c] = fmaxf(acc[k][c], 0.f);
          }
        } else {
          // ring pixels of an inactive or off-frame neighbour are zero at
          // the next layer's input, as on the zero-scattered frame
          const bool live = live_at(slot_of, y - r_out, x - r_out, th, tw);
#pragma unroll
          for (int c = 0; c < kCo; ++c)
            if (c < nc)
              nxt[(co0 + c) * pixels + j] = live ? fmaxf(acc[k][c], 0.f) : 0.f;
        }
      }
    }
  }
}

// C0..C2 and TILE fix the detector's (C0 -> C1 -> C2) two-layer stack on
// TILE x TILE tiles; all 0: the generic instance, everything from P.
template <int C0, int C1, int C2, int TILE>
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
  const int L = kFixed ? 2 : P.L;
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
    if (kFixed) {
      conv_layer<3, C0, C1, TILE + 4, TILE + 2>(
          buf[0], w_s + P.woff[0], buf[1], o, slot_of, 0, 0, 0, 0, 1, TILE,
          TILE, false);
      __syncthreads();
      conv_layer<2, C1, C2, TILE + 2, TILE>(
          buf[1], w_s + P.woff[1], nullptr, o, slot_of, 0, 0, 0, 0, 0, TILE,
          TILE, true);
    } else {
      for (int l = 0; l < L; ++l) {
        const int r_out = L - l - 1;
        conv_layer<3, 0, 0, 0, 0>(
            buf[l % 2], w_s + P.woff[l], buf[(l + 1) % 2], o, slot_of,
            P.chans[l], P.chans[l + 1], tw + 2 * r_out + 2, th + 2 * r_out,
            r_out, th, tw, l == L - 1);
        __syncthreads();
      }
    }
  }
}

// Lays out the shared memory for ``chans`` (L + 1 widths): the two
// activation buffers (layer l reads buffer l % 2, channel-major planes) and
// every layer's weights, padded to whole kCo output groups.
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

// One instance's launch: shared memory opted in once per device, then a
// persistent grid of as many CTAs as fit on the card, at most one per tile.
template <int C0, int C1, int C2, int TILE>
int launch(const float* packed, const float* wcat, const int* nbr, float* out,
           const StackParams& P, cudaStream_t stream) {
  static std::atomic<uint32_t> opted{0};
  auto kernel = roi_conv_stack_kernel<C0, C1, C2, TILE>;
  const size_t smem = smem_bytes(P);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const uint32_t bit = 1u << (dev & 31);
  if (!(opted.load(std::memory_order_acquire) & bit)) {
    // all a CTA may hold beside the static slot table, so any plan of this
    // instance fits without asking again
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(fa.sharedSizeBytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted.fetch_or(bit, std::memory_order_release);
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long fit = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(P.n < fit ? P.n : fit);
  kernel<<<grid, kThreads, smem, stream>>>(packed, wcat, nbr, out, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA needs for ``chans`` (L + 1 widths), in bytes.
extern "C" int roi_conv_stack_smem_bytes(const int* chans, int L, int th,
                                         int tw) {
  if (L < 1 || L > kMaxLayers) return -1;
  StackParams P;
  plan(chans, L, th, tw, &P);
  return static_cast<int>(smem_bytes(P));
}

extern "C" int roi_conv_stack_launch(const void* packed, const void* wcat,
                                     const int* chans, const void* nbr,
                                     void* out, int n, int th, int tw, int L,
                                     void* stream) {
  if (L < 1 || L > kMaxLayers) return static_cast<int>(cudaErrorInvalidValue);
  StackParams P;
  plan(chans, L, th, tw, &P);
  P.n = n;
  const float* x = static_cast<const float*>(packed);
  const float* w = static_cast<const float*>(wcat);
  const int* nb = static_cast<const int*>(nbr);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (L == 2 && th == 16 && tw == 16 && chans[0] == 8 && chans[1] == 16 &&
      chans[2] == 16)
    return launch<8, 16, 16, 16>(x, w, nb, o, P, st);   // the detector
  return launch<0, 0, 0, 0>(x, w, nb, o, P, st);
}
