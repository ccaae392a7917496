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
// have no order.  Here each CTA owns one tile and never needs another CTA's
// result: it loads its tile plus an L-pixel ring of the entry output from
// its neighbours (L = number of layers here), then recomputes the ring layer
// by layer -- each layer shrinks it by one pixel -- zeroing after every
// layer the ring pixels of neighbours whose slot is -1 (inactive or off the
// frame), exactly as the scatter onto zeros does.  The last layer computes
// the tile body only.  Exact while L <= the tile size, so the ring only
// reaches the 8 immediate neighbours; the wrapper refuses anything else.
//
// What bounds it on the H100: operations.  For the default (8,16,16)
// detector a 16x16 tile does ~1.8 MFLOP (with the recomputed ring) against
// 8 KB read and 16 KB written, ~70 FLOP per byte, above the float32 line of
// ~20.  The products are float32 FMAs; the activations of all layers stay
// in shared memory (20x20x8 in, 18x18x16 between layers, 16x16x16 out to
// device memory), so the only device traffic is the entry output and the
// final layer.  Pixels sit in shared memory at an odd channel stride, so
// the 32 threads of a warp, which take 32 neighbouring pixels, read 32
// different banks.
//
// Each output element accumulates its taps in a fixed order -- dy, dx, then
// input channel -- and depends only on this tile's ring, so a compact launch
// and a full launch give the same bits for the tiles they share.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 8;                    // output channels per pass
constexpr int kMaxLayers = 8;

struct StackParams {
  int n, th, tw, L;
  int chans[kMaxLayers + 1];
  int woff[kMaxLayers];                      // layer l's weights, in floats
  int buf_floats[2];                         // the two activation buffers
  int w_floats;
};

__host__ __device__ inline int pixel_stride(int c) {
  return (c % 2 == 0) ? c + 1 : c;           // odd: conflict-free pixels
}

__global__ void __launch_bounds__(kThreads)
roi_conv_stack_kernel(const float* __restrict__ packed,
                      const float* __restrict__ wcat,
                      const int* __restrict__ nbr, float* __restrict__ out,
                      StackParams P) {
  extern __shared__ float smem[];
  __shared__ int slot_of[9];                 // 3x3 region -> packed slot
  float* buf[2] = {smem, smem + P.buf_floats[0]};
  float* w_s = smem + P.buf_floats[0] + P.buf_floats[1];
  const int tile = blockIdx.x;
  const int th = P.th, tw = P.tw, L = P.L;

  if (threadIdx.x < 9) {
    const int code = threadIdx.x;            // (dy+1)*3 + (dx+1)
    int s = tile;
    if (code != 4) s = nbr[8 * static_cast<size_t>(tile) + (code < 4 ? code : code - 1)];
    if (s >= P.n) __trap();                  // a slot outside the launch
    slot_of[code] = s;
  }
  for (int i = threadIdx.x; i < P.w_floats; i += kThreads) w_s[i] = wcat[i];
  __syncthreads();

  // stack input: the tile plus an L-pixel ring from its neighbours
  {
    const int R = L, c0 = P.chans[0], cs = pixel_stride(c0);
    const int Win = tw + 2 * R, total = (th + 2 * R) * Win * c0;
    for (int e = threadIdx.x; e < total; e += kThreads) {
      const int pix = e / c0, ci = e - pix * c0;
      const int yy = pix / Win - R, xx = pix % Win - R;
      const int ry = yy < 0 ? 0 : (yy < th ? 1 : 2);
      const int rx = xx < 0 ? 0 : (xx < tw ? 1 : 2);
      const int s = slot_of[ry * 3 + rx];
      float v = 0.f;
      if (s >= 0) {
        const int ly = yy - (ry - 1) * th, lx = xx - (rx - 1) * tw;
        v = packed[((static_cast<size_t>(s) * th + ly) * tw + lx) * c0 + ci];
      }
      buf[0][pix * cs + ci] = v;
    }
  }
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int r_in = L - l, r_out = r_in - 1;
    const int cin = P.chans[l], cout = P.chans[l + 1];
    const int cs_in = pixel_stride(cin), cs_out = pixel_stride(cout);
    const int Win = tw + 2 * r_in, Ho = th + 2 * r_out, Wo = tw + 2 * r_out;
    const float* in = buf[l % 2];
    float* nxt = buf[(l + 1) % 2];
    const float* wl = w_s + P.woff[l];
    const bool last = (l == L - 1);
    const int pixels = Ho * Wo, chunks = (cout + kChunk - 1) / kChunk;
    for (int item = threadIdx.x; item < pixels * chunks; item += kThreads) {
      const int p = item % pixels, co0 = (item / pixels) * kChunk;
      const int oy = p / Wo, ox = p - oy * Wo;
      float acc[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) acc[k] = 0.f;
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const float* src = in + ((oy + dy) * Win + ox + dx) * cs_in;
          const float* wt = wl + (dy * 3 + dx) * cin * cout + co0;
          for (int ci = 0; ci < cin; ++ci) {
            const float v = src[ci];
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
              if (co0 + k < cout) acc[k] = fmaf(v, wt[ci * cout + k], acc[k]);
          }
        }
      }
      if (last) {
        float* o = out + ((static_cast<size_t>(tile) * th + oy) * tw + ox) * cout;
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (co0 + k < cout) o[co0 + k] = fmaxf(acc[k], 0.f);
      } else {
        // ring pixels of an inactive or off-frame neighbour are zero at
        // the next layer's input, as on the zero-scattered frame
        const int yy = oy - r_out, xx = ox - r_out;
        const int ry = yy < 0 ? 0 : (yy < th ? 1 : 2);
        const int rx = xx < 0 ? 0 : (xx < tw ? 1 : 2);
        const bool live = slot_of[ry * 3 + rx] >= 0;
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
          if (co0 + k < cout)
            nxt[p * cs_out + co0 + k] = live ? fmaxf(acc[k], 0.f) : 0.f;
      }
    }
    __syncthreads();
  }
}

// Lays out the shared memory for ``chans`` (L + 1 widths): the two
// activation buffers (layer l reads buffer l % 2) and every layer's weights.
void plan(const int* chans, int L, int th, int tw, StackParams* P) {
  *P = StackParams{};
  P->th = th;
  P->tw = tw;
  P->L = L;
  for (int l = 0; l <= L; ++l) P->chans[l] = chans[l];
  for (int l = 0; l < L; ++l) {
    const int r = L - l;
    const int in = (th + 2 * r) * (tw + 2 * r) * pixel_stride(chans[l]);
    int& b = P->buf_floats[l % 2];
    b = b > in ? b : in;
    P->woff[l] = P->w_floats;
    P->w_floats += 9 * chans[l] * chans[l + 1];
  }
}

size_t smem_bytes(const StackParams& P) {
  return sizeof(float) *
         static_cast<size_t>(P.buf_floats[0] + P.buf_floats[1] + P.w_floats);
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
  const size_t smem = smem_bytes(P);
  // the default detector needs ~50 KB, past the 48 KB granted unasked
  cudaError_t e = cudaFuncSetAttribute(
      roi_conv_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  roi_conv_stack_kernel<<<n, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(packed), static_cast<const float*>(wcat),
      static_cast<const int*>(nbr), static_cast<float*>(out), P);
  return static_cast<int>(cudaGetLastError());
}
