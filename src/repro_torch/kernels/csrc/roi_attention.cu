// B12 roi_attention: flash attention over RoI-packed tokens, causal on the
// tokens' ORIGINAL positions, with the causal block skip and the
// per-(head, q-block) visited counts.
//
// Replaces the TPU kernel repro/kernels/roi_attention.py::roi_attention
// (kernel _roi_attn_kernel).
//
// * q, k, v: (S, H, D) float32 or bfloat16, the packed layout of
//   ops.pack_tokens; positions (S,) int32, PAD_POS = INT32_MAX on padding
//   rows; kmin (S / bk,) int32, the per-k-block minimum position.  Query
//   row i attends key j iff positions[i] >= positions[j].  Output (S, H, D)
//   in q's type, visited (H, S / bq) int32.
// * The causal skip: a q-block visits k-blocks [0, hi), hi = 1 + the last
//   j with kmin[j] <= the block's largest real position (-1 without a real
//   row, so an all-padding block visits nothing and writes zeros).  Blocks
//   past hi are fully masked for every real row, and a fully masked block
//   is an exact no-op once a real key has been folded in (p = exp(-1e30 -
//   m) = 0, alpha = exp(0) = 1), so skipped and exhaustive runs give the
//   same bits on real rows.  That needs a correctly rounded exp: expf, no
//   --use_fast_math and no __expf.
//
// What bounds it on the H100: operations.  At the serving slice's shape (S
// = 9,472, H = 48, D = 128, blocks of 128) the visited block pairs need
// 4*bq*bk*D FLOPs each, about 0.14 TFLOP, against 0.47 GB of q, k, v and
// output.  This first kernel runs on the CUDA cores in f32 (no tensor
// cores, no wgmma, no TMA): a redesign PR takes it to the tensor cores.
//
// Design: one CTA per (q-block, head), 8 warps.  The CTA stages its
// q-block in shared memory, pre-scaled by 1/sqrt(D), loads its positions
// and finds hi itself (as the Pallas kernel reads its scalar-prefetched
// kmin).  It walks the visited k-blocks in sub-chunks of 32 keys, each
// staged in shared memory in f32: lane c of a warp scores key c against
// the warp's BQ/8 query rows (float4 reads; q broadcast, k rows padded by
// 4 floats so the lanes hit distinct banks), the online-softmax update
// runs per row with butterfly shuffles (every lane ends with the same
// bits), and the warp folds p @ v into its accumulators, lane d holding
// columns d, d+32, ...  Each sub-chunk is one online-softmax step in f32;
// the Pallas kernel takes one step per k-block, so the two agree within
// rounding, not bitwise.  The q-block needs up to 64 KB of shared memory,
// so the launcher opts the kernel into dynamic shared memory above 48 KB.
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 32;           // keys per sub-chunk: one per lane
constexpr float kNeg = -1e30f;     // the Pallas kernel's _NEG
constexpr int kPadPos = INT_MAX;   // PAD_POS

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Butterfly reductions: each step combines the same two operands on both
// lanes of a pair, so every lane ends with bitwise the same result.
__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D, int BQ>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + kSub * (D + 4) + kSub * D + BQ * kSub) +
         sizeof(int) * (BQ + kSub + 2);
}

template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
roi_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ pos,
                     const int* __restrict__ kmin, T* __restrict__ out,
                     int* __restrict__ visited, int H, int nk, int bk,
                     int causal_skip, float scale) {
  constexpr int RW = BQ / kWarps;          // query rows per warp
  constexpr int DJ = (D + 31) / 32;        // accumulator columns per lane
  constexpr int KS = D + 4;                // padded k row, in floats
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // (BQ, D), pre-scaled
  float* ks = qs + BQ * D;                 // (kSub, KS)
  float* vs = ks + kSub * KS;              // (kSub, D)
  float* ps = vs + kSub * D;               // (BQ, kSub) probabilities
  int* posq = reinterpret_cast<int*>(ps + BQ * kSub);
  int* posk = posq + BQ;
  int* red = posk + kSub;                  // [0] max real pos_q, [1] hi

  const int qi = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = static_cast<size_t>(H) * D;   // one token's stride
  const size_t q0 = static_cast<size_t>(qi) * BQ;
  const T* qh = q + q0 * row + static_cast<size_t>(h) * D;

  if (tid == 0) {
    red[0] = -1;
    red[1] = 0;
  }
  __syncthreads();
  for (int r = tid; r < BQ; r += kThreads) {
    const int p = pos[q0 + r];
    posq[r] = p;
    if (p != kPadPos) atomicMax(&red[0], p);
  }
  for (int e = tid; e < BQ * D; e += kThreads)
    qs[e] = to_f32(qh[(e / D) * row + e % D]) * scale;
  __syncthreads();
  int hi = nk;
  if (causal_skip) {
    const int pmax = red[0];
    for (int j = tid; j < nk; j += kThreads)
      if (kmin[j] <= pmax) atomicMax(&red[1], j + 1);
    __syncthreads();
    hi = red[1];
  }

  float acc[RW][DJ], m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }
  const float* qw = qs + warp * RW * D;
  float* pw = ps + warp * RW * kSub;

  const int n_sub = hi * (bk / kSub);
  for (int sc = 0; sc < n_sub; ++sc) {
    const size_t k0 = static_cast<size_t>(sc) * kSub;
    __syncthreads();                       // the last sub-chunk is consumed
    const T* kh = k + k0 * row + static_cast<size_t>(h) * D;
    const T* vh = v + k0 * row + static_cast<size_t>(h) * D;
    for (int e = tid; e < kSub * D; e += kThreads) {
      const int c = e / D, d = e % D;
      ks[c * KS + d] = to_f32(kh[c * row + d]);
      vs[e] = to_f32(vh[c * row + d]);
    }
    if (tid < kSub) posk[tid] = pos[k0 + tid];
    __syncthreads();

    // scores: lane c takes key c against the warp's rows
    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float4* k4 = reinterpret_cast<const float4*>(ks + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = k4[d4];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(qw + r * D)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // the online-softmax step of each row over this sub-chunk
    const int pk = posk[lane];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float sv = posq[warp * RW + r] >= pk ? s[r] : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = expf(sv - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      pw[r * kSub + lane] = p;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
    }
    __syncwarp();

    // acc += p @ v, lane d on columns d, d + 32, ...
#pragma unroll 2
    for (int c = 0; c < kSub; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = lane + 32 * j;
        vv[j] = d < D ? vs[c * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float pc = pw[r * kSub + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(pc, vv[j], acc[r][j]);
      }
    }
  }

  T* oh = out + q0 * row + static_cast<size_t>(h) * D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) store(oh + (warp * RW + r) * row + d, acc[r][j] / denom);
    }
  }
  if (tid == 0) visited[static_cast<size_t>(h) * gridDim.x + qi] = hi;
}

template <typename T, int D, int BQ>
int launch(const void* q, const void* k, const void* v, const int* pos,
           const int* kmin, void* out, int* visited, int S, int H, int bk,
           int causal_skip, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, BQ>();
  auto kernel = roi_attention_kernel<T, D, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(S / BQ, H), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, kmin, static_cast<T*>(out), visited, H,
      S / bk, bk, causal_skip, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bq(int bq, const void* q, const void* k, const void* v,
              const int* pos, const int* kmin, void* out, int* visited, int S,
              int H, int bk, int causal_skip, float scale,
              cudaStream_t stream) {
  switch (bq) {
    case 32:
      return launch<T, D, 32>(q, k, v, pos, kmin, out, visited, S, H, bk,
                              causal_skip, scale, stream);
    case 64:
      return launch<T, D, 64>(q, k, v, pos, kmin, out, visited, S, H, bk,
                              causal_skip, scale, stream);
    case 128:
      return launch<T, D, 128>(q, k, v, pos, kmin, out, visited, S, H, bk,
                               causal_skip, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_d(int D, int bq, const void* q, const void* k, const void* v,
             const int* pos, const int* kmin, void* out, int* visited, int S,
             int H, int bk, int causal_skip, float scale,
             cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_bq<T, 16>(bq, q, k, v, pos, kmin, out, visited, S, H, bk,
                              causal_skip, scale, stream);
    case 32:
      return launch_bq<T, 32>(bq, q, k, v, pos, kmin, out, visited, S, H, bk,
                              causal_skip, scale, stream);
    case 64:
      return launch_bq<T, 64>(bq, q, k, v, pos, kmin, out, visited, S, H, bk,
                              causal_skip, scale, stream);
    case 128:
      return launch_bq<T, 128>(bq, q, k, v, pos, kmin, out, visited, S, H,
                               bk, causal_skip, scale, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B12: q, k, v (S, H, D) of one type (bf16 != 0: bfloat16, else float32),
// positions (S,), kmin (S / bk,) -> out (S, H, D), visited (H, S / bq).
// D in {16, 32, 64, 128}, bq in {32, 64, 128}, bk a multiple of 32, S a
// multiple of bq and bk (the wrapper checks all of it).
extern "C" int roi_attention_launch(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    const void* kmin, void* out,
                                    void* visited, int S, int H, int D,
                                    int bq, int bk, int causal_skip, int bf16,
                                    float scale, void* stream) {
  if (bk % kSub != 0 || S % bk != 0 || S % bq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* p = static_cast<const int*>(pos);
  const int* km = static_cast<const int*>(kmin);
  int* vis = static_cast<int*>(visited);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_d<__nv_bfloat16>(D, bq, q, k, v, p, km, out, vis, S, H, bk,
                                   causal_skip, scale, st);
  return launch_d<float>(D, bq, q, k, v, p, km, out, vis, S, H, bk,
                         causal_skip, scale, st);
}
