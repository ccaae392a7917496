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
//   past hi are fully masked for every real row, and a fully masked step is
//   an exact no-op once a real key has been folded in (p = exp(-1e30 - m)
//   = 0, alpha = exp(0) = 1, acc + 0 * v = acc), so skipped and exhaustive
//   runs give the same bits on real rows.  That needs a correctly rounded
//   exp and an online-softmax step that divides bk, so that a skipped walk
//   is a prefix of the exhaustive one: expf, no --use_fast_math, no __expf.
//
// What bounds it on the H100: operations.  At the serving slice's shape (S
// = 9,472, H = 48, D = 128, blocks of 128) the visited block pairs need
// 4*bq*bk*D FLOPs each, about 0.14 TFLOP, against 0.47 GB of q, k, v and
// output: on the CUDA cores (~17 TFLOP/s reached) that is 8 ms, on the
// tensor cores (989 TFLOP/s peak in bf16) a tenth of a millisecond.
//
// bf16, the serving type: the tensor cores.  One CTA per (q-block, head),
// one warp per 16 query rows (BQ / 16 warps), the grid walked from the last
// q-block to the first: in the packed layout the real rows come first, so
// the q-blocks with the longest walks start first and the short ones fill
// the tail.  The CTA finds hi itself, then streams its keys in steps of KT
// (64, or 32 where bk is not a multiple of 64), each step's k and v rows
// and positions brought by cp.async into a two-stage ring while the
// previous step is computed (one __syncthreads a step).  Each warp keeps
// its q rows as bf16 mma fragments in registers (ldmatrix, once) and takes
// S = q k^T with mma.sync m16n8k16 (bf16 in, f32 accumulation), scales the
// f32 scores by 1/sqrt(D) (not bf16 q, which would add a rounding), masks
// them on original positions, and runs the online softmax in registers:
// row max over the 4 lanes that share a row by symmetric __shfl_xor_sync,
// so every lane holds the same bits.  P @ V reuses the score fragments as
// the A operand.  p is split into bf16 hi + lo halves (two mma each), so
// the product carries p to ~2^-17: with p in one bf16 the per-element bar
// of the smoke (2^-7|want| + 1e-3) is exceeded even on normal inputs
// (rehearse_attention_rounding.py on the CPU: 1.44 to 3.06 of it on four
// kinds of inputs; hi + lo 0.77 to 0.89).  l sums the same hi + lo values.  Rows of k, v and q sit in shared memory padded by 16
// bytes, so the 8 rows an ldmatrix reads fall in 8 different bank groups.
//
// float32, a type only the tests use, keeps the CUDA-core design: the
// q-block in shared memory pre-scaled, keys in sub-chunks of 32 (lane =
// key for the scores, lane = column for p @ v), f32 FMAs.  TF32 could not
// meet its 2e-5 bar.
#include <atomic>
#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;     // the Pallas kernel's _NEG
constexpr int kPadPos = INT_MAX;   // PAD_POS

// Opts a kernel into ``smem`` bytes of dynamic shared memory on the current
// device, once per device: ``done`` is the caller's own bit set, one per
// kernel instance.
template <typename K>
cudaError_t opt_in_once(std::atomic<uint32_t>& done, K kernel, size_t smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
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

// Finds the CTA's visit bound hi from its q-block's positions (stored to
// posq) and kmin; red holds two ints of scratch.  Every thread returns hi.
__device__ __forceinline__ int visit_bound(const int* __restrict__ pos,
                                           const int* __restrict__ kmin,
                                           int* posq, int* red, size_t q0,
                                           int bq, int nk, int causal_skip) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    red[0] = -1;
    red[1] = 0;
  }
  __syncthreads();
  for (int r = tid; r < bq; r += nt) {
    const int p = pos[q0 + r];
    posq[r] = p;
    if (p != kPadPos) atomicMax(&red[0], p);
  }
  __syncthreads();
  if (!causal_skip) return nk;
  const int pmax = red[0];
  for (int j = tid; j < nk; j += nt)
    if (kmin[j] <= pmax) atomicMax(&red[1], j + 1);
  __syncthreads();
  return red[1];
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 32;           // keys per sub-chunk: one per lane

template <int D, int BQ>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (BQ * D + kSub * (D + 4) + kSub * D + BQ * kSub) +
         sizeof(int) * (BQ + kSub + 2);
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
roi_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ pos,
                  const int* __restrict__ kmin, float* __restrict__ out,
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
  const float* qh = q + q0 * row + static_cast<size_t>(h) * D;

  for (int e = tid; e < BQ * D; e += kThreads)
    qs[e] = qh[(e / D) * row + e % D] * scale;
  const int hi = visit_bound(pos, kmin, posq, red, q0, BQ, nk, causal_skip);

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
    const float* kh = k + k0 * row + static_cast<size_t>(h) * D;
    const float* vh = v + k0 * row + static_cast<size_t>(h) * D;
    for (int e = tid; e < kSub * D; e += kThreads) {
      const int c = e / D, d = e % D;
      ks[c * KS + d] = kh[c * row + d];
      vs[e] = vh[c * row + d];
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

  float* oh = out + q0 * row + static_cast<size_t>(h) * D;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = lane + 32 * j;
      if (d < D) oh[(warp * RW + r) * row + d] = acc[r][j] / denom;
    }
  }
  if (tid == 0) visited[static_cast<size_t>(h) * gridDim.x + qi] = hi;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, f32 accumulation)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// Splits (p0, p1) into bf16 hi and lo halves, packed with p0 in the low
// half as an mma operand wants it, and adds hi + lo of both to ``sum``.
__device__ __forceinline__ void split_p(float p0, float p1, uint32_t& hi,
                                        uint32_t& lo, float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
  const float2 lf = __bfloat1622float2(l);
  sum += (hf.x + lf.x) + (hf.y + lf.y);
  hi = as_u32(h);
  lo = as_u32(l);
}

template <int D, int BQ, int KT>
struct MmaTile {
  static constexpr int kThreads = 2 * BQ;        // one warp per 16 rows
  static constexpr int kRow = D + 8;             // padded row, in bf16
  static constexpr size_t kSmem =
      sizeof(bf16) * (BQ + 4 * KT) * kRow + sizeof(int) * (2 * KT + BQ + 2);
};

template <int D, int BQ, int KT>
__global__ void __launch_bounds__(MmaTile<D, BQ, KT>::kThreads, 1)
roi_attention_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ pos,
                   const int* __restrict__ kmin, bf16* __restrict__ out,
                   int* __restrict__ visited, int H, int nk, int bk,
                   int causal_skip, float scale) {
  constexpr int NT = MmaTile<D, BQ, KT>::kThreads;
  constexpr int DS = MmaTile<D, BQ, KT>::kRow;
  constexpr int CH = D / 8;        // 16-byte chunks per row
  constexpr int DK = D / 16;       // k-steps of q k^T, n-tile pairs of p v
  constexpr int DN = D / 8;        // output n-tiles
  constexpr int KN = KT / 8;       // score n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // (BQ, DS)
  bf16* ks = qs + BQ * DS;                         // 2 stages of (KT, DS)
  bf16* vs = ks + 2 * KT * DS;                     // 2 stages of (KT, DS)
  int* posk = reinterpret_cast<int*>(vs + 2 * KT * DS);   // 2 stages of KT
  int* posq = posk + 2 * KT;
  int* red = posq + BQ;

  const int h = blockIdx.x, nq = gridDim.y;
  const int qi = nq - 1 - blockIdx.y;              // longest walks first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t row = static_cast<size_t>(H) * D;   // one token's stride
  const size_t q0 = static_cast<size_t>(qi) * BQ;
  const size_t hd = static_cast<size_t>(h) * D;
  bf16* oh = out + q0 * row + hd;

  const int hi = visit_bound(pos, kmin, posq, red, q0, BQ, nk, causal_skip);
  if (tid == 0) visited[static_cast<size_t>(h) * nq + qi] = hi;
  if (hi == 0) {                                   // no real row: zeros
    for (int e = tid; e < BQ * CH; e += NT)
      *reinterpret_cast<uint4*>(oh + (e / CH) * row + (e % CH) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  const bf16* qh = q + q0 * row + hd;
  for (int e = tid; e < BQ * CH; e += NT)
    cp_async16(smem_u32(qs + (e / CH) * DS + (e % CH) * 8),
               qh + (e / CH) * row + (e % CH) * 8);
  auto load_step = [&](int step, int stage) {
    const size_t k0 = static_cast<size_t>(step) * KT;
    const bf16* kh = k + k0 * row + hd;
    const bf16* vh = v + k0 * row + hd;
    bf16* kst = ks + stage * KT * DS;
    bf16* vst = vs + stage * KT * DS;
    for (int e = tid; e < KT * CH; e += NT) {
      const int r = e / CH, c = (e % CH) * 8;
      cp_async16(smem_u32(kst + r * DS + c), kh + r * row + c);
      cp_async16(smem_u32(vst + r * DS + c), vh + r * row + c);
    }
    if (tid < KT / 4)
      cp_async16(smem_u32(posk + stage * KT + 4 * tid), pos + k0 + 4 * tid);
  };
  load_step(0, 0);
  cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  const int pq0 = posq[warp * 16 + g], pq1 = posq[warp * 16 + g + 8];
  uint32_t qf[DK][4];
  float o[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  const int n_steps = hi * (bk / KT);
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait_all();
    __syncthreads();               // step st landed; step st - 1 consumed
    if (st == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * DS + kk * 16 +
                         (lane >> 4) * 8),
                qf[kk]);
    }
    if (st + 1 < n_steps) {
      load_step(st + 1, (st + 1) & 1);
      cp_async_commit();
    }
    const bf16* kst = ks + (st & 1) * KT * DS;
    const bf16* vst = vs + (st & 1) * KT * DS;
    const int* pk = posk + (st & 1) * KT;

    // s = q k^T over this step's KT keys
    float s[KN][4];
#pragma unroll
    for (int j = 0; j < KN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(smem_u32(kst + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * DS +
                         kk * 16 + ((lane >> 3) & 1) * 8),
                b);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask on original positions, row maxima over the row's 4 lanes
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      const int pk0 = pk[j * 8 + 2 * t], pk1 = pk[j * 8 + 2 * t + 1];
      s[j][0] = pq0 >= pk0 ? s[j][0] * scale : kNeg;
      s[j][1] = pq0 >= pk1 ? s[j][1] * scale : kNeg;
      s[j][2] = pq1 >= pk0 ? s[j][2] * scale : kNeg;
      s[j][3] = pq1 >= pk1 ? s[j][3] * scale : kNeg;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
    }
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // o += p v, p as the A operand in bf16 hi + lo
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_p(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0], rs0);
      split_p(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1], rs1);
      split_p(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2], rs0);
      split_p(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3], rs1);
#pragma unroll
      for (int np = 0; np < DK; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(
            smem_u32(vst + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * DS +
                     np * 16 + (lane >> 4) * 8),
            b);
        mma_bf16(o[2 * np], ph, b[0], b[1]);
        mma_bf16(o[2 * np], pl, b[0], b[1]);
        mma_bf16(o[2 * np + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * np + 1], pl, b[2], b[3]);
      }
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* o0 = oh + (warp * 16 + g) * row + 2 * t;
  bf16* o1 = o0 + 8 * row;
#pragma unroll
  for (int n = 0; n < DN; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(o0 + n * 8) =
        __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(o1 + n * 8) =
        __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  const int *pos, *kmin;
  void* out;
  int* visited;
  int S, H, bk, causal_skip;
  float scale;
  cudaStream_t stream;
};

template <int D, int BQ>
int launch_f32(const Args& a) {
  static std::atomic<uint32_t> opted{0};
  constexpr size_t smem = f32_smem_bytes<D, BQ>();
  auto kernel = roi_attention_f32<D, BQ>;
  cudaError_t err = opt_in_once(opted, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.S / BQ, a.H), kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.pos, a.kmin,
      static_cast<float*>(a.out), a.visited, a.H, a.S / a.bk, a.bk,
      a.causal_skip, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ, int KT>
int launch_bf16(const Args& a) {
  static std::atomic<uint32_t> opted{0};
  constexpr size_t smem = MmaTile<D, BQ, KT>::kSmem;
  auto kernel = roi_attention_bf16<D, BQ, KT>;
  cudaError_t err = opt_in_once(opted, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(a.H, a.S / BQ), MmaTile<D, BQ, KT>::kThreads, smem,
           a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), a.pos, a.kmin, static_cast<bf16*>(a.out),
      a.visited, a.H, a.S / a.bk, a.bk, a.causal_skip, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ>
int launch_type(int bf16_in, const Args& a) {
  if (!bf16_in) return launch_f32<D, BQ>(a);
  // the online-softmax step divides bk: a skipped walk is a prefix
  if (a.bk % 64 == 0) return launch_bf16<D, BQ, 64>(a);
  return launch_bf16<D, BQ, 32>(a);
}

template <int D>
int launch_bq(int bq, int bf16_in, const Args& a) {
  switch (bq) {
    case 32: return launch_type<D, 32>(bf16_in, a);
    case 64: return launch_type<D, 64>(bf16_in, a);
    case 128: return launch_type<D, 128>(bf16_in, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B12: q, k, v (S, H, D) of one type (bf16 != 0: bfloat16, else float32),
// positions (S,), kmin (S / bk,) -> out (S, H, D), visited (H, S / bq).
// D in {16, 32, 64, 128}, bq in {32, 64, 128}, bk a multiple of 32, S a
// multiple of bq and bk, every pointer 16-byte aligned (the wrapper checks
// all of it).
extern "C" int roi_attention_launch(const void* q, const void* k,
                                    const void* v, const void* pos,
                                    const void* kmin, void* out,
                                    void* visited, int S, int H, int D,
                                    int bq, int bk, int causal_skip, int bf16,
                                    float scale, void* stream) {
  if (bk % kSub != 0 || S % bk != 0 || S % bq != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(pos),
               static_cast<const int*>(kmin), out, static_cast<int*>(visited),
               S, H, bk, causal_skip, scale,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 16: return launch_bq<16>(bq, bf16, a);
    case 32: return launch_bq<32>(bq, bf16, a);
    case 64: return launch_bq<64>(bq, bf16, a);
    case 128: return launch_bq<128>(bq, bf16, a);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
