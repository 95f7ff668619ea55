// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry
// point (loaded with ctypes, see kernels/_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_kernel).  Same function:
// softmax(q k^T / sqrt(D) + mask) v with an fp32 online softmax, GQA through
// kv head h / (H/K), causal and sliding-window masks (kpos <= qpos,
// kpos > qpos - window), k-tiles outside those limits skipped, a row that no
// key reaches gives 0.  Unlike the Pallas kernel it takes any S >= 1: the
// last k-tile masks kpos >= S and rows qpos >= S are never stored.
//
// Design for the card, not carried over block by block:
//  * One block of 128 threads (4 warps) per (q-tile of 64 rows, head,
//    batch).  The TPU's sequential k grid dimension becomes a loop inside
//    the block over the 64-key tiles between the causal and window limits.
//  * q, k and v are read in their (B,S,H,D) layout through strides: no
//    transposes (the JAX wrapper swaps axes; this kernel does not need to).
//  * bfloat16 (the serving path): tensor cores through mma.sync m16n8k16
//    (bf16 in, fp32 accumulate).  Q, K and V tiles sit in shared memory as
//    bf16 with rows padded by 16 bytes against bank conflicts; each warp
//    owns 16 query rows, keeps its 16 x 64 score tile, the row max and sum
//    and its 16 x D output accumulator in registers, and turns the fp32
//    probabilities into bf16 A fragments in registers for the PV product
//    (as the model path does; the Pallas kernel keeps them fp32, so the
//    two differ at bf16 rounding, within 2e-2).  Up to D=128 the warp also
//    keeps its Q fragments in registers.  At D=256 (recurrentgemma) the
//    output accumulator alone takes 128 registers a thread (D/8 n-tiles x
//    4) and the Q fragments would take 64 more, past the 255 limit: there
//    each k-step reloads its 4 Q fragment registers from the shared Q tile
//    instead, which keeps the kernel free of spills.
//  * float32: scalar fp32 FMAs only, no TF32 and no tensor cores, so the
//    fp32 path meets 2e-5 against the plain version.  Q (pre-scaled), K, V
//    and the score tile sit in shared memory as fp32, the row statistics
//    too; each thread owns 4 rows x D/8 columns of the output.  At D=256
//    that is 214.5 KB of shared memory, under the 227 KB a block may have,
//    so one block runs per SM.
//
// What bounds it on an H100: at the olmo-1b prefill shape (B=4, S=512,
// H=K=16, D=128, bf16) the roofline bound is memory (about 33.5 MB against
// 4.3 GFLOP of causal work, 10 us against 4.4 us).  This version loads each
// tile synchronously and has no copy/compute overlap, so it runs well above
// that bound: it relies on several blocks per SM to hide load latency.
// TMA-fed tiles, wgmma and a producer warp are the later step.  At D=128
// the fp32 tiles take about 113 KB and the bf16 ones 51 KB of shared
// memory (at D=256, 214.5 KB and 99 KB), above the 48 KB default, so each
// launch raises the dynamic shared-memory limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per k-tile
constexpr int THREADS = 128;  // 4 warps
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int QS = D + 1;   // padded row stride of the Q and K tiles
  static constexpr int PS = BK + 1;  // padded row stride of the score tile
  static constexpr size_t floats =
      size_t(BQ) * QS + size_t(BK) * QS + size_t(BK) * D + size_t(BQ) * PS +
      3 * BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};
// the most dynamic shared memory a block may have on sm_90
static_assert(Layout<256>::bytes <= 232448, "fp32 tiles at D=256 too large");

// ---------------------------------------------------------------------------
// float32: scalar FMA kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
    fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, int S,
                  int group, int64_t qsb, int64_t qss, int64_t qsh,
                  int64_t ksb, int64_t kss, int64_t ksh, int64_t vsb,
                  int64_t vss, int64_t vsh, int64_t osb, int64_t oss,
                  int64_t osh, int causal, int window, float scale) {
  using L = Layout<D>;
  constexpr int NJ = D / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;               // [BQ][QS], q * scale
  float* sK = sQ + BQ * L::QS;    // [BK][QS]
  float* sV = sK + BK * L::QS;    // [BK][D]
  float* sP = sV + BK * D;        // [BQ][PS] scores, then probabilities
  float* sM = sP + BQ * L::PS;    // running max per row
  float* sL = sM + BQ;            // running sum per row
  float* sA = sL + BQ;            // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + kvh * ksh;
  const float* vb = v + b * vsb + kvh * vsh;
  float* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int qpos = q0 + r;
    sQ[r * L::QS + c] = qpos < S ? qb[qpos * qss + c] * scale : 0.f;
  }
  if (tid < BQ) {
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
  }

  // thread tile: rows tr*4 .. tr*4+3, columns tc + 8*j
  const int tr = tid / 8;
  const int tc = tid % 8;
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // keys this q-tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_hi = (k_hi + BK - 1) / BK;

  for (int t = k_lo / BK; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // last tile's sP/sV reads done; Q and stats visible
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int kpos = k0 + r;
      const bool in = kpos < S;
      sK[r * L::QS + c] = in ? kb[kpos * kss + c] : 0.f;
      sV[r * D + c] = in ? vb[kpos * vss + c] : 0.f;
    }
    __syncthreads();

    // scores s = (q * scale) . k for 4 x 8 (row, key) pairs per thread
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(tr * 4 + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tc + 8 * j) * L::QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tc + 8 * j;
        const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        sP[(tr * 4 + i) * L::PS + tc + 8 * j] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w*16 .. w*16+15; a lane takes
    // columns lane and lane+32 of a row
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int rr = 0; rr < BQ / 4; ++rr) {
        const int r = warp * (BQ / 4) + rr;
        float* row = sP + r * L::PS;
        const float m_prev = sM[r];
        const float x0 = row[lane], x1 = row[lane + 32];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_prev, mx);
        // a row no key has reached yet keeps p exactly 0
        const float p0 = m_new == NEG_INF ? 0.f : expf(x0 - m_new);
        const float p1 = m_new == NEG_INF ? 0.f : expf(x1 - m_new);
        row[lane] = p0;
        row[lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        __syncwarp();
        if (lane == 0) {
          const float alpha = m_prev == NEG_INF ? 0.f : expf(m_prev - m_new);
          sA[r] = alpha;
          sL[r] = sL[r] * alpha + sum;
          sM[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = sA[tr * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(tr * 4 + i) * L::PS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = sV[kk * D + tc + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i;
    const int qpos = q0 + r;
    if (qpos >= S) continue;
    const float l = sL[r];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      ob[qpos * oss + tc + 8 * j] = l == 0.f ? 0.f : acc[i][j] / l;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel (mma.sync m16n8k16, bf16 in, fp32 accumulate)
// ---------------------------------------------------------------------------

template <int D>
struct MmaLayout {
  static constexpr int RS = D + 8;  // padded row stride, bf16 elements
  static constexpr size_t bytes = size_t(3) * BQ * RS * sizeof(uint16_t);
};

// c += a * b for one 16x8x16 tile; fragment layouts as in the PTX ISA
// (g = lane / 4, t = lane % 4): a0 (row g, k 2t..2t+1), a1 (row g+8),
// a2 (row g, k 2t+8..), a3 (row g+8, k 2t+8..); b0 (k 2t..2t+1, col g),
// b1 (k 2t+8..); c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8).
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even) in one register, the
// first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragment of k-step kk for rows [r0, r0+16) of a padded shared tile
template <int D>
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const uint16_t* s,
                                            int r0, int kk) {
  constexpr int RS = MmaLayout<D>::RS;
  const int lane = threadIdx.x % 32;
  const uint16_t* p = s + (r0 + (lane >> 2)) * RS + kk * 16 + (lane & 3) * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * RS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * RS + 8);
}

// rows [r0, r0+64) of a (S, D) bf16 matrix with row stride `rs` into a
// padded shared tile; rows >= S become zeros.  16-byte loads.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst,
                                          const __nv_bfloat16* src,
                                          int64_t rs, int r0, int S) {
  constexpr int RS = MmaLayout<D>::RS;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BQ * VPR; i += THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * RS + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    fa_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, int S, int group, int64_t qsb,
                int64_t qss, int64_t qsh, int64_t ksb, int64_t kss,
                int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh,
                int64_t osb, int64_t oss, int64_t osh, int causal,
                int window, float scale_log2) {
  constexpr int RS = MmaLayout<D>::RS;
  constexpr int KSTEPS = D / 16;  // k-steps of q.k
  constexpr int NT_S = BK / 8;    // 8-key column tiles of the scores
  constexpr int NT_O = D / 8;     // 8-wide column tiles of the output
  extern __shared__ __align__(16) uint16_t smem16[];
  uint16_t* sQ = smem16;          // [BQ][RS]
  uint16_t* sK = sQ + BQ * RS;    // [BK][RS]
  uint16_t* sV = sK + BK * RS;    // [BK][RS]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const __nv_bfloat16* kb = k + b * ksb + kvh * ksh;
  const __nv_bfloat16* vb = v + b * vsb + kvh * vsh;
  __nv_bfloat16* ob = o + b * osb + h * osh;

  load_tile<D>(sQ, q + b * qsb + h * qsh, qss, q0, S);
  __syncthreads();
  // this warp's 16 query rows as A fragments: kept in registers up to
  // D=128, reloaded from sQ at each k-step above (see the note at the top)
  const int r0 = warp * 16;
  constexpr bool Q_IN_REGS = D <= 128;
  uint32_t qf[Q_IN_REGS ? KSTEPS : 1][4];
  if constexpr (Q_IN_REGS) {
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) load_a_frag<D>(qf[kk], sQ, r0, kk);
  }

  float oacc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  // statistics of rows g and g+8 (log2 domain), the same in all 4 lanes
  // of a quad
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_hi = (k_hi + BK - 1) / BK;

  for (int t = k_lo / BK; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the last K and V tiles
    load_tile<D>(sK, kb, kss, k0, S);
    load_tile<D>(sV, vb, vss, k0, S);
    __syncthreads();

    float sacc[NT_S][4];
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
      } else {
        load_a_frag<D>(qa, sQ, r0, kk);
      }
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const uint16_t* p = sK + (n * 8 + g) * RS + kk * 16 + t4 * 2;
        mma_16816(sacc[n], qa, ld32(p), ld32(p + 8));
      }
    }

    // mask, scale into the log2 domain, row max over the quad
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = qrow[e >> 1];
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        const bool ok = key < S && (!causal || key <= row) &&
                        (window <= 0 || key > row - window);
        sacc[n][e] = ok ? sacc[n][e] * scale_log2 : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
      }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = m[r] == NEG_INF ? 0.f : exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT_S; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        // a row no key has reached yet keeps p exactly 0
        const float p = m[r] == NEG_INF ? 0.f : exp2f(sacc[n][e] - m[r]);
        sacc[n][e] = p;
        rsum[r] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      l[r] = l[r] * alpha[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // o += p v: the score C fragments of key tiles 2j and 2j+1 are the A
    // fragment of k-step j; V's B fragments pair two key rows per register
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(sacc[2 * j][0], sacc[2 * j][1]),
                              pack_bf16(sacc[2 * j][2], sacc[2 * j][3]),
                              pack_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1]),
                              pack_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3])};
      const uint16_t* vp = sV + (j * 16 + t4 * 2) * RS + g;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        const uint16_t* p = vp + n * 8;
        const uint32_t b0 = uint32_t(p[0]) | (uint32_t(p[RS]) << 16);
        const uint32_t b1 =
            uint32_t(p[8 * RS]) | (uint32_t(p[9 * RS]) << 16);
        mma_16816(oacc[n], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= S) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    __nv_bfloat16* orow = ob + qrow[r] * oss + t4 * 2;
#pragma unroll
    for (int n = 0; n < NT_O; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(oacc[n][2 * r] * inv, oacc[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int D>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v,
                   void* o, int B, int S, int H, int KH, const int64_t* st,
                   int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  cudaError_t err;
  if (dtype == 0) {
    auto kern = fa_fwd_f32<D>;
    const size_t smem = Layout<D>::bytes;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H / KH,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
        st[10], st[11], causal, window, scale);
  } else {
    auto kern = fa_fwd_bf16<D>;
    const size_t smem = MmaLayout<D>::bytes;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(o), S, H / KH, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        causal, window, scale * 1.4426950408889634f);  // * log2(e)
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements and the head
// dim is contiguous; for bfloat16 the pointers are 16-byte aligned and the
// strides multiples of 8.  window <= 0 means no window.  Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t (0 on
// success).
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int S, int H, int KH, int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh, int causal,
    int window, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || KH < 1 || H % KH != 0 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return int(launch<16>(dtype, q, k, v, o, B, S, H, KH, st, causal,
                            window, scale, s));
    case 32:
      return int(launch<32>(dtype, q, k, v, o, B, S, H, KH, st, causal,
                            window, scale, s));
    case 64:
      return int(launch<64>(dtype, q, k, v, o, B, S, H, KH, st, causal,
                            window, scale, s));
    case 128:
      return int(launch<128>(dtype, q, k, v, o, B, S, H, KH, st, causal,
                             window, scale, s));
    case 256:
      return int(launch<256>(dtype, q, k, v, o, B, S, H, KH, st, causal,
                             window, scale, s));
    default:
      return int(cudaErrorInvalidValue);
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
