// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry
// point (loaded with ctypes, see kernels/_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_kernel).  Same function:
// softmax(q k^T / sqrt(D) + mask) v with an fp32 online softmax, GQA through
// kv head h / (H/K), causal and sliding-window masks (kpos <= qpos,
// kpos > qpos - window), k-tiles outside those limits skipped, a row that no
// key reaches gives 0.  Unlike the Pallas kernel it takes any S >= 1: keys
// kpos >= S are masked and rows qpos >= S are never stored.  q, k and v are
// read in their (B,S,H,D) layout through strides, with no copy (the JAX
// wrapper swaps axes; this kernel does not need to).  The TPU's sequential k
// grid dimension becomes a loop inside the block over the k-tiles between
// the causal and window limits.
//
// Three kernels, chosen by dtype and head dim in the C entry point at the
// bottom (no fall-back from one to another):
//
//  * bfloat16 at D = 64, 128 and 256 (the serving path: olmo-1b prefill at
//    D=128, recurrentgemma-2b at D=256): fa_fwd_wgmma, built the way
//    Hopper is fed.
//      - What bounds it: at the olmo-1b prefill shape (B=4, S=512, H=K=16,
//        D=128, causal) bytes (33.5 MB, 10 us at 3.35 TB/s, against 4.3
//        GFLOP, 4.4 us at 989 TFLOP/s); at the recurrentgemma-2b shape (B=4,
//        S=2600, H=10, K=1, D=256, window 2048) operations (132.2 GFLOP,
//        0.134 ms).  The first wants loads in flight while the tensor cores
//        run, the second the wgmma rate, which mma.sync cannot reach.
//      - Block: 384 threads, one block per (q-tile of 128 rows, head,
//        batch), the last q-tiles (the longest causal rows) first.
//        Warpgroup 0 is the producer: one of its threads issues TMA
//        (cp.async.bulk.tensor) loads from host-built 4-D tensor maps over
//        (D, heads, S, B) with the tensors' own strides, passed as
//        __grid_constant__ arguments.  Q arrives once; K and V go through a
//        ring of 2 stages with an mbarrier each for "K full" and "V full"
//        (arrive.expect_tx, completed by the TMA's bytes) and one "empty"
//        per stage that the 8 consumer warps arrive on when a stage is read.
//        Warpgroups 1 and 2 are consumers of 64 query rows each.
//        setmaxnreg gives the producer 40 registers and each consumer 232.
//      - Shared memory: 128-byte swizzle, which wgmma's descriptors read
//        without bank conflicts.  A 128-byte box is 64 bf16, so a row of
//        D=128 is 2 boxes and of D=256 4, each box a tile of its own
//        (rows x 128 bytes, 1024-byte aligned).  TMA fills rows past S with
//        zeros; keys past S are still masked, since a zero key scores 0,
//        not -inf.
//      - S = Q K^T with wgmma m64n64k16, A = Q and B = K both from shared
//        memory, K-major; O += P V with wgmma m64n64k16 (D=64) or
//        m64n128k16 (D=128; two of them, one per half of O, at D=256), A =
//        P from registers (the fp32 scores turned into bf16 A fragments in
//        place, as the model path rounds them; the Pallas kernel keeps
//        them fp32, so the two differ at bf16 rounding, within 2e-2), B = V
//        from shared memory, MN-major (transpose flag 1).  wgmma.wait_group
//        before the softmax reads S and before the stage is released.
//      - Tiles: BQ = 128, BK = 64 keys at every head dim (BK = 128 was
//        slower at the olmo-1b shape in trial builds).  Per consumer
//        thread: S 32 registers, P 16, O D/2.  Shared memory 97 KB at
//        D=128 and 193 KB at D=256; one block of 3 warpgroups per SM,
//        bound by registers (384 x 168).
//      - Mask arithmetic runs only on k-tiles that cross a limit of some
//        row of the warpgroup (the causal diagonal, the window's lower
//        edge, the ragged end of S); a tile none of its rows sees is
//        skipped, its barriers kept in step.
//      - Not yet: overlap of one warpgroup's softmax with its own or the
//        other's wgmma (ping-pong), persistent blocks, packing the query
//        heads of one kv head (recurrentgemma's 10 on 1) into one block.
//  * bfloat16 at D = 16 and 32 (smoke configurations and tests only):
//    fa_fwd_bf16, mma.sync m16n8k16 (bf16 in, fp32 accumulate), 4 warps of
//    16 query rows, tiles of 64 loaded synchronously into padded shared
//    memory.  Too narrow for a 128-byte box.
//  * float32 at every head dim (the slices' fp32 exactness checks):
//    fa_fwd_f32, scalar fp32 FMAs only, no TF32 and no tensor cores, so it
//    meets 2e-5 against the plain version.  Q (pre-scaled), K, V and the
//    score tile sit in shared memory as fp32, the row statistics too; each
//    thread owns 4 rows x D/8 columns of the output.  At D=256 that is
//    214.5 KB of shared memory, so one block runs per SM.
//
// Every launch raises its kernel's dynamic shared-memory limit first (all
// but the smallest tiles are above the 48 KB default).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block (fp32, mma.sync)
constexpr int BK = 64;        // key rows per k-tile (fp32, mma.sync)
constexpr int THREADS = 128;  // 4 warps (fp32, mma.sync)
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
// bfloat16 at D = 16 and 32: mma.sync m16n8k16 (bf16 in, fp32 accumulate)
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
  static_assert(D <= 32, "wider heads go to fa_fwd_wgmma");
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
  // this warp's 16 query rows as A fragments, kept in registers
  const int r0 = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) load_a_frag<D>(qf[kk], sQ, r0, kk);

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
#pragma unroll
      for (int n = 0; n < NT_S; ++n) {
        const uint16_t* p = sK + (n * 8 + g) * RS + kk * 16 + t4 * 2;
        mma_16816(sacc[n], qf[kk], ld32(p), ld32(p + 8));
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
// bfloat16 at D = 64, 128, 256: TMA, wgmma and a producer warpgroup
// ---------------------------------------------------------------------------

template <int D>
struct Wg {
  static constexpr int BQ = 128;              // 2 consumer warpgroups x 64
  static constexpr int BK = 64;               // keys per k-tile
  static constexpr int STAGES = 2;            // K/V ring depth
  static constexpr int BOXES = D / 64;        // 128-byte boxes per row
  // O in chunks of ON columns, one wgmma m64nONk16 per chunk and k-step
  static constexpr int ON = D > 128 ? 128 : D;
  static constexpr int NO = D / ON;
  static constexpr int THREADS = 384;         // producer + 2 consumers
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2; // one K or one V tile
  // 1024 bytes of slack to align the tiles to the swizzle atom, the tiles,
  // then the barriers: Q full, K full and V full per stage, empty per stage
  static constexpr size_t bytes =
      1024 + Q_BYTES + size_t(2) * STAGES * KV_BYTES + (1 + 3 * STAGES) * 8;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = 232;
};
static_assert(Wg<256>::bytes <= 232448, "D=256 tiles too large");
static_assert(Wg<128>::bytes <= 232448, "D=128 tiles too large");
// the registers a block holds at launch (168 a thread, the most that
// __launch_bounds__(384, 1) allows) are what setmaxnreg redistributes
static_assert(128 * Wg<128>::PRODUCER_REGS + 256 * Wg<128>::CONSUMER_REGS <=
                  384 * 168,
              "setmaxnreg split exceeds the block's registers");

template <int D>
__global__ void __launch_bounds__(Wg<D>::THREADS, 1)
    fa_fwd_wgmma(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 __nv_bfloat16* __restrict__ o, int S, int group,
                 int64_t osb, int64_t oss, int64_t osh, int causal,
                 int window, float scale_log2) {
  using C = Wg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, ST = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + C::Q_BYTES;          // stage s at sK + s * KV_BYTES
  uint8_t* sV = sK + ST * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + ST * C::KV_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + ST;
  uint64_t* empty = v_full + ST;

  // heaviest causal q-tiles first: the last q-tile runs as grid z = 0
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;

  // the block's k-tiles: those any of its rows can see
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int t_lo = k_lo / BK;
  const int n_tiles = (k_hi + BK - 1) / BK - t_lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // one if/else for the whole kernel, so that ptxas can apply setmaxnreg
  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring filled ----------
    hopper::setmaxnreg_dec<C::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tensormap(&mq);
      hopper::prefetch_tensormap(&mk);
      hopper::prefetch_tensormap(&mv);
      const int kvh = h / group;
      hopper::mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int j = 0; j < C::BOXES; ++j)
        hopper::tma_load_4d(sQ + j * BQ * 128, &mq, q_full, 64 * j, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        const int k0 = (t_lo + i) * BK;
        // wait until both consumers are done with this stage's last tile
        if (i >= ST) hopper::mbar_wait(&empty[s], ((i / ST) - 1) & 1);
        uint8_t* dk = sK + s * C::KV_BYTES;
        uint8_t* dv = sV + s * C::KV_BYTES;
        hopper::mbar_expect_tx(&k_full[s], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::BOXES; ++j)
          hopper::tma_load_4d(dk + j * BK * 128, &mk, &k_full[s], 64 * j, kvh,
                              k0, b);
        hopper::mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int j = 0; j < C::BOXES; ++j)
          hopper::tma_load_4d(dv + j * BK * 128, &mv, &v_full[s], 64 * j, kvh,
                              k0, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ------------------------
    hopper::setmaxnreg_inc<C::CONSUMER_REGS>();
    const int cw = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int t4 = lane & 3;
    const int wq0 = q0 + 64 * cw;
    // this thread's rows: wq0 + 16 warp + lane / 4, and 8 below it
    const int qrow[2] = {wq0 + 16 * warp + (lane >> 2),
                         wq0 + 16 * warp + (lane >> 2) + 8};
    // the keys this warpgroup's rows can see: [wk_lo, wk_hi)
    int wk_lo = 0, wk_hi = S;
    if (causal) wk_hi = min(S, wq0 + 64);
    if (window > 0) wk_lo = max(0, wq0 - window + 1);
    const bool active = wq0 < S;

    float oacc[C::NO][C::ON / 2];
#pragma unroll
    for (int c = 0; c < C::NO; ++c)
#pragma unroll
      for (int i = 0; i < C::ON / 2; ++i) oacc[c][i] = 0.f;
    // statistics of the two rows, the same in all 4 lanes of a quad: the
    // running max of the unscaled scores and the running sum of p
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    const uint32_t q_addr = hopper::smem_u32(sQ) + cw * 64 * 128;
    const uint32_t k_addr = hopper::smem_u32(sK);
    const uint32_t v_addr = hopper::smem_u32(sV);

    hopper::mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % ST;
      const uint32_t parity = (i / ST) & 1;
      const int k0 = (t_lo + i) * BK;
      if (active && k0 < wk_hi && k0 + BK > wk_lo) {
        // S = Q K^T: 64 x BK, D / 16 k-steps, both operands K-major
        hopper::mbar_wait(&k_full[s], parity);
        float sacc[BK / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          hopper::wgmma_ss(
              sacc,
              hopper::make_desc(q_addr + (kk / 4) * BQ * 128 + (kk % 4) * 32,
                                16, 1024),
              hopper::make_desc(k_addr + s * C::KV_BYTES +
                                    (kk / 4) * BK * 128 + (kk % 4) * 32,
                                16, 1024),
              kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sacc);

        // mask only the tiles that cross a limit of some row of this
        // warpgroup (the ragged end of S, the causal diagonal, the window's
        // lower edge); the row max over the quad, on the unscaled scores
        const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > wq0) ||
                          (window > 0 && k0 <= wq0 + 63 - window);
        float mx[2] = {NEG_INF, NEG_INF};
        if (edge) {
#pragma unroll
          for (int n = 0; n < BK / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = qrow[e >> 1];
              const int key = k0 + n * 8 + t4 * 2 + (e & 1);
              const bool ok = key < S && (!causal || key <= row) &&
                              (window <= 0 || key > row - window);
              if (!ok) sacc[4 * n + e] = NEG_INF;
            }
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * n + e]);
        // p = 2^(s scale_log2 - m scale_log2), one FFMA and one exp2 a score
        float alpha[2], base[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          // a row no key has reached yet keeps m = NEG_INF: subtracting 0
          // leaves its masked scores hugely negative, their exp2 exactly 0
          base[r] = m_new == NEG_INF ? 0.f : m_new * scale_log2;
          alpha[r] = exp2f((m[r] - m_new) * scale_log2);
          m[r] = m_new;
        }
#pragma unroll
        for (int n = 0; n < BK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                exp2f(fmaf(sacc[4 * n + e], scale_log2, -base[e >> 1]));
            sacc[4 * n + e] = p;
            rsum[e >> 1] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
          rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
          l[r] = l[r] * alpha[r] + rsum[r];
        }
#pragma unroll
        for (int c = 0; c < C::NO; ++c)
#pragma unroll
          for (int n = 0; n < C::ON / 8; ++n) {
            oacc[c][4 * n + 0] *= alpha[0];
            oacc[c][4 * n + 1] *= alpha[0];
            oacc[c][4 * n + 2] *= alpha[1];
            oacc[c][4 * n + 3] *= alpha[1];
          }
        // P in bf16 as wgmma A fragments: the score columns of key tiles 2j
        // and 2j+1 are the A fragment of k-step j
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          pa[j][0] = pack_bf16(sacc[8 * j + 0], sacc[8 * j + 1]);
          pa[j][1] = pack_bf16(sacc[8 * j + 2], sacc[8 * j + 3]);
          pa[j][2] = pack_bf16(sacc[8 * j + 4], sacc[8 * j + 5]);
          pa[j][3] = pack_bf16(sacc[8 * j + 6], sacc[8 * j + 7]);
        }

        // O += P V: 64 x D, BK / 16 k-steps, V MN-major (transpose flag 1)
        hopper::mbar_wait(&v_full[s], parity);
#pragma unroll
        for (int c = 0; c < C::NO; ++c) hopper::fence_regs(oacc[c]);
        hopper::fence_regs(pa);
        hopper::wgmma_fence();
#pragma unroll
        for (int j = 0; j < BK / 16; ++j)
#pragma unroll
          for (int c = 0; c < C::NO; ++c)
            hopper::wgmma_rs(
                oacc[c], pa[j],
                hopper::make_desc(v_addr + s * C::KV_BYTES + j * 16 * 128 +
                                      c * (C::ON / 64) * BK * 128,
                                  BK * 128, 1024),
                1);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int c = 0; c < C::NO; ++c) hopper::fence_regs(oacc[c]);
      } else {
        // a tile none of this warpgroup's rows sees: keep the barrier
        // phases in step with the other consumer and release the stage
        hopper::mbar_wait(&k_full[s], parity);
        hopper::mbar_wait(&v_full[s], parity);
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[s]);
    }

    __nv_bfloat16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] >= S) continue;
      const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
      __nv_bfloat16* orow = ob + qrow[r] * oss + t4 * 2;
#pragma unroll
      for (int c = 0; c < C::NO; ++c)
#pragma unroll
        for (int n = 0; n < C::ON / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + c * C::ON + n * 8) =
              pack_bf16(oacc[c][4 * n + 2 * r] * inv,
                        oacc[c][4 * n + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// error codes past cudaError_t's range, decoded by repro_cuda_error_string
constexpr int ERR_NO_ENCODER = 100000;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 200000;  // + the CUresult it returned

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up once in the libcuda.so.1 that the
// CUDA runtime has loaded: the kernel library links no libcuda itself.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 4-D map over (D, heads, S, B) of a (B,S,heads,D) bf16 tensor with
// element strides (sb, ss, sh, 1), in boxes of 64 x 1 x rows x 1: 128
// bytes wide, 128-byte swizzle, zeros outside the tensor.
int make_map(CUtensorMap* map, const void* ptr, int D, int heads, int S,
             int B, int64_t sb, int64_t ss, int64_t sh, int rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  // a dimension of size 1 is never stepped: whatever stride the tensor
  // gives it, the map gets that of the contiguous layout
  if (heads == 1) sh = D;
  if (S == 1) ss = int64_t(heads) * D;
  if (B == 1) sb = int64_t(S) * heads * D;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads),
                              cuuint64_t(S), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2,
                                 cuuint64_t(sb) * 2};  // bytes
  const cuuint32_t box[4] = {64, 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + int(r);
}

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KH, const int64_t* st, int causal,
               int window, float scale, cudaStream_t stream) {
  auto kern = fa_fwd_f32<D>;
  const size_t smem = Layout<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H / KH, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int S, int H, int KH, const int64_t* st, int causal,
               int window, float scale, cudaStream_t stream) {
  auto kern = fa_fwd_bf16<D>;
  const size_t smem = MmaLayout<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      S, H / KH, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, window, scale * LOG2E);
  return int(cudaGetLastError());
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KH, const int64_t* st, int causal,
                 int window, float scale, cudaStream_t stream) {
  using C = Wg<D>;
  CUtensorMap mq, mk, mv;
  int err = make_map(&mq, q, D, H, S, B, st[0], st[1], st[2], C::BQ);
  if (err == 0) err = make_map(&mk, k, D, KH, S, B, st[3], st[4], st[5], C::BK);
  if (err == 0) err = make_map(&mv, v, D, KH, S, B, st[6], st[7], st[8], C::BK);
  if (err != 0) return err;
  auto kern = fa_fwd_wgmma<D>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(H, B, (S + C::BQ - 1) / C::BQ);
  kern<<<grid, C::THREADS, C::bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), S, H / KH, st[9], st[10],
      st[11], causal, window, scale * LOG2E);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements and the head
// dim is contiguous; for bfloat16 the pointers are 16-byte aligned and the
// strides multiples of 8 (what TMA requires of a tensor map).  window <= 0
// means no window.  Launches on `stream`, does not synchronise, returns 0
// on success, else a cudaError_t or one of the ERR_ codes above.
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
#define ARGS q, k, v, o, B, S, H, KH, st, causal, window, scale, s
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(ARGS);
      case 32: return launch_f32<32>(ARGS);
      case 64: return launch_f32<64>(ARGS);
      case 128: return launch_f32<128>(ARGS);
      case 256: return launch_f32<256>(ARGS);
      default: return int(cudaErrorInvalidValue);
    }
  }
  // bfloat16: mma.sync below a 128-byte row, TMA and wgmma from D=64 up
  switch (D) {
    case 16: return launch_mma<16>(ARGS);
    case 32: return launch_mma<32>(ARGS);
    case 64: return launch_wgmma<64>(ARGS);
    case 128: return launch_wgmma<128>(ARGS);
    case 256: return launch_wgmma<256>(ARGS);
    default: return int(cudaErrorInvalidValue);
  }
#undef ARGS
}

const char* repro_cuda_error_string(int err) {
  static thread_local char buf[96];
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (err >= ERR_TENSOR_MAP) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             err - ERR_TENSOR_MAP);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
