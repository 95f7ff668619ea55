// WKV6 recurrence for Hopper (sm_90a), CUDA C++ with a plain C entry point
// (loaded with ctypes, see kernels/_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py:80
// (wkv6_kernel, body _wkv6_kernel at :30).  Same function, RWKV6's linear
// attention with a data-dependent decay and a (D,D) matrix state per head:
//
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,             S_{-1} = 0
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// for r, k, v, w of shape (B,H,S,D) in float32 or bfloat16 and u (H,D) in
// float32; out is stored in r's dtype and the final state as float32
// (B,H,D,D).  w is clipped to [floor, 1] (the Pallas kernel clips its log
// at 1e-38, the reference model's chunked form at 1e-8; the floor is an
// argument).  Unlike the Pallas kernel (S % 64 == 0) it takes any S >= 1.
// Inputs are read through strides (batch, head, step; the head dim
// contiguous), so the model's (B,S,H,D) activations viewed as (B,H,S,D)
// need no copy; out is written through its own strides.
//
// Why not the Pallas kernel's chunked form.  That form puts the work on a
// matrix unit, with the pairwise decay of a chunk formed as a (C,C,D)
// tensor of exponent differences (1 MB of float32 at C = D = 64, beyond a
// block's 227 KB of shared memory), and it reassociates the state update.
// Here the state must stay exact: it is rounded product by product and sum
// by sum (__fmul_rn, __fadd_rn, no FMA contraction), step by step in order,
// as the plain PyTorch version computes it, so the two carry the same
// state bit for bit.  A fused or reordered update drifts by a few 1e-6 of
// a state that grows to thousands, and a deep model with random weights
// amplifies that past the fp32 slice check.  Only the sum r^T S_{t-1} and
// the bonus r . (u * k) are taken in another order than the plain
// version's.  No exponent is formed: every decay is a product by
// w_t <= 1, so nothing overflows however strong the decay.
//
// What bounds it: four exact fp32 instructions per state value and step
// (w_i S_ij, k_i v_j, their sum, and the fma of r_i S_ij into out_j): at
// the rwkv6-1.6b prefill (B=4, H=32, S=2048, D=64) 4.3e9 lane operations,
// about 0.13 ms at 132 SMs x 128 lanes x 1.98 GHz, against 170 MB of
// traffic (51 us).  The state is carried in registers, and the grid must
// give every scheduler warps at the served B=1 re-prefills too (B*H = 32).
// Every r_i, k_i, w_i a thread uses reaches its registers from shared
// memory, which delivers 128 bytes a cycle an SM (an LDS.128 takes 4 such
// cycles, broadcast or not): 32 floats against 128 fp32 lanes.  With one
// column a thread that is three floats for every four operations, so
// shared memory, not the fp32 rate, bounds the step loop.  The design:
//  - Geometry.  A thread keeps IT rows x JC columns of the state, so each
//    r, k, w value it reads serves JC columns.  A block owns CT columns
//    of one (b, h) (independent given r, k and w): grid (D/CT, H, B), P =
//    D/IT row groups x NG column groups of threads, the column groups the
//    fastest index.  The wrapper picks the geometry (../ops.py): 8 x 4 at
//    a large B*H (D=64: 128 threads, one block a head, 128 blocks at B=4;
//    a float4 of r, k or w for 16 operations), 8 x 1 at a small one (4
//    blocks a head: 128 blocks and 512 warps at B=1, H=32).  Every block
//    of a head reads all D rows of r, k and w (from L2).
//  - Staging by cp.async.  r, k, w (all D rows) and the block's v columns
//    of TS steps (16 at 8 x 4, else 32) form a stage; a ring of NS = 3
//    stages in shared memory is filled by 16-byte cp.async copies in the
//    raw dtype (the wrapper refuses pointers and step strides that are
//    not 16-byte aligned), so nothing waits in registers.  A landed stage
//    is converted once into float32 (bf16 widening is exact; w clipped to
//    [floor, 1]) by quads of 4 elements, conflict-free, with each step's
//    bonus summed by shuffles.
//  - The step loop holds only the exact work: per step each thread reads
//    its IT rows of r, k, w and JC values of v as vectors, one step ahead,
//    updates its IT x JC state values and stores its JC partials of r.S.
//    No shuffle and no cross-thread chain is in it.
//  - The partials of a step are added over the row groups in a fixed
//    order, plus v_j * bonus_t, 4 columns at a time, and stored along the
//    columns.
//  - One barrier a stage: round s runs the steps of stage s, converts
//    stage s+1 and reduces stage s-1 (float32 r, k, w and the partials
//    double-buffered, v and bonus triple-buffered), so the warps of a
//    block overlap those phases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NS = 3;  // stages in the ring

// element type <-> float32; 16 raw bytes hold PER16 elements
struct F32 {
  using raw = float;
  static constexpr int PER16 = 4;
  // 4 consecutive elements at `p` in shared memory (16-byte aligned)
  __device__ static float4 load4(const unsigned char* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  // 4 outputs at `p` in device memory (16-byte aligned)
  __device__ static void store4(raw* p, float4 o) {
    *reinterpret_cast<float4*>(p) = o;
  }
};

struct BF16 {
  using raw = uint16_t;
  static constexpr int PER16 = 8;
  // 4 consecutive elements at `p` in shared memory (8-byte aligned)
  __device__ static float4 load4(const unsigned char* p) {  // exact
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    return make_float4(__uint_as_float(q.x << 16),
                       __uint_as_float(q.x & 0xffff0000u),
                       __uint_as_float(q.y << 16),
                       __uint_as_float(q.y & 0xffff0000u));
  }
  // 4 outputs at `p` in device memory (8-byte aligned), rounded to nearest
  __device__ static void store4(raw* p, float4 o) {
    auto two = [](float a, float b) {
      return uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
             (uint32_t(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
    };
    *reinterpret_cast<uint2*>(p) = make_uint2(two(o.x, o.y), two(o.z, o.w));
  }
};

// A block's geometry: each thread keeps the state of IT rows x JC columns;
// P row groups x NG column groups of threads (columns fastest) cover CT
// columns of one (b, h).  A stage is TS steps.
template <typename T, int D, int IT, int JC>
struct Geo {
  static constexpr int ES = int(sizeof(typename T::raw));
  static constexpr int P = D / IT;                       // row groups
  static constexpr int NG = 128 / P < D / JC ? 128 / P : D / JC;
  static constexpr int NT = P * NG;                      // threads a block
  static constexpr int CT = NG * JC;                     // columns a block
  static constexpr int TS = IT * JC >= 32 ? 16 : 32;     // steps a stage
  static constexpr int Q = IT / 4;                  // float4s of a thread's rows
  static constexpr int NQ = TS * D / 4 / NT;        // quads of r, k, w a thread
  static constexpr int NVQ = TS * CT / 4 / NT;  // quads of v, of outputs a thread
  static constexpr int RCH = D * ES / 16;           // 16-byte chunks of a row
  static constexpr int VCH = CT * ES / 16;          // of the block's v columns
  static constexpr int UNROLL = JC == 4 ? 4 : 8;    // steps unrolled
  // shared memory, bytes: the raw ring of NS stages; float32 r, k, w of 2
  // stages (computed, converted); v and bonus of 3 (also the one reduced);
  // the partials of 2 (computed, reduced)
  static constexpr int RAW_A = TS * D * ES;         // one of r, k, w
  static constexpr int RAW = 3 * RAW_A + TS * CT * ES;  // one stage
  static constexpr int WORK = 3 * TS * D;           // floats of r, k, w
  static constexpr int VB = TS * CT + TS;           // floats of v and bonus
  static constexpr int PSTEP = P * CT + 16;         // floats a step, padded
  static constexpr int PART = TS * PSTEP;           // floats of partials
  static constexpr int SMEM = NS * RAW + (2 * WORK + 3 * VB + 2 * PART) * 4;
  static_assert(D % IT == 0 && IT % 4 == 0 && NT % 32 == 0 &&
                    NT % (D / 4) == 0 && (TS * D / 4) % NT == 0 &&
                    (TS * CT / 4) % NT == 0 && (CT * ES) % 16 == 0 &&
                    (TS * RCH) % NT == 0 &&
                    (JC == 1 || JC == 4) && SMEM <= 227 * 1024,
                "tile does not divide");
};

template <int JC>
struct Vec;  // JC floats as one shared-memory access
template <>
struct Vec<1> {
  using type = float;
  __device__ static float get(float x, int) { return x; }
  __device__ static float make(const float* o) { return o[0]; }
};
template <>
struct Vec<4> {
  using type = float4;
  __device__ static float get(const float4& x, int e) {
    return e == 0 ? x.x : e == 1 ? x.y : e == 2 ? x.z : x.w;
  }
  __device__ static float4 make(const float* o) {
    return make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <typename T, int D, int IT, int JC>
__global__ void __launch_bounds__(Geo<T, D, IT, JC>::NT)
    wkv6_fwd(const typename T::raw* __restrict__ r,
             const typename T::raw* __restrict__ k,
             const typename T::raw* __restrict__ v,
             const typename T::raw* __restrict__ w,
             const float* __restrict__ u, typename T::raw* __restrict__ out,
             float* __restrict__ state, int H, int S, int64_t sb, int64_t sh,
             int64_t ss, int64_t ob, int64_t oh, int64_t os, float w_floor) {
  using raw = typename T::raw;
  using C = Geo<T, D, IT, JC>;
  using VJ = typename Vec<JC>::type;
  constexpr int TS = C::TS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* work = reinterpret_cast<float*>(smem + NS * C::RAW);  // 2 x r,k,w
  float* vbs = work + 2 * C::WORK;   // 3 x (v [TS][CT], bonus [TS])
  float* parts = vbs + 3 * C::VB;    // 2 x [TS][P][CT], steps padded

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * C::CT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t in0 = int64_t(b) * sb + int64_t(h) * sh;
  const int64_t out0 = int64_t(b) * ob + int64_t(h) * oh + j0;
  const int nstages = (S + TS - 1) / TS;

  // copies of stage `st` into its ring slot (steps past S zero-filled)
  auto issue = [&](int st) {
    if (st < nstages) {
      unsigned char* slot = smem + (st % NS) * C::RAW;
      const int t0 = st * TS;
#pragma unroll
      for (int n = 0; n < TS * C::RCH / C::NT; ++n) {
        const int e = tid + n * C::NT;
        const int t = e / C::RCH;
        const bool live = t0 + t < S;
        const int64_t off = in0 + (live ? int64_t(t0 + t) * ss : 0) +
                            (e % C::RCH) * T::PER16;
        const uint32_t bytes = live ? 16 : 0;
        hopper::cp_async16(slot + e * 16, r + off, bytes);
        hopper::cp_async16(slot + C::RAW_A + e * 16, k + off, bytes);
        hopper::cp_async16(slot + 2 * C::RAW_A + e * 16, w + off, bytes);
      }
      for (int e = tid; e < TS * C::VCH; e += C::NT) {
        const int t = e / C::VCH;
        const bool live = t0 + t < S;
        const raw* src = v + in0 + (live ? int64_t(t0 + t) * ss : 0) + j0 +
                         (e % C::VCH) * T::PER16;
        hopper::cp_async16(slot + 3 * C::RAW_A + e * 16, src, live ? 16 : 0);
      }
    }
    hopper::cp_async_commit();  // an empty group past the last stage
  };

  // raw stage `st` -> float32 r, k, w (w clipped) and v, and each step's
  // bonus r.(u*k).  Work goes by quads of 4 consecutive elements, quad q
  // to thread q % NT, so a warp reads and writes consecutive addresses
  // (no bank conflict); the D/4 quads of a step sit in D/4 neighbouring
  // lanes, which add their parts of the bonus by shuffles.  Every quad of
  // a thread covers the same 4 rows, whose u it keeps.
  const float4 uq = reinterpret_cast<const float4*>(u + h * D)[tid % (D / 4)];
  auto convert = [&](int st) {
    const unsigned char* slot = smem + (st % NS) * C::RAW;
    float4* rw = reinterpret_cast<float4*>(work + (st % 2) * C::WORK);
    float4* kw = rw + TS * D / 4;
    float4* ww = kw + TS * D / 4;
    float* vw = vbs + (st % 3) * C::VB;
#pragma unroll
    for (int n = 0; n < C::NQ; ++n) {
      const int q = tid + n * C::NT;
      const float4 rq = T::load4(slot + q * 4 * C::ES);
      const float4 kq = T::load4(slot + C::RAW_A + q * 4 * C::ES);
      const float4 wq = T::load4(slot + 2 * C::RAW_A + q * 4 * C::ES);
      rw[q] = rq;
      kw[q] = kq;
      ww[q] = make_float4(fminf(fmaxf(wq.x, w_floor), 1.f),
                          fminf(fmaxf(wq.y, w_floor), 1.f),
                          fminf(fmaxf(wq.z, w_floor), 1.f),
                          fminf(fmaxf(wq.w, w_floor), 1.f));
      float bsum = fmaf(rq.x, uq.x * kq.x, 0.f);
      bsum = fmaf(rq.y, uq.y * kq.y, bsum);
      bsum = fmaf(rq.z, uq.z * kq.z, bsum);
      bsum = fmaf(rq.w, uq.w * kq.w, bsum);
#pragma unroll
      for (int off = D / 8; off > 0; off /= 2)
        bsum += __shfl_xor_sync(0xffffffffu, bsum, off);
      if (q % (D / 4) == 0) vw[TS * C::CT + q / (D / 4)] = bsum;
    }
#pragma unroll
    for (int n = 0; n < C::NVQ; ++n) {
      const int q = tid + n * C::NT;
      reinterpret_cast<float4*>(vw)[q] =
          T::load4(slot + 3 * C::RAW_A + q * 4 * C::ES);
    }
  };

  // state: rows p*IT .. p*IT+IT-1 x columns g*JC .. g*JC+JC-1 of the
  // block's; the column groups are the fastest index of the threads, so a
  // warp reads only 32/NG row groups of a step
  const int g = tid % C::NG;
  const int p = tid / C::NG;
  float st[IT][JC];
#pragma unroll
  for (int i = 0; i < IT; ++i)
#pragma unroll
    for (int j = 0; j < JC; ++j) st[i][j] = 0.f;

  // the steps of stage `sg`: the exact update of the thread's state and
  // its partials of r.S, each step's r, k, w rows and v columns read into
  // registers one step ahead
  auto steps_of = [&](int sg) {
    const int steps = min(TS, S - sg * TS);
    const float* rw = work + (sg % 2) * C::WORK;
    const float4* r4 = reinterpret_cast<const float4*>(rw) + p * C::Q;
    const float4* k4 = reinterpret_cast<const float4*>(rw + TS * D) + p * C::Q;
    const float4* w4 =
        reinterpret_cast<const float4*>(rw + 2 * TS * D) + p * C::Q;
    const VJ* v4 = reinterpret_cast<const VJ*>(vbs + (sg % 3) * C::VB) + g;
    float* part = parts + (sg % 2) * C::PART;
    float4 nr[C::Q], nk[C::Q], nw[C::Q];
    VJ nv;
    auto fetch = [&](int tt) {  // tt <= TS: in shared memory even past TS
#pragma unroll
      for (int q = 0; q < C::Q; ++q) {
        nr[q] = r4[tt * (D / 4) + q];
        nk[q] = k4[tt * (D / 4) + q];
        nw[q] = w4[tt * (D / 4) + q];
      }
      nv = v4[tt * C::NG];
    };
    auto step = [&](int tt) {
      float4 rq[C::Q], kq[C::Q], wq[C::Q];
#pragma unroll
      for (int q = 0; q < C::Q; ++q) {
        rq[q] = nr[q];
        kq[q] = nk[q];
        wq[q] = nw[q];
      }
      const VJ vj = nv;
      fetch(tt + 1);
      float o[JC];
#pragma unroll
      for (int j = 0; j < JC; ++j) o[j] = 0.f;
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const float ri = Vec<4>::get(rq[i / 4], i % 4);
        const float ki = Vec<4>::get(kq[i / 4], i % 4);
        const float wi = Vec<4>::get(wq[i / 4], i % 4);
#pragma unroll
        for (int j = 0; j < JC; ++j) {
          o[j] = fmaf(ri, st[i][j], o[j]);
          st[i][j] = __fadd_rn(__fmul_rn(st[i][j], wi),
                               __fmul_rn(ki, Vec<JC>::get(vj, j)));
        }
      }
      *reinterpret_cast<VJ*>(part + tt * C::PSTEP + p * C::CT + g * JC) =
          Vec<JC>::make(o);
    };
    fetch(0);
    if (steps == TS) {  // unrolled: constant offsets, few copies
#pragma unroll(C::UNROLL)
      for (int tt = 0; tt < TS; ++tt) step(tt);
    } else {
#pragma unroll 1
      for (int tt = 0; tt < steps; ++tt) step(tt);
    }
  };

  // out_t[j] of stage `sg` = the sum of its partials over p (p ascending)
  // + v_j * bonus_t, by quads of 4 neighbouring columns, stored along the
  // columns (out's strides are r's, 16-byte multiples)
  auto reduce = [&](int sg) {
    const int t0 = sg * TS;
    const int steps = min(TS, S - t0);
    const float* part = parts + (sg % 2) * C::PART;
    const float* vw = vbs + (sg % 3) * C::VB;
#pragma unroll
    for (int n = 0; n < C::NVQ; ++n) {
      const int e = tid + n * C::NT;
      const int t = e / (C::CT / 4), c4 = e % (C::CT / 4) * 4;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < C::P; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(
            part + t * C::PSTEP + q * C::CT + c4);
        o = make_float4(o.x + x.x, o.y + x.y, o.z + x.z, o.w + x.w);
      }
      const float bt = vw[TS * C::CT + t];
      const float4 vq = *reinterpret_cast<const float4*>(vw + t * C::CT + c4);
      o = make_float4(fmaf(vq.x, bt, o.x), fmaf(vq.y, bt, o.y),
                      fmaf(vq.z, bt, o.z), fmaf(vq.w, bt, o.w));
      if (t < steps) T::store4(out + out0 + int64_t(t0 + t) * os + c4, o);
    }
  };

  // One barrier a stage.  Round s computes stage s, converts stage s+1 and
  // reduces stage s-1 (float32 r, k, w double-buffered, v and bonus
  // triple-buffered, partials double-buffered); the ring slot of stage s,
  // converted last round, is refilled with stage s+NS first.
#pragma unroll
  for (int st = 0; st < NS; ++st) issue(st);
  hopper::cp_async_wait<NS - 1>();
  __syncthreads();  // stage 0 landed
  convert(0);
  hopper::cp_async_wait<NS - 2>();
  __syncthreads();  // stage 0 converted, stage 1 landed
  for (int sg = 0; sg < nstages; ++sg) {
    issue(sg + NS);
    steps_of(sg);
    if (sg + 1 < nstages) convert(sg + 1);
    if (sg > 0) reduce(sg - 1);
    hopper::cp_async_wait<NS - 2>();
    __syncthreads();  // stage sg+2 landed for the next round's convert
  }
  reduce(nstages - 1);

  float* sp = state + ((int64_t(b) * H + h) * D + p * IT) * D + j0 + g * JC;
#pragma unroll
  for (int i = 0; i < IT; ++i)
#pragma unroll
    for (int j = 0; j < JC; ++j) sp[int64_t(i) * D + j] = st[i][j];
}

template <typename T, int D, int IT, int JC>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, void* out, float* state,
                   int B, int H, int S, int64_t sb, int64_t sh, int64_t ss,
                   int64_t ob, int64_t oh, int64_t os, float w_floor,
                   cudaStream_t stream) {
  using raw = typename T::raw;
  using C = Geo<T, D, IT, JC>;
  // above 48 KB of shared memory only after this (once per kernel)
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_fwd<T, D, IT, JC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(D / C::CT, H, B);
  wkv6_fwd<T, D, IT, JC><<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const raw*>(r), static_cast<const raw*>(k),
      static_cast<const raw*>(v), static_cast<const raw*>(w), u,
      static_cast<raw*>(out), state, H, S, sb, sh, ss, ob, oh, os, w_floor);
  return cudaGetLastError();
}

template <typename T, int IT, int JC>
cudaError_t dispatch(int D, const void* r, const void* k, const void* v,
                     const void* w, const float* u, void* out, float* state,
                     int B, int H, int S, int64_t sb, int64_t sh, int64_t ss,
                     int64_t ob, int64_t oh, int64_t os, float w_floor,
                     cudaStream_t stream) {
  switch (D) {
    case 16:  // 8 x 4 a thread would leave a block of 8 threads
      if constexpr (JC > 1) return cudaErrorInvalidValue;
      else
        return launch<T, 16, IT, JC>(r, k, v, w, u, out, state, B, H, S, sb,
                                     sh, ss, ob, oh, os, w_floor, stream);
    case 32:
      return launch<T, 32, IT, JC>(r, k, v, w, u, out, state, B, H, S, sb,
                                   sh, ss, ob, oh, os, w_floor, stream);
    case 64:
      return launch<T, 64, IT, JC>(r, k, v, w, u, out, state, B, H, S, sb,
                                   sh, ss, ob, oh, os, w_floor, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and out share it; u and
// state are float32).  r, k, v, w share the element strides (sb, sh, ss)
// of their (B,H,S,D) layout, out has (ob, oh, os); the head dim is
// contiguous in all of them.  r, k, v, w and their strides (in bytes) are
// 16-byte aligned.  u is contiguous (H,D), state contiguous (B,H,D,D).
// rows x cols: the state a thread keeps (the geometry), 8 x 4 (not at
// D = 16) or 8 x 1.  Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t (0 on
// success).
int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, void* state,
                   int dtype, int B, int H, int S, int D, int rows, int cols,
                   int64_t sb, int64_t sh, int64_t ss, int64_t ob,
                   int64_t oh, int64_t os, float w_floor, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || S < 1 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
#define REPRO_WKV6_DISPATCH(TYPE, ROWS, COLS)                             \
  return int(dispatch<TYPE, ROWS, COLS>(D, r, k, v, w, uf, out, sf, B, H, \
                                        S, sb, sh, ss, ob, oh, os,         \
                                        w_floor, s))
  switch (rows * 100 + cols * 10 + dtype) {
    case 840: REPRO_WKV6_DISPATCH(F32, 8, 4);
    case 841: REPRO_WKV6_DISPATCH(BF16, 8, 4);
    case 810: REPRO_WKV6_DISPATCH(F32, 8, 1);
    case 811: REPRO_WKV6_DISPATCH(BF16, 8, 1);
    default: return int(cudaErrorInvalidValue);
  }
#undef REPRO_WKV6_DISPATCH
}

const char* repro_wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
