// WKV6 recurrence for Hopper (sm_90a), CUDA C++ with a plain C entry point
// (loaded with ctypes, see kernels/_build.py and ../ops.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (_wkv6_kernel, launched by wkv6_kernel).  Same function, RWKV6's linear
// attention with a data-dependent decay and a (D,D) matrix state per head:
//
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,             S_{-1} = 0
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//
// for r, k, v, w of shape (B,H,S,D) in float32 or bfloat16 and u (H,D) in
// float32; out is stored in r's dtype and the final state as float32
// (B,H,D,D).  w is clipped to [floor, 1] (the Pallas kernel clips its log
// at 1e-38, the reference model's chunked form at 1e-8; the floor is an
// argument).
// Unlike the Pallas kernel (S % 64 == 0) it takes any S >= 1.  Inputs are
// read through strides (batch, head, step; the head dim contiguous), so
// the model's (B,S,H,D) activations viewed as (B,H,S,D) need no copy; out
// is written through its own strides.
//
// Design for the card.  The Pallas kernel uses the chunked form so that
// the TPU's matrix unit does the work, with the pairwise decay of a chunk
// formed as a (C,C,D) tensor of exponent differences.  At C = D = 64 that
// tensor is 1 MB of float32, far beyond a block's 227 KB of shared
// memory.  Here the recurrence runs step by step, as the CUDA RWKV kernels
// do: the state lives in registers, every decay is a plain product by
// w_t <= 1, and no exponent is formed at all, so nothing can overflow
// however strong the decay (w = 0 gives out and state finite).
//
// Work per (b, h, t) is about 5 D^2 float32 operations against 5 D values
// moved, so the kernel is bound by operations: at the rwkv6-1.6b prefill
// (B=4, H=32, S=2048, D=64) 5.4 GFLOP, 81 us at 67 TFLOP/s, against 170 MB,
// 51 us at 3.35 TB/s.  To spread that over the card:
//  - the columns j of the state are independent given r, k and w, so a
//    block owns a tile of CT columns of one (b, h): grid (D/CT, H, B);
//  - each column's D rows are split over P = D/16 threads, 16 rows each, so
//    a thread keeps 16 state values in registers and the P partial dot
//    products r^T S[:, j] meet in P - 1 warp shuffles (P = 4 at D = 64:
//    128 threads a block, 256 blocks at the prefill shape);
//  - r, k, w (all D rows) and v (the block's columns) of TS = 16 steps at a
//    time are staged in shared memory as float32, w clipped on the way;
//    the loads of the next 16 steps are issued into registers before the
//    current ones are computed;
//  - each thread reads its 16 rows of r, k and w as float4 broadcasts; each
//    thread's rows are padded by 4 floats so the P row groups a warp reads
//    at once fall in distinct banks;
//  - the bonus term r_t . (u * k_t) is the same for every column: it is
//    summed once per step over D (by NT/TS threads per step) and added as
//    v_j * bonus, which leaves four operations per state value and step
//    (k_i v_j, w_i S_ij, their sum, the fma of r_i S_ij).
// Outputs of the 16 steps are staged and stored along the columns.
//
// Exactness: the state update is rounded product by product and sum by
// sum (__fmul_rn, __fadd_rn: no FMA contraction), as the plain PyTorch
// version computes it, so the two carry the same state bit for bit.  A
// fused update would round once where the plain version rounds twice;
// over thousands of steps of decays near 1 the state grows to thousands
// and the two would drift apart by a few 1e-6 of it, which a deep model
// with random weights amplifies layer by layer.  Only the sum r^T S_{t-1} is
// taken in another order than the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 16;   // steps staged in shared memory per pass
constexpr int IT = 16;   // state rows a thread keeps
constexpr int PAD = 4;   // floats after each thread's rows of a staged step

// element type <-> float32; raw elements wait in registers until staged
struct F32 {
  using raw = float;
  __device__ static float load(raw v) { return v; }
  __device__ static raw store(float v) { return v; }
};

struct BF16 {
  using raw = uint16_t;
  __device__ static float load(raw v) {
    return __uint_as_float(uint32_t(v) << 16);  // exact widening
  }
  __device__ static raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <int D>
struct Tile {
  static constexpr int P = D / IT;            // threads sharing a column
  static constexpr int CT = D < 32 ? D : 32;  // columns per block
  static constexpr int NT = CT * P;           // threads per block
  static constexpr int ROW = P * (IT + PAD);  // padded floats per step
  static constexpr int NRKW = TS * D / NT;    // r, k, w loads a thread makes
  static constexpr int NV = TS * CT / NT;     // v loads a thread makes
  static constexpr int G = NT / TS;           // threads summing one bonus
  static constexpr int GI = D / G;            // rows each of them sums
  static_assert(D % IT == 0 && (TS * D) % NT == 0 && (TS * CT) % NT == 0 &&
                    NT % TS == 0 && D % G == 0 && 32 % P == 0 &&
                    32 % G == 0,
                "tile does not divide");
};

// padded position of row i in a staged step
__device__ __forceinline__ int pos(int i) {
  return (i / IT) * (IT + PAD) + i % IT;
}

template <typename T, int D>
__global__ void __launch_bounds__(Tile<D>::NT)
    wkv6_fwd(const typename T::raw* __restrict__ r,
             const typename T::raw* __restrict__ k,
             const typename T::raw* __restrict__ v,
             const typename T::raw* __restrict__ w,
             const float* __restrict__ u, typename T::raw* __restrict__ out,
             float* __restrict__ state, int H, int S, int64_t sb, int64_t sh,
             int64_t ss, int64_t ob, int64_t oh, int64_t os, float w_floor) {
  using raw = typename T::raw;
  using C = Tile<D>;
  __shared__ __align__(16) float rs[TS * C::ROW];
  __shared__ __align__(16) float ks[TS * C::ROW];
  __shared__ __align__(16) float ws[TS * C::ROW];
  __shared__ float vs[TS * C::CT];
  __shared__ float outs[TS * C::CT];
  __shared__ float bonus[TS];

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * C::CT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t in0 = int64_t(b) * sb + int64_t(h) * sh;
  const int64_t out0 = int64_t(b) * ob + int64_t(h) * oh + j0;

  // this thread's column, its rows p*IT .. p*IT+IT-1 and their state
  const int c = tid / C::P;
  const int p = tid % C::P;
  float st[IT];
#pragma unroll
  for (int i = 0; i < IT; ++i) st[i] = 0.f;

  // the bonus sum: thread tid adds rows g*GI .. g*GI+GI-1 of step tid/G
  const int bt = tid / C::G;
  const int bg = tid % C::G;
  float ur[C::GI];
#pragma unroll
  for (int m = 0; m < C::GI; ++m) ur[m] = u[h * D + bg * C::GI + m];

  raw pr[C::NRKW], pk[C::NRKW], pw[C::NRKW], pv[C::NV];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int n = 0; n < C::NRKW; ++n) {
      const int e = tid + n * C::NT;
      const int t = t0 + e / D;
      const int64_t off = in0 + int64_t(t) * ss + e % D;
      pr[n] = t < S ? r[off] : raw(0);
      pk[n] = t < S ? k[off] : raw(0);
      pw[n] = t < S ? w[off] : raw(0);
    }
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      const int e = tid + n * C::NT;
      const int t = t0 + e / C::CT;
      pv[n] = t < S ? v[in0 + int64_t(t) * ss + j0 + e % C::CT] : raw(0);
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < S; t0 += TS) {
    const int steps = min(TS, S - t0);
    // stage the fetched steps; past S: r = k = v = 0 and w = 1
#pragma unroll
    for (int n = 0; n < C::NRKW; ++n) {
      const int e = tid + n * C::NT;
      const int tt = e / D;
      const int at = tt * C::ROW + pos(e % D);
      const bool live = tt < steps;
      rs[at] = live ? T::load(pr[n]) : 0.f;
      ks[at] = live ? T::load(pk[n]) : 0.f;
      ws[at] = live ? fminf(fmaxf(T::load(pw[n]), w_floor), 1.f) : 1.f;
    }
#pragma unroll
    for (int n = 0; n < C::NV; ++n) {
      const int e = tid + n * C::NT;
      vs[e] = e / C::CT < steps ? T::load(pv[n]) : 0.f;
    }
    __syncthreads();

    {  // bonus[tt] = sum_i r_i u_i k_i, G threads per step
      float a = 0.f;
#pragma unroll
      for (int m = 0; m < C::GI; ++m) {
        const int at = bt * C::ROW + pos(bg * C::GI + m);
        a = fmaf(rs[at], ur[m] * ks[at], a);
      }
#pragma unroll
      for (int off = C::G / 2; off > 0; off /= 2)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (bg == 0) bonus[bt] = a;
    }
    __syncthreads();

    if (t0 + TS < S) fetch(t0 + TS);  // in flight while this pass computes

    for (int tt = 0; tt < steps; ++tt) {
      const float vj = vs[tt * C::CT + c];
      const int row = tt * C::ROW + p * (IT + PAD);
      const float4* r4 = reinterpret_cast<const float4*>(rs + row);
      const float4* k4 = reinterpret_cast<const float4*>(ks + row);
      const float4* w4 = reinterpret_cast<const float4*>(ws + row);
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int q = 0; q < IT / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q];
        float* sq = st + 4 * q;
        o0 = fmaf(rq.x, sq[0], o0);
        sq[0] = __fadd_rn(__fmul_rn(sq[0], wq.x), __fmul_rn(kq.x, vj));
        o1 = fmaf(rq.y, sq[1], o1);
        sq[1] = __fadd_rn(__fmul_rn(sq[1], wq.y), __fmul_rn(kq.y, vj));
        o0 = fmaf(rq.z, sq[2], o0);
        sq[2] = __fadd_rn(__fmul_rn(sq[2], wq.z), __fmul_rn(kq.z, vj));
        o1 = fmaf(rq.w, sq[3], o1);
        sq[3] = __fadd_rn(__fmul_rn(sq[3], wq.w), __fmul_rn(kq.w, vj));
      }
      float o = o0 + o1;
#pragma unroll
      for (int off = C::P / 2; off > 0; off /= 2)
        o += __shfl_xor_sync(0xffffffffu, o, off);
      if (p == 0) outs[tt * C::CT + c] = fmaf(vj, bonus[tt], o);
    }
    __syncthreads();

    for (int e = tid; e < steps * C::CT; e += C::NT)
      out[out0 + int64_t(t0 + e / C::CT) * os + e % C::CT] =
          T::store(outs[e]);
  }

  float* sp = state + ((int64_t(b) * H + h) * D + p * IT) * D + j0 + c;
#pragma unroll
  for (int i = 0; i < IT; ++i) sp[int64_t(i) * D] = st[i];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const float* u, void* out, float* state,
                   int B, int H, int S, int64_t sb, int64_t sh, int64_t ss,
                   int64_t ob, int64_t oh, int64_t os, float w_floor,
                   cudaStream_t stream) {
  using raw = typename T::raw;
  using C = Tile<D>;
  const dim3 grid(D / C::CT, H, B);
  wkv6_fwd<T, D><<<grid, C::NT, 0, stream>>>(
      static_cast<const raw*>(r), static_cast<const raw*>(k),
      static_cast<const raw*>(v), static_cast<const raw*>(w), u,
      static_cast<raw*>(out), state, H, S, sb, sh, ss, ob, oh, os, w_floor);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* r, const void* k, const void* v,
                     const void* w, const float* u, void* out, float* state,
                     int B, int H, int S, int64_t sb, int64_t sh, int64_t ss,
                     int64_t ob, int64_t oh, int64_t os, float w_floor,
                     cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, out, state, B, H, S, sb, sh, ss,
                           ob, oh, os, w_floor, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, out, state, B, H, S, sb, sh, ss,
                           ob, oh, os, w_floor, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, out, state, B, H, S, sb, sh, ss,
                           ob, oh, os, w_floor, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and out share it; u and
// state are float32).  r, k, v, w share the element strides (sb, sh, ss)
// of their (B,H,S,D) layout, out has (ob, oh, os); the head dim is
// contiguous in all of them.  u is contiguous (H,D), state contiguous
// (B,H,D,D).  Launches on `stream`, does not synchronise, returns the
// launch's cudaError_t (0 on success).
int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                   const void* w, const void* u, void* out, void* state,
                   int dtype, int B, int H, int S, int D, int64_t sb,
                   int64_t sh, int64_t ss, int64_t ob, int64_t oh,
                   int64_t os, float w_floor, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || S < 1 ||
      (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  float* sf = static_cast<float*>(state);
  if (dtype == 0)
    return int(dispatch<F32>(D, r, k, v, w, uf, out, sf, B, H, S, sb, sh,
                             ss, ob, oh, os, w_floor, s));
  return int(dispatch<BF16>(D, r, k, v, w, uf, out, sf, B, H, S, sb, sh, ss,
                            ob, oh, os, w_floor, s));
}

const char* repro_wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
