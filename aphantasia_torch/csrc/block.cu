// Fused ViT residual-block halves for Hopper (sm_90a), forward and dx-only
// backward, over the flat sample-major stream x [R, D] (R = samples * t).
//
// Replaces the Pallas TPU kernels of aphantasia_tpu/ops/pallas_block.py:
//   _attn_half_fwd (pallas_call at :273, body _attn_half_fwd_kernel :138)
//   _attn_half_bwd (pallas_call at :298, body _attn_half_bwd_kernel :150)
//   _mlp_half_fwd  (pallas_call at :333, body _mlp_half_fwd_kernel :196)
//   _mlp_half_bwd  (pallas_call at :358, body _mlp_half_bwd_kernel :206)
//
//   attn_half: y = x + out_proj(attention(qkv_proj(LN1(x))))
//   mlp_half:  y = x + proj(quick_gelu(fc(LN2(x))))
//
// The arithmetic and its roundings are the TPU kernel's (T is x's type,
// bf16 or float32; round_T is the identity for float32):
//   LN      one-pass float32 moments, h = round_T(xhat * g + b);
//   product T operands, float32 sums, round_T, then the bias added in T
//           (round_T(round_T(acc) + bias)); the residual add in T;
//   attention  s = q.k * scale, e = exp(min(s, 60)) (a clamp, no max
//           subtraction), inv = 1 / sum(e) saved per (row, head),
//           o = round_T(sum_j round_T(e_j) v_j * inv);
//   attention backward  p32 = e * inv, dv = sum_i round_T(p32) do_i,
//           ds = round_T(p32 (dp - sum_j dp p32) * scale), dq = ds k,
//           dk = ds^T q, each rounded to T; dh = dqkv @ in_w^T in float32;
//   MLP     u = round_T(round_T(h @ fc_w) + fc_b), a = round_T(u sigmoid(1.702 u));
//   MLP backward  da = dy @ p_w^T in float32, du = round_T(da (s + 1.702 u
//           s (1 - s))), s = sigmoid(1.702 u), dh = du @ fc_w^T in float32;
//   dx = round_T(dy + round_T(LN-backward(dh))).
//
// What bounds it on the H100: operations.  At the main path's shapes
// (ViT-B/32: R = 9500, D = 768, 12 heads of 64, t = 50) an entry point's
// products are 46 (attention forward) to 135 (MLP backward) GFLOP against
// 29-44 MB of activations read and written and 3.5-9.4 MB of bf16 weights:
// the attention backward's products and core are 82 GFLOP (0.083 ms at
// 989 TFLOP/s), the MLP backward's 134.5 GFLOP (0.136 ms).  The TPU kernel
// keeps a half's weights resident in VMEM and runs it as one grid; on the
// card a block has 227 KB of shared memory against 3.4 MB for in_w alone,
// so each entry point is a short chain of launches whose intermediates go
// through device memory:
//   a warp per row for the LayerNorm (and, in the backward, the LN
//   backward fused with the residual add);
//   one tiled product with a fused epilogue for every matrix product:
//   bias, bias + residual, bias + quick_gelu, round, float32, and the
//   quick_gelu derivative; with B as the row-major weight [K, N] or as its
//   transpose ([N, K], for the `@ W^T` products of the backward);
//   the attention core per (sample, head).
//
// Every bf16 entry point (the main path's) runs on the tensor cores
// through Hopper's own paths:
//   products: `gemm_tc_kernel`, one warp-specialised block per 128 x BN
//   output tile.  One producer thread keeps a ring of stages full with
//   TMA loads (128-byte swizzle, mbarriers): the A tile [128 rows, 64 K]
//   and the B tile, either one [BN N rows, 64 K] box of a weight stored
//   [N, K] (K-major, the `@ W^T` products of the backward) or [64 K rows,
//   64 N] boxes of a weight stored [K, N] (MN-major, wgmma's transpose
//   bit: qkv, out-proj, fc and proj, and the backward's recomputed qkv and
//   u).  Two consumer warpgroups each own 64 rows and run wgmma.m64nBNk16
//   (csrc/wgmma.cuh) into BN / 2 float32 registers a thread.  The
//   epilogue works at the accumulator's own coordinates: a float32 output
//   goes out straight from the registers; a bf16 one is staged through
//   the ring (idle by then) and written 16 bytes a thread along rows, each
//   thread loading what its rows need (the residual x, u) for all of them
//   before it stores any.  The tile width goes with the epilogue.  BN =
//   256, 4 stages (197 KB), one block an SM, the fewest operand bytes a
//   FLOP: qkv, proj, do, u and the two dh; at R = 9500 (75 row tiles,
//   the last 28 rows) 225 blocks for N = 768 (1.7 waves of 132), 675 for
//   N = 2304 (5.1), 900 for N = 3072 (6.8).  A heavier epilogue outlasts
//   its loop at K = 768: du (it reads u and computes the quick_gelu
//   derivative), fc (quick_gelu) and out-proj (it reads the residual x)
//   take BN = 128, 3 stages (97 KB), two blocks an SM, one block's
//   epilogue under the other's loop: 1800 blocks for N = 3072 (6.8 waves
//   of 264), 450 for N = 768 (1.7).  Each forward product's width was
//   measured both ways (kQkvBN .. kProjBN).  TMA's zero fill covers the
//   loads past M, N and K; the stores are guarded.  No split-K, no
//   atomics: two launches give the same bits.
//   The host encodes the tensor maps per call (cuTensorMapEncodeTiled
//   through cudaGetDriverEntryPoint, as csrc/cutout_win.cu) and passes
//   them as __grid_constant__ parameters.
//   cores: the 64-row tiles of csrc/attn_tile.cuh (ldmatrix-fed mma.sync
//   m16n8k16, P and dS fed from registers as A operands, S^T and dP^T
//   computed directly for dk/dv).  Chosen over wgmma by reckoning: at
//   t = 50 a (sample, head) is one 64 x 64 tile whose products are 0.65
//   MFLOP forward against ~25 KB of q, k, v and o moved, 1.6 MFLOP
//   backward against 45 KB of q, k, v, do and dqkv, so the cores are
//   bound by bytes and latency, and a warpgroup product would need 64-row
//   tiles of every operand in shared memory for no gain.
//   Forward: `core_fwd_tc_kernel`, a block per (sample, 64-row query
//   tile, head) walking 64-key tiles (one at t <= 64: 27 KB, 2280 blocks
//   at R = 9500); the clamp subtracts no running max, so o and the row
//   sum add up over key tiles with no rescaling, and keys past t are
//   masked to e = 0.  The clamp softmax also differs from
//   csrc/attention.cu's lse backward: rs = sum_j dp p32 needs the whole
//   row of dp before any ds.  t <= 64 (ViT-B/32):
//   `core_one_tile_tc_kernel`, a block per (sample, head) with Q, dO, K,
//   V resident (46 KB, 4 blocks an SM, 2280 blocks at R = 9500): dq with
//   rs kept in shared memory, then dk, dv.  Longer t: `core_dq_tc_kernel`
//   per 64-row query tile sums rs over the key tiles, walks them again
//   for ds and dq, and writes rs to float32 scratch [R, heads]; then
//   `core_dkv_tc_kernel` per 64-key tile walks the query tiles (55 KB
//   each).  A narrower head (the tests' 20) is padded with zero columns
//   to 64.  Every sum runs in a fixed order, nothing is atomic.
// The first design's bf16 tiles (128x128x32 mma.sync over a cp.async
// double buffer, and a scalar float32 core for the forward) are gone.
// float32 keeps 64x64 tiles of register FMAs (the tensor cores would
// round to TF32) and the scalar cores (the backward in two phases: dq
// with K, V resident, then dk, dv with Q, dO resident); it serves the
// card-against-CPU checks.
// The entry points make 4, 6, 3 and 5 launches (the bf16 attention
// backward 7 past t = 64: the core is two); each is counted once by its
// wrapper.
//
// Shapes: D and the MLP width are multiples of 8 (16-byte rows, as TMA
// needs), R is a multiple of t, D a multiple of the heads; the bf16 core
// takes heads up to 64 wide.  Every tile guards its rows and columns, so
// R, D and the widths need no other alignment.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "attn_tile.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kEps = 1e-5f;
constexpr int kRowWarps = 8;           // rows per block of the row kernels
constexpr int kAttnWarps = 8;          // warps per (sample, head) block
constexpr size_t kMaxSmem = 232448;    // per-block limit on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: the TPU kernel's `.astype(dt)`
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// ------------------------------------------------------------ row kernels

// N consecutive elements of a row as float32: 16 bytes of T a lane
template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Pack<bf16> {
  static constexpr int N = 8;
  __device__ static void load(const bf16* p, float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(bf16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
  }
}

// h = round_T(xhat * g + b) with one-pass float32 moments, a warp per
// row; stat[r] = (mu, 1/sigma) where stat is not null (the backward's).
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_kernel(const T* __restrict__ x, const float* __restrict__ g,
          const float* __restrict__ b, T* __restrict__ h,
          float* __restrict__ stat, int rows, int d) {
  constexpr int N = Pack<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const T* xr = x + (int64_t)row * d;
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N];
    Pack<T>::load(xr + c, v);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      s1 += v[i];
      s2 += v[i] * v[i];
    }
  }
  const float mu = warp_sum(s1) / d;
  const float var = warp_sum(s2) / d - mu * mu;
  const float inv = rsqrtf(var + kEps);
  T* hr = h + (int64_t)row * d;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N], gv[N], bv[N];
    Pack<T>::load(xr + c, v);
    load_f32(g + c, gv);
    load_f32(b + c, bv);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (v[i] - mu) * inv * gv[i] + bv[i];
    Pack<T>::store(hr + c, v);
  }
  if (stat != nullptr && lane == 0) {
    stat[2 * (int64_t)row] = mu;
    stat[2 * (int64_t)row + 1] = inv;
  }
}

// dx = round_T(dy + round_T((dh g - mean(dh g) - xhat mean(dh g xhat)) /
// sigma)), a warp per row; dh is float32.
template <typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
ln_back_kernel(const T* __restrict__ x, const float* __restrict__ g,
               const float* __restrict__ stat, const float* __restrict__ dh,
               const T* __restrict__ dy, T* __restrict__ dx, int rows,
               int d) {
  constexpr int N = Pack<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int64_t off = (int64_t)row * d;
  const float mu = stat[2 * (int64_t)row];
  const float inv = stat[2 * (int64_t)row + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N], dv[N], gv[N];
    Pack<T>::load(x + off + c, v);
    load_f32(dh + off + c, dv);
    load_f32(g + c, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dxhat = dv[i] * gv[i];
      m1 += dxhat;
      m2 += dxhat * ((v[i] - mu) * inv);
    }
  }
  m1 = warp_sum(m1) / d;
  m2 = warp_sum(m2) / d;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N], dv[N], gv[N], yv[N];
    Pack<T>::load(x + off + c, v);
    load_f32(dh + off + c, dv);
    load_f32(g + c, gv);
    Pack<T>::load(dy + off + c, yv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = (v[i] - mu) * inv;
      const float ln = (dv[i] * gv[i] - m1 - xhat * m2) * inv;
      v[i] = yv[i] + rnd<T>(ln);
    }
    Pack<T>::store(dx + off + c, v);
  }
}

// ------------------------------------------------------------ products

// The epilogues: each takes (row, col, acc[col], acc[col + 1]) of a row
// below M and an even col below N (N % 8 == 0, so col + 1 < N too); that
// direct store serves the float32 outputs, and a bf16 output goes
// through the staged `store8` below.

__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// Eight consecutive values of a row at p, 16-byte aligned: the wgmma
// product's staged epilogue (`kStaged`) reads and writes whole 16-byte
// chunks (`store8`), after loading what each row needs (`pre`) for all
// of a thread's rows at once; `kBN` is the product's tile width.
struct NoPre {};
__device__ __forceinline__ void ld8(const bf16* p, float (&v)[8]) {
  Pack<bf16>::load(p, v);
}
__device__ __forceinline__ void st8(bf16* p, const float (&v)[8]) {
  Pack<bf16>::store(p, v);
}

// out = round_T(round_T(acc) + bias)                  [qkv, u]
template <typename T, int BN = 256> struct EpBias {
  T* out; const T* bias; int ld;
  __device__ void operator()(int r, int n, float v0, float v1) const {
    put2(out + (int64_t)r * ld + n, rnd<T>(v0) + to_f(bias[n]),
         rnd<T>(v1) + to_f(bias[n + 1]));
  }
  static constexpr bool kStaged = true;
  static constexpr int kBN = BN;
  __device__ NoPre pre(int, int) const { return {}; }
  __device__ void store8(int r, int n, float (&v)[8], NoPre) const {
    float bv[8];
    ld8(bias + n, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = rnd<T>(v[i]) + bv[i];
    st8(out + (int64_t)r * ld + n, v);
  }
};
// out = round_T(res + round_T(round_T(acc) + bias))   [out_proj, proj]
template <typename T, int BN = 256> struct EpBiasResidual {
  T* out; const T* bias; const T* res; int ld;
  __device__ void operator()(int r, int n, float v0, float v1) const {
    const int64_t i = (int64_t)r * ld + n;
    put2(out + i, to_f(res[i]) + rnd<T>(rnd<T>(v0) + to_f(bias[n])),
         to_f(res[i + 1]) + rnd<T>(rnd<T>(v1) + to_f(bias[n + 1])));
  }
  static constexpr bool kStaged = true;
  static constexpr int kBN = BN;
  __device__ uint4 pre(int r, int n) const {  // the residual's 8 values
    return *reinterpret_cast<const uint4*>(res + (int64_t)r * ld + n);
  }
  __device__ void store8(int r, int n, float (&v)[8], uint4 xq) const {
    float bv[8], xv[8];
    ld8(bias + n, bv);
    ld8(reinterpret_cast<const bf16*>(&xq), xv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = xv[i] + rnd<T>(rnd<T>(v[i]) + bv[i]);
    st8(out + (int64_t)r * ld + n, v);
  }
};
// out = round_T(u sigmoid(1.702 u)), u = round_T(round_T(acc) + bias)   [fc]
template <typename T, int BN = 256> struct EpBiasGelu {
  T* out; const T* bias; int ld;
  __device__ float gelu(float v, float b) const {
    const float u = rnd<T>(rnd<T>(v) + b);
    return u * sigmoid(1.702f * u);
  }
  __device__ void operator()(int r, int n, float v0, float v1) const {
    put2(out + (int64_t)r * ld + n, gelu(v0, to_f(bias[n])),
         gelu(v1, to_f(bias[n + 1])));
  }
  static constexpr bool kStaged = true;
  static constexpr int kBN = BN;
  __device__ NoPre pre(int, int) const { return {}; }
  __device__ void store8(int r, int n, float (&v)[8], NoPre) const {
    float bv[8];
    ld8(bias + n, bv);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = gelu(v[i], bv[i]);
    st8(out + (int64_t)r * ld + n, v);
  }
};
// out = acc in T (round_T) or float32                  [do; dh]
template <typename O> struct EpStore {
  O* out; int ld;
  __device__ void operator()(int r, int n, float v0, float v1) const {
    put2(out + (int64_t)r * ld + n, v0, v1);
  }
  // float32 rows go out straight from the accumulators (a quad writes 32
  // contiguous bytes); bf16 rows through the staged epilogue
  static constexpr bool kStaged = sizeof(O) == 2;
  static constexpr int kBN = 256;
  __device__ NoPre pre(int, int) const { return {}; }
  __device__ void store8(int r, int n, float (&v)[8], NoPre) const {
    st8(out + (int64_t)r * ld + n, v);
  }
};
// du = round_T(acc (s + 1.702 u s (1 - s))), s = sigmoid(1.702 u)   [du]
template <typename T> struct EpGeluBack {
  T* out; const T* u; int ld;
  __device__ float du(float da, float uv) const {
    const float s = sigmoid(1.702f * uv);
    return da * (s + 1.702f * uv * s * (1.f - s));
  }
  __device__ void operator()(int r, int n, float v0, float v1) const {
    const int64_t i = (int64_t)r * ld + n;
    put2(out + i, du(v0, to_f(u[i])), du(v1, to_f(u[i + 1])));
  }
  static constexpr bool kStaged = true;
  // its epilogue (u read, the derivative) outlasts a 256-wide tile's
  // loop; 128-wide tiles run two blocks an SM and overlap the two
  static constexpr int kBN = 128;
  __device__ uint4 pre(int r, int n) const {  // u's 8 values, loaded early
    return *reinterpret_cast<const uint4*>(u + (int64_t)r * ld + n);
  }
  __device__ void store8(int r, int n, float (&v)[8], uint4 uq) const {
    const __nv_bfloat162* up = reinterpret_cast<const __nv_bfloat162*>(&uq);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 uf = __bfloat1622float2(up[k]);
      v[2 * k] = du(v[2 * k], uf.x);
      v[2 * k + 1] = du(v[2 * k + 1], uf.y);
    }
    st8(out + (int64_t)r * ld + n, v);
  }
};

template <typename T> struct Tile;
template <> struct Tile<float> {
  static constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
};

// One BM x BN tile of C = A B in float32 (the float32 entry points'
// products; bf16's run on gemm_tc_kernel): A [M, K] row-major, B [K, N]
// row-major or, with BT, B = W^T for W [N, K] row-major; ep(row, col, c0,
// c1) takes the results.  One shared stage, each thread a 4x8 register
// tile of FMAs.
template <bool BT, typename Ep>
__device__ void tile_product(const float* __restrict__ A,
                             const float* __restrict__ B, int M, int N, int K,
                             const Ep& ep) {
  using TL = Tile<float>;
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, THREADS = TL::THREADS;
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN + (BT ? 1 : 0)];
  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty*4 .. +4
  const int tx = tid % 8;  // cols tx*8 .. +8
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto load8 = [](const float* p, bool ok, float (&v)[8]) {
    if (ok) {
      load_f32(p, v);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
    }
  };
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = tid + j * THREADS;
      const int ar = slot / (BK / 8), ac = (slot % (BK / 8)) * 8;
      float v[8];
      load8(A + (int64_t)(r0 + ar) * K + k0 + ac, r0 + ar < M && k0 + ac < K,
            v);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[ar][ac + i] = v[i];
      if constexpr (BT) {
        load8(B + (int64_t)(n0 + ar) * K + k0 + ac,
              n0 + ar < N && k0 + ac < K, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[ac + i][ar] = v[i];
      } else {
        const int kk = slot / (BN / 8), c = (slot % (BN / 8)) * 8;
        load8(B + (int64_t)(k0 + kk) * N + n0 + c, k0 + kk < K && n0 + c < N,
              v);
#pragma unroll
        for (int i = 0; i < 8; ++i) Bs[kk][c + i] = v[i];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int n = n0 + tx * 8 + j;
      if (n < N) ep(r, n, acc[i][j], acc[i][j + 1]);
    }
  }
}

template <typename T, bool BT, typename Ep>
__global__ void __launch_bounds__(Tile<T>::THREADS)
product_kernel(const T* __restrict__ A, const T* __restrict__ B, int M,
               int N, int K, Ep ep) {
  tile_product<BT>(A, B, M, N, K, ep);
}

// C [M, N] = A [M, K] B through `ep`; B is [K, N], or W [N, K] with BT
template <typename T, bool BT, typename Ep>
cudaError_t product(const T* A, const T* B, int M, int N, int K, const Ep& ep,
                    cudaStream_t stream) {
  const dim3 grid((N + Tile<T>::BN - 1) / Tile<T>::BN,
                  (M + Tile<T>::BM - 1) / Tile<T>::BM);
  product_kernel<T, BT, Ep><<<grid, Tile<T>::THREADS, 0, stream>>>(A, B, M, N,
                                                                   K, ep);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 products on wgmma

constexpr int GM_BM = 128;    // output rows: two consumer warpgroups of 64
constexpr int GM_BK = 64;     // K of a stage: one 128-byte swizzle row
constexpr int GM_BOXN = 64;   // N of one box of an MN-major B
constexpr int GM_THREADS = 288;  // 2 consumer warpgroups + 1 producer warp
constexpr int GM_A_BYTES = GM_BM * GM_BK * 2;
constexpr int GM_BOX_BYTES = GM_BOXN * GM_BK * 2;

// A tile of BN output columns (one wgmma.m64nBNk16 a warpgroup): BN = 256
// runs one block an SM with a ring of 4 stages; BN = 128 two blocks an SM
// (3 stages, at most 112 registers a thread), so that one block's
// epilogue overlaps the other's loop.
template <int BN> struct Gemm {
  static constexpr int STAGES = BN == 256 ? 4 : 3;
  static constexpr int BLOCKS = BN == 256 ? 1 : 2;  // per SM
  static constexpr int B_BYTES = BN * GM_BK * 2;
  static constexpr int STAGE_BYTES = GM_A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + alignment
  static constexpr int LDS = BN + 8;  // floats a row of the staged epilogue
  static_assert(STAGE_BYTES % 1024 == 0, "stages keep 1024-byte alignment");
  static_assert(2 * 64 * LDS * 4 <= STAGES * STAGE_BYTES,
                "the epilogue's staging fits in the ring");
};

// bar.sync on a named barrier among `count` threads (ids above 0; 0 is
// __syncthreads')
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// One 128 x BN tile of C = A B through `ep`: A [M, K] row-major; B [K, N]
// row-major (MN-major, read as 64-column boxes) or, with BT, B = W^T for
// W [N, K] row-major (K-major, one box).  blockIdx: x = column tile,
// y = row tile.
template <int BN, bool BT, typename Ep>
__global__ void __launch_bounds__(GM_THREADS, Gemm<BN>::BLOCKS)
gemm_tc_kernel(const __grid_constant__ CUtensorMap amap,
               const __grid_constant__ CUtensorMap bmap, int M, int N, int K,
               Ep ep) {
  using G = Gemm<BN>;
  __shared__ __align__(8) uint64_t full[G::STAGES], empty[G::STAGES];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = smem_align<1024>(smem_raw);
  const int r0 = blockIdx.y * GM_BM, n0 = blockIdx.x * BN;
  const int nk = (K + GM_BK - 1) / GM_BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < G::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid >= 2 * 128) {
    // producer: one thread keeps the ring filled.  An MN-major B loads
    // only the boxes that reach into N; the columns of a box it skips hold
    // whatever the stage held before and feed only outputs that are never
    // stored.
    if (tid != 2 * 128) return;
    const int boxes =
        BT ? 1 : min(BN / GM_BOXN, (N - n0 + GM_BOXN - 1) / GM_BOXN);
    const uint32_t bytes =
        GM_A_BYTES + (BT ? G::B_BYTES : boxes * GM_BOX_BYTES);
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % G::STAGES;
      mbar_wait(&empty[st], ((kt / G::STAGES) & 1) ^ 1);
      uint8_t* a = smem + st * G::STAGE_BYTES;
      uint8_t* b = a + GM_A_BYTES;
      const int k0 = kt * GM_BK;
      mbar_expect_tx(&full[st], bytes);
      tma_load_2d(a, &amap, &full[st], k0, r0);
      if (BT) {
        tma_load_2d(b, &bmap, &full[st], k0, n0);
      } else {
        for (int j = 0; j < boxes; ++j)
          tma_load_2d(b + j * GM_BOX_BYTES, &bmap, &full[st],
                      n0 + j * GM_BOXN, k0);
      }
    }
    return;
  }
  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % G::STAGES;
    mbar_wait(&full[st], (kt / G::STAGES) & 1);
    const uint8_t* a = smem + st * G::STAGE_BYTES + wg * (GM_A_BYTES / 2);
    const uint8_t* b = smem + st * G::STAGE_BYTES + GM_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GM_BK / 16; ++kk) {
      // A, and a K-major B: rows of 128 bytes, 8-row groups 1024 bytes
      // apart, the k16 slice 32 bytes along the row.  An MN-major B: K
      // rows of 128 bytes (64 N), 8-row groups 1024 bytes apart, 64-column
      // boxes GM_BOX_BYTES apart, the k16 slice 16 rows down.
      const uint64_t da = gmma_desc(a + kk * 32, 16, 1024, 1);
      const uint64_t db =
          BT ? gmma_desc(b + kk * 32, 16, 1024, 1)
             : gmma_desc(b + kk * 16 * 128, GM_BOX_BYTES, 1024, 1);
      wgmma_bf16<BN, BT ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    if (kt > 0 && tid % 128 == 0) mbar_arrive(&empty[(kt - 1) % G::STAGES]);
  }
  wgmma_wait<0>();
  const int wt = tid % 128, lane = tid % 32;
  if constexpr (!Ep::kStaged) {
    const int row = r0 + wg * 64 + wt / 32 * 16 + lane / 4;
    const int q = 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + q;
        if (n < N) ep(r, n, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  } else {
    // The staged epilogue: the ring is idle once both warpgroups are done
    // with it, so each stages its float32 64 x BN accumulator there in
    // wgmma's layout, then reads it back by rows: a thread takes 8
    // consecutive columns of every (128 / (BN / 8))-th row, loads what
    // those rows need (`ep.pre`: u) for all of them first, and
    // `ep.store8` writes 16 bytes a row, coalesced.
    named_bar_sync(1, 256);
    float* tile = reinterpret_cast<float*>(smem) + wg * 64 * G::LDS;
    {
      const int rr = wt / 32 * 16 + lane / 4, q = 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = tile + (rr + 8 * h) * G::LDS + q;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          *reinterpret_cast<float2*>(row + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    named_bar_sync(2 + wg, 128);
    constexpr int CHUNKS = BN / 8, STEP = 128 / CHUNKS, ROWS = 64 / STEP;
    const int c8 = 8 * (wt % CHUNKS), n = n0 + c8;
    if (n >= N) return;
    const int rl0 = wt / CHUNKS, rg0 = r0 + wg * 64 + rl0;  // rows + STEP i
    decltype(ep.pre(0, 0)) pre[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
      if (rg0 + STEP * i < M) pre[i] = ep.pre(rg0 + STEP * i, n);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (rg0 + STEP * i >= M) break;
      float v[8];
      const float4* src = reinterpret_cast<const float4*>(
          tile + (rl0 + STEP * i) * G::LDS + c8);
      const float4 lo = src[0], hi = src[1];
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
      ep.store8(rg0 + STEP * i, n, v, pre[i]);
    }
  }
}

// A tensor map over the row-major bf16 matrix [rows, cols] (cols a
// multiple of 8, the base 16-byte aligned) in boxes of box_rows x
// box_cols with the 128-byte swizzle; parts of a box past the matrix
// read as zero.
bool bf16_map_2d(CUtensorMap* map, const void* base, uint64_t rows,
                 uint64_t cols, uint32_t box_rows, uint32_t box_cols) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C [M, N] = A [M, K] B through `ep` on wgmma, in tiles Ep::kBN wide; B
// is [K, N], or W [N, K] with BT.  Returns a cudaError_t or
// ERR_TENSOR_MAP.
template <bool BT, typename Ep>
int product_tc(const bf16* A, const bf16* B, int M, int N, int K,
               const Ep& ep, cudaStream_t stream) {
  constexpr int BN = Ep::kBN;
  CUtensorMap amap, bmap;
  const bool ok =
      bf16_map_2d(&amap, A, M, K, GM_BM, GM_BK) &&
      (BT ? bf16_map_2d(&bmap, B, N, K, BN, GM_BK)
          : bf16_map_2d(&bmap, B, K, N, GM_BK, GM_BOXN));
  if (!ok) return ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_tc_kernel<BN, BT, Ep>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Gemm<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + GM_BM - 1) / GM_BM);
  gemm_tc_kernel<BN, BT, Ep><<<grid, GM_THREADS, Gemm<BN>::SMEM, stream>>>(
      amap, bmap, M, N, K, ep);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ attention

// Shared floats of the core kernels at (t, hd): two [t][hd + 1] matrices,
// per-warp rows and columns, and (backward) inv and rs per query row.
size_t core_fwd_smem(int t, int hd) {
  return sizeof(float) * (2 * (size_t)t * (hd + 1) +
                          kAttnWarps * ((size_t)hd + t));
}
size_t core_bwd_smem(int t, int hd) {
  return sizeof(float) * (2 * (size_t)t * (hd + 1) +
                          2 * kAttnWarps * ((size_t)hd + t) + 2 * (size_t)t);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int c = 0; c < n; ++c) s = fmaf(a[c], b[c], s);
  return s;
}

// A block per (sample, head): K and V in shared memory, each warp walks
// query rows; lanes take keys for the scores, head columns for o.
template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
core_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                float* __restrict__ inv_out, int t, int n_heads, int d,
                float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads, ld = hd + 1;
  float* ks = smem;
  float* vs = ks + t * ld;
  float* qbuf = vs + t * ld;           // [warps][hd]
  float* pbuf = qbuf + kAttnWarps * hd;  // [warps][t]: round_T(e)
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int64_t row0 = (int64_t)b * t, d3 = 3 * (int64_t)d;
  const T* base = qkv + row0 * d3 + (int64_t)h * hd;
  for (int e = threadIdx.x; e < t * hd; e += kAttnWarps * 32) {
    const int j = e / hd, c = e - j * hd;
    ks[j * ld + c] = to_f(base[j * d3 + d + c]);
    vs[j * ld + c] = to_f(base[j * d3 + 2 * d + c]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* q = qbuf + warp * hd;
  float* p = pbuf + warp * t;
  for (int i = warp; i < t; i += kAttnWarps) {
    for (int c = lane; c < hd; c += 32) q[c] = to_f(base[i * d3 + c]);
    __syncwarp();
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(fminf(dot(q, ks + j * ld, hd) * scale, 60.f));
      p[j] = rnd<T>(e);
      sum += e;
    }
    const float inv = 1.f / warp_sum(sum);
    __syncwarp();
    T* orow = out + (row0 + i) * d + (int64_t)h * hd;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc = fmaf(p[j], vs[j * ld + c], acc);
      orow[c] = from_f<T>(acc * inv);
    }
    if (lane == 0) inv_out[(row0 + i) * n_heads + h] = inv;
    __syncwarp();
  }
}

// dqkv of one (sample, head) in two phases over the same shared memory:
// with K, V resident each warp walks query rows (p32, dp, rs = sum dp p32,
// ds, dq); then with Q, dO resident each warp walks key rows, recomputes
// that key's column of p32 and ds from the saved inv and rs, and writes dk
// and dv.  The scores and dp are the same dot products in the same order
// in both phases, so the two phases see the same bits.
template <typename T>
__global__ void __launch_bounds__(kAttnWarps * 32)
core_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                const float* __restrict__ inv_in, T* __restrict__ dqkv, int t,
                int n_heads, int d, float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads, ld = hd + 1;
  float* ma = smem;                             // [t][ld]: K, then Q
  float* mb = ma + t * ld;                      // [t][ld]: V, then dO
  float* rows = mb + t * ld;                    // [2][warps][hd]
  float* cols = rows + 2 * kAttnWarps * hd;     // [2][warps][t]
  float* inv_s = cols + 2 * kAttnWarps * t;     // [t]
  float* rs_s = inv_s + t;                      // [t]
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int64_t row0 = (int64_t)b * t, d3 = 3 * (int64_t)d;
  const int64_t hoff = (int64_t)h * hd;
  const T* base = qkv + row0 * d3 + hoff;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* r1 = rows + warp * hd;                 // q_i, then k_j
  float* r2 = rows + (kAttnWarps + warp) * hd;  // do_i, then v_j
  float* pc = cols + warp * t;                  // p32 of a row / p column
  float* dsc = cols + (kAttnWarps + warp) * t;  // dp -> ds

  for (int e = threadIdx.x; e < t * hd; e += kAttnWarps * 32) {
    const int j = e / hd, c = e - j * hd;
    ma[j * ld + c] = to_f(base[j * d3 + d + c]);
    mb[j * ld + c] = to_f(base[j * d3 + 2 * d + c]);
  }
  for (int i = threadIdx.x; i < t; i += kAttnWarps * 32)
    inv_s[i] = inv_in[(row0 + i) * n_heads + h];
  __syncthreads();
  for (int i = warp; i < t; i += kAttnWarps) {
    for (int c = lane; c < hd; c += 32) {
      r1[c] = to_f(base[i * d3 + c]);
      r2[c] = to_f(dout[(row0 + i) * d + hoff + c]);
    }
    __syncwarp();
    float rs = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(fminf(dot(r1, ma + j * ld, hd) * scale, 60.f));
      const float p32 = e * inv_s[i];
      const float dp = dot(r2, mb + j * ld, hd);
      pc[j] = p32;
      dsc[j] = dp;
      rs += dp * p32;
    }
    rs = warp_sum(rs);
    if (lane == 0) rs_s[i] = rs;
    for (int j = lane; j < t; j += 32)
      dsc[j] = rnd<T>(pc[j] * (dsc[j] - rs) * scale);
    __syncwarp();
    T* dq = dqkv + (row0 + i) * d3 + hoff;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < t; ++j) acc = fmaf(dsc[j], ma[j * ld + c], acc);
      dq[c] = from_f<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  for (int e = threadIdx.x; e < t * hd; e += kAttnWarps * 32) {
    const int i = e / hd, c = e - i * hd;
    ma[i * ld + c] = to_f(base[i * d3 + c]);
    mb[i * ld + c] = to_f(dout[(row0 + i) * d + hoff + c]);
  }
  __syncthreads();
  for (int j = warp; j < t; j += kAttnWarps) {
    for (int c = lane; c < hd; c += 32) {
      r1[c] = to_f(base[j * d3 + d + c]);
      r2[c] = to_f(base[j * d3 + 2 * d + c]);
    }
    __syncwarp();
    for (int i = lane; i < t; i += 32) {
      const float e = expf(fminf(dot(ma + i * ld, r1, hd) * scale, 60.f));
      const float p32 = e * inv_s[i];
      const float dp = dot(mb + i * ld, r2, hd);
      pc[i] = rnd<T>(p32);
      dsc[i] = rnd<T>(p32 * (dp - rs_s[i]) * scale);
    }
    __syncwarp();
    T* r = dqkv + (row0 + j) * d3 + hoff;
    for (int c = lane; c < hd; c += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = 0; i < t; ++i) {
        ak = fmaf(dsc[i], ma[i * ld + c], ak);
        av = fmaf(pc[i], mb[i * ld + c], av);
      }
      r[d + c] = from_f<T>(ak);
      r[2 * d + c] = from_f<T>(av);
    }
    __syncwarp();
  }
}

template <typename T>
cudaError_t core_fwd(const T* qkv, T* out, float* inv, int rows, int t,
                     int n_heads, int d, float scale, cudaStream_t stream) {
  const size_t smem = core_fwd_smem(t, d / n_heads);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      core_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  core_fwd_kernel<T><<<(rows / t) * n_heads, kAttnWarps * 32, smem, stream>>>(
      qkv, out, inv, t, n_heads, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t core_bwd(const T* qkv, const T* dout, const float* inv, T* dqkv,
                     int rows, int t, int n_heads, int d, float scale,
                     cudaStream_t stream) {
  const size_t smem = core_bwd_smem(t, d / n_heads);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      core_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  core_bwd_kernel<T><<<(rows / t) * n_heads, kAttnWarps * 32, smem, stream>>>(
      qkv, dout, inv, dqkv, t, n_heads, d, scale);
  return cudaGetLastError();
}

// ------------------------------------------------- bf16 core on tensor cores

constexpr int kTcThreads = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr size_t kDqSmem = 6 * kTile * sizeof(bf16);  // Q, dO, 2 K, 2 V
constexpr size_t kDkvSmem =                           // K, V, 2 Q, 2 dO,
    6 * kTile * sizeof(bf16) + 4 * kRows * sizeof(float);  // 2 inv, 2 rs

// Rows [0, n) and head columns [0, hd) of a 64 x 64 tile from device
// memory (row stride ld) into shared memory, zeros elsewhere, so padded
// rows and columns add nothing to a product: hd = 64 by 16-byte cp.async
// (`tile_load`, in the caller's next commit group), a narrower head an
// element at a time.
__device__ __forceinline__ void head_load(bf16* s, const bf16* g, int64_t ld,
                                          int n, int hd, int tid) {
  if (hd == kHd) {
    tile_load(s, g, ld, n, tid, kTcThreads);
    return;
  }
  for (int e = tid; e < kRows * kHd; e += kTcThreads) {
    const int r = e / kHd, c = e % kHd;
    s[r * kLd + c] =
        r < n && c < hd ? g[r * ld + c] : __float2bfloat16_rn(0.f);
  }
}

// The warp's 16 x 64 accumulator, row r scaled by mul0 and row r + 8 by
// mul1 in float32, rounded to bf16, rows [0, n) and head columns [0, hd),
// to device memory at g (row stride ld): hd = 64 through `warp_store`
// (staged in the warp's own rows at s), else an element at a time.
__device__ __forceinline__ void head_store(bf16* s, const float (&acc)[8][4],
                                           bf16* __restrict__ g, int64_t ld,
                                           int n, int hd, int lane,
                                           float mul0 = 1.f,
                                           float mul1 = 1.f) {
  if (hd == kHd) {
    warp_store(s, acc, mul0, mul1, g, ld, n, lane);
    return;
  }
  const int r = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r + 8 * (e >> 1), col = 8 * j + c + (e & 1);
      if (row < n && col < hd)
        g[row * ld + col] = from_f<bf16>(acc[j][e] * (e < 2 ? mul0 : mul1));
    }
}

// o and inv of one 64-row query tile of one (sample, head): the clamp
// softmax forward on the tensor cores.  Each warp owns 16 query rows; Q
// comes by `head_load`, K and V in 64-key tiles double-buffered by
// cp.async (t <= 64: one tile, one stage, no loop).  e = exp(min(s scale,
// 60)) subtracts nothing, so e needs no rescaling across key tiles: o and
// the row sum simply add up.  Keys at and past t get e = 0 (a zero-filled
// key row would score 0 and add exp(0) = 1 to the row sum).  The row sum
// takes the float32 e: a lane sums its columns in key order, then the
// quad adds its four partial sums, a fixed order.  o += round_bf16(e) v
// (`to_a_frags` rounds, as the TPU kernel's `e.astype(dt)`), and at the
// end o = round_bf16(o inv), multiplied in float32 and rounded once.
__global__ void __launch_bounds__(kTcThreads)
core_fwd_tc_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                   float* __restrict__ inv_out, int t, int n_heads, int d,
                   float scale, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nk = (t + kRows - 1) / kRows;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile;                     // one stage, or two
  bf16* vs = ks + (nk > 1 ? 2 : 1) * kTile;  // as many
  const int b = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = d / n_heads;
  const int64_t d3 = 3 * (int64_t)d, hoff = (int64_t)h * hd;
  const int64_t rows0 = (int64_t)b * t;      // the sample's first row
  const bf16* base = qkv + rows0 * d3 + hoff;
  auto load_kv = [&](int st, int k0) {
    head_load(ks + st * kTile, base + k0 * d3 + d, d3, t - k0, hd, tid);
    head_load(vs + st * kTile, base + k0 * d3 + 2 * d, d3, t - k0, hd, tid);
    cp_async_commit();
  };
  head_load(qs, base + q0 * d3, d3, t - q0, hd, tid);
  load_kv(0, 0);                   // Q rides in the first group
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int w16 = warp * 16;
  const bf16* qw = qs + w16 * kLd;
  float o[8][4], sum[2] = {0.f, 0.f};
  zero_acc(o);
  for (int v = 0; v < nk; ++v) {
    const int st = v & 1, k0 = v * kRows;
    if (v + 1 < nk) {
      load_kv(st ^ 1, k0 + kRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
    zero_acc(s);
    warp_abt(s, qw, ks + st * kTile, lane);
    // e = exp(min(s scale, 60)); zero past the sample's keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = k0 + 8 * j + c + (e & 1) < t
                      ? expf(fminf(s[j][e] * scale, 60.f))
                      : 0.f;
        sum[e >> 1] += s[j][e];
      }
    unsigned pf[4][4];
    to_a_frags(pf, s);             // round_bf16(e)
    warp_pb(o, pf, vs + st * kTile, lane);
    __syncthreads();
  }
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
    sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
    inv[hh] = 1.f / sum[hh];
    const int row = q0 + w16 + r + 8 * hh;
    if (c == 0 && row < t) inv_out[(rows0 + row) * n_heads + h] = inv[hh];
  }
  // the warp's own Q rows (read by no other warp) stage its o
  head_store(qs + w16 * kLd, o, out + (rows0 + q0 + w16) * d + hoff, d,
             t - q0 - w16, hd, lane, inv[0], inv[1]);
}

// The bf16 core forward: one launch of `core_fwd_tc_kernel`, a block per
// (sample, 64-row query tile, head); heads up to 64 wide.
int core_fwd_tc(const bf16* qkv, bf16* out, float* inv, int rows, int t,
                int n_heads, int d, float scale, cudaStream_t stream) {
  if (d / n_heads > kHd) return (int)cudaErrorInvalidValue;
  const int n_tiles = (t + kRows - 1) / kRows;
  const size_t smem = (1 + 2 * (n_tiles > 1 ? 2 : 1)) * kTile * sizeof(bf16);
  core_fwd_tc_kernel<<<dim3((rows / t) * n_tiles, n_heads), kTcThreads, smem,
                       stream>>>(qkv, out, inv, t, n_heads, d, scale,
                                 n_tiles);
  return (int)cudaGetLastError();
}

// dq of one 64-row query tile of one (sample, head) with t > 64, and
// rs = sum_j dp p32 of its rows into rs_out [rows, n_heads].  Each warp
// owns 16 query rows; K and V come in 64-key tiles, double-buffered.  rs
// needs the whole row before any ds, so the block walks the keys twice:
// the first sweep sums rs, the second forms ds and dq.  A lane sums its
// columns in key order, then the quad adds its four partial sums: a
// fixed order.
__global__ void __launch_bounds__(kTcThreads)
core_dq_tc_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                  const float* __restrict__ inv_in, bf16* __restrict__ dqkv,
                  float* __restrict__ rs_out, int t, int n_heads, int d,
                  float scale, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kTile;           // dO
  bf16* ks = gs + kTile;           // two stages
  bf16* vs = ks + 2 * kTile;       // two stages
  const int b = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = d / n_heads;
  const int64_t d3 = 3 * (int64_t)d, hoff = (int64_t)h * hd;
  const int64_t rows0 = (int64_t)b * t;      // the sample's first row
  const bf16* base = qkv + rows0 * d3 + hoff;
  const int nk = (t + kRows - 1) / kRows;
  const int nv = 2 * nk;                     // key tiles visited
  auto load_kv = [&](int st, int k0) {
    head_load(ks + st * kTile, base + k0 * d3 + d, d3, t - k0, hd, tid);
    head_load(vs + st * kTile, base + k0 * d3 + 2 * d, d3, t - k0, hd, tid);
    cp_async_commit();
  };
  head_load(qs, base + q0 * d3, d3, t - q0, hd, tid);
  head_load(gs, dout + (rows0 + q0) * d + hoff, d, t - q0, hd, tid);
  load_kv(0, 0);                   // Q and dO ride in the first group
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + r;       // this lane's rows: +0, +8
  float inv[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    inv[hh] = row < t ? inv_in[(rows0 + row) * n_heads + h] : 0.f;
  }
  const bf16* qw = qs + warp * 16 * kLd;
  const bf16* gw = gs + warp * 16 * kLd;
  float dq[8][4];
  zero_acc(dq);
  for (int v = 0; v < nv; ++v) {
    const int st = v & 1, k0 = (v % nk) * kRows;
    if (v + 1 < nv) {
      load_kv(st ^ 1, ((v + 1) % nk) * kRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    warp_abt(s, qw, ks + st * kTile, lane);
    warp_abt(dp, gw, vs + st * kTile, lane);
    // p32 = exp(min(s scale, 60)) inv; zero past the sample's keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + 8 * j + c + (e & 1) < t
                      ? expf(fminf(s[j][e] * scale, 60.f)) * inv[e >> 1]
                      : 0.f;
    if (v < nk) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += dp[j][e] * s[j][e];
    } else {
      if (v == nk) {               // every key summed: rs of the whole row
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
          rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)          // ds, rounded by to_a_frags
          s[j][e] = s[j][e] * (dp[j][e] - rs[e >> 1]) * scale;
      unsigned df[4][4];
      to_a_frags(df, s);
      warp_pb(dq, df, ks + st * kTile, lane);
    }
    __syncthreads();
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row < t) rs_out[(rows0 + row) * n_heads + h] = rs[hh];
    }
  }
  head_store(qs + warp * 16 * kLd, dq,
             dqkv + (rows0 + q0 + warp * 16) * d3 + hoff, d3,
             t - q0 - warp * 16, hd, lane);
}

// dk and dv of one 64-key tile of one (sample, head): K and V resident,
// the query tiles of Q and dO double-buffered with their rows' inv and rs
// (from the dq pass).  S^T = K Q^T and dP^T = V dO^T come out key-major,
// so P^T and dS^T sit in registers as the A operands of dV += P^T dO and
// dK += dS^T Q.
__global__ void __launch_bounds__(kTcThreads)
core_dkv_tc_kernel(const bf16* __restrict__ qkv,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ inv_in,
                   const float* __restrict__ rs_in, bf16* __restrict__ dqkv,
                   int t, int n_heads, int d, float scale, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;           // two stages
  bf16* gs = qs + 2 * kTile;       // dO, two stages
  float* inv_s = reinterpret_cast<float*>(gs + 2 * kTile);  // [2][64]
  float* rs_s = inv_s + 2 * kRows;                          // [2][64]
  const int b = blockIdx.x / n_tiles, j0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = d / n_heads;
  const int64_t d3 = 3 * (int64_t)d, hoff = (int64_t)h * hd;
  const int64_t rows0 = (int64_t)b * t;
  const bf16* base = qkv + rows0 * d3 + hoff;
  const int nq = (t + kRows - 1) / kRows;
  const int c = (lane & 3) * 2;
  auto stage = [&](int st, int i0) {
    head_load(qs + st * kTile, base + i0 * d3, d3, t - i0, hd, tid);
    head_load(gs + st * kTile, dout + (rows0 + i0) * d + hoff, d, t - i0, hd,
              tid);
    cp_async_commit();
    for (int i = tid; i < kRows; i += kTcThreads) {
      const int row = i0 + i;
      const int64_t at = (rows0 + row) * n_heads + h;
      inv_s[st * kRows + i] = row < t ? inv_in[at] : 0.f;
      rs_s[st * kRows + i] = row < t ? rs_in[at] : 0.f;
    }
  };
  head_load(ks, base + j0 * d3 + d, d3, t - j0, hd, tid);
  head_load(vs, base + j0 * d3 + 2 * d, d3, t - j0, hd, tid);
  stage(0, 0);                     // K and V ride in the first group
  const bf16* kw = ks + warp * 16 * kLd;
  const bf16* vw = vs + warp * 16 * kLd;
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int qt = 0; qt < nq; ++qt) {
    const int st = qt & 1, i0 = qt * kRows;
    if (qt + 1 < nq) {
      stage(st ^ 1, i0 + kRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qst = qs + st * kTile;
    const bf16* gst = gs + st * kTile;
    const float* inv_t = inv_s + st * kRows;
    const float* rs_t = rs_s + st * kRows;
    float s[8][4], dp[8][4];       // key rows x query columns
    zero_acc(s);
    zero_acc(dp);
    warp_abt(s, kw, qst, lane);
    warp_abt(dp, vw, gst, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        const float p = i0 + col < t
                            ? expf(fminf(s[j][e] * scale, 60.f)) * inv_t[col]
                            : 0.f;
        s[j][e] = p;                                  // p32^T
        dp[j][e] = p * (dp[j][e] - rs_t[col]) * scale;  // ds^T
      }
    unsigned af[4][4];
    to_a_frags(af, s);
    warp_pb(dv, af, gst, lane);    // dv += round(p32)^T do
    to_a_frags(af, dp);
    warp_pb(dk, af, qst, lane);    // dk += round(ds)^T q
    __syncthreads();
  }
  bf16* dk_g = dqkv + (rows0 + j0 + warp * 16) * d3 + d + hoff;
  const int n_rows = t - j0 - warp * 16;
  head_store(ks + warp * 16 * kLd, dk, dk_g, d3, n_rows, hd, lane);
  head_store(vs + warp * 16 * kLd, dv, dk_g + d, d3, n_rows, hd, lane);
}

constexpr size_t kOneSmem =                   // Q, dO, K, V, a staging
    5 * kTile * sizeof(bf16) + 2 * kRows * sizeof(float);  // tile; inv, rs

// dq, dk and dv of one (sample, head) with t <= 64 in one block: Q, dO, K
// and V stay in shared memory for both phases.  First each warp owns 16
// query rows (S, dP, rs, dS, dq, as the dq pass), and rs goes to shared
// memory; then each warp owns 16 key rows (S^T, dP^T, dv, dk, as the
// dk/dv pass).
__global__ void __launch_bounds__(kTcThreads)
core_one_tile_tc_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ inv_in,
                        bf16* __restrict__ dqkv, int t, int n_heads, int d,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kTile;           // dO
  bf16* ks = gs + kTile;
  bf16* vs = ks + kTile;
  bf16* os = vs + kTile;           // the warps' output staging
  float* inv_s = reinterpret_cast<float*>(os + kTile);  // [64]
  float* rs_s = inv_s + kRows;                          // [64]
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = d / n_heads;
  const int64_t d3 = 3 * (int64_t)d, hoff = (int64_t)h * hd;
  const int64_t rows0 = (int64_t)blockIdx.x * t;
  const bf16* base = qkv + rows0 * d3 + hoff;
  head_load(qs, base, d3, t, hd, tid);
  head_load(gs, dout + rows0 * d + hoff, d, t, hd, tid);
  head_load(ks, base + d, d3, t, hd, tid);
  head_load(vs, base + 2 * d, d3, t, hd, tid);
  cp_async_commit();
  for (int i = tid; i < kRows; i += kTcThreads)
    inv_s[i] = i < t ? inv_in[(rows0 + i) * n_heads + h] : 0.f;
  cp_async_wait<0>();
  __syncthreads();
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int w16 = warp * 16;
  bf16* ow = os + w16 * kLd;
  {
    // query rows w16 + r, + 8
    float s[8][4], dp[8][4], rs[2] = {0.f, 0.f};
    zero_acc(s);
    zero_acc(dp);
    warp_abt(s, qs + w16 * kLd, ks, lane);
    warp_abt(dp, gs + w16 * kLd, vs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 8 * j + c + (e & 1) < t
                      ? expf(fminf(s[j][e] * scale, 60.f)) *
                            inv_s[w16 + r + 8 * (e >> 1)]
                      : 0.f;
        rs[e >> 1] += dp[j][e] * s[j][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 1);
      rs[hh] += __shfl_xor_sync(0xffffffffu, rs[hh], 2);
      if (c == 0) rs_s[w16 + r + 8 * hh] = rs[hh];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)            // ds, rounded by to_a_frags
        s[j][e] = s[j][e] * (dp[j][e] - rs[e >> 1]) * scale;
    unsigned df[4][4];
    to_a_frags(df, s);
    float dq[8][4];
    zero_acc(dq);
    warp_pb(dq, df, ks, lane);
    head_store(ow, dq, dqkv + (rows0 + w16) * d3 + hoff, d3, t - w16, hd,
               lane);
  }
  __syncthreads();                 // every row's rs is in rs_s
  {
    // key rows w16 + r, + 8; query columns
    float s[8][4], dp[8][4];
    zero_acc(s);
    zero_acc(dp);
    warp_abt(s, ks + w16 * kLd, qs, lane);
    warp_abt(dp, vs + w16 * kLd, gs, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        const float p = col < t
                            ? expf(fminf(s[j][e] * scale, 60.f)) * inv_s[col]
                            : 0.f;
        s[j][e] = p;                                     // p32^T
        dp[j][e] = p * (dp[j][e] - rs_s[col]) * scale;   // ds^T
      }
    unsigned af[4][4];
    float dk[8][4], dv[8][4];
    zero_acc(dk);
    zero_acc(dv);
    to_a_frags(af, s);
    warp_pb(dv, af, gs, lane);     // dv += round(p32)^T do
    to_a_frags(af, dp);
    warp_pb(dk, af, qs, lane);     // dk += round(ds)^T q
    bf16* dk_g = dqkv + (rows0 + w16) * d3 + d + hoff;
    head_store(ow, dk, dk_g, d3, t - w16, hd, lane);
    head_store(ow, dv, dk_g + d, d3, t - w16, hd, lane);
  }
}

// The bf16 core backward: one launch of `core_one_tile_tc_kernel` for
// t <= 64, else the dq pass (which writes rs, float32 scratch
// [rows, n_heads]) and then the dk/dv pass.  Heads up to 64 wide.
int core_bwd_tc(const bf16* qkv, const bf16* dout, const float* inv,
                float* rs, bf16* dqkv, int rows, int t, int n_heads, int d,
                float scale, cudaStream_t stream) {
  if (d / n_heads > kHd) return (int)cudaErrorInvalidValue;
  if (t <= kRows) {
    core_one_tile_tc_kernel<<<dim3(rows / t, n_heads), kTcThreads, kOneSmem,
                              stream>>>(qkv, dout, inv, dqkv, t, n_heads, d,
                                        scale);
    return (int)cudaGetLastError();
  }
  const int n_tiles = (t + kRows - 1) / kRows;
  const dim3 grid((rows / t) * n_tiles, n_heads);
  cudaError_t err = cudaFuncSetAttribute(
      core_dq_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(core_dkv_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  core_dq_tc_kernel<<<grid, kTcThreads, kDqSmem, stream>>>(
      qkv, dout, inv, dqkv, rs, t, n_heads, d, scale, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  core_dkv_tc_kernel<<<grid, kTcThreads, kDkvSmem, stream>>>(
      qkv, dout, inv, rs, dqkv, t, n_heads, d, scale, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t layer_norm(const T* x, const float* g, const float* b, T* h,
                       float* stat, int rows, int d, cudaStream_t stream) {
  ln_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                 stream>>>(x, g, b, h, stat, rows, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t layer_norm_back(const T* x, const float* g, const float* stat,
                            const float* dh, const T* dy, T* dx, int rows,
                            int d, cudaStream_t stream) {
  ln_back_kernel<T><<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0,
                      stream>>>(x, g, stat, dh, dy, dx, rows, d);
  return cudaGetLastError();
}

#define TRY(call)                   \
  do {                              \
    const int err_ = (int)(call);   \
    if (err_ != 0) return err_;     \
  } while (0)

// The chains' products and attention cores: bf16 on wgmma and the
// tensor-core cores, float32 on the FMA tiles and the scalar cores.
template <bool BT, typename Ep>
int run_product(const bf16* A, const bf16* B, int M, int N, int K,
                const Ep& ep, cudaStream_t s) {
  return product_tc<BT>(A, B, M, N, K, ep, s);
}
template <bool BT, typename Ep>
int run_product(const float* A, const float* B, int M, int N, int K,
                const Ep& ep, cudaStream_t s) {
  return (int)product<float, BT>(A, B, M, N, K, ep, s);
}
int core_forward(const bf16* qkv, bf16* o, float* inv, int rows, int t,
                 int n_heads, int d, float scale, cudaStream_t s) {
  return core_fwd_tc(qkv, o, inv, rows, t, n_heads, d, scale, s);
}
int core_forward(const float* qkv, float* o, float* inv, int rows, int t,
                 int n_heads, int d, float scale, cudaStream_t s) {
  return (int)core_fwd(qkv, o, inv, rows, t, n_heads, d, scale, s);
}
int core_back(const bf16* qkv, const bf16* dout, const float* inv, float* rs,
              bf16* dqkv, int rows, int t, int n_heads, int d, float scale,
              cudaStream_t s) {
  return core_bwd_tc(qkv, dout, inv, rs, dqkv, rows, t, n_heads, d, scale,
                     s);
}
int core_back(const float* qkv, const float* dout, const float* inv,
              float* /* rs */, float* dqkv, int rows, int t, int n_heads,
              int d, float scale, cudaStream_t s) {
  return (int)core_bwd(qkv, dout, inv, dqkv, rows, t, n_heads, d, scale, s);
}

// The bf16 forward products' tile widths, each measured at 256 against
// 128 at ViT-B/32's shape (chip_smoke.py's `block fwd launch` lines): qkv
// 256 (0.0719 against 0.0734 ms), out-proj 128 (0.0309 against 0.0327:
// K = 768 is too short a loop to hide the residual read), fc 128 (0.1278
// against 0.1611: the quick_gelu epilogue), proj 256 (0.0743 against
// 0.0847: K = 3072).
constexpr int kQkvBN = 256, kOutBN = 128, kFcBN = 128, kProjBN = 256;

template <typename T>
int attn_fwd(const T* x, const float* g, const float* b, const T* in_w,
             const T* in_b, const T* out_w, const T* out_b, T* h, T* qkv,
             T* o, T* y, float* inv, int rows, int d, int n_heads, int t,
             float scale, cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, (float*)nullptr, rows, d, s));
  TRY((run_product<false>(h, in_w, rows, 3 * d, d,
                          EpBias<T, kQkvBN>{qkv, in_b, 3 * d}, s)));
  TRY(core_forward(qkv, o, inv, rows, t, n_heads, d, scale, s));
  TRY((run_product<false>(o, out_w, rows, d, d,
                          EpBiasResidual<T, kOutBN>{y, out_b, x, d}, s)));
  return 0;
}

template <typename T>
int attn_bwd(const T* x, const T* dy, const float* inv, const float* g,
             const float* b, const T* in_w, const T* in_b, const T* out_w,
             T* h, float* stat, T* qkv, T* dout, T* dqkv, float* rs,
             float* dh, T* dx, int rows, int d, int n_heads, int t,
             float scale, cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, stat, rows, d, s));
  TRY((run_product<false>(h, in_w, rows, 3 * d, d,
                           EpBias<T>{qkv, in_b, 3 * d}, s)));
  TRY((run_product<true>(dy, out_w, rows, d, d, EpStore<T>{dout, d}, s)));
  TRY(core_back(qkv, dout, inv, rs, dqkv, rows, t, n_heads, d, scale, s));
  TRY((run_product<true>(dqkv, in_w, rows, d, 3 * d,
                          EpStore<float>{dh, d}, s)));
  TRY(layer_norm_back(x, g, stat, dh, dy, dx, rows, d, s));
  return 0;
}

template <typename T>
int mlp_fwd(const T* x, const float* g, const float* b, const T* fc_w,
            const T* fc_b, const T* p_w, const T* p_b, T* h, T* a, T* y,
            int rows, int d, int hidden, cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, (float*)nullptr, rows, d, s));
  TRY((run_product<false>(h, fc_w, rows, hidden, d,
                          EpBiasGelu<T, kFcBN>{a, fc_b, hidden}, s)));
  TRY((run_product<false>(a, p_w, rows, d, hidden,
                          EpBiasResidual<T, kProjBN>{y, p_b, x, d}, s)));
  return 0;
}

template <typename T>
int mlp_bwd(const T* x, const T* dy, const float* g, const float* b,
            const T* fc_w, const T* fc_b, const T* p_w, T* h, float* stat,
            T* u, T* du, float* dh, T* dx, int rows, int d, int hidden,
            cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, stat, rows, d, s));
  TRY((run_product<false>(h, fc_w, rows, hidden, d,
                           EpBias<T>{u, fc_b, hidden}, s)));
  TRY((run_product<true>(dy, p_w, rows, hidden, d,
                          EpGeluBack<T>{du, u, hidden}, s)));
  TRY((run_product<true>(du, fc_w, rows, d, hidden, EpStore<float>{dh, d},
                          s)));
  TRY(layer_norm_back(x, g, stat, dh, dy, dx, rows, d, s));
  return 0;
}

// One bf16 product of kind 0, 4 or 5 of `block_product` in tiles BN wide.
template <int BN>
int fwd_product(const bf16* A, const bf16* W, const bf16* bias,
                const bf16* aux, bf16* out, int m, int n, int k, int kind,
                cudaStream_t s) {
  switch (kind) {
    case 0:
      return product_tc<false>(A, W, m, n, k, EpBias<bf16, BN>{out, bias, n},
                               s);
    case 4:
      return product_tc<false>(
          A, W, m, n, k, EpBiasResidual<bf16, BN>{out, bias, aux, n}, s);
    case 5:
      return product_tc<false>(A, W, m, n, k,
                               EpBiasGelu<bf16, BN>{out, bias, n}, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y, h, o [rows, d], qkv [rows, 3d], in_w [d, 3d], in_b [3d],
// out_w [d, d], out_b [d] in T (bf16 when `is_bf16` is 1, else float32);
// g, b [d] and inv [rows, n_heads] float32.  h, qkv, o are scratch.
int attn_half_fwd(const void* x, const void* g, const void* b,
                  const void* in_w, const void* in_b, const void* out_w,
                  const void* out_b, void* h, void* qkv, void* o, void* y,
                  void* inv, int rows, int d, int n_heads, int t, float scale,
                  int is_bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return attn_fwd<__nv_bfloat16>(
        (const bf16*)x, (const float*)g, (const float*)b, (const bf16*)in_w,
        (const bf16*)in_b, (const bf16*)out_w, (const bf16*)out_b, (bf16*)h,
        (bf16*)qkv, (bf16*)o, (bf16*)y, (float*)inv, rows, d, n_heads, t,
        scale, s);
  return attn_fwd<float>(
      (const float*)x, (const float*)g, (const float*)b, (const float*)in_w,
      (const float*)in_b, (const float*)out_w, (const float*)out_b,
      (float*)h, (float*)qkv, (float*)o, (float*)y, (float*)inv, rows, d,
      n_heads, t, scale, s);
}

// as above, with dy, dx, dout [rows, d] and dqkv [rows, 3d] in T; stat
// [rows, 2], rs [rows, n_heads] and dh [rows, d] float32; h, stat, qkv,
// dout, dqkv, rs, dh scratch (rs is written by the bf16 core only).  bf16
// needs heads up to 64 wide and 16-byte aligned bases (TMA).
int attn_half_bwd(const void* x, const void* dy, const void* inv,
                  const void* g, const void* b, const void* in_w,
                  const void* in_b, const void* out_w, void* h, void* stat,
                  void* qkv, void* dout, void* dqkv, void* rs, void* dh,
                  void* dx, int rows, int d, int n_heads, int t, float scale,
                  int is_bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return attn_bwd<__nv_bfloat16>(
        (const bf16*)x, (const bf16*)dy, (const float*)inv, (const float*)g,
        (const float*)b, (const bf16*)in_w, (const bf16*)in_b,
        (const bf16*)out_w, (bf16*)h, (float*)stat, (bf16*)qkv,
        (bf16*)dout, (bf16*)dqkv, (float*)rs, (float*)dh, (bf16*)dx, rows,
        d, n_heads, t, scale, s);
  return attn_bwd<float>(
      (const float*)x, (const float*)dy, (const float*)inv, (const float*)g,
      (const float*)b, (const float*)in_w, (const float*)in_b,
      (const float*)out_w, (float*)h, (float*)stat, (float*)qkv,
      (float*)dout, (float*)dqkv, (float*)rs, (float*)dh, (float*)dx, rows,
      d, n_heads, t, scale, s);
}

// x, y, h [rows, d], a [rows, hidden], fc_w [d, hidden], fc_b [hidden],
// p_w [hidden, d], p_b [d] in T; g, b [d] float32.  h, a are scratch.
int mlp_half_fwd(const void* x, const void* g, const void* b,
                 const void* fc_w, const void* fc_b, const void* p_w,
                 const void* p_b, void* h, void* a, void* y, int rows, int d,
                 int hidden, int is_bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return mlp_fwd<__nv_bfloat16>(
        (const bf16*)x, (const float*)g, (const float*)b, (const bf16*)fc_w,
        (const bf16*)fc_b, (const bf16*)p_w, (const bf16*)p_b, (bf16*)h,
        (bf16*)a, (bf16*)y, rows, d, hidden, s);
  return mlp_fwd<float>(
      (const float*)x, (const float*)g, (const float*)b, (const float*)fc_w,
      (const float*)fc_b, (const float*)p_w, (const float*)p_b, (float*)h,
      (float*)a, (float*)y, rows, d, hidden, s);
}

// as above, with dy, dx [rows, d] and u, du [rows, hidden] in T; stat
// [rows, 2] and dh [rows, d] float32; h, stat, u, du, dh scratch.
int mlp_half_bwd(const void* x, const void* dy, const void* g, const void* b,
                 const void* fc_w, const void* fc_b, const void* p_w, void* h,
                 void* stat, void* u, void* du, void* dh, void* dx, int rows,
                 int d, int hidden, int is_bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return mlp_bwd<__nv_bfloat16>(
        (const bf16*)x, (const bf16*)dy, (const float*)g, (const float*)b,
        (const bf16*)fc_w, (const bf16*)fc_b, (const bf16*)p_w, (bf16*)h,
        (float*)stat, (bf16*)u, (bf16*)du, (float*)dh, (bf16*)dx, rows, d,
        hidden, s);
  return mlp_bwd<float>(
      (const float*)x, (const float*)dy, (const float*)g, (const float*)b,
      (const float*)fc_w, (const float*)fc_b, (const float*)p_w, (float*)h,
      (float*)stat, (float*)u, (float*)du, (float*)dh, (float*)dx, rows, d,
      hidden, s);
}

// One bf16 product of the chains alone, as the entry points launch it
// (for per-launch timing and checks): out = a [m, k] times w through
// epilogue `kind`:
//   0  out = round(round(a @ w) + bias), w [k, n]                (qkv, u)
//   1  out = round(a @ w^T), w [n, k]                               (do)
//   2  out = a @ w^T in float32, w [n, k]                           (dh)
//   3  out = round((a @ w^T) gelu'(aux)), w [n, k], aux = u [m, n]  (du)
//   4  out = round(aux + round(round(a @ w) + bias)), w [k, n], aux the
//      residual x [m, n]                                   (out-proj, proj)
//   5  out = round(u sigmoid(1.702 u)), u = round(round(a @ w) + bias),
//      w [k, n]                                                     (fc)
// bias is [n]; out is bf16 [m, n] (float32 for kind 2).  `width` is the
// tile width, 128 or 256, for kinds 0, 4 and 5 (0: 256); kinds 1-3 take
// only 0 (their own: 256, 256, 128).
int block_product(const void* a, const void* w, const void* bias,
                  const void* aux, void* out, int m, int n, int k, int kind,
                  int width, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const bf16* A = (const bf16*)a;
  const bf16* W = (const bf16*)w;
  const bf16* B = (const bf16*)bias;
  const bf16* X = (const bf16*)aux;
  if (kind == 0 || kind == 4 || kind == 5) {
    if (width == 0 || width == 256)
      return fwd_product<256>(A, W, B, X, (bf16*)out, m, n, k, kind, s);
    if (width == 128)
      return fwd_product<128>(A, W, B, X, (bf16*)out, m, n, k, kind, s);
    return (int)cudaErrorInvalidValue;
  }
  if (width != 0) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 1:
      return product_tc<true>(A, W, m, n, k, EpStore<bf16>{(bf16*)out, n}, s);
    case 2:
      return product_tc<true>(A, W, m, n, k, EpStore<float>{(float*)out, n},
                              s);
    case 3:
      return product_tc<true>(A, W, m, n, k,
                              EpGeluBack<bf16>{(bf16*)out, X, n}, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 attention core forward alone, as attn_half_fwd launches it:
// o [rows, d] bf16 and inv [rows, n_heads] float32 from qkv [rows, 3d].
int block_core_fwd(const void* qkv, void* o, void* inv, int rows, int t,
                   int n_heads, int d, float scale, void* stream) {
  return core_fwd_tc((const bf16*)qkv, (bf16*)o, (float*)inv, rows, t,
                     n_heads, d, scale, (cudaStream_t)stream);
}

// The bf16 attention core backward alone, as attn_half_bwd launches it:
// dqkv [rows, 3d] bf16 and rs [rows, n_heads] float32 (scratch) from qkv
// [rows, 3d], dout [rows, d] bf16 and inv [rows, n_heads] float32.
int block_core_bwd(const void* qkv, const void* dout, const void* inv,
                   void* rs, void* dqkv, int rows, int t, int n_heads, int d,
                   float scale, void* stream) {
  return core_bwd_tc((const bf16*)qkv, (const bf16*)dout, (const float*)inv,
                     (float*)rs, (bf16*)dqkv, rows, t, n_heads, d, scale,
                     (cudaStream_t)stream);
}

// Shared-memory bytes of the float32 scalar attention cores at (t, hd),
// so the caller can refuse a shape before launching; the bf16 cores need
// at most 55 KB at any t.
int block_smem_bytes(int t, int hd, int backward) {
  return (int)(backward ? core_bwd_smem(t, hd) : core_fwd_smem(t, hd));
}

const char* kernel_error_string(int code) { return error_string(code); }

}  // extern "C"
