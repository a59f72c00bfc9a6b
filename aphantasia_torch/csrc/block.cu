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
// 29-44 MB of activations read and written and 3.5-9.4 MB of bf16 weights.  The TPU kernel keeps a half's weights resident in VMEM
// and runs it as one grid; on the card a block has 227 KB of shared memory
// against 3.4 MB for in_w alone, so each entry point is a short chain of
// launches whose intermediates go through device memory:
//   a warp per row for the LayerNorm (and, in the backward, the LN
//   backward fused with the residual add);
//   one tiled product with a fused epilogue for every matrix product:
//   bias, bias + residual, bias + quick_gelu, round, float32, and the
//   quick_gelu derivative; with B as the row-major weight [K, N] or as its
//   transpose ([N, K], for the `@ W^T` products of the backward).  bf16:
//   128x128x32 tiles over 8 warps of ldmatrix-fed mma.sync m16n8k16 with
//   float32 accumulators and a cp.async double buffer (the tile of
//   csrc/cutout_win.cu, on dense operands).  float32: 64x64 tiles of
//   register FMAs (the tensor cores would round to TF32);
//   a block per (sample, head) for the attention core, scalar float32
//   from shared memory, two phases in the backward (dq with K, V resident;
//   dk, dv with Q, dO resident), as csrc/attention.cu, with the clamp and
//   the roundings above.
// The entry points make 4, 6, 3 and 5 launches; each is counted once by
// its wrapper.  wgmma, TMA, weights resident in persistent blocks and a
// tensor-core attention core are later speed work (PERF.md).
//
// Shapes: D and the MLP width are multiples of 8 (16-byte rows), R is a
// multiple of t, D a multiple of the heads.  Every tile guards its rows
// and columns, so R, D and the widths need no other alignment.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

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
// below M and an even col below N (N % 8 == 0, so col + 1 < N too).

__device__ __forceinline__ void put2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void put2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// out = round_T(round_T(acc) + bias)                  [qkv, u]
template <typename T> struct EpBias {
  T* out; const T* bias; int ld;
  __device__ void operator()(int r, int n, float v0, float v1) const {
    put2(out + (int64_t)r * ld + n, rnd<T>(v0) + to_f(bias[n]),
         rnd<T>(v1) + to_f(bias[n + 1]));
  }
};
// out = round_T(res + round_T(round_T(acc) + bias))   [out_proj, proj]
template <typename T> struct EpBiasResidual {
  T* out; const T* bias; const T* res; int ld;
  __device__ void operator()(int r, int n, float v0, float v1) const {
    const int64_t i = (int64_t)r * ld + n;
    put2(out + i, to_f(res[i]) + rnd<T>(rnd<T>(v0) + to_f(bias[n])),
         to_f(res[i + 1]) + rnd<T>(rnd<T>(v1) + to_f(bias[n + 1])));
  }
};
// out = round_T(u sigmoid(1.702 u)), u = round_T(round_T(acc) + bias)   [fc]
template <typename T> struct EpBiasGelu {
  T* out; const T* bias; int ld;
  __device__ float gelu(float v, float b) const {
    const float u = rnd<T>(rnd<T>(v) + b);
    return u * sigmoid(1.702f * u);
  }
  __device__ void operator()(int r, int n, float v0, float v1) const {
    put2(out + (int64_t)r * ld + n, gelu(v0, to_f(bias[n])),
         gelu(v1, to_f(bias[n + 1])));
  }
};
// out = acc in T (round_T) or float32                  [do; dh]
template <typename O> struct EpStore {
  O* out; int ld;
  __device__ void operator()(int r, int n, float v0, float v1) const {
    put2(out + (int64_t)r * ld + n, v0, v1);
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
};

// 16 bytes of a shared tile from src, or zeros where the chunk lies
// outside the matrix
__device__ __forceinline__ void fill16(bf16* dst, const bf16* src, bool ok) {
  if (ok)
    cp_async16(dst, src);
  else
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
}

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
};
template <> struct Tile<float> {
  static constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
};

// One BM x BN tile of C = A B, A [M, K] row-major, B [K, N] row-major or,
// with BT, B = W^T for W [N, K] row-major; ep(row, col, c0, c1) takes the
// float32 results.  bf16: the next 32-deep K step's tiles are copied into
// the second shared stage with cp.async while the tensor cores work on the
// current one; ldmatrix brings each 16x16 A fragment and each pair of
// 16x8 B fragments (transposed for a row-major B; as stored for W, whose
// rows are B's columns); each of the 8 warps accumulates 32x64 of the tile.
template <bool BT, typename Ep>
__device__ void tile_product(const bf16* __restrict__ A,
                             const bf16* __restrict__ B, int M, int N, int K,
                             const Ep& ep) {
  using TL = Tile<bf16>;
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, THREADS = TL::THREADS;
  __shared__ __align__(128) bf16 As[2][BM][BK + 8];
  __shared__ __align__(128) bf16 Bs[2][BT ? BN : BK][BT ? BK + 8 : BN + 8];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 64;
  const int r0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  auto fill = [&](int st, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = tid + j * THREADS;
      const int ar = slot / (BK / 8), ac = (slot % (BK / 8)) * 8;
      fill16(&As[st][ar][ac], A + (int64_t)(r0 + ar) * K + k0 + ac,
             r0 + ar < M && k0 + ac < K);
      if constexpr (BT) {
        fill16(&Bs[st][ar][ac], B + (int64_t)(n0 + ar) * K + k0 + ac,
               n0 + ar < N && k0 + ac < K);
      } else {
        const int kk = slot / (BN / 8), c = (slot % (BN / 8)) * 8;
        fill16(&Bs[st][kk][c], B + (int64_t)(k0 + kk) * N + n0 + c,
               k0 + kk < K && n0 + c < N);
      }
    }
    cp_async_commit();
  };
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  fill(0, 0);
  int st = 0;
  for (int k0 = 0; k0 < K; k0 += BK, st ^= 1) {
    if (k0 + BK < K) {
      fill(st ^ 1, k0 + BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(a[i], &As[st][wr + 16 * i + (lane & 15)][kk + (lane >> 4) * 8]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        unsigned b[4];  // {b0, b1} of columns +0..7, then of +8..15
        if constexpr (BT) {
          ldsm_x4(b, &Bs[st][wc + 16 * jj + (lane >> 4) * 8 + (lane & 7)]
                        [kk + ((lane >> 3) & 1) * 8]);
        } else {
          ldsm_x4_trans(b, &Bs[st][kk + (lane & 15)]
                              [wc + 16 * jj + (lane >> 4) * 8]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][2 * jj], a[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  // accumulator (i, j): rows g and g + 8 of the 16-row block i, columns
  // q, q + 1 of the 8-column block j
  const int g = lane >> 2, q = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + wr + 16 * i + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + wc + 8 * j + q;
        if (n < N) ep(r, n, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// float32: one shared stage, each thread a 4x8 register tile of FMAs
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

#define TRY(call)                              \
  do {                                         \
    const cudaError_t err_ = (call);           \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)

template <typename T>
int attn_fwd(const T* x, const float* g, const float* b, const T* in_w,
             const T* in_b, const T* out_w, const T* out_b, T* h, T* qkv,
             T* o, T* y, float* inv, int rows, int d, int n_heads, int t,
             float scale, cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, (float*)nullptr, rows, d, s));
  TRY((product<T, false>(h, in_w, rows, 3 * d, d,
                         EpBias<T>{qkv, in_b, 3 * d}, s)));
  TRY(core_fwd(qkv, o, inv, rows, t, n_heads, d, scale, s));
  TRY((product<T, false>(o, out_w, rows, d, d,
                         EpBiasResidual<T>{y, out_b, x, d}, s)));
  return 0;
}

template <typename T>
int attn_bwd(const T* x, const T* dy, const float* inv, const float* g,
             const float* b, const T* in_w, const T* in_b, const T* out_w,
             T* h, float* stat, T* qkv, T* dout, T* dqkv, float* dh, T* dx,
             int rows, int d, int n_heads, int t, float scale,
             cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, stat, rows, d, s));
  TRY((product<T, false>(h, in_w, rows, 3 * d, d,
                         EpBias<T>{qkv, in_b, 3 * d}, s)));
  TRY((product<T, true>(dy, out_w, rows, d, d, EpStore<T>{dout, d}, s)));
  TRY(core_bwd(qkv, dout, inv, dqkv, rows, t, n_heads, d, scale, s));
  TRY((product<T, true>(dqkv, in_w, rows, d, 3 * d, EpStore<float>{dh, d},
                        s)));
  TRY(layer_norm_back(x, g, stat, dh, dy, dx, rows, d, s));
  return 0;
}

template <typename T>
int mlp_fwd(const T* x, const float* g, const float* b, const T* fc_w,
            const T* fc_b, const T* p_w, const T* p_b, T* h, T* a, T* y,
            int rows, int d, int hidden, cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, (float*)nullptr, rows, d, s));
  TRY((product<T, false>(h, fc_w, rows, hidden, d,
                         EpBiasGelu<T>{a, fc_b, hidden}, s)));
  TRY((product<T, false>(a, p_w, rows, d, hidden,
                         EpBiasResidual<T>{y, p_b, x, d}, s)));
  return 0;
}

template <typename T>
int mlp_bwd(const T* x, const T* dy, const float* g, const float* b,
            const T* fc_w, const T* fc_b, const T* p_w, T* h, float* stat,
            T* u, T* du, float* dh, T* dx, int rows, int d, int hidden,
            cudaStream_t s) {
  TRY(layer_norm(x, g, b, h, stat, rows, d, s));
  TRY((product<T, false>(h, fc_w, rows, hidden, d,
                         EpBias<T>{u, fc_b, hidden}, s)));
  TRY((product<T, true>(dy, p_w, rows, hidden, d,
                        EpGeluBack<T>{du, u, hidden}, s)));
  TRY((product<T, true>(du, fc_w, rows, d, hidden, EpStore<float>{dh, d},
                        s)));
  TRY(layer_norm_back(x, g, stat, dh, dy, dx, rows, d, s));
  return 0;
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
// [rows, 2] and dh [rows, d] float32; h, stat, qkv, dout, dqkv, dh scratch.
int attn_half_bwd(const void* x, const void* dy, const void* inv,
                  const void* g, const void* b, const void* in_w,
                  const void* in_b, const void* out_w, void* h, void* stat,
                  void* qkv, void* dout, void* dqkv, void* dh, void* dx,
                  int rows, int d, int n_heads, int t, float scale, int is_bf16,
                  void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return attn_bwd<__nv_bfloat16>(
        (const bf16*)x, (const bf16*)dy, (const float*)inv, (const float*)g,
        (const float*)b, (const bf16*)in_w, (const bf16*)in_b,
        (const bf16*)out_w, (bf16*)h, (float*)stat, (bf16*)qkv,
        (bf16*)dout, (bf16*)dqkv, (float*)dh, (bf16*)dx, rows, d, n_heads, t,
        scale, s);
  return attn_bwd<float>(
      (const float*)x, (const float*)dy, (const float*)inv, (const float*)g,
      (const float*)b, (const float*)in_w, (const float*)in_b,
      (const float*)out_w, (float*)h, (float*)stat, (float*)qkv,
      (float*)dout, (float*)dqkv, (float*)dh, (float*)dx, rows, d, n_heads,
      t, scale, s);
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

// Shared-memory bytes of the attention core at (t, hd), so the caller can
// refuse a shape before launching.
int block_smem_bytes(int t, int hd, int backward) {
  return (int)(backward ? core_bwd_smem(t, hd) : core_fwd_smem(t, hd));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
