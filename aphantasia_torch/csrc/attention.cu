// Multi-head attention core for Hopper (sm_90a), forward and backward, over
// the merged-qkv stream.
//
// Replaces the Pallas TPU kernels of aphantasia_tpu/ops/pallas_attn.py:
//   _flat_fwd (pallas_call at :412, body _fwd_kernel_flat :157)  -> attn_fwd
//   _core_fwd (pallas_call at :295, body _fwd_kernel :73)        -> attn_fwd
//   _flat_bwd (pallas_call at :442, body _bwd_kernel_flat :190)  -> attn_bwd
//   _core_bwd (pallas_call at :327, body _bwd_kernel :108)       -> attn_bwd
//
// Layout: qkv is [B*T, 3D] row-major (columns: q heads | k heads | v heads,
// head h at columns h*hd .. h*hd+hd-1 of each third).  The flat [b*t, 3D]
// stream and the [B, T, 3D] layout are the same memory, so one kernel
// serves both; `t` is the tokens per sample, `causal` masks keys j > i, and
// `valid_t` masks keys j >= valid_t (rows past it still attend to the
// valid keys; the caller never reads them).  out is [B*T, D]; lse is
// [B*T, H] float32, the log-sum-exp of each softmax row.
//
// Forward:  s = q k^T / sqrt(hd); m = rowmax(s); p = exp(s - m);
//           o = (round(p) v) / rowsum(p); lse = m + log(rowsum(p)).
// Backward: p = exp(s - lse); dv = round(p)^T do; dp = do v^T;
//           rs = rowdot(do, o); ds = round(p (dp - rs) / sqrt(hd));
//           dq = ds k; dk = ds^T q.
// round() is the rounding to bf16 before a product, at the TPU kernel's
// points (pallas_attn.py:99-101, 133-147); every sum is float32.  The TPU
// kernel skips the max subtraction (exp(min(s, 60))) and saves 1/rowsum;
// saving lse instead makes the backward's p = exp(s - lse) exact with the
// max subtracted, for any score range.  Its merging of samples into masked
// 400-row blocks, which fills the TPU's 128x128 matrix unit, is not carried
// over: here a tile never crosses a sample.
//
// What bounds it on the H100: device memory.  At CLIP's sizes (t = 50 to
// 577, hd = 64) the products are 4 t^2 hd operations a (sample, head)
// forward and 10 t^2 hd backward, against reading qkv (and do, o) once and
// writing the outputs once: at t <= 257 the bytes set the floor, at t =
// 577 the two are within a factor of two.  The bf16 design keeps every
// intermediate on chip and feeds the tensor cores:
//   forward: one block of 4 warps per (sample, head, 64-row query tile),
//     each warp 16 query rows.  The Q tile and 64-key tiles of K and V come
//     in by 16-byte cp.async, K and V double-buffered, so shared memory is
//     five 64 x 64 tiles (46 KB) at any t.  Per key tile: S = Q K^T by
//     ldmatrix-fed mma.sync m16n8k16 into float32 registers, the masks, an
//     online softmax (running row max and sum in registers), P rounded to
//     bf16 and fed from registers as the A operand of O += P V.  O is
//     divided by the row sum at the end and stored through shared memory
//     with 16-byte stores; lse beside it.  ViT-L/14's 7 cutouts x 16 heads
//     give 560 blocks (5 query tiles a head).
//   backward: two launches, one call.  (1) dq: a block per (sample, head,
//     64-row query tile) walks the key tiles: S = Q K^T, P = exp(S - lse),
//     dP = dO V^T, dS, then dQ += dS K with dS from registers.  (2) dk, dv:
//     a block per (sample, head, 64-key tile) walks the query tiles with Q
//     and dO double-buffered and computes S^T = K Q^T and dP^T = V dO^T
//     directly, so P^T and dS^T sit in registers as A operands of dV +=
//     P^T dO and dK += dS^T Q.  Both recompute the scores; neither shares
//     an accumulator, nothing is atomic, every sum runs in a fixed order,
//     so two runs give the same bits.  rs = rowdot(dO, O) is computed by
//     each pass for the rows it needs, with one function in one order
//     (`quad_rowdot`), so the two passes use the same values; the C
//     interface takes no scratch.
// The warp-level tile pieces live in csrc/attn_tile.cuh.  The bf16 kernels
// take hd = 64, the head width of every CLIP tower.
//
// float32 inputs run the scalar kernels of the first design: a block per
// (sample, head) with two [t, hd] float32 matrices of that head in shared
// memory (K, V in the forward; the backward in two phases, dq with K, V
// resident, then dk, dv with Q, dO resident).  The tensor cores have no
// float32 product (TF32 keeps about three digits, against a 2e-5
// tolerance), and the card's main path runs in bf16: float32 serves the
// card-against-CPU checks.  Their shared memory grows with t (156 KB at
// t = 257), so they refuse t past about 420 (`attn_smem_bytes`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // per-block limit on sm_90

// ------------------------------------------------- bf16 tensor-core tiles

constexpr int kBfThreads = 128;      // 4 warps x 16 rows = one 64-row tile
constexpr float kScale = 0.125f;     // 1 / sqrt(64)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kScaleLog2 = kScale * kLog2e;
constexpr size_t kFwdSmem = 5 * kTile * sizeof(bf16);   // Q, 2 K, 2 V
constexpr size_t kDqSmem = 6 * kTile * sizeof(bf16);    // Q, dO, 2 K, 2 V
constexpr size_t kDkvSmem =                             // K, V, 2 Q, 2 dO,
    6 * kTile * sizeof(bf16) + 4 * kRows * sizeof(float);  // 2 lse, 2 rs

__global__ void __launch_bounds__(kBfThreads)
attn_fwd_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                     float* __restrict__ lse, int t, int n_heads, int d,
                     int causal, int valid_t, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + kTile;           // two stages
  bf16* vs = ks + 2 * kTile;       // two stages
  const int b = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t d3 = 3 * (int64_t)d;
  const bf16* base = qkv + (int64_t)b * t * d3 + (int64_t)h * kHd;
  // keys this tile's rows can see; past them nothing is loaded
  const int kend = causal ? min(valid_t, q0 + kRows) : valid_t;
  const int nk = (kend + kRows - 1) / kRows;
  auto load_kv = [&](int st, int k0) {
    tile_load(ks + st * kTile, base + k0 * d3 + d, d3, kend - k0, tid,
              kBfThreads);
    tile_load(vs + st * kTile, base + k0 * d3 + 2 * d, d3, kend - k0, tid,
              kBfThreads);
    cp_async_commit();
  };
  tile_load(qs, base + q0 * d3, d3, t - q0, tid, kBfThreads);
  load_kv(0, 0);                   // Q rides in the first group
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + r;       // this lane's rows: +0, +8
  const bf16* qw = qs + warp * 16 * kLd;
  float m[2] = {-INFINITY, -INFINITY};       // running max, log2 units
  float l[2] = {0.f, 0.f};                   // this lane's part of the sum
  float o[8][4];
  zero_acc(o);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kRows;
    if (kt + 1 < nk) {
      load_kv(st ^ 1, k0 + kRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[8][4];
    zero_acc(s);
    warp_abt(s, qw, ks + st * kTile, lane);
    const bool edge = causal || k0 + kRows > valid_t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * kScaleLog2;
        if (edge) {
          const int key = k0 + 8 * j + c + (e & 1), row = row0 + 8 * (e >> 1);
          if (key >= valid_t || (causal && key > row)) x = -INFINITY;
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mu = mx == -INFINITY ? 0.f : mx;  // no key seen yet
      const float alpha = exp2f(m[hh] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          const float p = exp2f(s[j][e] - mu);
          s[j][e] = p;
          sum += p;
        }
      l[hh] = l[hh] * alpha + sum;
      m[hh] = mx;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j][2 * hh] *= alpha;
        o[j][2 * hh + 1] *= alpha;
      }
    }
    unsigned pf[4][4];
    to_a_frags(pf, s);
    warp_pb(o, pf, vs + st * kTile, lane);
    __syncthreads();
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  const int64_t out0 = (int64_t)b * t + q0 + warp * 16;
  warp_store(qs + warp * 16 * kLd, o, 1.f / l[0], 1.f / l[1],
             out + out0 * d + (int64_t)h * kHd, d, t - q0 - warp * 16, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row < t)
        lse[((int64_t)b * t + row) * n_heads + h] =
            (m[hh] + log2f(l[hh])) * kLn2;
    }
  }
}

// backward pass 1: dq of one 64-row query tile
__global__ void __launch_bounds__(kBfThreads)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ qkv,
                        const bf16* __restrict__ dout,
                        const bf16* __restrict__ out,
                        const float* __restrict__ lse, bf16* __restrict__ dqkv,
                        int t, int n_heads, int d, int causal, int valid_t,
                        int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* gs = qs + kTile;           // dO
  bf16* ks = gs + kTile;           // two stages
  bf16* vs = ks + 2 * kTile;       // two stages
  const int b = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t d3 = 3 * (int64_t)d;
  const int64_t hoff = (int64_t)h * kHd;
  const bf16* base = qkv + (int64_t)b * t * d3 + hoff;
  const int64_t rows0 = (int64_t)b * t;      // the sample's first row
  const int kend = causal ? min(valid_t, q0 + kRows) : valid_t;
  const int nk = (kend + kRows - 1) / kRows;
  auto load_kv = [&](int st, int k0) {
    tile_load(ks + st * kTile, base + k0 * d3 + d, d3, kend - k0, tid,
              kBfThreads);
    tile_load(vs + st * kTile, base + k0 * d3 + 2 * d, d3, kend - k0, tid,
              kBfThreads);
    cp_async_commit();
  };
  tile_load(qs, base + q0 * d3, d3, t - q0, tid, kBfThreads);
  tile_load(gs, dout + (rows0 + q0) * d + hoff, d, t - q0, tid, kBfThreads);
  load_kv(0, 0);
  const int r = lane >> 2, c = (lane & 3) * 2;
  const int row0 = q0 + warp * 16 + r;
  float lse2[2], rs[2];            // of rows row0, row0 + 8
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    const bool ok = row < t;
    const int64_t gr = rows0 + row;
    lse2[hh] = ok ? lse[gr * n_heads + h] * kLog2e : 0.f;
    rs[hh] = quad_rowdot(dout + gr * d + hoff, out + gr * d + hoff, ok, lane);
  }
  const bf16* qw = qs + warp * 16 * kLd;
  const bf16* gw = gs + warp * 16 * kLd;
  float dq[8][4];
  zero_acc(dq);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1, k0 = kt * kRows;
    if (kt + 1 < nk) {
      load_kv(st ^ 1, k0 + kRows);
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
    const bool edge = causal || k0 + kRows > valid_t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        float p = exp2f(s[j][e] * kScaleLog2 - lse2[hh]);
        if (edge) {
          const int key = k0 + 8 * j + c + (e & 1), row = row0 + 8 * hh;
          if (key >= valid_t || (causal && key > row)) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - rs[hh]) * kScale;   // ds
      }
    unsigned df[4][4];
    to_a_frags(df, s);
    warp_pb(dq, df, ks + st * kTile, lane);
    __syncthreads();
  }
  warp_store(qs + warp * 16 * kLd, dq, 1.f, 1.f,
             dqkv + (rows0 + q0 + warp * 16) * d3 + hoff, d3,
             t - q0 - warp * 16, lane);
}

// backward pass 2: dk and dv of one 64-key tile
__global__ void __launch_bounds__(kBfThreads)
attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ qkv,
                         const bf16* __restrict__ dout,
                         const bf16* __restrict__ out,
                         const float* __restrict__ lse,
                         bf16* __restrict__ dqkv, int t, int n_heads, int d,
                         int causal, int valid_t, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kTile;
  bf16* qs = vs + kTile;           // two stages
  bf16* gs = qs + 2 * kTile;       // dO, two stages
  float* lse_s = reinterpret_cast<float*>(gs + 2 * kTile);  // [2][64]
  float* rs_s = lse_s + 2 * kRows;                          // [2][64]
  const int b = blockIdx.x / n_tiles, j0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t d3 = 3 * (int64_t)d;
  const int64_t hoff = (int64_t)h * kHd;
  const bf16* base = qkv + (int64_t)b * t * d3 + hoff;
  const int64_t rows0 = (int64_t)b * t;
  // keys of this tile that carry a gradient; the rest (and a tile past
  // valid_t) get dk = dv = 0
  const int n_keys = min(t, valid_t) - j0;
  const int i_first = causal ? j0 : 0;       // query rows that see the tile
  const int nq = n_keys > 0 ? (t - i_first + kRows - 1) / kRows : 0;
  const int r = lane >> 2, c = (lane & 3) * 2;
  auto stage = [&](int st, int i0) {
    tile_load(qs + st * kTile, base + i0 * d3, d3, t - i0, tid, kBfThreads);
    tile_load(gs + st * kTile, dout + (rows0 + i0) * d + hoff, d, t - i0, tid,
              kBfThreads);
    cp_async_commit();
    // lse (log2 units) and rs of the tile's 64 query rows: warp w takes
    // rows 16w .. 16w + 15, a quad a row, as the dq pass does
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rr = warp * 16 + r + 8 * hh, row = i0 + rr;
      const bool ok = row < t;
      const int64_t gr = rows0 + row;
      const float v =
          quad_rowdot(dout + gr * d + hoff, out + gr * d + hoff, ok, lane);
      if ((lane & 3) == 0) {
        rs_s[st * kRows + rr] = v;
        lse_s[st * kRows + rr] = ok ? lse[gr * n_heads + h] * kLog2e : 0.f;
      }
    }
  };
  tile_load(ks, base + j0 * d3 + d, d3, n_keys, tid, kBfThreads);
  tile_load(vs, base + j0 * d3 + 2 * d, d3, n_keys, tid, kBfThreads);
  if (nq > 0) stage(0, i_first);   // K and V ride in the first group
  const int key0 = j0 + warp * 16 + r;       // this lane's keys: +0, +8
  const bf16* kw = ks + warp * 16 * kLd;
  const bf16* vw = vs + warp * 16 * kLd;
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int qt = 0; qt < nq; ++qt) {
    const int st = qt & 1, i0 = i_first + qt * kRows;
    if (qt + 1 < nq) {
      stage(st ^ 1, i0 + kRows);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qst = qs + st * kTile;
    const bf16* gst = gs + st * kTile;
    const float* lse_t = lse_s + st * kRows;
    const float* rs_t = rs_s + st * kRows;
    float s[8][4], dp[8][4];       // key rows x query columns
    zero_acc(s);
    zero_acc(dp);
    warp_abt(s, kw, qst, lane);
    warp_abt(dp, vw, gst, lane);
    const bool edge = causal || i0 + kRows > t || j0 + kRows > valid_t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + c + (e & 1);
        float p = exp2f(s[j][e] * kScaleLog2 - lse_t[col]);
        if (edge) {
          const int qi = i0 + col, key = key0 + 8 * (e >> 1);
          if (qi >= t || key >= valid_t || (causal && key > qi)) p = 0.f;
        }
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - rs_t[col]) * kScale;   // ds^T
      }
    unsigned af[4][4];
    to_a_frags(af, s);
    warp_pb(dv, af, gst, lane);    // dv += p^T do
    to_a_frags(af, dp);
    warp_pb(dk, af, qst, lane);    // dk += ds^T q
    __syncthreads();
  }
  bf16* dk_g = dqkv + (rows0 + j0 + warp * 16) * d3 + d + hoff;
  const int n_rows = t - j0 - warp * 16;
  warp_store(ks + warp * 16 * kLd, dk, 1.f, 1.f, dk_g, d3, n_rows, lane);
  warp_store(vs + warp * 16 * kLd, dv, 1.f, 1.f, dk_g + d, d3, n_rows, lane);
}

int launch_fwd_bf16(const void* qkv, void* out, void* lse, int batch, int t,
                    int n_heads, int d, int causal, int valid_t,
                    cudaStream_t stream) {
  if (d != n_heads * kHd) return (int)cudaErrorInvalidValue;
  const int n_tiles = (t + kRows - 1) / kRows;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kFwdSmem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_bf16_kernel<<<dim3(batch * n_tiles, n_heads), kBfThreads, kFwdSmem,
                         stream>>>((const bf16*)qkv, (bf16*)out, (float*)lse,
                                   t, n_heads, d, causal, valid_t, n_tiles);
  return (int)cudaGetLastError();
}

int launch_bwd_bf16(const void* qkv, const void* dout, const void* out,
                    const void* lse, void* dqkv, int batch, int t, int n_heads,
                    int d, int causal, int valid_t, cudaStream_t stream) {
  if (d != n_heads * kHd) return (int)cudaErrorInvalidValue;
  const int n_tiles = (t + kRows - 1) / kRows;
  const dim3 grid(batch * n_tiles, n_heads);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kDqSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_bf16_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kDkvSmem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_bf16_kernel<<<grid, kBfThreads, kDqSmem, stream>>>(
      (const bf16*)qkv, (const bf16*)dout, (const bf16*)out,
      (const float*)lse, (bf16*)dqkv, t, n_heads, d, causal, valid_t, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_bf16_kernel<<<grid, kBfThreads, kDkvSmem, stream>>>(
      (const bf16*)qkv, (const bf16*)dout, (const bf16*)out,
      (const float*)lse, (bf16*)dqkv, t, n_heads, d, causal, valid_t, n_tiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ float32, scalar

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t fwd_smem(int t, int hd) {
  return sizeof(float) * (2 * (size_t)t * (hd + 1) + kWarps * (size_t)hd + kWarps * (size_t)t);
}
size_t bwd_smem(int t, int hd) {
  return sizeof(float) * (2 * (size_t)t * (hd + 1) + 2 * kWarps * (size_t)hd +
                          2 * kWarps * (size_t)t + 2 * (size_t)t);
}

__global__ void __launch_bounds__(kThreads)
attn_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int t, int n_heads, int d,
                    int causal, int valid_t, float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads;
  const int ld = hd + 1;
  float* ks = smem;
  float* vs = ks + t * ld;
  float* qbuf = vs + t * ld;          // [kWarps][hd], q row pre-scaled
  float* pbuf = qbuf + kWarps * hd;   // [kWarps][t], scores -> exp
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int64_t row0 = (int64_t)b * t;
  const int64_t d3 = 3 * (int64_t)d;
  const float* base = qkv + row0 * d3 + (int64_t)h * hd;
  for (int e = threadIdx.x; e < t * hd; e += kThreads) {
    const int j = e / hd, c = e - j * hd;
    ks[j * ld + c] = base[j * d3 + d + c];
    vs[j * ld + c] = base[j * d3 + 2 * d + c];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = qbuf + warp * hd;
  float* p = pbuf + warp * t;
  for (int i = warp; i < t; i += kWarps) {
    for (int c = lane; c < hd; c += 32) q[c] = base[i * d3 + c] * scale;
    __syncwarp();
    const int kend = causal ? min(i + 1, valid_t) : valid_t;
    float m = -INFINITY;
    for (int j = lane; j < kend; j += 32) {
      const float* kr = ks + j * ld;
      float s = 0.f;
      for (int c = 0; c < hd; ++c) s = fmaf(q[c], kr[c], s);
      p[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < kend; j += 32) {
      const float e = expf(p[j] - m);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    const float inv = 1.f / sum;
    float* orow = out + (row0 + i) * d + (int64_t)h * hd;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kend; ++j) acc = fmaf(p[j], vs[j * ld + c], acc);
      orow[c] = acc * inv;
    }
    if (lane == 0) lse[(row0 + i) * n_heads + h] = m + logf(sum);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
attn_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    const float* __restrict__ out, const float* __restrict__ lse,
                    float* __restrict__ dqkv, int t, int n_heads, int d,
                    int causal, int valid_t, float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads;
  const int ld = hd + 1;
  float* ma = smem;                          // [t][ld]: K, then Q
  float* mb = ma + t * ld;                   // [t][ld]: V, then dO
  float* rows = mb + t * ld;                 // [2][kWarps][hd]
  float* cols = rows + 2 * kWarps * hd;      // [2][kWarps][t]
  float* lse_s = cols + 2 * kWarps * t;      // [t]
  float* rs_s = lse_s + t;                   // [t], rowdot(do, o)
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int64_t row0 = (int64_t)b * t;
  const int64_t d3 = 3 * (int64_t)d;
  const int64_t hoff = (int64_t)h * hd;
  const float* base = qkv + row0 * d3 + hoff;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* r1 = rows + warp * hd;              // q_i, then k_j
  float* r2 = rows + (kWarps + warp) * hd;   // do_i, then v_j
  float* pc = cols + warp * t;               // p column of key j
  float* dsc = cols + (kWarps + warp) * t;   // ds row of query i / column of key j

  // phase 1: K, V resident; each warp takes query rows -> dq, rs
  for (int e = threadIdx.x; e < t * hd; e += kThreads) {
    const int j = e / hd, c = e - j * hd;
    ma[j * ld + c] = base[j * d3 + d + c];
    mb[j * ld + c] = base[j * d3 + 2 * d + c];
  }
  for (int i = threadIdx.x; i < t; i += kThreads) lse_s[i] = lse[(row0 + i) * n_heads + h];
  __syncthreads();
  for (int i = warp; i < t; i += kWarps) {
    const int64_t row = row0 + i;
    float rs = 0.f;
    for (int c = lane; c < hd; c += 32) {
      r1[c] = base[i * d3 + c];
      const float g = dout[row * d + hoff + c];
      r2[c] = g;
      rs = fmaf(g, out[row * d + hoff + c], rs);
    }
    rs = warp_sum(rs);
    if (lane == 0) rs_s[i] = rs;
    __syncwarp();
    const float l = lse_s[i];
    const int kend = causal ? min(i + 1, valid_t) : valid_t;
    for (int j = lane; j < kend; j += 32) {
      const float* kr = ma + j * ld;
      const float* vr = mb + j * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < hd; ++c) {
        s = fmaf(r1[c], kr[c], s);
        dp = fmaf(r2[c], vr[c], dp);
      }
      const float p = expf(s * scale - l);
      dsc[j] = p * (dp - rs) * scale;
    }
    __syncwarp();
    float* dq = dqkv + row * d3 + hoff;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kend; ++j) acc = fmaf(dsc[j], ma[j * ld + c], acc);
      dq[c] = acc;
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 2: Q, dO resident; each warp takes key rows -> dk, dv
  for (int e = threadIdx.x; e < t * hd; e += kThreads) {
    const int i = e / hd, c = e - i * hd;
    ma[i * ld + c] = base[i * d3 + c];
    mb[i * ld + c] = dout[(row0 + i) * d + hoff + c];
  }
  __syncthreads();
  for (int j = warp; j < t; j += kWarps) {
    float* r = dqkv + (row0 + j) * d3 + hoff;
    if (j >= valid_t) {                      // a masked key: no gradient
      for (int c = lane; c < hd; c += 32) {
        r[d + c] = 0.f;
        r[2 * d + c] = 0.f;
      }
      continue;
    }
    for (int c = lane; c < hd; c += 32) {
      r1[c] = base[j * d3 + d + c];
      r2[c] = base[j * d3 + 2 * d + c];
    }
    __syncwarp();
    const int i0 = causal ? j : 0;           // rows that see key j
    for (int i = i0 + lane; i < t; i += 32) {
      const float* qr = ma + i * ld;
      const float* gr = mb + i * ld;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < hd; ++c) {
        s = fmaf(qr[c], r1[c], s);
        dp = fmaf(gr[c], r2[c], dp);
      }
      const float p = expf(s * scale - lse_s[i]);
      pc[i] = p;
      dsc[i] = p * (dp - rs_s[i]) * scale;
    }
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float ak = 0.f, av = 0.f;
      for (int i = i0; i < t; ++i) {
        ak = fmaf(dsc[i], ma[i * ld + c], ak);
        av = fmaf(pc[i], mb[i * ld + c], av);
      }
      r[d + c] = ak;
      r[2 * d + c] = av;
    }
    __syncwarp();
  }
}

int launch_fwd_f32(const void* qkv, void* out, void* lse, int batch, int t,
                   int n_heads, int d, int causal, int valid_t,
                   cudaStream_t stream) {
  const int hd = d / n_heads;
  const size_t smem = fwd_smem(t, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_f32_kernel<<<batch * n_heads, kThreads, smem, stream>>>(
      (const float*)qkv, (float*)out, (float*)lse, t, n_heads, d, causal,
      valid_t, 1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int launch_bwd_f32(const void* qkv, const void* dout, const void* out,
                   const void* lse, void* dqkv, int batch, int t, int n_heads,
                   int d, int causal, int valid_t, cudaStream_t stream) {
  const int hd = d / n_heads;
  const size_t smem = bwd_smem(t, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_f32_kernel<<<batch * n_heads, kThreads, smem, stream>>>(
      (const float*)qkv, (const float*)dout, (const float*)out,
      (const float*)lse, (float*)dqkv, t, n_heads, d, causal, valid_t,
      1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [batch*t, 3d], out [batch*t, d] (bf16 if is_bf16 else f32), lse
// [batch*t, n_heads] f32.  bf16 runs the tensor-core kernel (d = 64 x
// n_heads, 16-byte aligned rows), float32 the scalar one.
int attn_fwd(const void* qkv, void* out, void* lse, int batch, int t, int n_heads,
             int d, int causal, int valid_t, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd_bf16(qkv, out, lse, batch, t, n_heads, d, causal, valid_t, s)
                 : launch_fwd_f32(qkv, out, lse, batch, t, n_heads, d, causal, valid_t, s);
}

// dout/out [batch*t, d], dqkv [batch*t, 3d] in the qkv dtype.  bf16: two
// launches (dq, then dk and dv) on `stream`.
int attn_bwd(const void* qkv, const void* dout, const void* out, const void* lse,
             void* dqkv, int batch, int t, int n_heads, int d, int causal,
             int valid_t, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd_bf16(qkv, dout, out, lse, dqkv, batch, t, n_heads, d,
                                   causal, valid_t, s)
                 : launch_bwd_f32(qkv, dout, out, lse, dqkv, batch, t, n_heads, d,
                                  causal, valid_t, s);
}

// Shared-memory bytes the float32 kernels need for (t, hd), so the caller
// can refuse a shape before launching (the bf16 kernels' need is fixed).
int attn_smem_bytes(int t, int hd, int backward) {
  return (int)(backward ? bwd_smem(t, hd) : fwd_smem(t, hd));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
