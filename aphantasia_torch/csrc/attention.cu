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
// float32 inputs run FMA tiles with the same structure and no tensor cores
// (TF32 keeps about three digits, against a 2e-5 tolerance; the card's main
// path runs in bf16, so float32 serves the card-against-CPU checks and the
// float32 towers): 256 threads a block as a 16 x 16 grid, each thread a 4 x
// 4 piece of a 64 x 64 score tile and 4 rows x hd/16 columns of the output.
//   forward: a block per (sample, head, 64-row query tile) walks 64-key
//     tiles of K and V staged in shared memory, keeps an online softmax
//     (running max, partial row sums) in registers, writes P to a [64][65]
//     tile and adds P V into registers.
//   backward: two launches, one call, as the bf16 pair: dq per query tile
//     over the key tiles, then dk, dv per key tile over the query tiles of
//     Q and dO; p = exp(s - lse) from the saved lse, rs = rowdot(dO, O) by
//     one function in one order for both; no atomics, every sum in a fixed
//     order, so two runs give the same bits.
// Shared memory is a few [64][hd + 1] tiles (67 KB forward, 84 KB dq, 100
// KB dk/dv at hd = 64) whatever t is, so any t runs; hd up to 128.  The
// tiles are bound by FMA issue and shared-memory loads, not by bytes (8
// scalar loads feed the 16 multiply-adds of a 4 x 4 piece).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

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

// ---------------------------------------------------- float32, FMA tiles

constexpr int kF32Threads = 256;   // a 16 x 16 grid: tx = tid & 15, ty = tid >> 4
constexpr int kF32Rows = 64;       // query rows, and keys, of a tile
constexpr int kF32MaxHd = 128;     // head width the register tiles hold
constexpr int kF32Cols = kF32MaxHd / 16;   // head columns a thread holds
constexpr int kPld = kF32Rows + 1;         // row stride of a score tile

// shared memory of each kernel in floats: [64][hd + 1] operand tiles, [64][65]
// score tiles and two 64-row vectors; none of it depends on t
size_t f32_fwd_smem(int hd) {
  return sizeof(float) * (3 * kF32Rows * (hd + 1) + kF32Rows * kPld);
}
size_t f32_dq_smem(int hd) {
  return sizeof(float) * (4 * kF32Rows * (hd + 1) + kF32Rows * kPld +
                          2 * kF32Rows);
}
size_t f32_dkv_smem(int hd) {
  return sizeof(float) * (4 * kF32Rows * (hd + 1) + 2 * kF32Rows * kPld +
                          2 * kF32Rows);
}

// rows 0 .. n_rows - 1 of a [64, hd] tile whose rows lie `stride` floats
// apart, into dst[64][ld]; rows past n_rows are zero
__device__ __forceinline__ void f32_tile_load(float* dst, const float* src,
                                              int64_t stride, int n_rows,
                                              int hd, int ld) {
  for (int e = threadIdx.x; e < kF32Rows * hd; e += kF32Threads) {
    const int r = e / hd, c = e - r * hd;
    dst[r * ld + c] = r < n_rows ? src[r * stride + c] : 0.f;
  }
}

// acc[i][j] += a[ty + 16 i] . b[tx + 16 j] over hd: a thread's 4 x 4 piece
// of a 64 x 64 product of two [64][ld] tiles
__device__ __forceinline__ void f32_abt(float (&acc)[4][4], const float* a,
                                        const float* b, int hd, int ld,
                                        int tx, int ty) {
  for (int k = 0; k < hd; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * ld + k];
      bv[i] = b[(tx + 16 * i) * ld + k];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// o[i][j] += sum over r < n of p[ty + 16 i][r] * v[r][tx + 16 j]: a
// thread's rows of a [64][65] score tile times a [64][ld] tile
__device__ __forceinline__ void f32_pb(float (&o)[4][kF32Cols], const float* p,
                                       const float* v, int n, int hd, int ld,
                                       int tx, int ty) {
  for (int r = 0; r < n; ++r) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * kPld + r];
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) {
        const float x = v[r * ld + col];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], x, o[i][j]);
      }
    }
  }
}

// over the 16 threads of a tile row (one half-warp)
__device__ __forceinline__ float row_max16(float v) {
  for (int o = 1; o < 16; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// lse and rs = rowdot(dO, O) of query rows i0 .. i0 + 63 (0 past t), four
// threads a row in a fixed order: both backward passes call this one
// function, so they use the same values
__device__ __forceinline__ void f32_row_stats(float* lse_s, float* rs_s,
                                              const float* dout,
                                              const float* out,
                                              const float* lse, int64_t rows0,
                                              int i0, int t, int n_heads,
                                              int h, int d, int hd) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int row = i0 + r;
  float rs = 0.f;
  if (row < t) {
    const int64_t off = (rows0 + row) * d + (int64_t)h * hd;
    for (int c = part; c < hd; c += 4) rs = fmaf(dout[off + c], out[off + c], rs);
  }
  rs += __shfl_xor_sync(0xffffffffu, rs, 1);
  rs += __shfl_xor_sync(0xffffffffu, rs, 2);
  if (part == 0) {
    rs_s[r] = rs;
    lse_s[r] = row < t ? lse[(rows0 + row) * n_heads + h] : 0.f;
  }
}

__global__ void __launch_bounds__(kF32Threads)
attn_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                    float* __restrict__ lse, int t, int n_heads, int d,
                    int causal, int valid_t, int n_tiles, float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads, ld = hd + 1;
  float* qs = smem;
  float* ks = qs + kF32Rows * ld;
  float* vs = ks + kF32Rows * ld;
  float* ps = vs + kF32Rows * ld;            // [64][kPld] probabilities
  const int b = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kF32Rows;
  const int h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t d3 = 3 * (int64_t)d;
  const float* base = qkv + (int64_t)b * t * d3 + (int64_t)h * hd;
  // keys this tile's rows can see; past them nothing is loaded
  const int kend = causal ? min(valid_t, q0 + kF32Rows) : valid_t;
  f32_tile_load(qs, base + q0 * d3, d3, t - q0, hd, ld);
  float m[4], l[4], o[4][kF32Cols];          // running max, partial sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) o[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < kend; k0 += kF32Rows) {
    const int nk = min(kF32Rows, kend - k0);
    f32_tile_load(ks, base + k0 * d3 + d, d3, nk, hd, ld);
    f32_tile_load(vs, base + k0 * d3 + 2 * d, d3, nk, hd, ld);
    __syncthreads();
    float s[4][4] = {};
    f32_abt(s, qs, ks, hd, ld, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (key >= valid_t || (causal && key > row)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max16(mx);
      const float mu = mx == -INFINITY ? 0.f : mx;   // no key seen yet
      const float alpha = expf(m[i] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mu);
        ps[(ty + 16 * i) * kPld + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mx;
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) o[i][j] *= alpha;
    }
    __syncthreads();
    f32_pb(o, ps, vs, nk, hd, ld, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float sum = row_sum16(l[i]);
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const int64_t r = (int64_t)b * t + row;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) out[r * d + (int64_t)h * hd + col] = o[i][j] / sum;
    }
    if (tx == 0) lse[r * n_heads + h] = m[i] + logf(sum);
  }
}

// backward pass 1: dq of one 64-row query tile, walking the key tiles
__global__ void __launch_bounds__(kF32Threads)
attn_bwd_dq_f32_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ dout,
                       const float* __restrict__ out,
                       const float* __restrict__ lse,
                       float* __restrict__ dqkv, int t, int n_heads, int d,
                       int causal, int valid_t, int n_tiles, float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads, ld = hd + 1;
  float* qs = smem;
  float* gs = qs + kF32Rows * ld;            // dO
  float* ks = gs + kF32Rows * ld;
  float* vs = ks + kF32Rows * ld;
  float* dss = vs + kF32Rows * ld;           // [64][kPld] ds
  float* lse_s = dss + kF32Rows * kPld;
  float* rs_s = lse_s + kF32Rows;
  const int b = blockIdx.x / n_tiles, q0 = (blockIdx.x % n_tiles) * kF32Rows;
  const int h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t d3 = 3 * (int64_t)d;
  const int64_t hoff = (int64_t)h * hd;
  const int64_t rows0 = (int64_t)b * t;      // the sample's first row
  const float* base = qkv + rows0 * d3 + hoff;
  const int kend = causal ? min(valid_t, q0 + kF32Rows) : valid_t;
  f32_tile_load(qs, base + q0 * d3, d3, t - q0, hd, ld);
  f32_tile_load(gs, dout + (rows0 + q0) * d + hoff, d, t - q0, hd, ld);
  f32_row_stats(lse_s, rs_s, dout, out, lse, rows0, q0, t, n_heads, h, d, hd);
  float dq[4][kF32Cols] = {};
  for (int k0 = 0; k0 < kend; k0 += kF32Rows) {
    const int nk = min(kF32Rows, kend - k0);
    f32_tile_load(ks, base + k0 * d3 + d, d3, nk, hd, ld);
    f32_tile_load(vs, base + k0 * d3 + 2 * d, d3, nk, hd, ld);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    f32_abt(s, qs, ks, hd, ld, tx, ty);
    f32_abt(dp, gs, vs, hd, ld, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        float p = expf(s[i][j] * scale - lse_s[r]);
        if (key >= valid_t || (causal && key > row)) p = 0.f;
        dss[r * kPld + tx + 16 * j] = p * (dp[i][j] - rs_s[r]) * scale;
      }
    }
    __syncthreads();
    f32_pb(dq, dss, ks, nk, hd, ld, tx, ty);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) dqkv[(rows0 + row) * d3 + hoff + col] = dq[i][j];
    }
  }
}

// backward pass 2: dk and dv of one 64-key tile, walking the query tiles
__global__ void __launch_bounds__(kF32Threads)
attn_bwd_dkv_f32_kernel(const float* __restrict__ qkv,
                        const float* __restrict__ dout,
                        const float* __restrict__ out,
                        const float* __restrict__ lse,
                        float* __restrict__ dqkv, int t, int n_heads, int d,
                        int causal, int valid_t, int n_tiles, float scale) {
  extern __shared__ float smem[];
  const int hd = d / n_heads, ld = hd + 1;
  float* ks = smem;
  float* vs = ks + kF32Rows * ld;
  float* qs = vs + kF32Rows * ld;
  float* gs = qs + kF32Rows * ld;            // dO
  float* pts = gs + kF32Rows * ld;           // [64 keys][kPld] p^T
  float* dst = pts + kF32Rows * kPld;        // [64 keys][kPld] ds^T
  float* lse_s = dst + kF32Rows * kPld;
  float* rs_s = lse_s + kF32Rows;
  const int b = blockIdx.x / n_tiles, j0 = (blockIdx.x % n_tiles) * kF32Rows;
  const int h = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t d3 = 3 * (int64_t)d;
  const int64_t hoff = (int64_t)h * hd;
  const int64_t rows0 = (int64_t)b * t;
  const float* base = qkv + rows0 * d3 + hoff;
  // keys of this tile that carry a gradient; the rest (and a tile past
  // valid_t) get dk = dv = 0
  const int n_keys = valid_t - j0;
  float dk[4][kF32Cols] = {}, dv[4][kF32Cols] = {};
  if (n_keys > 0) {
    f32_tile_load(ks, base + j0 * d3 + d, d3, n_keys, hd, ld);
    f32_tile_load(vs, base + j0 * d3 + 2 * d, d3, n_keys, hd, ld);
    for (int i0 = causal ? j0 : 0; i0 < t; i0 += kF32Rows) {
      const int nq = min(kF32Rows, t - i0);
      f32_tile_load(qs, base + i0 * d3, d3, nq, hd, ld);
      f32_tile_load(gs, dout + (rows0 + i0) * d + hoff, d, nq, hd, ld);
      f32_row_stats(lse_s, rs_s, dout, out, lse, rows0, i0, t, n_heads, h, d,
                    hd);
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};     // key rows x query columns
      f32_abt(s, ks, qs, hd, ld, tx, ty);
      f32_abt(dp, vs, gs, hd, ld, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i, key = j0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qi = i0 + c;
          float p = expf(s[i][j] * scale - lse_s[c]);
          if (qi >= t || key >= valid_t || (causal && key > qi)) p = 0.f;
          pts[r * kPld + c] = p;
          dst[r * kPld + c] = p * (dp[i][j] - rs_s[c]) * scale;
        }
      }
      __syncthreads();
      f32_pb(dv, pts, gs, nq, hd, ld, tx, ty);   // dv += p^T do
      f32_pb(dk, dst, qs, nq, hd, ld, tx, ty);   // dk += ds^T q
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = j0 + ty + 16 * i;
    if (key >= t) continue;
    float* r = dqkv + (rows0 + key) * d3 + hoff;
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) {
        r[d + col] = dk[i][j];
        r[2 * d + col] = dv[i][j];
      }
    }
  }
}

int launch_fwd_f32(const void* qkv, void* out, void* lse, int batch, int t,
                   int n_heads, int d, int causal, int valid_t,
                   cudaStream_t stream) {
  const int hd = d / n_heads;
  if (hd * n_heads != d || hd > kF32MaxHd) return (int)cudaErrorInvalidValue;
  const int n_tiles = (t + kF32Rows - 1) / kF32Rows;
  const size_t smem = f32_fwd_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_f32_kernel<<<dim3(batch * n_tiles, n_heads), kF32Threads, smem,
                        stream>>>(
      (const float*)qkv, (float*)out, (float*)lse, t, n_heads, d, causal,
      valid_t, n_tiles, 1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

int launch_bwd_f32(const void* qkv, const void* dout, const void* out,
                   const void* lse, void* dqkv, int batch, int t, int n_heads,
                   int d, int causal, int valid_t, cudaStream_t stream) {
  const int hd = d / n_heads;
  if (hd * n_heads != d || hd > kF32MaxHd) return (int)cudaErrorInvalidValue;
  const int n_tiles = (t + kF32Rows - 1) / kF32Rows;
  const dim3 grid(batch * n_tiles, n_heads);
  const float scale = 1.f / sqrtf((float)hd);
  const size_t dq_smem = f32_dq_smem(hd), dkv_smem = f32_dkv_smem(hd);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_f32_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_f32_kernel<<<grid, kF32Threads, dq_smem, stream>>>(
      (const float*)qkv, (const float*)dout, (const float*)out,
      (const float*)lse, (float*)dqkv, t, n_heads, d, causal, valid_t,
      n_tiles, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_f32_kernel<<<grid, kF32Threads, dkv_smem, stream>>>(
      (const float*)qkv, (const float*)dout, (const float*)out,
      (const float*)lse, (float*)dqkv, t, n_heads, d, causal, valid_t,
      n_tiles, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [batch*t, 3d], out [batch*t, d] (bf16 if is_bf16 else f32), lse
// [batch*t, n_heads] f32.  bf16 runs the tensor-core kernel (d = 64 x
// n_heads, 16-byte aligned rows), float32 the FMA tiles (hd <= 128).
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

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
