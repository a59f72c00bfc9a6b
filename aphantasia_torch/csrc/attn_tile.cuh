// Warp-level pieces of the bf16 tensor-core attention tiles (head width
// 64), shared by csrc/attention.cu and open to any kernel that walks
// 64-row query and key tiles of a merged-qkv stream.
//
// A tile is 64 rows x 64 bf16 columns in shared memory with a row stride
// of kLd = 72 elements (144 bytes): the eight 16-byte rows an ldmatrix
// reads, and the rows an accumulator store writes, fall in distinct banks.
// A warp owns 16 rows of a product; its float32 accumulator acc[j][e]
// holds, for the 8-column block j, rows g and g + 8 (g = lane / 4) at
// columns 8j + 2 (lane % 4) + {0, 1}: e = 0, 1 on row g, e = 2, 3 on row
// g + 8.  That layout is the m16n8k16 A operand's once packed to bf16
// pairs (`to_a_frags`), so a product's result feeds the next product from
// registers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;                  // the head width the tiles take
constexpr int kRows = 64;                // rows of a query or key tile
constexpr int kLd = kHd + 8;             // shared row stride, elements
constexpr int kTile = kRows * kLd;       // elements of one shared tile

// Rows [0, n) of a 64 x 64 tile from device memory (row stride `ld`
// elements, 16-byte aligned) into shared memory by 16-byte cp.async; rows
// at and past n are zero, so a ragged tile's products see zeros there.
__device__ __forceinline__ void tile_load(bf16* s, const bf16* g, int64_t ld,
                                          int n, int tid, int nthreads) {
  for (int c = tid; c < kRows * (kHd / 8); c += nthreads) {
    const int r = c >> 3, k = (c & 7) * 8;
    bf16* dst = s + r * kLd + k;
    if (r < n)
      cp_async16(dst, g + r * ld + k);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += A B^T over the head width: A the warp's 16 rows at `a`, B the 64
// rows of a tile at `b` (B's rows are the product's columns), both in
// shared memory.
__device__ __forceinline__ void warp_abt(float (&acc)[8][4], const bf16* a,
                                         const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < kHd; kk += 16) {
    unsigned af[4];
    ldsm_x4(af, a + (lane & 15) * kLd + kk + (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      unsigned bf[4];  // {b0, b1} of columns 16jj + 0..7, then of + 8..15
      ldsm_x4(bf, b + (16 * jj + (lane >> 4) * 8 + (lane & 7)) * kLd + kk +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * jj], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += P B over a 64-deep k: P the warp's 16 x 64 bf16 A fragments in
// registers (`to_a_frags`), B a 64 x 64 tile in shared memory, row-major
// [k][n].
__device__ __forceinline__ void warp_pb(float (&acc)[8][4],
                                        const unsigned (&p)[4][4],
                                        const bf16* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      unsigned bf[4];
      ldsm_x4_trans(bf, b + (16 * kk + (lane & 15)) * kLd + 16 * jj +
                            (lane >> 4) * 8);
      mma_bf16(acc[2 * jj], p[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * jj + 1], p[kk], bf[2], bf[3]);
    }
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// The accumulator's 16 x 64 values rounded to bf16 as the A operand of a
// 64-deep product: fragment kk covers columns 16kk .. 16kk + 15.
__device__ __forceinline__ void to_a_frags(unsigned (&p)[4][4],
                                           const float (&acc)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    p[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    p[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    p[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    p[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// The warp's 16 x 64 accumulator, row g scaled by mul0 and row g + 8 by
// mul1, rounded to bf16 and written to rows [0, n) of device memory at `g`
// (row stride `ld`): staged in the warp's own 16 rows of shared memory at
// `s`, then copied 16 bytes a lane.
__device__ __forceinline__ void warp_store(bf16* s, const float (&acc)[8][4],
                                           float mul0, float mul1,
                                           bf16* __restrict__ g, int64_t ld,
                                           int n, int lane) {
  const int r = lane >> 2, c = (lane & 3) * 2;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<unsigned*>(s + r * kLd + 8 * j + c) =
        pack_bf16(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<unsigned*>(s + (r + 8) * kLd + 8 * j + c) =
        pack_bf16(acc[j][2] * mul1, acc[j][3] * mul1);
  }
  __syncwarp();
#pragma unroll
  for (int k = lane; k < 16 * (kHd / 8); k += 32) {
    const int row = k >> 3, col = (k & 7) * 8;
    if (row < n)
      *reinterpret_cast<uint4*>(g + row * ld + col) =
          *reinterpret_cast<const uint4*>(s + row * kLd + col);
  }
}

// rowdot(x, y) over the head width of one row, for the four lanes of a
// quad (lanes 4g .. 4g + 3 share a row): lane q sums columns 16q .. 16q +
// 15 in order, then the quad adds its partial sums (xor 1, then xor 2), so
// every lane returns the same float32 value.  `ok` false gives 0 and reads
// nothing (the quad agrees on it).
__device__ __forceinline__ float quad_rowdot(const bf16* __restrict__ x,
                                             const bf16* __restrict__ y,
                                             bool ok, int lane) {
  float s = 0.f;
  if (ok) {
    const int c = (lane & 3) * 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 xv = *reinterpret_cast<const uint4*>(x + c + 8 * h);
      const uint4 yv = *reinterpret_cast<const uint4*>(y + c + 8 * h);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&yv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(xp[e]);
        const float2 b = __bfloat1622float2(yp[e]);
        s = fmaf(a.x, b.x, s);
        s = fmaf(a.y, b.y, s);
      }
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

}  // namespace
