// Windowed cutout forward for Hopper (sm_90a): two matrix products per
// sample over the window its bicubic taps can reach.
//
// Replaces the Pallas TPU kernel of aphantasia_tpu/ops/pallas_cutout_win.py:
//   windowed_cut_fwd (pallas_call at :128, body _kernel :66).
//
// For sample s with window (rb, cb, k_h, k_w) of its size tier:
//   t1[s,c,r,n]  = round_T( sum_{k<k_w} img[c, rb+r, cb+k] * wxt[s,k,n] )   r < k_h
//   out[s,c,m,n] = sum_{r<k_h} wyw[s,m,r] * t1[s,c,r,n]                      (float32)
// where img columns at or past W read as zero (the TPU kernel pads the frame
// to a multiple of 128 columns) and round_T rounds the intermediate to the
// compute type T, as the TPU kernel does.
//
// What bounds it on the H100: operations.  At the main path's draw (190
// samples of M = 224 from a 720x1280 bf16 frame, three tiers up to
// 720x896) the two products are ~180 GFLOP against ~260 MB of inputs and
// outputs, so the tensor cores set the floor in bf16.  This design reaches
// about a third of it: every block reloads its 28 KB B slice from L2 for
// each 64-deep K step, ~2.4 GB a call, so the L2 rate is the likelier
// limit now (PERF.md, section 7).
//
// The bf16 design (csrc/wgmma.cuh): both passes are one warp-specialised
// product kernel.  A block computes a 128 x 224 output tile: two consumer
// warpgroups, each a 64 x 224 wgmma.m64n224k16 accumulator in registers
// (224 = M, so no output column is padding), and one producer thread that
// keeps a ring of 4 stages of 64-deep K slices filled by TMA.  A stage is
// the 128 x 64 A tile (128-byte swizzle, K-major) and the 64 x 224 B tile
// as seven 32-column boxes (64-byte swizzle, N-major: wxt and t1 are read
// as they lie, the transposed B operand of wgmma).  TMA does the address
// arithmetic: pass 1 asks the frame's tensor map [C,H,W] for the box at
// (cb + k, rb + r, c), and its zero fill gives the zero columns past W and
// the zero rows past H.  Pass 1 tiles the k_h rows of one channel (a box
// cannot cross channels) and stores t1 rounded to bf16; its last row tile
// stores zeros in the rows from k_h up to the next multiple of 64, which
// pass 2's last K slice reads (t1 is uninitialised scratch, and 0 x NaN is
// NaN; past KHmax TMA fills zeros).  Pass 2 tiles the M rows of wyw[s].
// Tiles past a sample's own tier exit at once.  The two launches are one
// call of `win_cut_fwd`, counted once by the wrapper.  The host builds the
// four tensor maps per call with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint (no -lcuda), and passes them as __grid_constant__
// parameters.  Row strides must be multiples of 16 bytes: the wrapper pads
// the frame's rows (and wyw's, wxt's) to a multiple of 8 elements where
// they are not (ops/cutout_win.py:tma_pad).
//
// float32 keeps a 64x64 tile of 4x8 register FMAs per thread (the tensor
// cores would round the operands to TF32) with the operands reached
// through row pointers; it serves the card-against-plain checks.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

// p[n], p[n+1] = v0, v1 where n, n+1 < lim; n is even, and with an even
// lim (the rows' length) the pair is aligned and stored at once
__device__ __forceinline__ void put2(float* p, int n, int lim, float v0,
                                     float v1) {
  if (n + 1 < lim && (lim & 1) == 0) {
    *reinterpret_cast<float2*>(p + n) = make_float2(v0, v1);
  } else {
    if (n < lim) p[n] = v0;
    if (n + 1 < lim) p[n + 1] = v1;
  }
}

// ---------------------------------------------------------------- bf16

constexpr int TC_BM = 128;              // output rows: two warpgroups of 64
constexpr int TC_BN = 224;              // output columns: one wgmma N
constexpr int TC_BK = 64;               // K of a stage: one 128-byte row
constexpr int TC_BOXN = 32;             // N of a B box (64-byte swizzle)
constexpr int TC_STAGES = 4;
constexpr int TC_THREADS = 384;         // 2 consumer + 1 producer warpgroup
constexpr int TC_A_BYTES = TC_BM * TC_BK * 2;
constexpr int TC_BOX_BYTES = TC_BK * TC_BOXN * 2;
constexpr int TC_STAGE_BYTES = TC_A_BYTES + TC_BN / TC_BOXN * TC_BOX_BYTES;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE_BYTES + 1024;  // + alignment
static_assert(TC_STAGE_BYTES % 1024 == 0, "stages keep 1024-byte alignment");

// pass 1 (kRows): A = frame window rows of channel ch, B = wxt[s],
//   dst = t1 (bf16), rows r0.. of the channel's k_h, zeros to ceil64(k_h);
// pass 2: A = wyw[s], B = t1[s, ch], dst = out (float32), rows of M.
// blockIdx: x = column tile, y = row tile, z = s * c + ch.
template <bool kRows>
__global__ void __launch_bounds__(TC_THREADS, 1)
win_tc_kernel(const __grid_constant__ CUtensorMap amap,
              const __grid_constant__ CUtensorMap bmap,
              const int* __restrict__ geo, void* __restrict__ dst, int c,
              int m, int mp, int kh_max) {
  __shared__ __align__(8) uint64_t full[TC_STAGES], empty[TC_STAGES];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int sc = blockIdx.z;
  const int s = sc / c, ch = sc - s * c;
  const int rb = geo[4 * s], cb = geo[4 * s + 1];
  const int k_h = geo[4 * s + 2], k_w = geo[4 * s + 3];
  const int r0 = blockIdx.y * TC_BM;
  const int n0 = blockIdx.x * TC_BN;
  if (kRows && r0 >= k_h) return;  // a smaller tier: nothing in this tile
  const int nk = ((kRows ? k_w : k_h) + TC_BK - 1) / TC_BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < TC_STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid >= 2 * 128) {
    // producer: one thread keeps the ring filled
    if (tid != 2 * 128) return;
    for (int kt = 0; kt < nk; ++kt) {
      const int st = kt % TC_STAGES;
      mbar_wait(&empty[st], ((kt / TC_STAGES) & 1) ^ 1);
      uint8_t* a = smem + st * TC_STAGE_BYTES;
      uint8_t* b = a + TC_A_BYTES;
      mbar_expect_tx(&full[st], TC_STAGE_BYTES);
      const int k0 = kt * TC_BK;
      if (kRows) {
        tma_load_3d(a, &amap, &full[st], cb + k0, rb + r0, ch);
      } else {
        tma_load_3d(a, &amap, &full[st], k0, r0, s);
      }
#pragma unroll
      for (int j = 0; j < TC_BN / TC_BOXN; ++j)
        tma_load_3d(b + j * TC_BOX_BYTES, &bmap, &full[st],
                    n0 + j * TC_BOXN, k0, kRows ? s : sc);
    }
    return;
  }
  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
  const int wg = tid / 128;
  float acc[TC_BN / 2];
#pragma unroll
  for (int i = 0; i < TC_BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % TC_STAGES;
    mbar_wait(&full[st], (kt / TC_STAGES) & 1);
    const uint8_t* a = smem + st * TC_STAGE_BYTES + wg * (TC_A_BYTES / 2);
    const uint8_t* b = smem + st * TC_STAGE_BYTES + TC_A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      // A: rows of 128 bytes, 8-row groups 1024 bytes apart, the k16
      // slice 32 bytes along the row; B: K rows of 64 bytes, 8-row groups
      // 512 bytes apart, 32-column boxes TC_BOX_BYTES apart, the k16 slice
      // 16 rows down
      wgmma_m64n224k16_bf16_tb(acc, gmma_desc(a + kk * 32, 16, 1024, 1),
                               gmma_desc(b + kk * 16 * 64, TC_BOX_BYTES,
                                         512, 2));
    }
    wgmma_commit();
    // the previous stage's products are done: hand its buffers back
    wgmma_wait<1>();
    if (kt > 0 && tid % 128 == 0)
      mbar_arrive(&empty[(kt - 1) % TC_STAGES]);
  }
  wgmma_wait<0>();
  const int lane = tid % 32;
  const int row0 = r0 + wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
  const int q = 2 * (lane % 4);
  if (kRows) {
    // t1 [S, C, kh_max, mp]: rows below k_h rounded, rows up to the next
    // multiple of TC_BK zero, columns below mp
    const int zlim = min((k_h + TC_BK - 1) / TC_BK * TC_BK, kh_max);
    __nv_bfloat16* t1 = reinterpret_cast<__nv_bfloat16*>(dst) +
                        (int64_t)sc * kh_max * mp;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= zlim) continue;
      const bool live = r < k_h;
      __nv_bfloat16* row = t1 + (int64_t)r * mp;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
        const int n = n0 + 8 * j + q;
        if (n < mp)
          *reinterpret_cast<__nv_bfloat162*>(row + n) =
              live ? __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                           acc[4 * j + 2 * h + 1])
                   : __floats2bfloat162_rn(0.f, 0.f);
      }
    }
  } else {
    // out [S, C, m, m] float32
    float* out = reinterpret_cast<float*>(dst) + (int64_t)sc * m * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= m) continue;
      float* row = out + (int64_t)r * m;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j)
        put2(row, n0 + 8 * j + q, m, acc[4 * j + 2 * h],
             acc[4 * j + 2 * h + 1]);
    }
  }
}

// A bf16 tensor map over a 3-D tensor of dims (d0, d1, d2), innermost
// first, with row and plane strides in bytes; boxes of b0 x b1 x 1.
bool bf16_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1,
              uint64_t d2, uint64_t row_bytes, uint64_t plane_bytes,
              uint32_t b0, uint32_t b1, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {row_bytes, plane_bytes};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* img, const void* geo, const void* wyw,
                const void* wxt, void* t1, void* out, int c, int h, int w,
                int wp, int s, int m, int mp, int kh_max, int khp,
                int kw_max, cudaStream_t stream) {
  CUtensorMap frame_map, wxt_map, wyw_map, t1_map;
  const uint64_t e = 2;
  if (!bf16_map(&frame_map, img, w, h, c, wp * e, (uint64_t)h * wp * e,
                TC_BK, TC_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&wxt_map, wxt, mp, kw_max, s, mp * e,
                (uint64_t)kw_max * mp * e, TC_BOXN, TC_BK,
                CU_TENSOR_MAP_SWIZZLE_64B) ||
      !bf16_map(&wyw_map, wyw, kh_max, m, s, khp * e, (uint64_t)m * khp * e,
                TC_BK, TC_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&t1_map, t1, mp, kh_max, (uint64_t)s * c, mp * e,
                (uint64_t)kh_max * mp * e, TC_BOXN, TC_BK,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return ERR_TENSOR_MAP;
  cudaError_t err = cudaFuncSetAttribute(
      win_tc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(win_tc_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (m + TC_BN - 1) / TC_BN;
  const dim3 g1(ntiles, (kh_max + TC_BM - 1) / TC_BM, s * c);
  win_tc_kernel<true><<<g1, TC_THREADS, TC_SMEM, stream>>>(
      frame_map, wxt_map, (const int*)geo, t1, c, m, mp, kh_max);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(ntiles, (m + TC_BM - 1) / TC_BM, s * c);
  win_tc_kernel<false><<<g2, TC_THREADS, TC_SMEM, stream>>>(
      wyw_map, t1_map, (const int*)geo, out, c, m, mp, kh_max);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- float32

constexpr int F_BM = 64, F_BN = 64, F_BK = 32, F_THREADS = 128;

// Eight consecutive elements p[k .. k+8) of a row, zero at and past `lim`
// or where the row is null; two 16-byte loads when the row allows it.
__device__ __forceinline__ void load8(const float* p, int k, int lim,
                                      bool vec, float (&v)[8]) {
  if (p != nullptr && vec && k + 8 <= lim) {
    *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p + k);
    *reinterpret_cast<float4*>(v + 4) =
        *reinterpret_cast<const float4*>(p + k + 4);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = (p != nullptr && k + i < lim) ? p[k + i] : 0.f;
}

// One 64x64 tile of C = A . B over K, where A(r, k) = a_row(r)[k] for
// k < a_lim and B(k, n) = b_row(k)[n] for n < b_lim, zero elsewhere and
// where a row pointer is null; `a_vec`/`b_vec` say that rows are 16-byte
// aligned at every multiple of 8 elements.  Row r of C is written at
// out_row(r)[0 .. n_lim), or not at all where out_row(r) is null.  One
// shared stage, each thread a 4x8 register tile of FMAs.
template <typename ARow, typename BRow, typename OutRow>
__device__ void tile_product(int r0, int n0, int k_len, const ARow& a_row,
                             int a_lim, bool a_vec, const BRow& b_row,
                             int b_lim, bool b_vec, const OutRow& out_row,
                             int n_lim) {
  constexpr int A_CHUNKS = F_BK / 8, B_CHUNKS = F_BN / 8;
  static_assert(F_BM * A_CHUNKS == 2 * F_THREADS &&
                    F_BK * B_CHUNKS == 2 * F_THREADS,
                "each thread fills two chunks of each operand tile");
  __shared__ float As[F_BM][F_BK + 1];
  __shared__ float Bs[F_BK][F_BN];
  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty*4 .. +4
  const int tx = tid % 8;  // cols tx*8 .. +8
  const float* a_ptr[2];
  int a_r[2], a_c[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int slot = tid + j * F_THREADS;
    a_r[j] = slot / A_CHUNKS;
    a_c[j] = (slot % A_CHUNKS) * 8;
    a_ptr[j] = a_row(r0 + a_r[j]);
  }
  a_lim = min(a_lim, k_len);
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k_len; k0 += F_BK) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[8];
      load8(a_ptr[j], k0 + a_c[j], a_lim, a_vec, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[a_r[j]][a_c[j] + i] = v[i];
      const int slot = tid + j * F_THREADS;
      const int kk = slot / B_CHUNKS, c = (slot % B_CHUNKS) * 8;
      load8(k0 + kk < k_len ? b_row(k0 + kk) : nullptr, n0 + c, b_lim,
            b_vec, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[kk][c + i] = v[i];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < F_BK; ++kk) {
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
    float* p = out_row(r0 + ty * 4 + i);
    if (p == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      put2(p, n0 + tx * 8 + j, n_lim, acc[i][j], acc[i][j + 1]);
  }
}

// geo[s] = (rb, cb, k_h, k_w) of sample s's window.
__global__ void __launch_bounds__(F_THREADS)
win_rows_kernel(const float* __restrict__ img, const int* __restrict__ geo,
                const float* __restrict__ wxt, float* __restrict__ t1,
                int c, int h, int w, int m, int kh_max, int kw_max) {
  const int s = blockIdx.z;
  const int rb = geo[4 * s], cb = geo[4 * s + 1];
  const int k_h = geo[4 * s + 2], k_w = geo[4 * s + 3];
  const int rows = c * k_h;
  const int r0 = blockIdx.y * F_BM;
  if (r0 >= rows) return;  // a smaller tier: nothing in this row tile
  const int n0 = blockIdx.x * F_BN;
  const int64_t plane = (int64_t)h * w;
  // row r of A is frame row rb + r % k_h of channel r / k_h, from column
  // cb on; columns at or past w read as zero
  auto a_row = [&](int r) -> const float* {
    if (r >= rows) return nullptr;
    const int ch = r / k_h;
    const int y = rb + r - ch * k_h;
    return y < h ? img + ch * plane + (int64_t)y * w + cb : nullptr;
  };
  const float* wx_s = wxt + (int64_t)s * kw_max * m;
  auto b_row = [&](int k) -> const float* { return wx_s + (int64_t)k * m; };
  float* t1_s = t1 + (int64_t)s * c * kh_max * m;
  auto out_row = [&](int r) -> float* {
    if (r >= rows) return nullptr;
    const int ch = r / k_h;
    return t1_s + ((int64_t)ch * kh_max + r - ch * k_h) * m;
  };
  tile_product(r0, n0, k_w, a_row, w - cb, w % 8 == 0, b_row, m, m % 8 == 0,
               out_row, m);
}

__global__ void __launch_bounds__(F_THREADS)
win_cols_kernel(const int* __restrict__ geo, const float* __restrict__ wyw,
                const float* __restrict__ t1, float* __restrict__ out, int c,
                int m, int kh_max) {
  const int sc = blockIdx.z;  // sample * c + channel
  const int s = sc / c;
  const int k_h = geo[4 * s + 2];
  const int r0 = blockIdx.y * F_BM;
  const int n0 = blockIdx.x * F_BN;
  const float* wy_s = wyw + (int64_t)s * m * kh_max;
  auto a_row = [&](int r) -> const float* {
    return r < m ? wy_s + (int64_t)r * kh_max : nullptr;
  };
  const float* t1_sc = t1 + (int64_t)sc * kh_max * m;
  auto b_row = [&](int k) -> const float* { return t1_sc + (int64_t)k * m; };
  float* out_sc = out + (int64_t)sc * m * m;
  auto out_row = [&](int r) -> float* {
    return r < m ? out_sc + (int64_t)r * m : nullptr;
  };
  tile_product(r0, n0, k_h, a_row, k_h, kh_max % 8 == 0, b_row, m,
               m % 8 == 0, out_row, m);
}

int launch_f32(const void* img, const void* geo, const void* wyw,
               const void* wxt, void* t1, void* out, int c, int h, int w,
               int s, int m, int kh_max, int kw_max, cudaStream_t stream) {
  const dim3 g1((m + F_BN - 1) / F_BN, (c * kh_max + F_BM - 1) / F_BM, s);
  win_rows_kernel<<<g1, F_THREADS, 0, stream>>>(
      (const float*)img, (const int*)geo, (const float*)wxt, (float*)t1, c,
      h, w, m, kh_max, kw_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((m + F_BN - 1) / F_BN, (m + F_BM - 1) / F_BM, s * c);
  win_cols_kernel<<<g2, F_THREADS, 0, stream>>>(
      (const int*)geo, (const float*)wyw, (const float*)t1, (float*)out, c,
      m, kh_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img [c,h,wp] T (columns w.. wp zero); geo [s,4] int32 (rb, cb, k_h,
// k_w); wyw [s,m,khp] T; wxt [s,kw_max,mp] T; t1 [s,c,kh_max,mp] T
// scratch; out [s,c,m,m] float32.  T is bf16 when `bf16` is 1, else
// float32; in float32 wp = w, mp = m and khp = kh_max.  bf16 needs wp, mp
// and khp multiples of 8 and 16-byte aligned bases (TMA).
int win_cut_fwd(const void* img, const void* geo, const void* wyw,
                const void* wxt, void* t1, void* out, int c, int h, int w,
                int wp, int s, int m, int mp, int kh_max, int khp,
                int kw_max, int bf16, void* stream) {
  if (bf16)
    return launch_bf16(img, geo, wyw, wxt, t1, out, c, h, w, wp, s, m, mp,
                       kh_max, khp, kw_max, (cudaStream_t)stream);
  return launch_f32(img, geo, wyw, wxt, t1, out, c, h, w, s, m, kh_max,
                    kw_max, (cudaStream_t)stream);
}

const char* kernel_error_string(int code) { return error_string(code); }

}  // extern "C"
