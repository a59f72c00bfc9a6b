// Windowed cutout forward for Hopper (sm_90a): two tiled matrix products per
// sample over the window its bicubic taps can reach.
//
// Replaces the Pallas TPU kernel of aphantasia_tpu/ops/pallas_cutout_win.py:
//   windowed_cut_fwd (pallas_call at :128, body _kernel :66).
//
// For sample s with window (rb, cb, k_h, k_w) of its size tier:
//   t1[s,c,r,n]  = round_T( sum_{k<k_w} img[c, rb+r, cb+k] * wxt[s,k,n] )   r < k_h
//   out[s,c,m,n] = sum_{r<k_h} wyw[s,m,r] * t1[s,c,r,n]                      (float32)
// where img columns at or past W read as zero (the TPU kernel pads the frame
// to a multiple of 128 columns; here no padded copy exists) and round_T
// rounds the intermediate to the compute type T, as the TPU kernel does.
//
// What bounds it on the H100: operations.  At the main path's draw (190
// samples of M = 224 from a 720x1280 bf16 frame, three tiers up to
// 720x896) the two products are ~180 GFLOP against ~260 MB of inputs and
// outputs, so the tensor cores set the floor in bf16.  The design: one
// generic tiled product C = A . B whose operands are reached through row
// pointers, so the window, the zero columns past W and the tiers are
// address arithmetic, not copies.  In bf16 a 128x128 output tile over 8
// warps, each a 32x64 block of mma.sync m16n8k16 tensor-core products fed
// by ldmatrix, with float32 accumulators (the TPU's
// preferred_element_type), the next 32-deep K step's tiles copied into a
// second shared stage with cp.async while the current one is multiplied.
// In float32 a 64x64 tile of 4x8 register FMAs per thread (the tensor
// cores would round to TF32).  Pass 1 runs one grid over (column tile, row
// tile of the C*k_h rows, sample) and writes t1 to a scratch
// [S,C,KHmax,M] that the wrapper allocates; pass 2 runs one grid over
// (column tile, row tile, sample*channel).  Tiles past a sample's own k_h
// (a smaller tier) exit at once.  The two launches are one call of
// `win_cut_fwd`, counted once by the wrapper.  mma.sync reaches a fraction
// of what wgmma and TMA would; that is later speed work (PERF.md).
//
// No access leaves the frame: rows are guarded against H, columns against
// W, and every operand index against its tier's k_h/k_w.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "mma.cuh"

namespace {

// Output tile, K step and threads per element type: bf16 tiles feed the
// tensor cores (8 warps, each 32x64 of a 128x128 tile); float32 tiles are
// 64x64 over 4 warps of FMAs.
template <typename T> struct Tile;
template <> struct Tile<__nv_bfloat16> {
  static constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
};
template <> struct Tile<float> {
  static constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive elements p[k .. k+8) of a row, zero at and past `lim`
// or where the row is null; one 16-byte load when the row allows it.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int k, int lim, bool vec,
                                      T (&v)[8]) {
  if (p != nullptr && vec && k + 8 <= lim) {
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p + k);
    } else {
      *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(p + k);
      *reinterpret_cast<float4*>(v + 4) =
          *reinterpret_cast<const float4*>(p + k + 4);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = (p != nullptr && k + i < lim) ? p[k + i] : from_f<T>(0.f);
}

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
__device__ __forceinline__ void put2(__nv_bfloat16* p, int n, int lim,
                                     float v0, float v1) {
  if (n + 1 < lim && (lim & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p + n) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (n < lim) p[n] = __float2bfloat16_rn(v0);
    if (n + 1 < lim) p[n + 1] = __float2bfloat16_rn(v1);
  }
}

// Fill the 8-element chunk `dst` of a shared tile with p[k .. k+8): one
// asynchronous 16-byte copy when the chunk lies inside an aligned row,
// else element by element (zero at and past `lim`, or for a null row).
__device__ __forceinline__ void fill8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* p, int k, int lim,
                                      bool vec) {
  if (p != nullptr && vec && k + 8 <= lim) {
    cp_async16(dst, p + k);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = (p != nullptr && k + i < lim) ? p[k + i] : __float2bfloat16(0.f);
}

// One BM x BN tile of C = A . B over K, where A(r, k) = a_row(r)[k] for
// k < a_lim and B(k, n) = b_row(k)[n] for n < b_lim, zero elsewhere and
// where a row pointer is null; `a_vec`/`b_vec` say that rows are 16-byte
// aligned at every multiple of 8 elements.  Row r of C is written at
// out_row(r)[0 .. n_lim), or not at all where out_row(r) is null.  Each thread fills
// two 8-element chunks of each operand tile a step; the A rows it fills
// are fixed, so their pointers are taken once.
//
// bf16: two shared stages, the next K step's tiles copied with cp.async
// while the tensor cores work on the current one: ldmatrix brings each
// 16x16 A fragment and, transposed, each pair of 16x8 B fragments, and
// mma.sync m16n8k16 accumulates in float32 registers.  The 8 warps own
// 32x64 of the 128x128 tile each and write it from their registers.
template <typename ARow, typename BRow, typename OutRow>
__device__ void tile_product(__nv_bfloat16*, int r0, int n0, int k_len,
                             const ARow& a_row, int a_lim, bool a_vec,
                             const BRow& b_row, int b_lim, bool b_vec,
                             const OutRow& out_row, int n_lim) {
  using TL = Tile<__nv_bfloat16>;
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, THREADS = TL::THREADS;
  constexpr int A_CHUNKS = BK / 8, B_CHUNKS = BN / 8;
  static_assert(BM * A_CHUNKS == 2 * THREADS && BK * B_CHUNKS == 2 * THREADS,
                "each thread fills two chunks of each operand tile");
  __shared__ __align__(128) __nv_bfloat16 As[2][BM][BK + 8];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][BK][BN + 8];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wr = (warp / 2) * 32;
  const int wc = (warp % 2) * 64;
  const __nv_bfloat16* a_ptr[2];
  int a_r[2], a_c[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int slot = tid + j * THREADS;
    a_r[j] = slot / A_CHUNKS;
    a_c[j] = (slot % A_CHUNKS) * 8;
    a_ptr[j] = a_row(r0 + a_r[j]);
  }
  a_lim = min(a_lim, k_len);
  auto fill = [&](int st, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      fill8(&As[st][a_r[j]][a_c[j]], a_ptr[j], k0 + a_c[j], a_lim, a_vec);
      const int slot = tid + j * THREADS;
      const int kk = slot / B_CHUNKS, c = (slot % B_CHUNKS) * 8;
      fill8(&Bs[st][kk][c], k0 + kk < k_len ? b_row(k0 + kk) : nullptr,
            n0 + c, b_lim, b_vec);
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
  for (int k0 = 0; k0 < k_len; k0 += BK, st ^= 1) {
    if (k0 + BK < k_len) {
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
        ldsm_x4_trans(b, &Bs[st][kk + (lane & 15)][wc + 16 * jj +
                                                   (lane >> 4) * 8]);
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
      auto* p = out_row(r0 + wr + 16 * i + g + 8 * h);
      if (p == nullptr) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        put2(p, n0 + wc + 8 * j + q, n_lim, acc[i][j][2 * h],
             acc[i][j][2 * h + 1]);
    }
}

// float32: one shared stage, each thread a 4x8 register tile of FMAs (the
// tensor cores would round the operands to TF32).
template <typename ARow, typename BRow, typename OutRow>
__device__ void tile_product(float*, int r0, int n0, int k_len,
                             const ARow& a_row, int a_lim, bool a_vec,
                             const BRow& b_row, int b_lim, bool b_vec,
                             const OutRow& out_row, int n_lim) {
  using TL = Tile<float>;
  constexpr int BM = TL::BM, BN = TL::BN, BK = TL::BK, THREADS = TL::THREADS;
  constexpr int A_CHUNKS = BK / 8, B_CHUNKS = BN / 8;
  static_assert(BM * A_CHUNKS == 2 * THREADS && BK * B_CHUNKS == 2 * THREADS,
                "each thread fills two chunks of each operand tile");
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int ty = tid / 8;  // rows ty*4 .. +4
  const int tx = tid % 8;  // cols tx*8 .. +8
  const float* a_ptr[2];
  int a_r[2], a_c[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int slot = tid + j * THREADS;
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
  for (int k0 = 0; k0 < k_len; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v[8];
      load8(a_ptr[j], k0 + a_c[j], a_lim, a_vec, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) As[a_r[j]][a_c[j] + i] = v[i];
      const int slot = tid + j * THREADS;
      const int kk = slot / B_CHUNKS, c = (slot % B_CHUNKS) * 8;
      load8(k0 + kk < k_len ? b_row(k0 + kk) : nullptr, n0 + c, b_lim,
            b_vec, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) Bs[kk][c + i] = v[i];
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
    auto* p = out_row(r0 + ty * 4 + i);
    if (p == nullptr) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2)
      put2(p, n0 + tx * 8 + j, n_lim, acc[i][j], acc[i][j + 1]);
  }
}

// geo[s] = (rb, cb, k_h, k_w) of sample s's window.
template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
win_rows_kernel(const T* __restrict__ img, const int* __restrict__ geo,
                const T* __restrict__ wxt, T* __restrict__ t1, int c, int h,
                int w, int m, int kh_max, int kw_max) {
  const int s = blockIdx.z;
  const int rb = geo[4 * s], cb = geo[4 * s + 1];
  const int k_h = geo[4 * s + 2], k_w = geo[4 * s + 3];
  const int rows = c * k_h;
  const int r0 = blockIdx.y * Tile<T>::BM;
  if (r0 >= rows) return;  // a smaller tier: nothing in this row tile
  const int n0 = blockIdx.x * Tile<T>::BN;
  const int64_t plane = (int64_t)h * w;
  // row r of A is frame row rb + r % k_h of channel r / k_h, from column
  // cb on; columns at or past w read as zero
  auto a_row = [&](int r) -> const T* {
    if (r >= rows) return nullptr;
    const int ch = r / k_h;
    const int y = rb + r - ch * k_h;
    return y < h ? img + ch * plane + (int64_t)y * w + cb : nullptr;
  };
  const T* wx_s = wxt + (int64_t)s * kw_max * m;
  auto b_row = [&](int k) -> const T* { return wx_s + (int64_t)k * m; };
  T* t1_s = t1 + (int64_t)s * c * kh_max * m;
  auto out_row = [&](int r) -> T* {
    if (r >= rows) return nullptr;
    const int ch = r / k_h;
    return t1_s + ((int64_t)ch * kh_max + r - ch * k_h) * m;
  };
  tile_product((T*)nullptr, r0, n0, k_w, a_row, w - cb, w % 8 == 0, b_row,
               m, m % 8 == 0, out_row, m);
}

template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
win_cols_kernel(const int* __restrict__ geo, const T* __restrict__ wyw,
                const T* __restrict__ t1, float* __restrict__ out, int c,
                int m, int kh_max) {
  const int sc = blockIdx.z;  // sample * c + channel
  const int s = sc / c;
  const int k_h = geo[4 * s + 2];
  const int r0 = blockIdx.y * Tile<T>::BM;
  const int n0 = blockIdx.x * Tile<T>::BN;
  const T* wy_s = wyw + (int64_t)s * m * kh_max;
  auto a_row = [&](int r) -> const T* {
    return r < m ? wy_s + (int64_t)r * kh_max : nullptr;
  };
  const T* t1_sc = t1 + (int64_t)sc * kh_max * m;
  auto b_row = [&](int k) -> const T* { return t1_sc + (int64_t)k * m; };
  float* out_sc = out + (int64_t)sc * m * m;
  auto out_row = [&](int r) -> float* {
    return r < m ? out_sc + (int64_t)r * m : nullptr;
  };
  tile_product((T*)nullptr, r0, n0, k_h, a_row, k_h, kh_max % 8 == 0,
               b_row, m, m % 8 == 0, out_row, m);
}

template <typename T>
int launch(const void* img, const void* geo, const void* wyw, const void* wxt,
           void* t1, void* out, int c, int h, int w, int s, int m, int kh_max,
           int kw_max, cudaStream_t stream) {
  constexpr int BM = Tile<T>::BM, BN = Tile<T>::BN;
  const dim3 g1((m + BN - 1) / BN, (c * kh_max + BM - 1) / BM, s);
  win_rows_kernel<T><<<g1, Tile<T>::THREADS, 0, stream>>>(
      (const T*)img, (const int*)geo, (const T*)wxt, (T*)t1, c, h, w, m,
      kh_max, kw_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((m + BN - 1) / BN, (m + BM - 1) / BM, s * c);
  win_cols_kernel<T><<<g2, Tile<T>::THREADS, 0, stream>>>(
      (const int*)geo, (const T*)wyw, (const T*)t1, (float*)out, c, m,
      kh_max);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img [c,h,w] T; geo [s,4] int32 (rb, cb, k_h, k_w); wyw [s,m,kh_max] T;
// wxt [s,kw_max,m] T; t1 [s,c,kh_max,m] T scratch; out [s,c,m,m] float32.
// T is bf16 when `bf16` is 1, else float32.
int win_cut_fwd(const void* img, const void* geo, const void* wyw,
                const void* wxt, void* t1, void* out, int c, int h, int w,
                int s, int m, int kh_max, int kw_max, int bf16,
                void* stream) {
  if (bf16)
    return launch<__nv_bfloat16>(img, geo, wyw, wxt, t1, out, c, h, w, s, m,
                                 kh_max, kw_max, (cudaStream_t)stream);
  return launch<float>(img, geo, wyw, wxt, t1, out, c, h, w, s, m, kh_max,
                       kw_max, (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
