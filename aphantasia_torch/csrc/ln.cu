// Row LayerNorm forward and backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of aphantasia_tpu/ops/pallas_ln.py:
//   _ln_fwd (pallas_call at :88, body _fwd_kernel :36) and
//   _ln_bwd (pallas_call at :114, body _bwd_kernel :48).
//
// For x [R, D] (bf16 or float32) and float32 gain g, bias b [D]:
//   fwd: mu = E[x], var = E[x^2] - mu^2 (one-pass float32 moments, as the
//        TPU kernel and the plain version take them), rstd = rsqrt(var+eps),
//        y = (x - mu) * rstd * g + b in x's type; stat[r] = (mu, rstd).
//   bwd: xhat = (x - mu) * rstd, h = dy * g,
//        dx = (h - mean(h) - xhat * mean(h * xhat)) * rstd in x's type,
//        dg = sum_r dy * xhat, db = sum_r dy (float32).
//
// What bounds it on the H100: bytes.  A row is read, reduced and written
// with a handful of float32 operations per element.  The forward: one
// warp per row with 16-byte loads (8 bf16 or 4 float32 a lane); the row's
// second pass re-reads it from L1, where the first pass left it, so device
// memory sees each input once.
//
// The backward reads x and dy once, one warp per row with the same
// per-lane order and warp tree for m1, m2 and dx as the first design, so
// dx keeps its bits; a lane holds its columns of the row in registers
// for both passes.  The TPU kernel carries dg/db from one grid step to
// the next in one output block, which Hopper's unordered blocks cannot
// do.  Here each lane adds the row's dg/db terms of its own columns into
// its warp's rows of shared memory, from the values it already holds for
// dx; a block's 16 warps then add theirs in warp order and write one
// partial row each of dg and db.  The grid is one block an SM (132), so
// the partials are at most 132 rows; a second launch adds each column's
// partials in a fixed tree (32 interleaved runs over the blocks, then the
// runs in order), four columns a thread with 16-byte loads.  Both sums
// are deterministic: the same inputs give the same bits on every run and
// under graph replay, with no atomics.  Rows wider than a lane's
// registers hold (more than 1280 columns) take a general path: the same rows and dx, then the
// block's column sums re-read from L1/L2, a thread a column.  Each entry
// point is counted once by its wrapper, whatever number of launches it
// makes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FWD_WARPS = 8;      // rows per forward block
constexpr int BWD_THREADS = 256;  // 8 warps per block of the general path
constexpr int BWD_WARPS = 16;     // warps per block of ln_bwd_kernel

template <typename T> struct Pack;
template <> struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  }
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& q, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  }
};

__device__ __forceinline__ void load_f32(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load_f32(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(FWD_WARPS * 32)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, T* __restrict__ y,
              float* __restrict__ stat, int rows, int d, float eps) {
  constexpr int N = Pack<T>::N;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * FWD_WARPS + threadIdx.x / 32;
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
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const float mu = s1 / d;
  const float var = s2 / d - mu * mu;
  const float rstd = rsqrtf(var + eps);
  T* yr = y + (int64_t)row * d;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N], gv[N], bv[N];
    Pack<T>::load(xr + c, v);
    load_f32(g + c, gv);
    load_f32(b + c, bv);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (v[i] - mu) * rstd * gv[i] + bv[i];
    Pack<T>::store(yr + c, v);
  }
  if (lane == 0) {
    stat[2 * (int64_t)row] = mu;
    stat[2 * (int64_t)row + 1] = rstd;
  }
}

// The dx of one row, a warp, lane columns lane*N + 32*N*j: the first
// design's per-lane order and warp tree, which ln_bwd_kernel keeps.
template <typename T>
__device__ __forceinline__ void bwd_row(const T* __restrict__ x,
                                        const float* __restrict__ g,
                                        const float* __restrict__ stat,
                                        const T* __restrict__ dy,
                                        T* __restrict__ dx, int row, int d,
                                        int lane) {
  constexpr int N = Pack<T>::N;
  const T* xr = x + (int64_t)row * d;
  const T* dyr = dy + (int64_t)row * d;
  const float mu = stat[2 * (int64_t)row];
  const float rstd = stat[2 * (int64_t)row + 1];
  float m1 = 0.f, m2 = 0.f;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N], dv[N], gv[N];
    Pack<T>::load(xr + c, v);
    Pack<T>::load(dyr + c, dv);
    load_f32(g + c, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float hv = dv[i] * gv[i];
      m1 += hv;
      m2 += hv * ((v[i] - mu) * rstd);
    }
  }
  m1 = warp_sum(m1) / d;
  m2 = warp_sum(m2) / d;
  T* dxr = dx + (int64_t)row * d;
  for (int c = lane * N; c < d; c += 32 * N) {
    float v[N], dv[N], gv[N];
    Pack<T>::load(xr + c, v);
    Pack<T>::load(dyr + c, dv);
    load_f32(g + c, gv);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float xhat = (v[i] - mu) * rstd;
      v[i] = (dv[i] * gv[i] - m1 - xhat * m2) * rstd;
    }
    Pack<T>::store(dxr + c, v);
  }
}

// Block b takes rows [b*rb, b*rb + rb), warp w every 16th from the w-th.
// A lane holds its CH chunks of N columns of the row's x and dy in
// registers for both passes (the arithmetic of bwd_row) and adds the
// row's dg/db terms of its columns into its warp's rows of `acc`
// ([BWD_WARPS][2][d] floats, shared memory), in row order; then the
// warps' sums in warp order go to part[0][b][:] and part[1][b][:].
template <typename T, int CH>
__global__ void __launch_bounds__(BWD_WARPS * 32, 1)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ stat, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ part, int rows, int d,
              int rb) {
  constexpr int N = Pack<T>::N;
  extern __shared__ __align__(16) float acc[];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rb;
  const int r1 = min(r0 + rb, rows);
  float* pg = acc + warp * 2 * d;
  float* pb = pg + d;
  for (int c = lane * 4; c < d; c += 128) {
    *reinterpret_cast<float4*>(pg + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(pb + c) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int row = r0 + warp; row < r1; row += BWD_WARPS) {
    const float2 ms =
        *reinterpret_cast<const float2*>(stat + 2 * (int64_t)row);
    const float mu = ms.x, rstd = ms.y;
    uint4 cx[CH], cd[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane * N + 32 * N * j;
      if (c < d) {
        cx[j] = *reinterpret_cast<const uint4*>(x + (int64_t)row * d + c);
        cd[j] = *reinterpret_cast<const uint4*>(dy + (int64_t)row * d + c);
      }
    }
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane * N + 32 * N * j;
      if (c >= d) continue;
      float v[N], dv[N], gv[N];
      Pack<T>::unpack(cx[j], v);
      Pack<T>::unpack(cd[j], dv);
      load_f32(g + c, gv);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float hv = dv[i] * gv[i];
        m1 += hv;
        m2 += hv * ((v[i] - mu) * rstd);
      }
    }
    m1 = warp_sum(m1) / d;
    m2 = warp_sum(m2) / d;
    T* dxr = dx + (int64_t)row * d;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane * N + 32 * N * j;
      if (c >= d) continue;
      float v[N], dv[N], gv[N];
      Pack<T>::unpack(cx[j], v);
      Pack<T>::unpack(cd[j], dv);
      load_f32(g + c, gv);
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        float4 sg = *reinterpret_cast<float4*>(pg + c + i);
        float4 sb = *reinterpret_cast<float4*>(pb + c + i);
        float* tg = &sg.x;
        float* tb = &sb.x;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xhat = (v[i + e] - mu) * rstd;
          tg[e] += dv[i + e] * xhat;
          tb[e] += dv[i + e];
          v[i + e] = (dv[i + e] * gv[i + e] - m1 - xhat * m2) * rstd;
        }
        *reinterpret_cast<float4*>(pg + c + i) = sg;
        *reinterpret_cast<float4*>(pb + c + i) = sb;
      }
      Pack<T>::store(dxr + c, v);
    }
  }
  __syncthreads();
  const int64_t nblk = gridDim.x;
  for (int c = threadIdx.x; c < d; c += BWD_WARPS * 32) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < BWD_WARPS; ++w) {
      tg += acc[w * 2 * d + c];
      tb += acc[w * 2 * d + d + c];
    }
    part[(int64_t)blockIdx.x * d + c] = tg;
    part[(nblk + blockIdx.x) * d + c] = tb;
  }
}

// The general path, for rows wider than ln_bwd_kernel's registers: the
// same rows and dx, then the block's column sums re-read, a thread a
// column, in row order, into part[0][b][:] and part[1][b][:].
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
ln_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ stat, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part, int rows,
                   int d, int rb) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rb;
  const int r1 = min(r0 + rb, rows);
  for (int row = r0 + warp; row < r1; row += BWD_THREADS / 32)
    bwd_row(x, g, stat, dy, dx, row, d, lane);
  const int64_t nblk = gridDim.x;
  for (int c = threadIdx.x; c < d; c += BWD_THREADS) {
    float pg = 0.f, pb = 0.f;
    for (int row = r0; row < r1; ++row) {
      const float mu = stat[2 * (int64_t)row];
      const float rstd = stat[2 * (int64_t)row + 1];
      const float xv = to_f(x[(int64_t)row * d + c]);
      const float dv = to_f(dy[(int64_t)row * d + c]);
      pg += dv * ((xv - mu) * rstd);
      pb += dv;
    }
    part[(int64_t)blockIdx.x * d + c] = pg;
    part[(nblk + blockIdx.x) * d + c] = pb;
  }
}

// dg[c], db[c] = the sums of the partials of column c over the blocks
// (blockIdx.y 0: dg from part[0], 1: db from part[1]).  A block takes 32
// columns, 4 a thread: thread (q, r) sums the partials r, r + 32, ... of
// columns 4q .. 4q + 3 in block order; then 4 sums of 8 runs each in run
// order, and the 4 in order.
constexpr int RED_QUADS = 8, RED_RUNS = 32;
__global__ void __launch_bounds__(RED_QUADS * RED_RUNS)
ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dg,
                     float* __restrict__ db, int nblk, int d) {
  __shared__ float4 run[RED_RUNS][RED_QUADS], quarter[4][RED_QUADS];
  const int q = threadIdx.x % RED_QUADS, r = threadIdx.x / RED_QUADS;
  const int c = (blockIdx.x * RED_QUADS + q) * 4;
  const float* src = part + (int64_t)blockIdx.y * nblk * d;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (c < d) {
#pragma unroll 4
    for (int i = r; i < nblk; i += RED_RUNS) {
      const float4 v = *reinterpret_cast<const float4*>(src + (int64_t)i * d
                                                        + c);
      t.x += v.x; t.y += v.y; t.z += v.z; t.w += v.w;
    }
  }
  run[r][q] = t;
  __syncthreads();
  if (threadIdx.x < 4 * RED_QUADS) {
    const int k = threadIdx.x / RED_QUADS;
    float4 u = run[8 * k][q];
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      const float4 v = run[8 * k + i][q];
      u.x += v.x; u.y += v.y; u.z += v.z; u.w += v.w;
    }
    quarter[k][q] = u;
  }
  __syncthreads();
  if (threadIdx.x < RED_QUADS && c < d) {
    float4 u = quarter[0][q];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      const float4 v = quarter[k][q];
      u.x += v.x; u.y += v.y; u.z += v.z; u.w += v.w;
    }
    *reinterpret_cast<float4*>((blockIdx.y ? db : dg) + c) = u;
  }
}

template <typename T>
int fwd(const void* x, const void* g, const void* b, void* y, void* stat,
        int rows, int d, float eps, cudaStream_t stream) {
  const int blocks = (rows + FWD_WARPS - 1) / FWD_WARPS;
  ln_fwd_kernel<T><<<blocks, FWD_WARPS * 32, 0, stream>>>(
      (const T*)x, (const float*)g, (const float*)b, (T*)y, (float*)stat,
      rows, d, eps);
  return (int)cudaGetLastError();
}

// the register path's lane chunks of N columns, at most: 1280 columns,
// a row of x and dy in 40 registers of bf16 pairs or 80 of float32, and
// 16 warps' shared sums in 160 KB
template <typename T> constexpr int max_chunks() { return 40 / Pack<T>::N; }

template <typename T, int CH>
int launch_bwd(const void* x, const void* g, const void* stat,
               const void* dy, void* dx, void* part, int rows, int d,
               int nblk, int rb, cudaStream_t stream) {
  const int smem = BWD_WARPS * 2 * d * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  ln_bwd_kernel<T, CH><<<nblk, BWD_WARPS * 32, smem, stream>>>(
      (const T*)x, (const float*)g, (const float*)stat, (const T*)dy, (T*)dx,
      (float*)part, rows, d, rb);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* g, const void* stat, const void* dy,
        void* dx, void* part, void* dg, void* db, int rows, int d, int nblk,
        cudaStream_t stream) {
  if (nblk < 1 || nblk > rows) return (int)cudaErrorInvalidValue;
  const int rb = (rows + nblk - 1) / nblk;
  const int ch = (d + 32 * Pack<T>::N - 1) / (32 * Pack<T>::N);
  int code = 0;
  switch (ch <= max_chunks<T>() ? ch : 0) {
#define LN_CH(k)                                                          \
  case k:                                                                 \
    if constexpr (k <= max_chunks<T>())                                   \
      code = launch_bwd<T, k>(x, g, stat, dy, dx, part, rows, d, nblk,    \
                              rb, stream);                                \
    break;
    LN_CH(1) LN_CH(2) LN_CH(3) LN_CH(4) LN_CH(5)
    LN_CH(6) LN_CH(7) LN_CH(8) LN_CH(9) LN_CH(10)
#undef LN_CH
    default:
      ln_bwd_wide_kernel<T><<<nblk, BWD_THREADS, 0, stream>>>(
          (const T*)x, (const float*)g, (const float*)stat, (const T*)dy,
          (T*)dx, (float*)part, rows, d, rb);
      code = (int)cudaGetLastError();
  }
  if (code != 0) return code;
  ln_bwd_reduce_kernel<<<dim3((d + 4 * RED_QUADS - 1) / (4 * RED_QUADS), 2),
                         RED_QUADS * RED_RUNS, 0, stream>>>(
      (const float*)part, (float*)dg, (float*)db, nblk, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows,d] (bf16 when `bf16` is 1, else float32), d a multiple of 8,
// 16-byte aligned; g, b [d] float32; y like x; stat [rows,2] float32.
int ln_fwd(const void* x, const void* g, const void* b, void* y, void* stat,
           int rows, int d, float eps, int bf16, void* stream) {
  if (bf16)
    return fwd<__nv_bfloat16>(x, g, b, y, stat, rows, d, eps,
                              (cudaStream_t)stream);
  return fwd<float>(x, g, b, y, stat, rows, d, eps, (cudaStream_t)stream);
}

// x, dy, dx [rows,d] of one type as above; g [d], stat [rows,2] float32;
// part [2, nblk, d] float32 scratch (nblk blocks, 1 <= nblk <= rows, a
// function of rows alone); dg, db [d] float32.
int ln_bwd(const void* x, const void* g, const void* stat, const void* dy,
           void* dx, void* part, void* dg, void* db, int rows, int d,
           int nblk, int bf16, void* stream) {
  if (bf16)
    return bwd<__nv_bfloat16>(x, g, stat, dy, dx, part, dg, db, rows, d,
                              nblk, (cudaStream_t)stream);
  return bwd<float>(x, g, stat, dy, dx, part, dg, db, rows, d, nblk,
                    (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
