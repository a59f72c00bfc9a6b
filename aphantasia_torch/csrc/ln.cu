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
// with a handful of float32 operations per element.  The design: one warp
// per row with 16-byte loads (8 bf16 or 4 float32 a lane); the row's second
// pass re-reads it from L1, where the first pass left it, so device memory
// sees each input once.  The TPU kernel carries dg/db from one grid step to
// the next in one output block, which Hopper's unordered blocks cannot do;
// here each block of the backward writes its rows' partial column sums to
// a float32 scratch [2, blocks, D], and a second launch adds the partials
// of every column in a fixed order (8 interleaved runs over the blocks,
// then the 8 run sums).  Both sums are deterministic: the same inputs give
// the same bits on every run.  Each entry point is counted once
// by its wrapper, whatever number of launches it makes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int FWD_WARPS = 8;      // rows per forward block
constexpr int BWD_THREADS = 256;  // 8 warps per backward block

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
template <> struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
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

// Block `blk` takes rows [blk*rb, blk*rb + rb): dx row by row (a warp per
// row), then the partial dg/db of those rows, a thread per column, summed
// in row order into part[0][blk][:] and part[1][blk][:].
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
ln_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ stat, const T* __restrict__ dy,
                   T* __restrict__ dx, float* __restrict__ part, int rows,
                   int d, int rb) {
  constexpr int N = Pack<T>::N;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * rb;
  const int r1 = min(r0 + rb, rows);
  for (int row = r0 + warp; row < r1; row += BWD_THREADS / 32) {
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

// dg[c], db[c] = the sums of the partials of column c over the blocks: a
// block takes 32 columns, its 8 warps sum every 8th partial each, in block
// order, and the first warp adds the 8 results in warp order.
constexpr int RED_COLS = 32, RED_GROUPS = 8;
__global__ void __launch_bounds__(RED_COLS * RED_GROUPS)
ln_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dg,
                     float* __restrict__ db, int nblk, int d) {
  __shared__ float sg[RED_GROUPS][RED_COLS], sb[RED_GROUPS][RED_COLS];
  const int cx = threadIdx.x % RED_COLS, gy = threadIdx.x / RED_COLS;
  const int c = blockIdx.x * RED_COLS + cx;
  float pg = 0.f, pb = 0.f;
  if (c < d) {
    for (int i = gy; i < nblk; i += RED_GROUPS) {
      pg += part[(int64_t)i * d + c];
      pb += part[((int64_t)nblk + i) * d + c];
    }
  }
  sg[gy][cx] = pg;
  sb[gy][cx] = pb;
  __syncthreads();
  if (gy == 0 && c < d) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < RED_GROUPS; ++i) {
      tg += sg[i][cx];
      tb += sb[i][cx];
    }
    dg[c] = tg;
    db[c] = tb;
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

template <typename T>
int bwd(const void* x, const void* g, const void* stat, const void* dy,
        void* dx, void* part, void* dg, void* db, int rows, int d, int rb,
        cudaStream_t stream) {
  const int nblk = (rows + rb - 1) / rb;
  ln_bwd_rows_kernel<T><<<nblk, BWD_THREADS, 0, stream>>>(
      (const T*)x, (const float*)g, (const float*)stat, (const T*)dy, (T*)dx,
      (float*)part, rows, d, rb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<(d + RED_COLS - 1) / RED_COLS,
                         RED_COLS * RED_GROUPS, 0, stream>>>(
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
// part [2, ceil(rows/rb), d] float32 scratch; dg, db [d] float32.
int ln_bwd(const void* x, const void* g, const void* stat, const void* dy,
           void* dx, void* part, void* dg, void* db, int rows, int d, int rb,
           int bf16, void* stream) {
  if (bf16)
    return bwd<__nv_bfloat16>(x, g, stat, dy, dx, part, dg, db, rows, d, rb,
                              (cudaStream_t)stream);
  return bwd<float>(x, g, stat, dy, dx, part, dg, db, rows, d, rb,
                    (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
