// Short-sequence multi-head attention core for Hopper (sm_90a), forward and
// backward, over the merged-qkv stream.
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
//           o = (p v) / rowsum(p); lse = m + log(rowsum(p)).
// The TPU kernel skips the max subtraction (exp(min(s, 60))) and saves
// 1/rowsum; saving lse instead makes the backward's p = exp(s - lse) exact
// with the max subtracted, for any score range.
// Backward: p = exp(s - lse); dv = p^T do; dp = do v^T; rs = rowdot(do, o);
//           ds = p (dp - rs) / sqrt(hd); dq = ds k; dk = ds^T q.
//
// The TPU kernel merges bb samples into one masked [bb*t, bb*t] score block
// to fill the 128x128 MXU and overcomputes ~bb-fold; that is not carried
// over.  Here one block handles one (sample, head), and two [t, hd] float32
// matrices of that head live in shared memory with a row stride of hd+1
// (conflict-free column reads): K and V in the forward, where each warp
// walks query rows.  The backward runs in two phases in the same block and
// the same shared memory: with K and V resident, each warp walks query rows
// and writes dq (saving rs per row); then with Q and dO resident, each warp
// walks key rows, recomputes that key's column of p and ds, and writes dk
// and dv.  So no accumulator is shared, nothing is atomic, every sum runs
// in a fixed order, and the shared memory stays at two matrices (156 KB at
// t = 257, ViT-L/14), for the price of computing the scores twice.
//
// What bounds it on the H100: at CLIP's sizes (t = 50 to 257, hd = 64) a
// head's working set stays on chip, so nothing but qkv, do, o, lse and the
// outputs touches device memory, and the byte floor is reading and writing
// those once.  This simple scalar float32 design is far from that floor:
// it is bound by its serial per-lane loops over keys (latency, FMA issue
// and shared-memory bandwidth); tensor-core tiles (wgmma) are later work.
// Inputs are bf16 or float32; all arithmetic is float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr size_t kMaxSmem = 232448;  // per-block limit on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, float* __restrict__ lse,
                int t, int n_heads, int d, int causal, int valid_t, float scale) {
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
  const T* base = qkv + row0 * d3 + (int64_t)h * hd;
  for (int e = threadIdx.x; e < t * hd; e += kThreads) {
    const int j = e / hd, c = e - j * hd;
    ks[j * ld + c] = to_f(base[j * d3 + d + c]);
    vs[j * ld + c] = to_f(base[j * d3 + 2 * d + c]);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* q = qbuf + warp * hd;
  float* p = pbuf + warp * t;
  for (int i = warp; i < t; i += kWarps) {
    for (int c = lane; c < hd; c += 32) q[c] = to_f(base[i * d3 + c]) * scale;
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
    T* orow = out + (row0 + i) * d + (int64_t)h * hd;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kend; ++j) acc = fmaf(p[j], vs[j * ld + c], acc);
      orow[c] = from_f<T>(acc * inv);
    }
    if (lane == 0) lse[(row0 + i) * n_heads + h] = m + logf(sum);
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                const T* __restrict__ out, const float* __restrict__ lse,
                T* __restrict__ dqkv, int t, int n_heads, int d, int causal,
                int valid_t, float scale) {
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
  const T* base = qkv + row0 * d3 + hoff;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* r1 = rows + warp * hd;              // q_i, then k_j
  float* r2 = rows + (kWarps + warp) * hd;   // do_i, then v_j
  float* pc = cols + warp * t;               // p column of key j
  float* dsc = cols + (kWarps + warp) * t;   // ds row of query i / column of key j

  // phase 1: K, V resident; each warp takes query rows -> dq, rs
  for (int e = threadIdx.x; e < t * hd; e += kThreads) {
    const int j = e / hd, c = e - j * hd;
    ma[j * ld + c] = to_f(base[j * d3 + d + c]);
    mb[j * ld + c] = to_f(base[j * d3 + 2 * d + c]);
  }
  for (int i = threadIdx.x; i < t; i += kThreads) lse_s[i] = lse[(row0 + i) * n_heads + h];
  __syncthreads();
  for (int i = warp; i < t; i += kWarps) {
    const int64_t row = row0 + i;
    float rs = 0.f;
    for (int c = lane; c < hd; c += 32) {
      r1[c] = to_f(base[i * d3 + c]);
      const float g = to_f(dout[row * d + hoff + c]);
      r2[c] = g;
      rs = fmaf(g, to_f(out[row * d + hoff + c]), rs);
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
    T* dq = dqkv + row * d3 + hoff;
    for (int c = lane; c < hd; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < kend; ++j) acc = fmaf(dsc[j], ma[j * ld + c], acc);
      dq[c] = from_f<T>(acc);
    }
    __syncwarp();
  }
  __syncthreads();

  // phase 2: Q, dO resident; each warp takes key rows -> dk, dv
  for (int e = threadIdx.x; e < t * hd; e += kThreads) {
    const int i = e / hd, c = e - i * hd;
    ma[i * ld + c] = to_f(base[i * d3 + c]);
    mb[i * ld + c] = to_f(dout[(row0 + i) * d + hoff + c]);
  }
  __syncthreads();
  for (int j = warp; j < t; j += kWarps) {
    T* r = dqkv + (row0 + j) * d3 + hoff;
    if (j >= valid_t) {                      // a masked key: no gradient
      for (int c = lane; c < hd; c += 32) {
        r[d + c] = from_f<T>(0.f);
        r[2 * d + c] = from_f<T>(0.f);
      }
      continue;
    }
    for (int c = lane; c < hd; c += 32) {
      r1[c] = to_f(base[j * d3 + d + c]);
      r2[c] = to_f(base[j * d3 + 2 * d + c]);
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
      r[d + c] = from_f<T>(ak);
      r[2 * d + c] = from_f<T>(av);
    }
    __syncwarp();
  }
}

template <typename T>
int launch_fwd(const void* qkv, void* out, void* lse, int batch, int t, int n_heads,
               int d, int causal, int valid_t, cudaStream_t stream) {
  const int hd = d / n_heads;
  const size_t smem = fwd_smem(t, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_kernel<T><<<batch * n_heads, kThreads, smem, stream>>>(
      (const T*)qkv, (T*)out, (float*)lse, t, n_heads, d, causal, valid_t,
      1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* qkv, const void* dout, const void* out, const void* lse,
               void* dqkv, int batch, int t, int n_heads, int d, int causal,
               int valid_t, cudaStream_t stream) {
  const int hd = d / n_heads;
  const size_t smem = bwd_smem(t, hd);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<T><<<batch * n_heads, kThreads, smem, stream>>>(
      (const T*)qkv, (const T*)dout, (const T*)out, (const float*)lse, (T*)dqkv,
      t, n_heads, d, causal, valid_t, 1.f / sqrtf((float)hd));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// qkv [batch*t, 3d], out [batch*t, d] (bf16 if is_bf16 else f32), lse [batch*t, n_heads] f32.
int attn_fwd(const void* qkv, void* out, void* lse, int batch, int t, int n_heads,
             int d, int causal, int valid_t, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<__nv_bfloat16>(qkv, out, lse, batch, t, n_heads, d, causal, valid_t, s)
                 : launch_fwd<float>(qkv, out, lse, batch, t, n_heads, d, causal, valid_t, s);
}

// dout/out [batch*t, d], dqkv [batch*t, 3d] in the qkv dtype.
int attn_bwd(const void* qkv, const void* dout, const void* out, const void* lse,
             void* dqkv, int batch, int t, int n_heads, int d, int causal,
             int valid_t, int is_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? launch_bwd<__nv_bfloat16>(qkv, dout, out, lse, dqkv, batch, t, n_heads, d,
                                             causal, valid_t, s)
                 : launch_bwd<float>(qkv, dout, out, lse, dqkv, batch, t, n_heads, d,
                                     causal, valid_t, s);
}

// Shared-memory bytes each kernel needs for (t, hd), so the caller can refuse
// a shape before launching.
int attn_smem_bytes(int t, int hd, int backward) {
  return (int)(backward ? bwd_smem(t, hd) : fwd_smem(t, hd));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
