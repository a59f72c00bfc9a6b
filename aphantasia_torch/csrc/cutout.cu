// Cutout crop-and-resize for Hopper (sm_90a): forward gather, backward scatter.
//
// Replaces the Pallas TPU kernels of aphantasia_tpu/ops/pallas_cutout.py:
//   _pallas_cut_fwd (pallas_call at :109, body _fwd_kernel :56) and
//   _pallas_cut_bwd (pallas_call at :139, body _bwd_kernel :68).
//
// Computes, for S samples of an M x M bicubic crop of a C x H x W frame,
//   out[s,c,m,n] = sum_a sum_b yw[s,m,a] * xw[s,n,b] * img[c, yidx[s,m,a], xidx[s,n,b]]
//   d_img[c,y,x] = sum over (s,m,n,a,b) with yidx=y, xidx=x of yw * xw * g[s,c,m,n]
//
// The TPU kernel builds dense Wy [M,H] / Wx [W,M] matrices per sample from
// the taps and runs two MXU matmuls, because the MXU is what a TPU has.  On
// Hopper the work is 16 multiply-adds per output, so a dense matmul would
// do ~H/4 times the arithmetic; the direct gather does only the 16.
//
// What bounds it on the H100: the forward writes S*C*M*M float32 outputs
// (120 MB at S=200, M=224, C=3) and reads the 11 MB frame, which stays in
// the 50 MB L2 across all samples, so the floor is the output write at
// 3.35 TB/s.  The design: one block per (output row m, sample s), one
// thread per output column n; the row's four y-taps sit in shared memory,
// each thread loads its four x-taps once (16-byte vector loads) and reuses
// them for all C channels; stores are coalesced along n.
//
// The backward is a scatter: every g element adds into 16 frame pixels with
// a float32 atomicAdd, and neighbouring samples overlap, so the order of
// the additions (and the last bits of d_img) changes from run to run;
// tests hold it to 1e-4 of the largest d_img entry against the plain
// version.  The atomics, not the bytes, bound it; a per-sample-partitioned
// reduction without atomics is later work.
//
// The wrapper (ops/cutout.py) clamps every tap into the frame and zeroes
// the weight of a tap that was outside it, so no read or write leaves the
// frame.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cutout_fwd_kernel(const float* __restrict__ img,
                                  const int* __restrict__ yidx,
                                  const float* __restrict__ yw,
                                  const int* __restrict__ xidx,
                                  const float* __restrict__ xw,
                                  float* __restrict__ out,
                                  int c, int h, int w, int m) {
  const int row = blockIdx.x;
  const int smp = blockIdx.y;
  __shared__ int ys[4];
  __shared__ float yws[4];
  const int64_t tap_row = ((int64_t)smp * m + row) * 4;
  if (threadIdx.x < 4) {
    ys[threadIdx.x] = yidx[tap_row + threadIdx.x];
    yws[threadIdx.x] = yw[tap_row + threadIdx.x];
  }
  __syncthreads();
  const int64_t plane = (int64_t)h * w;
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const int64_t tap_col = ((int64_t)smp * m + n) * 4;
    const int4 xi = *reinterpret_cast<const int4*>(xidx + tap_col);
    const float4 xv = *reinterpret_cast<const float4*>(xw + tap_col);
    for (int ch = 0; ch < c; ++ch) {
      const float* base = img + ch * plane;
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float* r = base + (int64_t)ys[a] * w;
        const float v = xv.x * __ldg(r + xi.x) + xv.y * __ldg(r + xi.y) +
                        xv.z * __ldg(r + xi.z) + xv.w * __ldg(r + xi.w);
        acc = fmaf(yws[a], v, acc);
      }
      out[(((int64_t)smp * c + ch) * m + row) * m + n] = acc;
    }
  }
}

__global__ void cutout_bwd_kernel(const float* __restrict__ g,
                                  const int* __restrict__ yidx,
                                  const float* __restrict__ yw,
                                  const int* __restrict__ xidx,
                                  const float* __restrict__ xw,
                                  float* __restrict__ dimg,
                                  int c, int h, int w, int m) {
  const int row = blockIdx.x;
  const int smp = blockIdx.y;
  __shared__ int ys[4];
  __shared__ float yws[4];
  const int64_t tap_row = ((int64_t)smp * m + row) * 4;
  if (threadIdx.x < 4) {
    ys[threadIdx.x] = yidx[tap_row + threadIdx.x];
    yws[threadIdx.x] = yw[tap_row + threadIdx.x];
  }
  __syncthreads();
  const int64_t plane = (int64_t)h * w;
  for (int n = threadIdx.x; n < m; n += blockDim.x) {
    const int64_t tap_col = ((int64_t)smp * m + n) * 4;
    const int4 xi = *reinterpret_cast<const int4*>(xidx + tap_col);
    const float4 xv = *reinterpret_cast<const float4*>(xw + tap_col);
    for (int ch = 0; ch < c; ++ch) {
      const float gv = g[(((int64_t)smp * c + ch) * m + row) * m + n];
      float* base = dimg + ch * plane;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float ga = yws[a] * gv;
        float* r = base + (int64_t)ys[a] * w;
        atomicAdd(r + xi.x, ga * xv.x);
        atomicAdd(r + xi.y, ga * xv.y);
        atomicAdd(r + xi.z, ga * xv.z);
        atomicAdd(r + xi.w, ga * xv.w);
      }
    }
  }
}

int block_threads(int m) {
  const int t = ((m + 31) / 32) * 32;
  return t < 256 ? t : 256;
}

}  // namespace

extern "C" {

// img [c,h,w] f32; yidx/xidx [s,m,4] int32; yw/xw [s,m,4] f32; out [s,c,m,m] f32.
int cutout_fwd(const void* img, const void* yidx, const void* yw,
               const void* xidx, const void* xw, void* out,
               int c, int h, int w, int s, int m, void* stream) {
  dim3 grid(m, s);
  cutout_fwd_kernel<<<grid, block_threads(m), 0, (cudaStream_t)stream>>>(
      (const float*)img, (const int*)yidx, (const float*)yw, (const int*)xidx,
      (const float*)xw, (float*)out, c, h, w, m);
  return (int)cudaGetLastError();
}

// g [s,c,m,m] f32; dimg [c,h,w] f32, zeroed by the caller.
int cutout_bwd(const void* g, const void* yidx, const void* yw,
               const void* xidx, const void* xw, void* dimg,
               int c, int h, int w, int s, int m, void* stream) {
  dim3 grid(m, s);
  cutout_bwd_kernel<<<grid, block_threads(m), 0, (cudaStream_t)stream>>>(
      (const float*)g, (const int*)yidx, (const float*)yw, (const int*)xidx,
      (const float*)xw, (float*)dimg, c, h, w, m);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
