// Exact perspective (homography) warp for Hopper (sm_90a): forward gather
// and backward gather over the inverse map.
//
// Replaces the Pallas TPU kernels of aphantasia_tpu/ops/pallas_persp.py:
//   _fwd_call (pallas_call at :394, body _fwd_kernel :217) and
//   _bwd_call (pallas_call at :439, body _bwd_kernel :276); the compact
//   route (:573/:592) calls the same two and is a wrapper here too.
//
// Computes torchvision's F.perspective / F.affine(fill=0) per sample s of
// S cutouts [S,C,H,W], with coeffs (a..h) mapping an output pixel centre to
// its input position:
//   sx = (a*(x+.5) + b*(y+.5) + c) / (g*(x+.5) + h*(y+.5) + 1) - .5
//   sy = (d*(x+.5) + e*(y+.5) + f) / (same)                    - .5
//   out[s,:,y,x] = mask * sum over the 4 bilinear taps q in the frame of
//                  w(q) * img[s,:,q],   mask = sum of those in-frame w(q)
// (zero padding; the mask is torchvision's sampled ones channel).  A sample
// whose flag is 0 is copied bit for bit (RandomPerspective returns the
// input unchanged when its Bernoulli fails).
//
// The TPU kernel is a banded one-hot matmul: it builds the hat-function
// weight matrices with iota compares and contracts a window of source rows
// on the MXU, with compile-time window bounds per family, 16-row tiles and
// 16-aligned window bases (Mosaic's tiling) and an XLA-gather fallback for
// H % 16 != 0.  None of that is needed on Hopper: a thread reads its four
// taps directly, so any H and W work and no window bound exists forward.
//
// Forward (persp_fwd): one thread per output pixel (s, y, x), all C
// channels.  Positions, weights and sums are float32 for bf16 and float32
// images alike; the result is rounded once to the image's type.  The
// position arithmetic uses round-to-nearest intrinsics without contraction,
// so it equals the plain PyTorch version's to the bit.
//
// Backward (persp_bwd): d_img for d_out, as a gather, so that each element
// is written once, with no atomics, and the result is deterministic.  One
// thread per input pixel q maps q's centre through the inverse homography
// to the output position p* whose sample lands on q, then walks the
// (2R+1)^2 output pixels p around round(p*), R = 3, recomputes each one's
// exact forward taps and mask, and sums g[p] * mask(p) * w(p -> q).  A
// division-free test first drops the candidates whose sample lands a pixel
// or more from q, so only the few that reach q pay for the exact taps.
// Window assumption: p contributes to q only if |src(p) - q|_inf < 1, so
// |p - p*|_inf <= |J| * sqrt(2) with J the Jacobian of the inverse map, and
// |p - round(p*)|_inf <= |J| * sqrt(2) + 1/2.  R = 3 covers |J| <= 1.76:
// the distortion-0.33 RandomPerspective family peaks near 1.5 (the JAX
// package's _BWD_RADIUS note, aphantasia_tpu/ops/perspective.py:45-48,
// states the family bound as |J| <= 1.9 with its rounding margin) and
// rotations have |J| = 1.  tests/test_torch_persp.py checks the window at
// the extreme corner draws and at +-30 degrees on the CPU, and chip_smoke.py
// holds this kernel against autograd's exact transpose there on the card.
//
// What bounds it on the H100: at [200,3,224,224] bf16 the function reads
// and writes 60 MB (36 us at 3.35 TB/s) and does ~50 flops per drawn
// pixel, so it is bound by bytes; the forward's gathers read a sample's
// 300 KB from L1/L2.  The backward kernel does far more than the function
// needs: 49 rejection tests per pixel of a drawn sample and the exact taps
// of the few candidates that pass, so its time follows the share of drawn
// samples and it is bound by issued instructions, not bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kMaxC = 4;
constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Coef {
  float a, b, c, d, e, f, g, h;
};

__device__ __forceinline__ Coef load_coef(const float* coef, int s) {
  const float* p = coef + 8 * s;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3),
          __ldg(p + 4), __ldg(p + 5), __ldg(p + 6), __ldg(p + 7)};
}

// The input position sampled by output pixel (x, y), in the plain
// version's operation order: ((a*xx + b*yy) + c) / ((g*xx + h*yy) + 1) - .5
__device__ __forceinline__ void src_pos(const Coef& k, int x, int y,
                                        float* sx, float* sy) {
  const float xx = (float)x + 0.5f, yy = (float)y + 0.5f;
  const float den = __fadd_rn(__fadd_rn(__fmul_rn(k.g, xx), __fmul_rn(k.h, yy)),
                              1.0f);
  *sx = __fsub_rn(__fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(k.a, xx),
                                                __fmul_rn(k.b, yy)), k.c),
                            den), 0.5f);
  *sy = __fsub_rn(__fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(k.d, xx),
                                                __fmul_rn(k.e, yy)), k.f),
                            den), 0.5f);
}

// The four taps of a sample position: corner origin, fractions, the
// in-frame weights (0 outside) and their sum, the fill mask.
struct Taps {
  float x0, y0, tx, ty;
  float w[4];   // (dy,dx) = (0,0), (0,1), (1,0), (1,1), times in-frame
  float mask;
};

__device__ __forceinline__ Taps taps_at(float sx, float sy, int h, int w) {
  Taps t;
  t.x0 = floorf(sx);
  t.y0 = floorf(sy);
  t.tx = __fsub_rn(sx, t.x0);
  t.ty = __fsub_rn(sy, t.y0);
  const float ux = __fsub_rn(1.0f, t.tx), uy = __fsub_rn(1.0f, t.ty);
  const bool okx0 = t.x0 >= 0.f && t.x0 < (float)w;
  const bool okx1 = t.x0 + 1.f >= 0.f && t.x0 + 1.f < (float)w;
  const bool oky0 = t.y0 >= 0.f && t.y0 < (float)h;
  const bool oky1 = t.y0 + 1.f >= 0.f && t.y0 + 1.f < (float)h;
  t.w[0] = (okx0 && oky0) ? __fmul_rn(ux, uy) : 0.f;
  t.w[1] = (okx1 && oky0) ? __fmul_rn(t.tx, uy) : 0.f;
  t.w[2] = (okx0 && oky1) ? __fmul_rn(ux, t.ty) : 0.f;
  t.w[3] = (okx1 && oky1) ? __fmul_rn(t.tx, t.ty) : 0.f;
  t.mask = __fadd_rn(__fadd_rn(__fadd_rn(t.w[0], t.w[1]), t.w[2]), t.w[3]);
  return t;
}

template <typename T>
__global__ void persp_fwd_kernel(const T* __restrict__ img,
                                 const float* __restrict__ coef,
                                 const int* __restrict__ flags,
                                 T* __restrict__ out, int c, int h, int w) {
  const int s = blockIdx.y;
  const int hw = h * w;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int64_t base = (int64_t)s * c * hw + pix;
  if (flags[s] == 0) {
    for (int ch = 0; ch < c; ++ch) out[base + (int64_t)ch * hw] = img[base + (int64_t)ch * hw];
    return;
  }
  const int y = pix / w, x = pix - y * w;
  float sx, sy;
  src_pos(load_coef(coef, s), x, y, &sx, &sy);
  const Taps t = taps_at(sx, sy, h, w);
  // clamped tap offsets: a tap outside the frame has weight 0
  const int ix0 = (int)fminf(fmaxf(t.x0, 0.f), (float)(w - 1));
  const int ix1 = (int)fminf(fmaxf(t.x0 + 1.f, 0.f), (float)(w - 1));
  const int iy0 = (int)fminf(fmaxf(t.y0, 0.f), (float)(h - 1));
  const int iy1 = (int)fminf(fmaxf(t.y0 + 1.f, 0.f), (float)(h - 1));
  const int off[4] = {iy0 * w + ix0, iy0 * w + ix1, iy1 * w + ix0,
                      iy1 * w + ix1};
  const T* src = img + (int64_t)s * c * hw;
  for (int ch = 0; ch < c; ++ch) {
    const T* plane = src + (int64_t)ch * hw;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) acc = __fadd_rn(acc, __fmul_rn(load(plane + off[k]), t.w[k]));
    store(out + base + (int64_t)ch * hw, __fmul_rn(acc, t.mask));
  }
}

template <typename T>
__global__ void persp_bwd_kernel(const T* __restrict__ g,
                                 const float* __restrict__ coef,
                                 const float* __restrict__ inv,
                                 const int* __restrict__ flags,
                                 T* __restrict__ dimg, int c, int h, int w) {
  const int s = blockIdx.y;
  const int hw = h * w;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= hw) return;
  const int64_t base = (int64_t)s * c * hw + pix;
  if (flags[s] == 0) {
    for (int ch = 0; ch < c; ++ch) dimg[base + (int64_t)ch * hw] = g[base + (int64_t)ch * hw];
    return;
  }
  const int qy = pix / w, qx = pix - qy * w;
  const float fqx = (float)qx, fqy = (float)qy;
  // the output position whose sample lands on q's centre
  const float* m = inv + 9 * s;
  const float xq = fqx + 0.5f, yq = fqy + 0.5f;
  const float den = __ldg(m + 6) * xq + __ldg(m + 7) * yq + __ldg(m + 8);
  const float px = (__ldg(m) * xq + __ldg(m + 1) * yq + __ldg(m + 2)) / den - 0.5f;
  const float py = (__ldg(m + 3) * xq + __ldg(m + 4) * yq + __ldg(m + 5)) / den - 0.5f;
  // clamp before the integer conversion; a clamped centre only moves the
  // window off the frame, where every candidate is skipped
  const int p0x = (int)rintf(fminf(fmaxf(px, -2.f * kRadius), (float)(w + 2 * kRadius)));
  const int p0y = (int)rintf(fminf(fmaxf(py, -2.f * kRadius), (float)(h + 2 * kRadius)));
  const Coef k = load_coef(coef, s);
  const T* gs = g + (int64_t)s * c * hw;
  float acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
    const int oy = p0y + dy;
    if (oy < 0 || oy >= h) continue;
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      const int ox = p0x + dx;
      if (ox < 0 || ox >= w) continue;
      // cheap rejection without the divisions: p reaches q only if
      // |sx - qx| < 1 and |sy - qy| < 1, i.e. |num - (q + .5) den| < |den|;
      // the slack keeps rounding from rejecting a candidate that reaches q
      const float ux = (float)ox + 0.5f, uy = (float)oy + 0.5f;
      const float dn = k.g * ux + k.h * uy + 1.f;
      const float lim = 1.001f * fabsf(dn);
      if (fabsf(k.a * ux + k.b * uy + k.c - xq * dn) >= lim ||
          fabsf(k.d * ux + k.e * uy + k.f - yq * dn) >= lim) continue;
      float sx, sy;
      src_pos(k, ox, oy, &sx, &sy);
      const Taps t = taps_at(sx, sy, h, w);
      // which of p's taps is q, if any
      const int jx = fqx == t.x0 ? 0 : (fqx == t.x0 + 1.f ? 1 : -1);
      const int jy = fqy == t.y0 ? 0 : (fqy == t.y0 + 1.f ? 1 : -1);
      if (jx < 0 || jy < 0) continue;
      const float wq = __fmul_rn(t.w[2 * jy + jx], t.mask);
      const int op = oy * w + ox;
#pragma unroll
      for (int ch = 0; ch < kMaxC; ++ch)
        if (ch < c) acc[ch] = fmaf(load(gs + (int64_t)ch * hw + op), wq, acc[ch]);
    }
  }
#pragma unroll
  for (int ch = 0; ch < kMaxC; ++ch)
    if (ch < c) store(dimg + base + (int64_t)ch * hw, acc[ch]);
}

template <typename T>
int launch_fwd(const void* img, const void* coef, const void* flags, void* out,
               int s, int c, int h, int w, cudaStream_t stream) {
  dim3 grid((h * w + kThreads - 1) / kThreads, s);
  persp_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)img, (const float*)coef, (const int*)flags, (T*)out, c, h, w);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* coef, const void* inv,
               const void* flags, void* dimg, int s, int c, int h, int w,
               cudaStream_t stream) {
  dim3 grid((h * w + kThreads - 1) / kThreads, s);
  persp_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)g, (const float*)coef, (const float*)inv, (const int*)flags,
      (T*)dimg, c, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img/out [s,c,h,w] (bf16 when bf16 != 0, else f32); coef [s,8] f32;
// flags [s] int32.
int persp_fwd(const void* img, const void* coef, const void* flags, void* out,
              int s, int c, int h, int w, int bf16, void* stream) {
  if (bf16)
    return launch_fwd<__nv_bfloat16>(img, coef, flags, out, s, c, h, w,
                                     (cudaStream_t)stream);
  return launch_fwd<float>(img, coef, flags, out, s, c, h, w,
                           (cudaStream_t)stream);
}

// g/dimg [s,c,h,w] (bf16 or f32); coef [s,8] f32; inv [s,3,3] f32 (the
// inverse homography, m22 = 1); flags [s] int32; c <= 4.
int persp_bwd(const void* g, const void* coef, const void* inv,
              const void* flags, void* dimg, int s, int c, int h, int w,
              int bf16, void* stream) {
  if (c > kMaxC) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_bwd<__nv_bfloat16>(g, coef, inv, flags, dimg, s, c, h, w,
                                     (cudaStream_t)stream);
  return launch_bwd<float>(g, coef, inv, flags, dimg, s, c, h, w,
                           (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
