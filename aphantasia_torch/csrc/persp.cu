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
// Both kernels copy a flag-0 sample with 16-byte vector loads and stores,
// spread over the sample's blocks (`copy_sample`); at p = 0.2 that is 80%
// of the bytes.  Positions, weights and sums are float32 for bf16 and
// float32 images alike, each result rounded once to the image's type; the
// position arithmetic uses round-to-nearest intrinsics without
// contraction, so it equals the plain PyTorch version's to the bit.
//
// Forward (persp_fwd): a block owns a 2-D output tile (8 runs of 16 bytes
// wide, 32 rows) of one sample.  A warp computes 8 x 4 blocks of pixels,
// so that each of its gathers reads a compact patch of the input through
// L1; each pixel's four taps are summed per channel in the fixed order of
// `taps_at`, rounded once into a shared-memory copy of the tile, and each
// thread then stores a 16-byte run a channel (scalar stores where W is not
// a multiple of the run).
//
// Backward (persp_bwd): d_img for d_out as a gather, so that each element
// is written once, with no atomics, and the result is deterministic.  A
// block owns a 32 x 32 tile of input pixels q of one sample.  (1) The
// output rows whose taps can reach the tile: p reaches q only if src(p)
// lies within a pixel of q, so p lies in the inverse image of the tile
// widened by one pixel (and kSlack for rounding); its corners through the
// inverse map give the rows.  (2) Within each row the pixels whose
// sample lands in that rectangle form an interval, solved in closed form
// (`row_interval`).  (3) Each p of those intervals gets its exact forward
// taps once (`src_pos`, `taps_at`) into shared memory: the tap origin
// relative to the tile, the four weights times the mask and g[p] for C
// <= 4 channels.  (4) Each q walks the output pixels within the tile's
// reach of p*(q), the output position whose sample lands on q's centre
// (the inverse map; the reach bounds how far p* moves when q moves a
// pixel, from the map's Jacobian at the tile's corners), cut to the first
// design's window of R = 3 around round(p*), dy-major then dx: an integer
// compare decides whether q is one of p's taps, and then one fmaf a
// channel adds g[p] * w * mask into float32.  The pixels that reach q are
// those the first design's (2R+1)^2 walk found, in the same order, so the
// sums are the same bits.  Window assumption, as in the first design: p
// reaches q only if |src(p) - q|_inf < 1, so |p - p*|_inf <= |J| * sqrt(2)
// with J the Jacobian of the inverse map, and |p - round(p*)|_inf <= |J| *
// sqrt(2) + 1/2.  R = 3 covers |J| <= 1.76: the distortion-0.33
// RandomPerspective family peaks near 1.5 (the JAX package's _BWD_RADIUS
// note, aphantasia_tpu/ops/perspective.py:45-48, states the family bound
// as |J| <= 1.9 with its rounding margin) and rotations have |J| = 1,
// where the walk is at most 3 x 3.  tests/test_torch_persp.py checks the
// window, the rows, the intervals and the reach by brute force at the
// extreme corner draws, at +-30 degrees and on a 200x216 frame on the CPU,
// and chip_smoke.py holds this kernel against autograd's exact transpose
// there on the card.  A tile whose rows or entries do not fit in shared
// memory (none of either family), or whose corners straddle a horizon of
// either map, takes `walk_direct`, the first design's per-candidate walk,
// with the same result.
//
// What bounds it on the H100: at [200,3,224,224] bf16 the function reads
// and writes 60 MB (36 us at 3.35 TB/s) and does ~50 flops per drawn
// pixel, so it is bound by bytes.  The copies run near the byte rate; a
// drawn sample is bound by issue and latency, not bytes: the forward by
// each pixel's two IEEE divisions and twelve 2-byte gathers, the backward
// by the exact taps of ~1.1 output pixels a tile pixel (two IEEE
// divisions each) and by the walk's ~25 shared-memory loads a pixel.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 3;
constexpr int kMaxC = 4;
constexpr int kThreads = 256;
// forward: a tile of 8 runs of 16 bytes by 32 rows, a thread a run
constexpr int kRunsX = 8;
constexpr int kFwdRows = 32;
// backward: a tile of 32 x 32 input pixels, a warp 8 x 4 of them at a
// time, so a thread takes four; the output rows a tile may need and the
// output pixels whose taps it holds
constexpr int kQx = 32;
constexpr int kQy = 32;
constexpr int kMaxRows = 128;
constexpr int kEntries = 2272;
// slack (input pixels) of the rows' intervals, and of a pixel's window
// (output pixels, and relative), over the float32 rounding of the maps
constexpr float kSlack = 0.25f;
constexpr float kEps = 0.05f;
constexpr float kEpsRel = 1e-3f;

// the C <= 4 channels of one pixel: four bf16 in 8 bytes, or four floats
template <typename T> struct Pix;
template <> struct Pix<float> { using type = float4; };
template <> struct Pix<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 unpack(float4 v) { return v; }
__device__ __forceinline__ float4 unpack(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
// the pixel at p of each of the c planes (c <= 4) lying hw apart, packed
__device__ __forceinline__ float4 gather(const float* p, int64_t hw, int c) {
  return make_float4(__ldg(p), c > 1 ? __ldg(p + hw) : 0.f,
                     c > 2 ? __ldg(p + 2 * hw) : 0.f,
                     c > 3 ? __ldg(p + 3 * hw) : 0.f);
}
__device__ __forceinline__ uint2 gather(const __nv_bfloat16* p, int64_t hw,
                                        int c) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  const unsigned b0 = __ldg(u), b1 = c > 1 ? __ldg(u + hw) : 0u;
  const unsigned b2 = c > 2 ? __ldg(u + 2 * hw) : 0u;
  const unsigned b3 = c > 3 ? __ldg(u + 3 * hw) : 0u;
  return make_uint2(b0 | (b1 << 16), b2 | (b3 << 16));
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// One sample's n elements src -> dst by this block, part `part` of the
// sample's `parts` blocks: 16-byte vectors interleaved over the blocks,
// the unaligned ends element by element.  src and dst lie alike modulo 16
// bytes (the wrapper passes 16-byte aligned tensors of one shape).
template <typename T>
__device__ void copy_sample(const T* __restrict__ src, T* __restrict__ dst,
                            int64_t n, int part, int parts) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t lead = ((16 - ((uintptr_t)src & 15)) & 15) / sizeof(T);
  const int64_t head = lead < n ? lead : n;
  const int64_t nv = (n - head) / kVec;
  const int4* vs = reinterpret_cast<const int4*>(src + head);
  int4* vd = reinterpret_cast<int4*>(dst + head);
  for (int64_t i = (int64_t)part * blockDim.x + threadIdx.x; i < nv;
       i += (int64_t)parts * blockDim.x)
    vd[i] = __ldg(vs + i);
  if (part == parts - 1) {
    for (int64_t i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
    for (int64_t i = head + nv * kVec + threadIdx.x; i < n; i += blockDim.x)
      dst[i] = src[i];
  }
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
__global__ void __launch_bounds__(kThreads)
persp_fwd_kernel(const T* __restrict__ img, const float* __restrict__ coef,
                 const int* __restrict__ flags, T* __restrict__ out, int c,
                 int h, int w, int tiles_x) {
  constexpr int kRun = 16 / sizeof(T);       // pixels of a 16-byte run
  constexpr int kTileW = kRunsX * kRun;
  // the tile's output, a row of kTileW + one 16-byte pad a channel row
  __shared__ __align__(16) T tile_s[kMaxC][kFwdRows][kTileW + kRun];
  const int s = blockIdx.y;
  const int hw = h * w;
  const int64_t base = (int64_t)s * c * hw;
  const Coef k = load_coef(coef, s);
  if (flags[s] == 0) {
    copy_sample(img + base, out + base, (int64_t)c * hw, blockIdx.x,
                gridDim.x);
    return;
  }
  const int tx0 = ((int)blockIdx.x % tiles_x) * kTileW;
  const int ty0 = ((int)blockIdx.x / tiles_x) * kFwdRows;
  const T* src = img + base;
  // a warp computes 8 x 4 blocks of pixels, kRun of them side by side in
  // four rows, so that a gather of the warp reads a compact patch
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ly = warp * 4 + (lane >> 3), y = ty0 + ly;
#pragma unroll
  for (int v = 0; v < kRun; ++v) {
    const int lx = 8 * v + (lane & 7), x = tx0 + lx;
    if (x >= w || y >= h) continue;
    float sx, sy;
    src_pos(k, x, y, &sx, &sy);
    const Taps t = taps_at(sx, sy, h, w);
    // clamped tap offsets: a tap outside the frame has weight 0
    const int ix0 = (int)fminf(fmaxf(t.x0, 0.f), (float)(w - 1));
    const int ix1 = (int)fminf(fmaxf(t.x0 + 1.f, 0.f), (float)(w - 1));
    const int iy0 = (int)fminf(fmaxf(t.y0, 0.f), (float)(h - 1));
    const int iy1 = (int)fminf(fmaxf(t.y0 + 1.f, 0.f), (float)(h - 1));
    const int off[4] = {iy0 * w + ix0, iy0 * w + ix1, iy1 * w + ix0,
                        iy1 * w + ix1};
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch) {
      if (ch >= c) break;
      const T* plane = src + (int64_t)ch * hw;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc = __fadd_rn(acc, __fmul_rn(load(plane + off[q]), t.w[q]));
      store(&tile_s[ch][ly][lx], __fmul_rn(acc, t.mask));
    }
  }
  __syncthreads();
  // then a thread a 16-byte run of a row, a store a channel
  const int ry = threadIdx.x / kRunsX, rx = (threadIdx.x % kRunsX) * kRun;
  const int x0 = tx0 + rx;
  if (ty0 + ry >= h || x0 >= w) return;
  T* dst = out + base + (int64_t)(ty0 + ry) * w + x0;
  if (w % kRun == 0) {       // whole runs, every row on a 16-byte boundary
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
      if (ch < c)
        *reinterpret_cast<uint4*>(dst + (int64_t)ch * hw) =
            *reinterpret_cast<const uint4*>(&tile_s[ch][ry][rx]);
  } else {
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
#pragma unroll
      for (int v = 0; v < kRun; ++v)
        if (ch < c && x0 + v < w)
          dst[(int64_t)ch * hw + v] = tile_s[ch][ry][rx + v];
  }
}

// The inverse homography of a sample, [3][3] with m22 = 1: the adjugate of
// [[a, b, c], [d, e, f], [g, h, 1]] over its last entry, each term rounded
// as the PyTorch version's (ops/perspective.py:_inverse_coeffs) is; maps
// an input pixel centre to the output position that samples it.
struct Inv {
  float m[9];
};

__device__ __forceinline__ Inv inverse(const Coef& k) {
  auto det2 = [](float p, float q, float r, float t) {
    return __fsub_rn(__fmul_rn(p, q), __fmul_rn(r, t));
  };
  const float adj[9] = {
      det2(k.e, 1.f, k.f, k.h), det2(k.c, k.h, k.b, 1.f),
      det2(k.b, k.f, k.c, k.e), det2(k.f, k.g, k.d, 1.f),
      det2(k.a, 1.f, k.c, k.g), det2(k.c, k.d, k.a, k.f),
      det2(k.d, k.h, k.e, k.g), det2(k.b, k.g, k.a, k.h),
      det2(k.a, k.e, k.b, k.d)};
  Inv r;
#pragma unroll
  for (int i = 0; i < 9; ++i) r.m[i] = __fdiv_rn(adj[i], adj[8]);
  return r;
}

// The output position p* whose sample lands on input pixel (xs, ys).
__device__ __forceinline__ float2 p_star(const Inv& v, float xs, float ys) {
  const float xq = xs + 0.5f, yq = ys + 0.5f;
  const float den = v.m[6] * xq + v.m[7] * yq + v.m[8];
  return make_float2((v.m[0] * xq + v.m[1] * yq + v.m[2]) / den - 0.5f,
                     (v.m[3] * xq + v.m[4] * yq + v.m[5]) / den - 0.5f);
}

// round(p*), clamped before the integer conversion (a clamped centre only
// moves the window off the frame): the centre of the first design's
// (2R+1)^2 window, whose bound the walk keeps
__device__ __forceinline__ int centre(float p, int n) {
  return (int)rintf(fminf(fmaxf(p, -2.f * kRadius), (float)(n + 2 * kRadius)));
}

// The first design's walk for one q: every output pixel within R of p0,
// dy-major then dx, its exact taps recomputed after a division-free test
// drops those whose sample lands a pixel or more from q.  Used by a block
// whose rows do not fit; gives the same sums as the shared-memory walk.
template <typename T>
__device__ __noinline__ float4 walk_direct(const Coef& k, const T* gs, int qx,
                                           int qy, int p0x, int p0y, int c,
                                           int h, int w) {
  const int hw = h * w;
  const float fqx = (float)qx, fqy = (float)qy;
  const float xq = fqx + 0.5f, yq = fqy + 0.5f;
  float acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int dy = -kRadius; dy <= kRadius; ++dy) {
    const int oy = p0y + dy;
    if (oy < 0 || oy >= h) continue;
    for (int dx = -kRadius; dx <= kRadius; ++dx) {
      const int ox = p0x + dx;
      if (ox < 0 || ox >= w) continue;
      // p reaches q only if |sx - qx| < 1 and |sy - qy| < 1, i.e.
      // |num - (q + .5) den| < |den|; the slack keeps rounding from
      // rejecting a candidate that reaches q
      const float ux = (float)ox + 0.5f, uy = (float)oy + 0.5f;
      const float dn = k.g * ux + k.h * uy + 1.f;
      const float lim = 1.001f * fabsf(dn);
      if (fabsf(k.a * ux + k.b * uy + k.c - xq * dn) >= lim ||
          fabsf(k.d * ux + k.e * uy + k.f - yq * dn) >= lim) continue;
      float sx, sy;
      src_pos(k, ox, oy, &sx, &sy);
      const Taps t = taps_at(sx, sy, h, w);
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
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// acc += g[p] * w * mask of entry i, for the tap (jx, jy) of dk = (jy << 8)
// + jx, in float32 with one rounding a channel
template <typename P>
__device__ __forceinline__ void add_tap(float (&acc)[kMaxC],
                                        const float4* wq_s, const P* g_s,
                                        int i, int dk, int c) {
  const float wq =
      reinterpret_cast<const float*>(wq_s + i)[((dk >> 7) & 2) | (dk & 1)];
  const float4 gv = unpack(g_s[i]);
  acc[0] = fmaf(gv.x, wq, acc[0]);
  if (c > 1) acc[1] = fmaf(gv.y, wq, acc[1]);
  if (c > 2) acc[2] = fmaf(gv.z, wq, acc[2]);
  if (c > 3) acc[3] = fmaf(gv.w, wq, acc[3]);
}

// Narrow [lo, hi] to the x with kx * x >= r (ge) or kx * x <= r (!ge);
// the approximate division is covered by kSlack.
__device__ __forceinline__ void narrow(float kx, float r, bool ge, float* lo,
                                       float* hi) {
  if (fabsf(kx) < 1e-12f) {
    if (ge ? r > 0.f : r < 0.f) {
      *lo = INFINITY;
      *hi = -INFINITY;
    }
  } else if ((kx > 0.f) == ge) {
    *lo = fmaxf(*lo, __fdividef(r, kx));
  } else {
    *hi = fminf(*hi, __fdividef(r, kx));
  }
}

// The output pixels of row py whose sample lands in [x0s, x1s] x [y0s, y1s]
// (input pixel coordinates), as [lo, hi] cut to [0, w - 1] (empty: lo >
// hi).  Along a row the sample moves on a line, so they form an interval:
// with the denominator D > 0, s_lo <= N / D - .5 <= s_hi is linear in x.
__device__ __forceinline__ void row_interval(const Coef& k, int py, float x0s,
                                             float x1s, float y0s, float y1s,
                                             int w, int* lo, int* hi) {
  const float yy = (float)py + 0.5f;
  const float hd = k.h * yy + 1.f, bx = k.b * yy + k.c, by = k.e * yy + k.f;
  float a = -INFINITY, b = INFINITY;         // in x + .5
  narrow(k.a - (x0s + 0.5f) * k.g, (x0s + 0.5f) * hd - bx, true, &a, &b);
  narrow(k.a - (x1s + 0.5f) * k.g, (x1s + 0.5f) * hd - bx, false, &a, &b);
  narrow(k.d - (y0s + 0.5f) * k.g, (y0s + 0.5f) * hd - by, true, &a, &b);
  narrow(k.d - (y1s + 0.5f) * k.g, (y1s + 0.5f) * hd - by, false, &a, &b);
  *lo = (int)fminf(fmaxf(ceilf(a - 0.5f), 0.f), (float)w);
  *hi = (int)fmaxf(fminf(floorf(b - 0.5f), (float)(w - 1)), -1.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
persp_bwd_kernel(const T* __restrict__ g, const float* __restrict__ coef,
                 const int* __restrict__ flags, T* __restrict__ dimg, int c,
                 int h, int w, int tiles_x) {
  using P = typename Pix<T>::type;
  constexpr int kPer = kQy / (kThreads / 32);          // pixels a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* wq_s = reinterpret_cast<float4*>(smem_raw);  // w(k) * mask
  P* g_s = reinterpret_cast<P*>(wq_s + kEntries);      // g[p]
  int* key_s = reinterpret_cast<int*>(g_s + kEntries); // tap origin
  int* row_lo = key_s + kEntries;
  int* row_hi = row_lo + kMaxRows;
  int* row_off = row_hi + kMaxRows;          // kMaxRows + 1 entries
  int* warp_len = row_off + kMaxRows + 1;    // rows' lengths by warp
  const int s = blockIdx.y;
  const int hw = h * w;
  const int64_t base = (int64_t)s * c * hw;
  const Coef k = load_coef(coef, s);
  if (flags[s] == 0) {
    copy_sample(g + base, dimg + base, (int64_t)c * hw, blockIdx.x,
                gridDim.x);
    return;
  }
  const Inv m = inverse(k);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qx0 = ((int)blockIdx.x % tiles_x) * kQx;
  const int qy0 = ((int)blockIdx.x / tiles_x) * kQy;
  const int qx1 = min(qx0 + kQx, w) - 1, qy1 = min(qy0 + kQy, h) - 1;
  const T* gs = g + base;
  // this thread's pixels: block warp + 8u of 8 x 4, and p* of each
  int lx[kPer], ly[kPer];
  float2 pc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int blk = warp + 8 * u;
    lx[u] = 8 * (blk & 3) + (lane & 7);
    ly[u] = 4 * (blk >> 2) + (lane >> 3);
    pc[u] = p_star(m, (float)(qx0 + lx[u]), (float)(qy0 + ly[u]));
  }

  // (1) the output rows whose taps can reach the tile: p reaches it only
  // if src(p) lies in [qx0 - 1, qx1 + 1) x [qy0 - 1, qy1 + 1); widened by
  // kSlack, the inverse image of that rectangle, whose extremes lie at its
  // corners while the inverse map's denominator keeps one sign over it.
  // Every thread reckons the same rows.
  const float x0s = qx0 - 1 - kSlack, x1s = qx1 + 1 + kSlack;
  const float y0s = qy0 - 1 - kSlack, y1s = qy1 + 1 + kSlack;
  float lo_x = INFINITY, hi_x = -INFINITY, lo_y = INFINITY, hi_y = -INFINITY;
  float min_d2 = INFINITY;
  int sign = 0;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner) {
    const float xs = (corner & 1 ? x1s : x0s) + 0.5f;
    const float ys = (corner & 2 ? y1s : y0s) + 0.5f;
    const float den = m.m[6] * xs + m.m[7] * ys + m.m[8];
    sign += den > 0.f ? 1 : (den < 0.f ? -1 : 0);
    min_d2 = fminf(min_d2, den * den);
    const float px = __fdividef(m.m[0] * xs + m.m[1] * ys + m.m[2], den);
    const float py = __fdividef(m.m[3] * xs + m.m[4] * ys + m.m[5], den);
    lo_x = fminf(lo_x, px);
    hi_x = fmaxf(hi_x, px);
    lo_y = fminf(lo_y, py);
    hi_y = fmaxf(hi_y, py);
  }
  // how far p* moves when q moves by up to a pixel on each axis, over the
  // same rectangle: |dp| <= |dp/dx| + |dp/dy|, each the numerator, linear
  // in one coordinate, over D^2, D linear: both extremes at the corners
  const float xa = x0s + 0.5f, xb = x1s + 0.5f, ya = y0s + 0.5f, yb = y1s + 0.5f;
  auto reach = [&](float r0, float r1, float r2) {
    const float ax = r0 * m.m[7] - m.m[6] * r1, bx = r0 * m.m[8] - m.m[6] * r2;
    const float ay = r1 * m.m[6] - m.m[7] * r0, by = r1 * m.m[8] - m.m[7] * r2;
    return (fmaxf(fabsf(ax * ya + bx), fabsf(ax * yb + bx)) +
            fmaxf(fabsf(ay * xa + by), fabsf(ay * xb + by))) / min_d2 *
               (1.f + kEpsRel) + kEps;
  };
  const float reach_x = reach(m.m[0], m.m[1], m.m[2]);
  const float reach_y = reach(m.m[3], m.m[4], m.m[5]);
  // (p = the position - .5; the rounding of the approximate division is
  // covered by kSlack)
  const int by0 = (int)fminf(fmaxf(floorf(lo_y - 0.5f), 0.f), (float)h);
  const int by1 = (int)fmaxf(fminf(ceilf(hi_y - 0.5f), (float)(h - 1)), -1.f);
  const int rows = max(by1 - by0 + 1, 0);
  // the intervals are solved with the forward denominator positive: it is
  // linear, so positive over the rows' box when it is at the box's corners
  const float bx0 = fmaxf(floorf(lo_x - 0.5f), 0.f) + 0.5f;
  const float bx1 = fminf(ceilf(hi_x - 0.5f), (float)(w - 1)) + 0.5f;
  bool boxed = (sign == 4 || sign == -4) && isfinite(lo_x) &&
               isfinite(hi_x) && isfinite(lo_y) && isfinite(hi_y) &&
               rows <= kMaxRows;
#pragma unroll
  for (int corner = 0; corner < 4; ++corner)
    boxed = boxed && k.g * (corner & 1 ? bx1 : bx0) +
                     k.h * ((corner & 2 ? by1 : by0) + 0.5f) + 1.f > 0.f;

  // (2) a thread a row: each row's interval and its offset among the rows
  // of its warp
  if (boxed && tid < kMaxRows) {
    int lo = 0, hi = -1;
    if (tid < rows)
      row_interval(k, by0 + tid, x0s, x1s, y0s, y1s, w, &lo, &hi);
    const int len = max(hi - lo + 1, 0);
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    row_lo[tid] = lo;
    row_hi[tid] = hi;
    row_off[tid] = incl - len;
    if (lane == 31) warp_len[warp] = incl;
  }
  __syncthreads();
  float acc[kPer][kMaxC] = {};
  int total = 0;
  if (boxed) {
    // the rows' offsets across warps
    int before = 0;
    for (int j = 0; j < kMaxRows / 32; ++j) {
      if (j < warp) before += warp_len[j];
      total += warp_len[j];
    }
    boxed = total <= kEntries;
    if (tid < kMaxRows) row_off[tid] += before;
    if (tid == 0) row_off[kMaxRows] = total;
    __syncthreads();
  }
  if (boxed) {
    // (3) each p of the rows: its exact taps, once, a warp a row.  The
    // tap origin is kept relative to (qx0 - 2, qy0 - 2), clamped to [0,
    // kQx + 3] x [0, kQy + 3] (an origin whose taps miss the tile never
    // matches), as (y << 8) | x
    for (int r = warp; r < rows; r += kThreads / 32) {
      const int lo = row_lo[r], n = row_hi[r] - lo + 1, py = by0 + r;
      for (int j = lane; j < n; j += 32) {
        const int px = lo + j, i = row_off[r] + j;
        const P gv = gather(gs + py * w + px, hw, c);
        float sx, sy;
        src_pos(k, px, py, &sx, &sy);
        const Taps t = taps_at(sx, sy, h, w);
        const int ox = (int)fminf(fmaxf(t.x0 - (float)(qx0 - 2), 0.f),
                                  (float)(kQx + 3));
        const int oy = (int)fminf(fmaxf(t.y0 - (float)(qy0 - 2), 0.f),
                                  (float)(kQy + 3));
        key_s[i] = (oy << 8) | ox;
        wq_s[i] = make_float4(
            __fmul_rn(t.w[0], t.mask), __fmul_rn(t.w[1], t.mask),
            __fmul_rn(t.w[2], t.mask), __fmul_rn(t.w[3], t.mask));
        g_s[i] = gv;
      }
    }
    __syncthreads();
    // (4) each q walks the output pixels whose sample can land within a
    // pixel of it: those within (reach_x, reach_y) of p*(q), cut to the
    // first design's window around round(p*(q)), dy-major then dx, so the
    // pixels that reach q come in its order.  A warp takes 8 x 4 blocks of
    // q, so its windows overlap; a window of up to 3 x 3 (every rotation)
    // is walked unrolled.
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (qx0 + lx[u] >= w || qy0 + ly[u] >= h) continue;
      const int p0x = centre(pc[u].x, w), p0y = centre(pc[u].y, h);
      const int xlo = (int)fmaxf(ceilf(pc[u].x - reach_x), (float)(p0x - kRadius));
      const int xhi = (int)fminf(floorf(pc[u].x + reach_x), (float)(p0x + kRadius));
      const int ylo = (int)fmaxf(ceilf(pc[u].y - reach_y),
                                 (float)max(p0y - kRadius, by0));
      const int yhi = (int)fminf(floorf(pc[u].y + reach_y),
                                 (float)min(p0y + kRadius, by1));
      const int qkey = ((ly[u] + 2) << 8) | (lx[u] + 2);
      if (xhi - xlo < 3 && yhi - ylo < 3) {
        // the keys first, so that their loads are in flight together
        int dks[9], idx[9];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const bool row_ok = ylo + dy <= yhi;
          const int rr = row_ok ? ylo + dy - by0 : 0;
          const int rlo = row_lo[rr], rhi = row_hi[rr];
          const int e0 = row_off[rr] - rlo;        // entry of x = 0
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int ox = xlo + dx;
            const bool in = row_ok && ox <= xhi && ox >= rlo && ox <= rhi;
            idx[3 * dy + dx] = e0 + ox;
            dks[3 * dy + dx] = in ? qkey - key_s[e0 + ox] : -1;
          }
        }
#pragma unroll
        for (int j = 0; j < 9; ++j)      // (jy << 8) + jx: a tap of p
          if (!(dks[j] & ~0x101)) add_tap(acc[u], wq_s, g_s, idx[j], dks[j], c);
      } else {
        for (int oy = ylo; oy <= yhi; ++oy) {
          const int rr = oy - by0;
          const int e0 = row_off[rr] - row_lo[rr];
          const int hi = min(xhi, row_hi[rr]);
          for (int ox = max(xlo, row_lo[rr]); ox <= hi; ++ox) {
            const int dk = qkey - key_s[e0 + ox];
            if (!(dk & ~0x101)) add_tap(acc[u], wq_s, g_s, e0 + ox, dk, c);
          }
        }
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (qx0 + lx[u] >= w || qy0 + ly[u] >= h) continue;
      const float4 r = walk_direct(k, gs, qx0 + lx[u], qy0 + ly[u],
                                   centre(pc[u].x, w), centre(pc[u].y, h), c,
                                   h, w);
      acc[u][0] = r.x;
      acc[u][1] = r.y;
      acc[u][2] = r.z;
      acc[u][3] = r.w;
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int qx = qx0 + lx[u], qy = qy0 + ly[u];
    if (qx >= w || qy >= h) continue;
    T* dst = dimg + base + (int64_t)qy * w + qx;
#pragma unroll
    for (int ch = 0; ch < kMaxC; ++ch)
      if (ch < c) store(dst + (int64_t)ch * hw, acc[u][ch]);
  }
}

template <typename T>
constexpr size_t bwd_smem() {
  return kEntries * (sizeof(float4) + sizeof(typename Pix<T>::type) +
                     sizeof(int)) +
         (3 * kMaxRows + 1 + kMaxRows / 32) * sizeof(int);
}

template <typename T>
int launch_fwd(const void* img, const void* coef, const void* flags, void* out,
               int s, int c, int h, int w, cudaStream_t stream) {
  constexpr int tile_w = kRunsX * 16 / (int)sizeof(T);
  const int tiles_x = (w + tile_w - 1) / tile_w;
  const dim3 grid(tiles_x * ((h + kFwdRows - 1) / kFwdRows), s);
  persp_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      (const T*)img, (const float*)coef, (const int*)flags, (T*)out, c, h, w,
      tiles_x);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* coef, const void* flags, void* dimg,
               int s, int c, int h, int w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      persp_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem<T>());
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (w + kQx - 1) / kQx;
  const dim3 grid(tiles_x * ((h + kQy - 1) / kQy), s);
  persp_bwd_kernel<T><<<grid, kThreads, bwd_smem<T>(), stream>>>(
      (const T*)g, (const float*)coef, (const int*)flags, (T*)dimg, c, h, w,
      tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img/out [s,c,h,w] (bf16 when bf16 != 0, else f32), 16-byte aligned;
// coef [s,8] f32; flags [s] int32; c <= 4.
int persp_fwd(const void* img, const void* coef, const void* flags, void* out,
              int s, int c, int h, int w, int bf16, void* stream) {
  if (c > kMaxC) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_fwd<__nv_bfloat16>(img, coef, flags, out, s, c, h, w,
                                     (cudaStream_t)stream);
  return launch_fwd<float>(img, coef, flags, out, s, c, h, w,
                           (cudaStream_t)stream);
}

// g/dimg [s,c,h,w] (bf16 or f32), 16-byte aligned; coef [s,8] f32; flags
// [s] int32; c <= 4.
int persp_bwd(const void* g, const void* coef, const void* flags, void* dimg,
              int s, int c, int h, int w, int bf16, void* stream) {
  if (c > kMaxC) return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_bwd<__nv_bfloat16>(g, coef, flags, dimg, s, c, h, w,
                                     (cudaStream_t)stream);
  return launch_bwd<float>(g, coef, flags, dimg, s, c, h, w,
                           (cudaStream_t)stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
