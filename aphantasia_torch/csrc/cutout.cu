// Cutout crop-and-resize for Hopper (sm_90a): a separable forward with
// the TPU kernel's bf16 roundings, and a backward owner-computes gather.
//
// Replaces the Pallas TPU kernels of aphantasia_tpu/ops/pallas_cutout.py:
//   _pallas_cut_fwd (pallas_call at :109, body _fwd_kernel :56) and
//   _pallas_cut_bwd (pallas_call at :139, body _bwd_kernel :68).
//
// For S samples of an M x M bicubic crop of a C x H x W float32 frame,
// with per-sample taps yidx/yw, xidx/xw [S,M,4]:
//   wy[m,y] = bf16(float32 sum, in tap order, of row m's y-taps on y)
//   tmp[m,x] = bf16(sum_y wy[m,y] * bf16(img[c,y,x]))   (float32 sum)
//   out[s,c,m,n] = sum_x tmp[m,x] * wx[n,x]              (float32 sum)
//   d_img[c,y,x] = sum over (s,m,n,a,b) with yidx=y, xidx=x of
//                  yw * xw * g[s,c,m,n]                  (float32 weights)
// wx is built from the x-taps as wy from the y-taps.  These are the TPU
// kernel's roundings (pallas_cutout.py:60-65, :107).  A product of two
// bf16 values is exact in float32, so only the order of each sum is
// free: every sum runs over the distinct taps of a row or column in
// ascending frame index, the order of the dense product, as the plain
// version (ops/cutout.py:rounded_fwd) takes it.
//
// The forward writes S*C*M*M float32 outputs (120 MB at S=200, M=224,
// C=3: 0.040 ms at 3.35 TB/s).  A direct 16-tap gather from the float32
// frame made 48 scattered reads an output (1.9 GB through L1 and L2 at
// that size).  The design here is separable, as the TPU kernel is:
//   - a block owns one sample, a band of kFwdRows output rows and up to
//     256 output columns.  Its threads sort, merge and round the taps of
//     the band's rows and of its columns (each distinct pixel's summed
//     weight rounded once), list the frame rows the band reaches (at most
//     4 a row, ascending) and the span of frame columns its columns reach;
//   - it stages those frame rows, kFwdPiece columns a stage, from a bf16
//     copy of the frame (one small launch in the same call, so a stage
//     is a plain 16-byte cp.async a thread) into a ring of 2 to 4 stages
//     in shared memory, the next ones in flight while the row pass runs
//     on this one, so a frame row comes from L2 once for the band however
//     many of its rows reach it.  Staging from the float32 frame instead,
//     rounded on the way in, moves twice the bytes out of L2 and was
//     measured slower than the copy's launch costs (PERF.md, PR 12);
//   - the row pass computes the rounded tmp [band][span] in shared
//     memory; then each thread takes one output column, keeps its four
//     taps in registers, gathers them from tmp for every row of the band
//     and writes a coalesced row of outputs a warp.
// A span wider than the tmp buffer (wide frames, or overscan taps folded
// across the frame) is walked in pieces of it in ascending x; each output
// carries its sum from piece to piece, so the order stays ascending.
// The walk is bound by L2 and instructions, not by the output bytes: the
// staging moves about 0.4 GB from L2 at the size above (each sample's
// crop region once a band, in bf16), and the row pass costs 4 FMAs and
// 4 unpacks a tmp value, with barriers around every stage.  No atomics:
// the bits repeat from run to run and under CUDA-graph replay.
//
// The backward reads g (120 MB) about once and writes d_img (11 MB): the
// same byte bound, 0.040 ms.  A scatter of every g element into its 16
// pixels would need float32 atomics, 482 M of them into one frame that
// 200 overlapping crops share: contention, and sums in a run-dependent
// order.  Instead each 32 x 32 tile of frame pixels (all channels) is
// owned by one block, which writes each pixel once, zero where no crop
// reaches:
//   - cutout_ranges_kernel, a pre-pass in the same call, records for each
//     sample the lowest and highest m with a weighted tap in each band of
//     32 rows and in each frame row, and the same for n and columns
//     (integer min/max, order-free).  Taps are monotone in m within a
//     crop, so a band maps to a short range; under --align
//     overscan|overmax the tile maps fold them, so a range is only an
//     envelope, and the weights below still compare each tap with its
//     pixel.
//   - cutout_bwd_kernel lists the samples that reach its tile and walks
//     them in order in chunks of at most 32 m and 32 n.  A producer warp
//     stages each chunk's g[s, :, m, n], taps and pixel ranges by TMA, up
//     to three chunks ahead, off the path of the eight summing warps.
//     Those build the chunk's weights on the tile, dense (Wx [n][x], Wy
//     [m][y]; a pixel's weight from one row of taps is their sum, so the
//     two taps the crop edge's clamp puts on one pixel both count), then
//     sum along n into T[c][m][x] (over each column's range of n) and
//     along m into registers that own the pixels (over the rows' ranges).
//   - The tiles go out from the middle of the frame, where the crops pile
//     up (a tile meets 2 to 164 of 200 crops at S = 200), and a tile's
//     walk is cut into up to 4 pieces of the samples, summed in order by
//     cutout_sum_kernel, so that no block walks all 164.
// Every pixel's sum runs in one fixed order (pieces, samples, chunks, n,
// m ascending; each weight's taps in order), so the bits repeat from run
// to run and under CUDA-graph replay: no floating-point atomics.  The
// walk is bound by its instructions, not its bytes: a step of three
// barriers, the weights and the two banded sums for every chunk of every
// crop a tile meets.

// The same two designs compute the card's default bf16 cut, the dense
// contraction's function (ops/sampler.py:_Contract, ops/cutout.py:contract):
//   contract_fwd: rows first, it is cutout_fwd's function.  Columns first
//     (W first, h < w) it is that function of the transposed frame with
//     the axes' taps swapped, its output transposed: the bf16 copy is made
//     transposed (frame_bf16_t_kernel) and cutout_fwd_kernel<true> writes
//     each band's outputs as rows of out[s,c,n,m].
//   contract_bwd: cutout_bwd_kernel<*, true, *> rounds the weights and g
//     to bf16, carries T over all the n chunks of an m chunk, rounds it
//     once to bf16 and only then sums along m, one running float32 sum a
//     pixel over its piece's samples and their m in order.  W first, it
//     walks the transposed frame with g read transposed by TMA (the same
//     map, the coordinates swapped) and writes d_img transposed, or
//     transpose_sum_kernel adds the pieces in order into it.  A frame of
//     4K's size takes tiles of 64 (the wrapper's choice; no sum's order
//     depends on the tile).
// The plain version (ops/cutout.py:contract_plain) takes every sum in
// these orders, so the pair repeats it bit for bit.

// The wrapper (ops/cutout.py) clamps every tap into the frame and zeroes
// the weight of a tap that was outside it, so no read leaves the frame and
// such taps count nowhere.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kFwdThreads = 256;
constexpr int kFwdRows = 16;      // output rows a block (a band)
constexpr int kFwdCols = 256;     // output columns a block, at most
constexpr int kFwdPiece = 128;    // frame columns staged at a time
constexpr int kFwdSpan = 768;     // tmp columns a block holds at most

// The bf16 copy of the frame the forward stages from: RNE, as
// img.astype(bfloat16) (pallas_cutout.py:107).
__global__ void frame_bf16_kernel(const float* __restrict__ img,
                                  __nv_bfloat16* __restrict__ dst,
                                  int64_t n) {
  const int64_t i = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) * 8;
  if (i + 8 <= n) {
    const float4 a = *reinterpret_cast<const float4*>(img + i);
    const float4 b = *reinterpret_cast<const float4*>(img + i + 4);
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(a.x, a.y);
    h[1] = __floats2bfloat162_rn(a.z, a.w);
    h[2] = __floats2bfloat162_rn(b.x, b.y);
    h[3] = __floats2bfloat162_rn(b.z, b.w);
    *reinterpret_cast<uint4*>(dst + i) = q;
  } else {
    for (int64_t j = i; j < n; ++j) dst[j] = __float2bfloat16_rn(img[j]);
  }
}

// The bf16 copy of the frame transposed, dst [c,w,h] from img [c,h,w],
// through a 32 x 32 tile in shared memory (blocks of 32 x 8 threads).
__global__ void frame_bf16_t_kernel(const float* __restrict__ img,
                                    __nv_bfloat16* __restrict__ dst, int h,
                                    int w) {
  __shared__ float tile[32][33];
  const int ch = blockIdx.z, y0 = blockIdx.y * 32, x0 = blockIdx.x * 32;
  const float* src = img + (int64_t)ch * h * w;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int y = y0 + i, x = x0 + threadIdx.x;
    if (y < h && x < w) tile[i][threadIdx.x] = src[(int64_t)y * w + x];
  }
  __syncthreads();
  __nv_bfloat16* out = dst + (int64_t)ch * h * w;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int x = x0 + i, y = y0 + threadIdx.x;
    if (y < h && x < w)
      out[(int64_t)x * h + y] = __float2bfloat16_rn(tile[threadIdx.x][i]);
  }
}

// One row's (or column's) four taps, as the dense bf16 matrix holds them:
// sorted by index (adjacent swaps, so taps on one index keep their
// order), the first tap of each index carrying the float32 sum of that
// index's weights in tap order rounded to bf16, the others weight 0; a
// tap of weight 0 gets index -1.
__device__ __forceinline__ void distinct_taps(int4 iv, float4 wv,
                                              int (&ix)[4], float (&w)[4]) {
  ix[0] = iv.x; ix[1] = iv.y; ix[2] = iv.z; ix[3] = iv.w;
  w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
  const int order[6][2] = {{0, 1}, {1, 2}, {0, 1}, {2, 3}, {1, 2}, {0, 1}};
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int a = order[t][0], b = order[t][1];
    if (ix[a] > ix[b]) {
      const int ti = ix[a]; ix[a] = ix[b]; ix[b] = ti;
      const float tw = w[a]; w[a] = w[b]; w[b] = tw;
    }
  }
  float sum[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float acc = w[k];
#pragma unroll
    for (int j = k + 1; j < 4; ++j) acc += ix[j] == ix[k] ? w[j] : 0.f;
    sum[k] = (k > 0 && ix[k] == ix[k - 1]) ? 0.f : acc;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = __bfloat162float(__float2bfloat16_rn(sum[k]));
    if (w[k] == 0.f) ix[k] = -1;
  }
}

// v rounded to bf16 (RNE), as a float
__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// A stage of the walk over a block's frame columns: channel ch, piece p
// of tw columns from x_base, kFwdPiece columns from sp within it.
struct Stage {
  int ch, p, sp;
};

// The forward's shared memory for a block of nb output columns and a tmp
// buffer of tw columns: the column taps, the band's row lists, the ring
// of staged frame rows (kFwdRing bytes) and tmp.
constexpr int kFwdRing = 2 * 4 * kFwdRows * kFwdPiece * 2 + 8192;
inline int fwd_smem(int nb, int tw) {
  return nb * 32 + 3 * 4 * kFwdRows * 4 + 16 + kFwdRing +
         kFwdRows * tw * 2;
}

// cp.async.wait_group n: all but the n most recent stages have landed
__device__ __forceinline__ void wait_ring(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<1>();
}

// blockIdx.y = s; blockIdx.x = band * ncols + column chunk: the band's
// output rows [band * kFwdRows, +kFwdRows), the chunk's columns
// [chunk * nb, +nb).  Frame img16 [c,h,w] bf16 (rows 16-byte aligned
// when vec), taps as the wrapper clamps them, out [s,c,m,m] float32.
// The block walks its span of frame columns in pieces of tw (one where
// it fits), each piece kFwdPiece columns a stage, channel by channel.
// Thread t stages and computes the row pass of band row t / 16, frame
// columns 8 (t % 16) .. + 7 of each stage, and after a piece adds the
// terms of output column t's taps in that piece to its sums for every
// band row: pieces ascend in x, and a column's taps too, so each sum runs
// in ascending x.  kTransOut writes the output transposed, out[s,c,n,m]
// for the kernel's row m and column n (the contraction of a transposed
// frame, contract_fwd).
template <bool kTransOut>
__global__ void __launch_bounds__(kFwdThreads, 3)
cutout_fwd_kernel(const __nv_bfloat16* __restrict__ img16,
                  const int* __restrict__ yidx, const float* __restrict__ yw,
                  const int* __restrict__ xidx, const float* __restrict__ xw,
                  float* __restrict__ out, int c, int h, int w, int m,
                  int nb, int tw, int ncols, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int4* xt = reinterpret_cast<int4*>(smem_raw);            // [nb]
  float4* xv = reinterpret_cast<float4*>(xt + nb);         // [nb]
  int* ent = reinterpret_cast<int*>(xv + nb);              // [4 kFwdRows]
  int* slot = ent + 4 * kFwdRows;                           // [4 kFwdRows]
  int* rows = slot + 4 * kFwdRows;                          // [4 kFwdRows]
  int* span = rows + 4 * kFwdRows;                          // lo, hi, nrows
  // the ring of stages of staged frame rows [nrows][kFwdPiece], then tmp
  __nv_bfloat16* fr = reinterpret_cast<__nv_bfloat16*>(span + 4);
  __nv_bfloat16* tmp = fr + kFwdRing / 2;                   // [rows][tw]
  const int tid = threadIdx.x, lane = tid & 31;
  const int smp = blockIdx.y;
  const int m0 = blockIdx.x / ncols * kFwdRows;
  const int n0 = blockIdx.x % ncols * nb;
  const int mr = min(kFwdRows, m - m0), nr = min(nb, m - n0);
  if (tid == 0) {
    span[0] = 0x7fffffff;
    span[1] = -1;
  }
  __syncthreads();
  // the columns' taps and the span of frame columns they reach
  int lo = 0x7fffffff, hi = -1;
  for (int j = tid; j < nb; j += kFwdThreads) {
    int ix[4] = {-1, -1, -1, -1};
    float wt[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < nr) {
      const int64_t at = ((int64_t)smp * m + n0 + j) * 4;
      distinct_taps(*reinterpret_cast<const int4*>(xidx + at),
                    *reinterpret_cast<const float4*>(xw + at), ix, wt);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (ix[k] >= 0) {
          lo = min(lo, ix[k]);
          hi = max(hi, ix[k]);
        }
    }
    xt[j] = make_int4(ix[0], ix[1], ix[2], ix[3]);
    xv[j] = make_float4(wt[0], wt[1], wt[2], wt[3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0 && lo <= hi) {
    atomicMin(&span[0], lo);
    atomicMax(&span[1], hi);
  }
  // this thread's band row and its taps; ent lists the frame row of
  // every weighted tap of the band
  const int q = tid / 16, grp = tid % 16;
  int ry[4] = {-1, -1, -1, -1};
  float rw[4] = {0.f, 0.f, 0.f, 0.f};
  if (q < mr) {
    const int64_t at = ((int64_t)smp * m + m0 + q) * 4;
    distinct_taps(*reinterpret_cast<const int4*>(yidx + at),
                  *reinterpret_cast<const float4*>(yw + at), ry, rw);
  }
  if (grp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) ent[4 * q + k] = ry[k];
  }
  __syncthreads();
  // the band's distinct frame rows, ascending, by warp 0 (two entries a
  // lane): an entry is first if no earlier entry names its row, and a
  // row's place is the count of first entries below it
  if (tid < 32) {
    const unsigned all = 0xffffffffu;
    const int v0 = ent[tid], v1 = ent[tid + 32];
    bool f0 = v0 >= 0, f1 = v1 >= 0;
    for (int src = 0; src < 32; ++src) {
      const int a = __shfl_sync(all, v0, src);
      const int b = __shfl_sync(all, v1, src);
      f0 = f0 && !(src < tid && a == v0);
      f1 = f1 && a != v1 && !(src < tid && b == v1);
    }
    const unsigned fa = __ballot_sync(all, f0);
    const unsigned fb = __ballot_sync(all, f1);
    int r0 = 0, r1 = 0;
    for (int src = 0; src < 32; ++src) {
      const int a = __shfl_sync(all, v0, src);
      const int b = __shfl_sync(all, v1, src);
      const bool ua = fa >> src & 1, ub = fb >> src & 1;
      r0 += (ua && a < v0) + (ub && b < v0);
      r1 += (ua && a < v1) + (ub && b < v1);
    }
    const int count = __popc(fa) + __popc(fb);
    // entries on one row write the same value to the same place
    if (v0 >= 0) rows[r0] = v0;
    if (v1 >= 0) rows[r1] = v1;
    // a tap of weight 0 reads the first staged row, times 0
    slot[tid] = v0 >= 0 ? r0 : 0;
    slot[tid + 32] = v1 >= 0 ? r1 : 0;
    if (tid == 0) span[2] = count;
  }
  __syncthreads();
  const int x_lo = span[0], x_hi = span[1], nrows = span[2];
  if (nrows == 0 || x_lo > x_hi) {
    // no weighted tap: every sum is empty
    for (int ch = 0; ch < c; ++ch)
      for (int it = tid; it < mr * nr; it += kFwdThreads)
        out[(((int64_t)smp * c + ch) * m + m0 + it / nr) * m + n0 +
            it % nr] = 0.f;
    return;
  }
  int sl[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) sl[k] = slot[4 * q + k] * kFwdPiece;
  // the ring: as many stages of the band's rows as kFwdRing holds, at
  // most 4 (2 for 64 rows)
  const int stage_elems = nrows * kFwdPiece;
  const int nslots = min(4, kFwdRing / 2 / stage_elems);
  const int x_base = x_lo & ~7;
  const int npieces = (x_hi + 1 - x_base + tw - 1) / tw;
  auto piece_w = [&](int p) { return min(tw, x_hi + 1 - x_base - p * tw); };
  // this thread stages columns 8 grp .. + 7 of the staged rows q + 16 i
  int64_t row_at[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    row_at[i] = q + 16 * i < nrows ? (int64_t)rows[q + 16 * i] * w : 0;
  const int j = grp * 8;
  // stage st's frame rows into ring slot b, by cp.async where a row's
  // eight values lie whole in a 16-byte aligned row, else one at a time
  auto issue = [&](Stage st, int b) {
    const int x = x_base + st.p * tw + st.sp + j;
    if (st.ch >= c || j >= min(kFwdPiece, piece_w(st.p) - st.sp)) return;
    const __nv_bfloat16* plane = img16 + (int64_t)st.ch * h * w + x;
    __nv_bfloat16* dst = fr + b * stage_elems + j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q + 16 * i;
      if (r >= nrows) break;
      const __nv_bfloat16* src = plane + row_at[i];
      if (vec && x + 8 <= w) {
        cp_async16(dst + r * kFwdPiece, src);
      } else {
        uint4 v;
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
        for (int t = 0; t < 8; ++t)
          e[t] = x + t < w ? src[t] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(dst + r * kFwdPiece) = v;
      }
    }
  };
  auto next = [&](Stage st) {
    st.sp += kFwdPiece;
    if (st.sp >= piece_w(st.p)) {
      st.sp = 0;
      if (++st.p == npieces) {
        st.p = 0;
        ++st.ch;
      }
    }
    return st;
  };
  // this thread's output column, its taps and its sums
  const int jc = min(tid, nb - 1);
  const int4 cxi = xt[jc];
  const float4 cxw = xv[jc];
  const int cix[4] = {cxi.x, cxi.y, cxi.z, cxi.w};
  const float cwv[4] = {cxw.x, cxw.y, cxw.z, cxw.w};
  float acc[kFwdRows] = {};
  Stage cur = {0, 0, 0}, ahead = cur;
  for (int i = 0; i < nslots - 1; ++i, ahead = next(ahead)) {
    issue(ahead, i);
    cp_async_commit();
  }
  for (int k = 0; cur.ch < c; ++k, cur = next(cur), ahead = next(ahead)) {
    issue(ahead, (k + nslots - 1) % nslots);
    cp_async_commit();
    wait_ring(nslots - 1);
    __syncthreads();
    // the row pass: tmp = bf16(sum over the row's taps, ascending)
    const int pw = piece_w(cur.p);
    if (q < mr && cur.sp + j < pw) {
      const __nv_bfloat16* f = fr + k % nslots * stage_elems + j;
      float a[8] = {};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint4 v = *reinterpret_cast<const uint4*>(f + sl[t]);
        const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[2 * e] = fmaf(rw[t], bf_lo(u[e]), a[2 * e]);
          a[2 * e + 1] = fmaf(rw[t], bf_hi(u[e]), a[2 * e + 1]);
        }
      }
      uint4 o;
      __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ho[e] = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
      *reinterpret_cast<uint4*>(tmp + q * tw + cur.sp + j) = o;
    }
    if (cur.sp + kFwdPiece >= pw) {
      __syncthreads();
      // the column pass over this piece: a tap outside it adds 0 times
      // the piece's first value, so each sum stays in ascending x
      const int xp0 = x_base + cur.p * tw;
      int off[4];
      float wk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = cix[e] >= xp0 && cix[e] < xp0 + pw;
        off[e] = in ? cix[e] - xp0 : 0;
        wk[e] = in ? cwv[e] : 0.f;
      }
      const bool last = cur.p == npieces - 1;
      if (tid < nr) {
        float* dst =
            out + (((int64_t)smp * c + cur.ch) * m + m0) * m + n0 + tid;
#pragma unroll
        for (int i = 0; i < kFwdRows; ++i) {
          if (i >= mr) break;
          const __nv_bfloat16* trow = tmp + i * tw;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i] = fmaf(wk[e], __bfloat162float(trow[off[e]]), acc[i]);
          if (!kTransOut && last) {
            dst[(int64_t)i * m] = acc[i];
            acc[i] = 0.f;
          }
        }
        if (kTransOut && last) {
          // the band's outputs of this column are one row of the
          // transposed output: 16 consecutive floats
          float* row =
              out + (((int64_t)smp * c + cur.ch) * m + n0 + tid) * m + m0;
          if (mr == kFwdRows && (m & 3) == 0) {
#pragma unroll
            for (int i = 0; i < kFwdRows; i += 4)
              *reinterpret_cast<float4*>(row + i) =
                  make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
          } else {
#pragma unroll
            for (int i = 0; i < kFwdRows; ++i)
              if (i < mr) row[i] = acc[i];
          }
#pragma unroll
          for (int i = 0; i < kFwdRows; ++i) acc[i] = 0.f;
        }
      }
    }
    __syncthreads();
  }
}

constexpr int kTile = 32;      // frame pixels a block side (rows, columns)
constexpr int kChunk = 32;     // m (n) values a chunk
constexpr int kBoxM = 16;      // m values a TMA box of g
// n values a TMA box of g: a chunk's kChunk from a start rounded down to
// 4 (TMA boxes start on 16 bytes)
constexpr int kBoxN = kChunk + 4;
constexpr int kBufs = 3;       // chunks staged: this one and two ahead
constexpr int kGroup = 3;      // channels a pass over the samples
constexpr int kBwdThreads = 256;   // the warps that sum
constexpr int kBwdBlock = kBwdThreads + 32;   // + the producer warp

// bar.sync on named barrier 1 among the kBwdThreads summing threads
__device__ __forceinline__ void sum_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kBwdThreads) : "memory");
}

// The pre-pass's table, one row of int2 (lowest, highest) per sample, in
// three segments each of an even length (TMA reads the last two from
// 16-byte boundaries): the bands, [0, nby) the m with a weighted tap in
// each band of kTile rows and [nby, nby + nbx) the n for each band of
// kTile columns; from rows_at(h, w) the m for each frame row; from
// cols_at(h, w) the n for each frame column.  (INT_MAX, -1) where none.
__host__ __device__ inline int even(int k) { return (k + 1) / 2 * 2; }
__host__ __device__ inline int rows_at(int h, int w) {
  return even((h + kTile - 1) / kTile + (w + kTile - 1) / kTile);
}
__host__ __device__ inline int cols_at(int h, int w) {
  return rows_at(h, w) + even(h);
}
__host__ __device__ inline int table_width(int h, int w) {
  return cols_at(h, w) + even(w);
}

// blockIdx.x = s, blockIdx.y = 0 for rows (yidx), 1 for columns (xidx).
__global__ void cutout_ranges_kernel(const int* __restrict__ yidx,
                                     const float* __restrict__ yw,
                                     const int* __restrict__ xidx,
                                     const float* __restrict__ xw,
                                     int2* __restrict__ table, int m, int h,
                                     int w) {
  extern __shared__ int lohi[];
  const int smp = blockIdx.x, cols = blockIdx.y;
  const int nby = (h + kTile - 1) / kTile, nbx = (w + kTile - 1) / kTile;
  const int nb = cols ? nbx : nby, np = cols ? w : h;
  const int* idx = (cols ? xidx : yidx) + (int64_t)smp * m * 4;
  const float* wts = (cols ? xw : yw) + (int64_t)smp * m * 4;
  int* lo = lohi;              // [nb] bands, then [np] pixels
  int* hi = lohi + nb + np;
  for (int b = threadIdx.x; b < nb + np; b += blockDim.x) {
    lo[b] = 0x7fffffff;
    hi[b] = -1;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < m * 4; t += blockDim.x) {
    if (wts[t] == 0.f) continue;
    const int p = idx[t];
    atomicMin(&lo[p / kTile], t / 4);
    atomicMax(&hi[p / kTile], t / 4);
    atomicMin(&lo[nb + p], t / 4);
    atomicMax(&hi[nb + p], t / 4);
  }
  __syncthreads();
  int2* row = table + (int64_t)smp * table_width(h, w);
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    row[(cols ? nby : 0) + b] = make_int2(lo[b], hi[b]);
  int2* pix = row + (cols ? cols_at(h, w) : rows_at(h, w));
  for (int b = threadIdx.x; b < np; b += blockDim.x)
    pix[b] = make_int2(lo[nb + b], hi[nb + b]);
}

// A sample that reaches the tile, with its ranges of m and n there.
struct Active {
  int s, m0, m1, n0, n1;
};

// One piece of the walk: active sample a, m from m0 (mr of them), n from
// n0 (nr); a = count when the walk is over.
struct Chunk {
  int a, m0, mr, n0, nr;
};

__device__ __forceinline__ Chunk first_chunk(const Active* act, int a,
                                             int count) {
  if (a >= count) return {count, 0, 0, 0, 0};
  const Active& r = act[a];
  return {a, r.m0, min(kChunk, r.m1 + 1 - r.m0), r.n0,
          min(kChunk, r.n1 + 1 - r.n0)};
}

// The chunk after `cur`: the next n chunk, else the next m chunk, else the
// next active sample's first.  Every thread computes the same walk.
__device__ __forceinline__ Chunk next_chunk(Chunk cur, const Active* act,
                                            int count) {
  if (cur.a >= count) return cur;
  const Active& r = act[cur.a];
  const int n0 = cur.n0 + cur.nr, m0 = cur.m0 + cur.mr;
  if (n0 <= r.n1)
    return {cur.a, cur.m0, cur.mr, n0, min(kChunk, r.n1 + 1 - n0)};
  if (m0 <= r.m1)
    return {cur.a, m0, min(kChunk, r.m1 + 1 - m0), r.n0,
            min(kChunk, r.n1 + 1 - r.n0)};
  return first_chunk(act, cur.a + 1, count);
}

// A chunk's staged inputs, each brought by TMA: g for kGroup channels in
// boxes of kBoxM m (box q / kBoxM holds [channel][q % kBoxM][n + the
// chunk's n0 % 4]), the taps of its m and n, and the pixel ranges of the
// rows and columns of a tile kT pixels a side.
template <int kT>
struct Staged {
  float g[2][kGroup][kBoxM][kBoxN];
  int yi[kChunk][4], xi[kChunk][4];
  float yw[kChunk][4], xw[kChunk][4];
  int2 ry[kT], rx[kT];
};

// The tensor maps the main kernel reads its inputs through: g, the taps
// (yidx, yw, xidx, xw) and the range table.
struct Maps {
  const CUtensorMap *g, *yi, *yw, *xi, *xw, *table;
};

// Thread 0 asks TMA for chunk k's inputs into st, completing on bar.
// kTransG reads g transposed (g[s,c,n,m] for the kernel's m and n): box
// i then holds [channel][n % kBoxM][m + the chunk's m0 % 4] of the n in
// [n0 + kBoxM i, +kBoxM).
template <int kT, bool kTransG>
__device__ __forceinline__ void stage(Staged<kT>& st, uint64_t* bar, Chunk k,
                                      int smp, const Maps& maps, int c,
                                      int c0, int m, int h, int w, int x0,
                                      int y0) {
  const int bm = ((kTransG ? k.nr : k.mr) + kBoxM - 1) / kBoxM;
  mbar_expect_tx(bar, bm * (int)sizeof(st.g[0]) + 4 * kChunk * 16 +
                          2 * kT * 8);
  for (int i = 0; i < bm; ++i) {
    if (kTransG)
      tma_load_3d(st.g[i], maps.g, bar, k.m0 & ~3, k.n0 + kBoxM * i,
                  smp * c + c0);
    else
      tma_load_3d(st.g[i], maps.g, bar, k.n0 & ~3, k.m0 + kBoxM * i,
                  smp * c + c0);
  }
  tma_load_2d(st.yi, maps.yi, bar, 0, smp * m + k.m0);
  tma_load_2d(st.yw, maps.yw, bar, 0, smp * m + k.m0);
  tma_load_2d(st.xi, maps.xi, bar, 0, smp * m + k.n0);
  tma_load_2d(st.xw, maps.xw, bar, 0, smp * m + k.n0);
  tma_load_2d(st.ry, maps.table, bar, 2 * (rows_at(h, w) + y0), smp);
  tma_load_2d(st.rx, maps.table, bar, 2 * (cols_at(h, w) + x0), smp);
}

// The i-th of n positions counted from the middle outwards: the middle,
// one after it, one before it, ... (a permutation of 0 .. n - 1).
__device__ __forceinline__ int middle_out(int i, int n) {
  const int mid = (n - 1) / 2;
  return (i & 1) ? mid + (i + 1) / 2 : mid - i / 2;
}

// The range of a tile of kT pixels, b-th along an axis of nb bands of
// kTile: the union of its bands' ranges in the table row `row`.
template <int kT>
__device__ __forceinline__ int2 tile_range(const int2* row, int b, int nb) {
  int2 r = make_int2(0x7fffffff, -1);
#pragma unroll
  for (int j = 0; j < kT / kTile; ++j) {
    const int at = b * (kT / kTile) + j;
    if (at >= nb) break;
    const int2 o = row[at];
    r = make_int2(min(r.x, o.x), max(r.y, o.y));
  }
  return r;
}

// The part of range r inside [0, len) of a chunk starting at at.
__device__ __forceinline__ int2 clip(int2 r, int at, int len) {
  return make_int2(max(r.x, at) - at, min(r.y, at + len - 1) - at);
}

// Block b takes piece b % split (the samples [piece * nsmp / split,
// (piece + 1) * nsmp / split)) of tile b / split, the tiles counted from
// the middle of the frame outwards, where the crops pile up, so that the
// heaviest start first.  It writes d_img of that piece for the kT x kT
// pixels of the tile, all channels, into part[piece].  Each chunk of the
// walk is one iteration of the summing warps between their barriers; the
// producer warp stages the chunks by TMA up to kBufs ahead, off their
// path.  Summing warp w owns rows kR w .. kR w + kR - 1 of the tile (kR =
// kT / 8), lane l the columns l + 32 j, j < kT / 32.  Tiles of 64 (the
// contraction's) take a quarter of the walks of tiles of 32 where crops
// are much larger than a tile, as at 4K, each of a chunk.
// kRound computes the dense contraction's gradient instead (contract_bwd):
// the weights and g rounded to bf16, T summed over all the n of an m chunk
// (its n chunks in order) and rounded to bf16 once, and the m pass run
// after the chunk's last n chunk.  kTransG reads g transposed (stage).
template <int kT, bool kRound, bool kTransG>
__global__ void __launch_bounds__(kBwdBlock)
cutout_bwd_kernel(const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap yimap,
                  const __grid_constant__ CUtensorMap ywmap,
                  const __grid_constant__ CUtensorMap ximap,
                  const __grid_constant__ CUtensorMap xwmap,
                  const __grid_constant__ CUtensorMap tmap,
                  const int2* __restrict__ table, float* __restrict__ part,
                  int c, int h, int w, int nsmp, int m, int split,
                  int tout) {
  constexpr int kR = kT / 8, kC = kT / 32;   // rows a warp, columns a lane
  const Maps maps = {&gmap, &yimap, &ywmap, &ximap, &xwmap, &tmap};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kBufs], empty[kBufs];
  Staged<kT>* buf = reinterpret_cast<Staged<kT>*>(smem_align<128>(smem_raw));
  float* wx = reinterpret_cast<float*>(buf + kBufs);       // [kChunk][kT]
  float* wy = wx + kChunk * kT;                            // [kChunk][kT]
  float* tt = wy + kT * kChunk;                    // [kGroup][kChunk][kT]
  int* counts = reinterpret_cast<int*>(tt + kGroup * kChunk * kT);
  Active* act = reinterpret_cast<Active*>(counts + kBwdBlock / 32);
  const int nby = (h + kT - 1) / kT, nbx = (w + kT - 1) / kT;
  // the table's bands of kTile
  const int nty = (h + kTile - 1) / kTile, ntx = (w + kTile - 1) / kTile;
  const int tw = table_width(h, w);
  const int tile = blockIdx.x / split, piece = blockIdx.x % split;
  const int by = middle_out(tile / nbx, nby);
  const int bx = middle_out(tile % nbx, nbx);
  const int s0 = (int)((int64_t)piece * nsmp / split);
  const int s_end = (int)((int64_t)(piece + 1) * nsmp / split);
  float* dst = part + (int64_t)piece * c * h * w;
  const int x0 = bx * kT, y0 = by * kT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < kChunk * kT; i += kBwdBlock) wx[i] = wy[i] = 0.f;
  __syncthreads();
  // the samples of the piece that reach the tile, in order: a ballot per
  // warp, the warps' counts added up in order
  int count = 0;
  for (int base = s0; base < s_end; base += kBwdThreads) {
    const int smp = base + tid;
    int2 ry = make_int2(1, 0), rx = make_int2(1, 0);
    if (tid < kBwdThreads && smp < s_end) {
      const int2* row = table + (int64_t)smp * tw;
      ry = tile_range<kT>(row, by, nty);
      rx = tile_range<kT>(row + nty, bx, ntx);
    }
    const bool hit = ry.x <= ry.y && rx.x <= rx.y;
    const unsigned vote = __ballot_sync(0xffffffffu, hit);
    if (lane == 0 && tid < kBwdThreads) counts[warp] = __popc(vote);
    __syncthreads();
    int at = count;
    for (int v = 0; v < warp; ++v) at += counts[v];
    if (hit)
      act[at + __popc(vote & ((1u << lane) - 1))] = {smp, ry.x, ry.y, rx.x,
                                                     rx.y};
    for (int v = 0; v < kBwdThreads / 32; ++v) count += counts[v];
    __syncthreads();
  }
  if (tid >= kBwdThreads) {
    // the producer: chunk seq into buf[seq % kBufs] once the summing warps
    // are done with the chunk kBufs before it
    if (lane != 0) return;
    int seq = 0;
    for (int c0 = 0; c0 < c; c0 += kGroup)
      for (Chunk k = first_chunk(act, 0, count); k.a < count;
           k = next_chunk(k, act, count), ++seq) {
        const int b = seq % kBufs;
        mbar_wait(&empty[b], ((seq / kBufs) & 1) ^ 1);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        stage<kT, kTransG>(buf[b], &full[b], k, act[k.a].s, maps, c, c0, m,
                           h, w, x0, y0);
      }
    return;
  }
  // the weights this thread wrote last (an index into wx or wy, or -1):
  // it clears them before it writes the next chunk's
  int mine[4] = {-1, -1, -1, -1};
  int seq = 0;   // chunks walked so far: chunk seq sits in buf[seq % kBufs]
  for (int c0 = 0; c0 < c; c0 += kGroup) {
    const int cg = min(kGroup, c - c0);
    float acc[kGroup][kR][kC] = {};
    for (Chunk cur = first_chunk(act, 0, count); cur.a < count;
         cur = next_chunk(cur, act, count), ++seq) {
      const int b = seq % kBufs;
      mbar_wait(&full[b], (seq / kBufs) & 1);
      // this chunk's weights on the tile, each built by one thread (warp
      // 0: Wx [n][x] by lane n; warp 1: Wy [m][y] by lane m): a pixel's
      // weight is the sum of the thread's taps on it, in tap order
      const Staged<kT>& st = buf[b];
      if (warp < 2) {
        const bool cols = warp == 0;
        float* wt = cols ? wx : wy;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (mine[t] >= 0) wt[mine[t]] = 0.f;
          mine[t] = -1;
        }
        if (lane < (cols ? cur.nr : cur.mr)) {
          const int4 i4 = *reinterpret_cast<const int4*>(cols ? st.xi[lane]
                                                             : st.yi[lane]);
          const float4 w4 = *reinterpret_cast<const float4*>(
              cols ? st.xw[lane] : st.yw[lane]);
          const int at = cols ? x0 : y0;
          const int pix[4] = {i4.x - at, i4.y - at, i4.z - at, i4.w - at};
          const float v[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (pix[t] < 0 || pix[t] >= kT) continue;
            bool first = true;
            float sum = 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (pix[u] != pix[t] || v[u] == 0.f) continue;
              first = first && u >= t;
              sum += v[u];
            }
            if (kRound) sum = bf16r(sum);
            if (!first || sum == 0.f) continue;
            mine[t] = lane * kT + pix[t];
            wt[mine[t]] = sum;
          }
        }
      }
      sum_sync();
      // along n: T[cc][q][x] = sum_n Wx[n][x] g[cc][q][n], over the n of
      // the chunk that reach column x (kRound: carried on from the m
      // chunk's earlier n chunks, rounded after its last)
      const Active& ar = act[cur.a];
      const bool carry = kRound && cur.n0 != ar.n0;
      const bool fin = !kRound || cur.n0 + cur.nr > ar.n1;
      {
        int2 r[kC];
#pragma unroll
        for (int j = 0; j < kC; ++j)
          r[j] = x0 + lane + 32 * j < w
                     ? clip(st.rx[lane + 32 * j], cur.n0, cur.nr)
                     : make_int2(0, -1);
        // a warp takes the rows q and q + 8 of each 16 together, so that
        // they share the weight loads
        const int off = kTransG ? cur.m0 & 3 : cur.n0 & 3;
        for (int q = warp; q < cur.mr; q += 2 * (kBwdThreads / 32)) {
          const int q2 = q + kBwdThreads / 32 < cur.mr ? q + kBwdThreads / 32
                                                      : q;
          float t[2][kC][kGroup] = {};
          if (carry) {
#pragma unroll
            for (int j = 0; j < kC; ++j)
#pragma unroll
              for (int cc = 0; cc < kGroup; ++cc) {
                t[0][j][cc] = tt[(cc * kChunk + q) * kT + lane + 32 * j];
                t[1][j][cc] = tt[(cc * kChunk + q2) * kT + lane + 32 * j];
              }
          }
#pragma unroll
          for (int j = 0; j < kC; ++j) {
            const int x = lane + 32 * j;
            if (kTransG) {
              for (int n = r[j].x; n <= r[j].y; ++n) {
                const float v = wx[n * kT + x];
                const float* gn = st.g[n / kBoxM][0][n % kBoxM] + off;
#pragma unroll
                for (int cc = 0; cc < kGroup; ++cc) {
                  t[0][j][cc] += v * bf16r(gn[cc * kBoxM * kBoxN + q]);
                  t[1][j][cc] += v * bf16r(gn[cc * kBoxM * kBoxN + q2]);
                }
              }
            } else {
              const float* g0 = st.g[q / kBoxM][0][q % kBoxM] + off;
              const float* g1 = st.g[q2 / kBoxM][0][q2 % kBoxM] + off;
              for (int n = r[j].x; n <= r[j].y; ++n) {
                const float v = wx[n * kT + x];
#pragma unroll
                for (int cc = 0; cc < kGroup; ++cc) {
                  if (kRound) {
                    t[0][j][cc] += v * bf16r(g0[cc * kBoxM * kBoxN + n]);
                    t[1][j][cc] += v * bf16r(g1[cc * kBoxM * kBoxN + n]);
                  } else {
                    t[0][j][cc] += v * g0[cc * kBoxM * kBoxN + n];
                    t[1][j][cc] += v * g1[cc * kBoxM * kBoxN + n];
                  }
                }
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kC; ++j)
#pragma unroll
            for (int cc = 0; cc < kGroup; ++cc) {
              if (kRound && fin) {
                t[0][j][cc] = bf16r(t[0][j][cc]);
                t[1][j][cc] = bf16r(t[1][j][cc]);
              }
              tt[(cc * kChunk + q) * kT + lane + 32 * j] = t[0][j][cc];
              // q2 = q when q + 8 is past the chunk: the same value again
              tt[(cc * kChunk + q2) * kT + lane + 32 * j] = t[1][j][cc];
            }
        }
      }
      sum_sync();
      // along m: acc[cc][i][j] += sum_q Wy[q][kR warp + i] T[cc][q][x],
      // over the m of the chunk that reach the warp's rows
      if (fin) {
        int q0 = 0x7fffffff, q1 = -1;
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          if (y0 + kR * warp + i >= h) continue;
          const int2 r = clip(st.ry[kR * warp + i], cur.m0, cur.mr);
          q0 = min(q0, r.x);
          q1 = max(q1, r.y);
        }
        for (int q = q0; q <= q1; ++q) {
          float t[kC][kGroup];
#pragma unroll
          for (int j = 0; j < kC; ++j)
#pragma unroll
            for (int cc = 0; cc < kGroup; ++cc)
              t[j][cc] = tt[(cc * kChunk + q) * kT + lane + 32 * j];
          float v[kR];
#pragma unroll
          for (int i = 0; i < kR; i += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(
                wy + q * kT + kR * warp + i);
            v[i] = v4.x;
            v[i + 1] = v4.y;
            v[i + 2] = v4.z;
            v[i + 3] = v4.w;
          }
#pragma unroll
          for (int i = 0; i < kR; ++i)
#pragma unroll
            for (int j = 0; j < kC; ++j)
#pragma unroll
              for (int cc = 0; cc < kGroup; ++cc)
                acc[cc][i][j] += v[i] * t[j][cc];
        }
      }
      sum_sync();
      if (tid == 0) mbar_arrive(&empty[b]);   // buf[b] is free again
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int y = y0 + kR * warp + i;
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int x = x0 + lane + 32 * j;
        if (y >= h || x >= w) continue;
#pragma unroll
        for (int cc = 0; cc < kGroup; ++cc) {
          if (cc >= cg) continue;
          // tout: d_img of the transposed frame, [c, w, h]
          if (tout)
            dst[((int64_t)(c0 + cc) * w + x) * h + y] = acc[cc][i][j];
          else
            dst[((int64_t)(c0 + cc) * h + y) * w + x] = acc[cc][i][j];
        }
      }
    }
  }
}

// d_img = part[0] + part[1] + ... + part[split - 1], in that order.
__global__ void cutout_sum_kernel(const float* __restrict__ part,
                                  float* __restrict__ dimg, int64_t size,
                                  int split) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < size;
       i += (int64_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int p = 1; p < split; ++p) v += part[p * size + i];
    dimg[i] = v;
  }
}

// dimg [c,w,h] = the transpose of part[0] + ... + part[split - 1] [c,h,w],
// the pieces added in that order; through a 32 x 32 tile in shared memory
// (blocks of 32 x 8 threads).
__global__ void transpose_sum_kernel(const float* __restrict__ part,
                                     float* __restrict__ dimg, int h, int w,
                                     int split) {
  __shared__ float tile[32][33];
  const int ch = blockIdx.z, y0 = blockIdx.y * 32, x0 = blockIdx.x * 32;
  const int64_t size = (int64_t)gridDim.z * h * w;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int y = y0 + i, x = x0 + threadIdx.x;
    if (y < h && x < w) {
      const int64_t at = ((int64_t)ch * h + y) * w + x;
      float v = part[at];
      for (int p = 1; p < split; ++p) v += part[p * size + at];
      tile[i][threadIdx.x] = v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int x = x0 + i, y = y0 + threadIdx.x;
    if (y < h && x < w)
      dimg[((int64_t)ch * w + x) * h + y] = tile[threadIdx.x][i];
  }
}

// shared memory of cutout_bwd_kernel<kT, ...> for a piece of `samples`
// samples
template <int kT>
int bwd_smem(int samples) {
  return (int)(128 + kBufs * sizeof(Staged<kT>) +
               (2 * kChunk * kT + kGroup * kChunk * kT) * sizeof(float) +
               kBwdBlock / 32 * sizeof(int) + samples * sizeof(Active));
}

// A tensor map over `rank` dimensions of 4-byte elements (dims and box
// innermost first, byte strides of the outer dimensions), no swizzle;
// parts of a box past the tensor read as zero.
bool map_4b(CUtensorMap* map, const void* base, bool is_float, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             is_float ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_INT32,
             rank, const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The separable forward on img16 (bf16 [c,h,w]) into out.
template <bool kTransOut>
int launch_fwd(const void* img16, const void* yidx, const void* yw,
               const void* xidx, const void* xw, void* out, int c, int h,
               int w, int s, int m, cudaStream_t st) {
  // the output columns in chunks of at most kFwdCols, a multiple of 4
  const int ncols = (m + kFwdCols - 1) / kFwdCols;
  const int nb = ((m + ncols - 1) / ncols + 3) / 4 * 4;
  // room for the whole span of a crop where the frame allows it: the
  // span starts on a multiple of 8 at most 7 columns left of the crop
  const int tw = min(kFwdSpan, (w + 7 + 7) / 8 * 8);
  const int smem = fwd_smem(nb, tw);
  cudaError_t err = cudaFuncSetAttribute(
      cutout_fwd_kernel<kTransOut>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nbands = (m + kFwdRows - 1) / kFwdRows;
  cutout_fwd_kernel<kTransOut><<<dim3(nbands * ncols, s), kFwdThreads, smem,
                                 st>>>(
      (const __nv_bfloat16*)img16, (const int*)yidx, (const float*)yw,
      (const int*)xidx, (const float*)xw, (float*)out, c, h, w, m, nb, tw,
      ncols, w % 8 == 0);
  return (int)cudaGetLastError();
}

// The range pre-pass and the tile gather of an h x w frame into pieces
// (split of them, [split, c, h, w]; tout: one piece, written transposed,
// [c, w, h]).
template <int kT, bool kRound, bool kTransG>
int launch_bwd(const void* g, const void* yidx, const void* yw,
               const void* xidx, const void* xw, void* table, float* pieces,
               int c, int h, int w, int s, int m, int ldg, int split,
               bool tout, cudaStream_t st) {
  const int nty = (h + kTile - 1) / kTile, ntx = (w + kTile - 1) / kTile;
  const int nby = (h + kT - 1) / kT, nbx = (w + kT - 1) / kT;
  const int tw = table_width(h, w);
  const int np = (nty > ntx ? nty : ntx) + (h > w ? h : w);
  cutout_ranges_kernel<<<dim3(s, 2), 256, 2 * np * sizeof(int), st>>>(
      (const int*)yidx, (const float*)yw, (const int*)xidx,
      (const float*)xw, (int2*)table, m, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap maps[6];
  const cuuint64_t gd[3] = {(cuuint64_t)ldg, (cuuint64_t)m,
                            (cuuint64_t)s * c};
  const cuuint64_t gs[2] = {(cuuint64_t)ldg * 4, (cuuint64_t)ldg * m * 4};
  const cuuint32_t gb[3] = {kBoxN, kBoxM, kGroup};
  const cuuint64_t td[2] = {4, (cuuint64_t)s * m};
  const cuuint64_t ts[1] = {16};
  const cuuint32_t tb[2] = {4, kChunk};
  const cuuint64_t rd[2] = {(cuuint64_t)2 * tw, (cuuint64_t)s};
  const cuuint64_t rs[1] = {(cuuint64_t)tw * 8};
  const cuuint32_t rb[2] = {2 * kT, 1};
  if (!map_4b(&maps[0], g, true, 3, gd, gs, gb) ||
      !map_4b(&maps[1], yidx, false, 2, td, ts, tb) ||
      !map_4b(&maps[2], yw, true, 2, td, ts, tb) ||
      !map_4b(&maps[3], xidx, false, 2, td, ts, tb) ||
      !map_4b(&maps[4], xw, true, 2, td, ts, tb) ||
      !map_4b(&maps[5], table, false, 2, rd, rs, rb))
    return ERR_TENSOR_MAP;
  const int smem = bwd_smem<kT>((s + split - 1) / split);
  err = cudaFuncSetAttribute(cutout_bwd_kernel<kT, kRound, kTransG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  cutout_bwd_kernel<kT, kRound, kTransG><<<nby * nbx * split, kBwdBlock,
                                           smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      (const int2*)table, pieces, c, h, w, s, m, split, tout);
  return (int)cudaGetLastError();
}

// The pieces into dimg [c,h,w]: in place for one piece, else summed in
// order (cutout_sum_kernel).
int sum_pieces(float* pieces, void* dimg, int c, int h, int w, int split,
               cudaStream_t st) {
  if (split == 1) return cudaSuccess;
  const int64_t size = (int64_t)c * h * w;
  cutout_sum_kernel<<<264, 512, 0, st>>>(pieces, (float*)dimg, size, split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// img [c,h,w] f32; img16 [c,h,w] bf16 scratch; yidx/xidx [s,m,4] int32
// and yw/xw [s,m,4] f32 (taps clamped into the frame, weight 0 where one
// was outside), 16-byte aligned; out [s,c,m,m] f32.  The bf16 copy of
// the frame, then the separable forward.
int cutout_fwd(const void* img, void* img16, const void* yidx,
               const void* yw, const void* xidx, const void* xw, void* out,
               int c, int h, int w, int s, int m, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = (int64_t)c * h * w;
  frame_bf16_kernel<<<(unsigned)((n + 8 * 256 - 1) / (8 * 256)), 256, 0,
                      st>>>((const float*)img, (__nv_bfloat16*)img16, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fwd<false>(img16, yidx, yw, xidx, xw, out, c, h, w, s, m,
                           st);
}

// The dense contraction's forward (ops/sampler.py:_Contract at bf16),
// arguments as cutout_fwd's and its pass order wf (ops/cutout.py:w_first).
// H first is cutout_fwd's function.  W first is that function of the
// transposed frame with the two axes' taps swapped, its output transposed:
// the bf16 copy is made transposed, and the forward writes out[s,c,m,n]
// by rows of n.
int contract_fwd(const void* img, void* img16, const void* yidx,
                 const void* yw, const void* xidx, const void* xw, void* out,
                 int c, int h, int w, int s, int m, int wf, void* stream) {
  if (!wf)
    return cutout_fwd(img, img16, yidx, yw, xidx, xw, out, c, h, w, s, m,
                      stream);
  const cudaStream_t st = (cudaStream_t)stream;
  frame_bf16_t_kernel<<<dim3((w + 31) / 32, (h + 31) / 32, c), dim3(32, 8),
                        0, st>>>((const float*)img, (__nv_bfloat16*)img16, h,
                                 w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_fwd<true>(img16, xidx, xw, yidx, yw, out, c, w, h, s, m, st);
}

// The width, in int2, of a sample's row of cutout_bwd's range table for
// an h x w frame (the wrapper sizes the table by it).
int cutout_table_width(int h, int w) { return table_width(h, w); }

// g [s,c,m,ldg] f32 (ldg = m rounded up to 4, 16-byte aligned); table
// [s, cutout_table_width(h, w)] int2, scratch; part [split, c, h, w] f32,
// scratch (unused for split = 1); dimg [c,h,w] f32, every element
// written.  The range pre-pass, the tile gather (into dimg for split = 1,
// else into part), and for split > 1 the sum of the pieces.
int cutout_bwd(const void* g, const void* yidx, const void* yw,
               const void* xidx, const void* xw, void* table, void* part,
               void* dimg, int c, int h, int w, int s, int m, int ldg,
               int split, void* stream) {
  if (split < 1 || split > s || ldg % 4 || ldg < m)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // piece 0 goes straight into dimg's memory when there is one piece;
  // else the pieces fill part, piece p at p * c * h * w
  float* pieces = split == 1 ? (float*)dimg : (float*)part;
  const int err = launch_bwd<kTile, false, false>(g, yidx, yw, xidx, xw, table,
                                           pieces, c, h, w, s, m, ldg, split,
                                           false, st);
  if (err != cudaSuccess) return err;
  return sum_pieces(pieces, dimg, c, h, w, split, st);
}

// The dense contraction's image gradient (ops/sampler.py:_contract_bwd at
// bf16), arguments as cutout_bwd's and the pass order wf, the table sized
// for the kernel's frame (w x h W first).  H first: the tile gather with
// g, the weights and the n pass rounded to bf16 (kRound).  W first: the
// same on the transposed frame with the axes' taps swapped and g read
// transposed; one piece is written into dimg transposed, more (in part,
// [split, c, w, h]) are summed in order and transposed into dimg.  `tile`, 32 or 64, is
// the side of the gather's tiles (the result does not depend on it).
int contract_bwd(const void* g, const void* yidx, const void* yw,
                 const void* xidx, const void* xw, void* table, void* part,
                 void* dimg, int c, int h, int w, int s, int m, int ldg,
                 int split, int tile, int wf, void* stream) {
  if (split < 1 || split > s || ldg % 4 || ldg < m ||
      (tile != 32 && tile != 64))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  float* pieces = split == 1 ? (float*)dimg : (float*)part;
  if (!wf) {
    const int err =
        tile == 64
            ? launch_bwd<64, true, false>(g, yidx, yw, xidx, xw, table,
                                          pieces, c, h, w, s, m, ldg, split,
                                          false, st)
            : launch_bwd<32, true, false>(g, yidx, yw, xidx, xw, table,
                                          pieces, c, h, w, s, m, ldg, split,
                                          false, st);
    if (err != cudaSuccess) return err;
    return sum_pieces(pieces, dimg, c, h, w, split, st);
  }
  // one piece goes straight into dimg, transposed; else the pieces fill
  // part in the kernel's frame and are summed and transposed after
  const int err =
      tile == 64
          ? launch_bwd<64, true, true>(g, xidx, xw, yidx, yw, table, pieces,
                                       c, w, h, s, m, ldg, split, split == 1,
                                       st)
          : launch_bwd<32, true, true>(g, xidx, xw, yidx, yw, table, pieces,
                                       c, w, h, s, m, ldg, split, split == 1,
                                       st);
  if (err != cudaSuccess || split == 1) return err;
  transpose_sum_kernel<<<dim3((h + 31) / 32, (w + 31) / 32, c), dim3(32, 8),
                         0, st>>>((const float*)part, (float*)dimg, w, h,
                                  split);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return error_string(code); }

}  // extern "C"
