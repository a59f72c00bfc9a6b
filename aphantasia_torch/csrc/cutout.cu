// Cutout crop-and-resize for Hopper (sm_90a): forward gather, backward
// owner-computes gather.
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

// The wrapper (ops/cutout.py) clamps every tap into the frame and zeroes
// the weight of a tap that was outside it, so no read leaves the frame and
// such taps count nowhere.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

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
// tile's rows and columns.
struct Staged {
  float g[2][kGroup][kBoxM][kBoxN];
  int yi[kChunk][4], xi[kChunk][4];
  float yw[kChunk][4], xw[kChunk][4];
  int2 ry[kTile], rx[kTile];
};

// The tensor maps the main kernel reads its inputs through: g, the taps
// (yidx, yw, xidx, xw) and the range table.
struct Maps {
  const CUtensorMap *g, *yi, *yw, *xi, *xw, *table;
};

// Thread 0 asks TMA for chunk k's inputs into st, completing on bar.
__device__ __forceinline__ void stage(Staged& st, uint64_t* bar, Chunk k,
                                      int smp, const Maps& maps, int c,
                                      int c0, int m, int h, int w, int x0,
                                      int y0) {
  const int bm = (k.mr + kBoxM - 1) / kBoxM;
  mbar_expect_tx(bar, bm * (int)sizeof(st.g[0]) + 4 * kChunk * 16 +
                          2 * kTile * 8);
  for (int i = 0; i < bm; ++i)
    tma_load_3d(st.g[i], maps.g, bar, k.n0 & ~3, k.m0 + kBoxM * i,
                smp * c + c0);
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

// The part of range r inside [0, len) of a chunk starting at at.
__device__ __forceinline__ int2 clip(int2 r, int at, int len) {
  return make_int2(max(r.x, at) - at, min(r.y, at + len - 1) - at);
}

// Block b takes piece b % split (the samples [piece * nsmp / split,
// (piece + 1) * nsmp / split)) of tile b / split, the tiles counted from
// the middle of the frame outwards, where the crops pile up, so that the
// heaviest start first.  It writes d_img of that piece for the kTile x
// kTile pixels of the tile, all channels, into part[piece].  Each chunk
// of the walk is one iteration of the summing warps between their
// barriers; the producer warp stages the chunks by TMA up to kBufs ahead,
// off their path.  Summing warp w owns rows 4w .. 4w + 3 of the tile,
// lane l column l.
__global__ void __launch_bounds__(kBwdBlock)
cutout_bwd_kernel(const __grid_constant__ CUtensorMap gmap,
                  const __grid_constant__ CUtensorMap yimap,
                  const __grid_constant__ CUtensorMap ywmap,
                  const __grid_constant__ CUtensorMap ximap,
                  const __grid_constant__ CUtensorMap xwmap,
                  const __grid_constant__ CUtensorMap tmap,
                  const int2* __restrict__ table, float* __restrict__ part,
                  int c, int h, int w, int nsmp, int m, int split) {
  const Maps maps = {&gmap, &yimap, &ywmap, &ximap, &xwmap, &tmap};
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kBufs], empty[kBufs];
  Staged* buf = reinterpret_cast<Staged*>(smem_align<128>(smem_raw));
  float* wx = reinterpret_cast<float*>(buf + kBufs);       // [kChunk][kTile]
  float* wy = wx + kChunk * kTile;                         // [kChunk][kTile]
  float* tt = wy + kTile * kChunk;                 // [kGroup][kChunk][kTile]
  int* counts = reinterpret_cast<int*>(tt + kGroup * kChunk * kTile);
  Active* act = reinterpret_cast<Active*>(counts + kBwdBlock / 32);
  const int nby = (h + kTile - 1) / kTile, nbx = (w + kTile - 1) / kTile;
  const int tw = table_width(h, w);
  const int tile = blockIdx.x / split, piece = blockIdx.x % split;
  const int by = middle_out(tile / nbx, nby);
  const int bx = middle_out(tile % nbx, nbx);
  const int s0 = (int)((int64_t)piece * nsmp / split);
  const int s_end = (int)((int64_t)(piece + 1) * nsmp / split);
  float* dst = part + (int64_t)piece * c * h * w;
  const int x0 = bx * kTile, y0 = by * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    mbar_fence_init();
  }
  for (int i = tid; i < kChunk * kTile; i += kBwdBlock) wx[i] = wy[i] = 0.f;
  __syncthreads();
  // the samples of the piece that reach the tile, in order: a ballot per
  // warp, the warps' counts added up in order
  int count = 0;
  for (int base = s0; base < s_end; base += kBwdThreads) {
    const int smp = base + tid;
    int2 ry = make_int2(1, 0), rx = make_int2(1, 0);
    if (tid < kBwdThreads && smp < s_end) {
      ry = table[(int64_t)smp * tw + by];
      rx = table[(int64_t)smp * tw + nby + bx];
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
        stage(buf[b], &full[b], k, act[k.a].s, maps, c, c0, m, h, w, x0,
              y0);
      }
    return;
  }
  // the weights this thread wrote last (an index into wx or wy, or -1):
  // it clears them before it writes the next chunk's
  int mine[4] = {-1, -1, -1, -1};
  int seq = 0;   // chunks walked so far: chunk seq sits in buf[seq % kBufs]
  for (int c0 = 0; c0 < c; c0 += kGroup) {
    const int cg = min(kGroup, c - c0);
    float acc[kGroup][4] = {};
    for (Chunk cur = first_chunk(act, 0, count); cur.a < count;
         cur = next_chunk(cur, act, count), ++seq) {
      const int b = seq % kBufs;
      mbar_wait(&full[b], (seq / kBufs) & 1);
      // this chunk's weights on the tile, each built by one thread (warp
      // 0: Wx [n][x] by lane n; warp 1: Wy [m][y] by lane m): a pixel's
      // weight is the sum of the thread's taps on it, in tap order
      const Staged& st = buf[b];
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
            if (pix[t] < 0 || pix[t] >= kTile) continue;
            bool first = true;
            float sum = 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (pix[u] != pix[t] || v[u] == 0.f) continue;
              first = first && u >= t;
              sum += v[u];
            }
            if (!first || sum == 0.f) continue;
            mine[t] = lane * kTile + pix[t];
            wt[mine[t]] = sum;
          }
        }
      }
      sum_sync();
      // along n: T[cc][q][x] = sum_n Wx[n][x] g[cc][q][n], over the n of
      // the chunk that reach column x
      {
        const int2 r = x0 + lane < w ? clip(st.rx[lane], cur.n0, cur.nr)
                                     : make_int2(0, -1);
        // a warp takes the rows q and q + 8 of each 16 together, so that
        // they share the weight loads
        const int off = cur.n0 & 3;
        for (int q = warp; q < cur.mr; q += 2 * (kBwdThreads / 32)) {
          const int q2 = q + kBwdThreads / 32 < cur.mr ? q + kBwdThreads / 32
                                                      : q;
          float t[2][kGroup] = {};
          const float* g0 = st.g[q / kBoxM][0][q % kBoxM] + off;
          const float* g1 = st.g[q2 / kBoxM][0][q2 % kBoxM] + off;
          for (int n = r.x; n <= r.y; ++n) {
            const float v = wx[n * kTile + lane];
#pragma unroll
            for (int cc = 0; cc < kGroup; ++cc) {
              t[0][cc] += v * g0[cc * kBoxM * kBoxN + n];
              t[1][cc] += v * g1[cc * kBoxM * kBoxN + n];
            }
          }
#pragma unroll
          for (int cc = 0; cc < kGroup; ++cc) {
            tt[(cc * kChunk + q) * kTile + lane] = t[0][cc];
            // q2 = q when q + 8 is past the chunk: the same value again
            tt[(cc * kChunk + q2) * kTile + lane] = t[1][cc];
          }
        }
      }
      sum_sync();
      // along m: acc[cc][i] += sum_q Wy[q][4 warp + i] T[cc][q][lane],
      // over the m of the chunk that reach the warp's rows
      {
        int q0 = 0x7fffffff, q1 = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (y0 + 4 * warp + i >= h) continue;
          const int2 r = clip(st.ry[4 * warp + i], cur.m0, cur.mr);
          q0 = min(q0, r.x);
          q1 = max(q1, r.y);
        }
        for (int q = q0; q <= q1; ++q) {
          float t[kGroup];
#pragma unroll
          for (int cc = 0; cc < kGroup; ++cc)
            t[cc] = tt[(cc * kChunk + q) * kTile + lane];
          const float4 v4 =
              *reinterpret_cast<const float4*>(wy + q * kTile + 4 * warp);
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int cc = 0; cc < kGroup; ++cc) acc[cc][i] += v[i] * t[cc];
        }
      }
      sum_sync();
      if (tid == 0) mbar_arrive(&empty[b]);   // buf[b] is free again
    }
    const int x = x0 + lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int y = y0 + 4 * warp + i;
      if (y >= h || x >= w) continue;
#pragma unroll
      for (int cc = 0; cc < kGroup; ++cc)
        if (cc < cg) dst[((int64_t)(c0 + cc) * h + y) * w + x] = acc[cc][i];
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

// shared memory of cutout_bwd_kernel for a piece of `samples` samples
int bwd_smem(int samples) {
  return (int)(128 + kBufs * sizeof(Staged) +
               (2 * kChunk * kTile + kGroup * kChunk * kTile) * sizeof(float) +
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
  const int nby = (h + kTile - 1) / kTile, nbx = (w + kTile - 1) / kTile;
  const int tw = table_width(h, w);
  const cudaStream_t st = (cudaStream_t)stream;
  const int np = (nby > nbx ? nby : nbx) + (h > w ? h : w);
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
  const cuuint32_t rb[2] = {2 * kTile, 1};
  if (!map_4b(&maps[0], g, true, 3, gd, gs, gb) ||
      !map_4b(&maps[1], yidx, false, 2, td, ts, tb) ||
      !map_4b(&maps[2], yw, true, 2, td, ts, tb) ||
      !map_4b(&maps[3], xidx, false, 2, td, ts, tb) ||
      !map_4b(&maps[4], xw, true, 2, td, ts, tb) ||
      !map_4b(&maps[5], table, false, 2, rd, rs, rb))
    return ERR_TENSOR_MAP;
  const int smem = bwd_smem((s + split - 1) / split);
  err = cudaFuncSetAttribute(cutout_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  // piece 0 goes straight into dimg's memory when there is one piece;
  // else the pieces fill part, piece p at p * c * h * w
  float* pieces = split == 1 ? (float*)dimg : (float*)part;
  cutout_bwd_kernel<<<nby * nbx * split, kBwdBlock, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      (const int2*)table, pieces, c, h, w, s, m, split);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return (int)err;
  const int64_t size = (int64_t)c * h * w;
  cutout_sum_kernel<<<264, 512, 0, st>>>(pieces, (float*)dimg, size, split);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) { return error_string(code); }

}  // extern "C"
