// Fractional shift by DFT phase rotation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of aphantasia_tpu/ops/pallas_shift.py:
//   _run (pallas_call at :73, body _kernel :48).
//
// Computes, for every row r of x [R, n_in] (a window of a length-n signal
// that starts at in_off; the rest of the signal is zero),
//   F[r, k]   = sum_i x[r, i] * ana[in_off + i, k]          k < 2nf
//   G[r, k]   = F[r, k] rotated by phi = -2 pi k shift[r] / n (k < nf:
//               (Fr + i Fi) * (cos phi + i sin phi), nf = n/2 + 1)
//   out[r, j] = sum_k G[r, k] * syn[k, out_off + j]          j < n_out
// with ana [n, 2nf] = [cos | -sin] and syn [2nf, n] = [[cos], [-sin]] the
// packed real-DFT analysis and synthesis matrices (the irfft weights
// folded in; aphantasia_torch/ops/sep_warp.py:_dft_mats_packed), which the
// wrapper hands over already cut to the two windows.  The
// backward of the shift is this kernel on the cotangent at -shift with the
// two windows exchanged (the op is linear and S(shift)^T = S(-shift)).
//
// Like the TPU kernel, one block takes a tile of rows, keeps its spectrum
// on chip (shared memory here, VMEM there) and computes the phase itself,
// so device memory sees only x in and out out.  The two products are the
// kernel's own loops.  A block of 256 threads takes 64 rows: warp w owns
// rows 8w..8w+7 and lane l the columns 4l..4l+3 and 128+4l..128+4l+3 of a
// 256-wide chunk, so a thread keeps an 8 x 8 tile of sums.  The row
// operand (x, then the spectrum) sits in shared memory transposed,
// [column][64 rows], so a thread's 8 rows are two 16-byte reads that the
// whole warp shares (a broadcast).  The matrix operand comes through
// shared memory in tiles of 16 rows x 256 columns that the block's 8 warps
// share, so L2 serves each matrix element once a block.  Each step is 64
// FMAs for four 16-byte shared reads.  When the spectrum fits one chunk
// (n <= 254) it overlays x, which phase 1 no longer needs: 74 KB a block
// at n = 224.  The wrapper hands over both matrices cut to the windows
// and zero-padded to a multiple of 4 columns.
//
// What bounds it on the H100: at the elastic pipeline's [134400, 224]
// float32 pass the two products are 2 x 2 x R x 224 x 226 = 27 GFLOP,
// 0.41 ms at 67 TFLOP/s, while x and out are 240 MB, 0.072 ms at
// 3.35 TB/s, so it is bound by float32 arithmetic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows per block (8 per warp)
constexpr int kThreads = 256;  // 8 warps
constexpr int kCols = 256;     // columns per chunk (8 per lane)
constexpr int kTile = 16;      // matrix rows per shared tile

// Stage rows t0.. of m [nrows, ld] (ld a multiple of 4), columns c0..c0+255,
// into tile [kTile][kCols]; zeros outside.
__device__ __forceinline__ void load_tile(float* tile, const float* m,
                                          int nrows, int ld, int t0, int c0) {
  for (int q = threadIdx.x; q < kTile * kCols / 4; q += kThreads) {
    const int t = q / (kCols / 4), c = (q - t * (kCols / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + t < nrows && c0 + c < ld)
      v = __ldg(reinterpret_cast<const float4*>(m + (int64_t)(t0 + t) * ld + c0 + c));
    reinterpret_cast<float4*>(tile)[q] = v;
  }
}

// acc += rows(8, from rowsT [k][kRows] at row8) x tile(k, this lane's 8 cols)
// over the tile's rows t0..t0+count-1.
__device__ __forceinline__ void tile_product(float (&acc)[8][8],
                                             const float* rowsT,
                                             const float* tile, int t0,
                                             int count, int row8, int lane) {
  for (int t = 0; t < count; ++t) {
    const float4* r = reinterpret_cast<const float4*>(rowsT + (t0 + t) * kRows + row8);
    const float4 r0 = r[0], r1 = r[1];
    const float4 m0 = reinterpret_cast<const float4*>(tile + t * kCols)[lane];
    const float4 m1 = reinterpret_cast<const float4*>(tile + t * kCols + 128)[lane];
    const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const float mv[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(rv[u], mv[v], acc[u][v]);
  }
}

// The column of this lane's v-th sum in a chunk starting at c0.
__device__ __forceinline__ int lane_col(int c0, int lane, int v) {
  return c0 + (v < 4 ? 4 * lane + v : 128 + 4 * lane + v - 4);
}

// x [rows, n_in]; ana [n_in, lda]: the input window's rows, zero-padded to
// lda (a multiple of 4 >= 2nf); syn [2nf, lds]: the output window's
// columns, zero-padded to lds (a multiple of 4 >= n_out).
__global__ void frac_shift_kernel(const float* __restrict__ x,
                                  const float* __restrict__ shift,
                                  const float* __restrict__ ana,
                                  const float* __restrict__ syn,
                                  float* __restrict__ out, int rows, int n_in,
                                  int n, int lda, int n_out, int lds) {
  extern __shared__ float4 smem4[];
  const int nf = n / 2 + 1;
  const int nc = 2 * nf;
  const bool overlay = nc <= kCols;
  float* tile = reinterpret_cast<float*>(smem4);        // [kTile][kCols]
  float* xs = tile + kTile * kCols;                     // [n_in][kRows]
  float* fs = overlay ? xs : xs + n_in * kRows;         // [nc][kRows]
  const int r0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31;
  const int row8 = (threadIdx.x >> 5) * 8;             // this warp's rows

  // x, transposed; rows fastest so that the shared stores do not conflict
  for (int idx = threadIdx.x; idx < kRows * n_in; idx += kThreads) {
    const int i = idx / kRows, r = idx - i * kRows;
    xs[idx] = r0 + r < rows ? __ldg(x + (int64_t)(r0 + r) * n_in + i) : 0.f;
  }

  // analysis: F = x @ ana
  for (int c0 = 0; c0 < nc; c0 += kCols) {
    float acc[8][8] = {};
    for (int t0 = 0; t0 < n_in; t0 += kTile) {
      __syncthreads();                 // the tile (and x) are free to write
      load_tile(tile, ana, n_in, lda, t0, c0);
      __syncthreads();
      tile_product(acc, xs, tile, t0, min(kTile, n_in - t0), row8, lane);
    }
    if (overlay) __syncthreads();      // every warp is done reading x
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int col = lane_col(c0, lane, v);
      if (col >= nc) continue;
      float4* f = reinterpret_cast<float4*>(fs + col * kRows + row8);
      f[0] = make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
      f[1] = make_float4(acc[4][v], acc[5][v], acc[6][v], acc[7][v]);
    }
  }
  __syncthreads();

  // phase rotation, in the plain version's order: ((-2 pi * k) * shift) / n
  for (int idx = threadIdx.x; idx < kRows * nf; idx += kThreads) {
    const int k = idx / kRows, r = idx - k * kRows;
    const float sh = r0 + r < rows ? shift[r0 + r] : 0.f;
    const float phi = __fdiv_rn(__fmul_rn(__fmul_rn(-6.283185307179586f, (float)k), sh),
                                (float)n);
    float sn, cs;
    sincosf(phi, &sn, &cs);
    float* re = fs + k * kRows + r;
    float* im = fs + (nf + k) * kRows + r;
    const float fr = *re, fi = *im;
    *re = fr * cs - fi * sn;
    *im = fr * sn + fi * cs;
  }

  // synthesis: out = G @ syn
  for (int c0 = 0; c0 < n_out; c0 += kCols) {
    float acc[8][8] = {};
    for (int t0 = 0; t0 < nc; t0 += kTile) {
      __syncthreads();                 // the tile is free, the phase is done
      load_tile(tile, syn, nc, lds, t0, c0);
      __syncthreads();
      tile_product(acc, fs, tile, t0, min(kTile, nc - t0), row8, lane);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int row = r0 + row8 + u;
      if (row >= rows) break;
      float* o = out + (int64_t)row * n_out;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int col = lane_col(c0, lane, v);
        if (col < n_out) o[col] = acc[u][v];
      }
    }
  }
}

// Shared memory the kernel needs for signal length n and window n_in.
int smem_bytes(int n_in, int n) {
  const int nc = 2 * (n / 2 + 1);
  const int rows_operand = nc <= kCols ? (n_in > nc ? n_in : nc) : n_in + nc;
  return (int)((kTile * kCols + rows_operand * kRows) * sizeof(float));
}

}  // namespace

extern "C" {

// x [rows, n_in] f32; shift [rows] f32; ana [n_in, lda] f32 and syn
// [2nf, lds] f32, the windowed, zero-padded DFT matrices (lda, lds
// multiples of 4); out [rows, n_out] f32.  Sizes whose block would need
// more shared memory than a Hopper block may have (232448 bytes) return
// the attribute call's error.
int frac_shift(const void* x, const void* shift, const void* ana,
               const void* syn, void* out, int rows, int n_in, int n,
               int lda, int n_out, int lds, void* stream) {
  if (lda % 4 || lds % 4 || lda < 2 * (n / 2 + 1) || lds < n_out)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(n_in, n);
  cudaError_t err = cudaFuncSetAttribute(
      frac_shift_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kRows - 1) / kRows;
  frac_shift_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)shift, (const float*)ana,
      (const float*)syn, (float*)out, rows, n_in, n, lda, n_out, lds);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
