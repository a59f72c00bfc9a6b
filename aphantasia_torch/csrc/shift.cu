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
// folded in; aphantasia_torch/ops/sep_warp.py:_dft_mats_packed).  The
// backward of the shift is this kernel on the cotangent at -shift with the
// two windows exchanged (the op is linear and S(shift)^T = S(-shift)).
//
// What bounds it on the H100: at the elastic pipeline's [134400, 224]
// float32 pass the two products are 2 x 2 x R x 224 x 226 = 27.2 GFLOP
// (226 = 2nf packed spectrum columns).  On the CUDA cores (67 TFLOP/s
// float32) that is 0.41 ms; x and out are 240
// MB, 0.072 ms at 3.35 TB/s.  So the products run on the tensor cores in
// 3xTF32: each float32 operand v splits into hi = tf32(v) and lo =
// tf32(v - hi), both rounded to nearest (cvt.rna), and a product is
// lo.hi + hi.lo + hi.hi (the small terms first; lo.lo is dropped),
// summed in float32: float32's accuracy at three tf32 products, 81.6
// GFLOP, 0.165 ms at 495 TFLOP/s (84 GFLOP issued on the 232 columns the
// spectrum is padded to).  One tf32 product alone errs by ~2^-11 of each
// term, too coarse for the 1e-4 the kernel is held to.
//
// The design.  A CTA takes 128 rows at a time: two consumer warpgroups
// of 64 rows each and a producer warpgroup, one thread of which keeps a
// ring of kStages stages filled by TMA; the producer gives up registers
// (setmaxnreg) so that a consumer thread may hold 232.  A stage of the
// analysis holds the 128 x 8 chunk of x and the K chunk (8 values) of
// ana's hi and lo for every spectrum column; a stage of the synthesis
// holds a K chunk of syn's hi and lo for 112 output columns.  The matrix
// chunks are what the SMs read most (832 KB for every 128 rows, ~6 TB/s
// from L2 at the tensor cores' pace), so CTAs run in clusters of two on
// neighbouring row tiles: each producer brings one half (hi or lo) and
// multicasts it into both CTAs, and L2 serves each chunk once for 256
// rows.  The grid is persistent, so the producers run on into the next
// tiles (and ask L2 for their x) while the consumers finish these.
// Nothing else lives in shared memory:
//   - wgmma.m64nNAk8 (tf32) takes A from registers.  A thread reads its x
//     fragment from the stage (two 8-byte loads), splits it and issues the
//     three products into the F accumulator (NA / 2 = 116 registers for
//     NA = 232 spectrum columns, 116 frequencies).
//   - A spectrum wider than one product (2nf > 232, n > 230) runs in
//     chunks of 116 frequencies, one launch each: the launch of the chunk
//     that starts at frequency k0 takes that chunk's matrices, rotates by
//     k0 + its own column, and adds its synthesis to what the earlier
//     launches stored (a second instantiation, kLater, so that the first
//     chunk's code holds no read of out and no more registers).  n <= 230
//     (every CLIP input up to 224 px) is one launch.
//   - The spectrum is interleaved (re_0, im_0, re_1, im_1, ...: the
//     wrapper permutes ana's columns and syn's rows so), and the
//     accumulator gives a thread two adjacent columns of a row, so each
//     thread holds both parts of its frequencies and rotates them in
//     registers, slice by slice during the first synthesis pass, while
//     the previous slice's products run: phi = pi * (k * (-2 shift / n)),
//     sincospif (an exact reduction of the ~19 rad phi reaches at +-6 px,
//     and a fraction of sincosf's instructions).
//   - The rotated spectrum G stays in those registers and is the A
//     operand of the synthesis: the accumulator holds columns 2q, 2q + 1
//     of a k8 slice where the A fragment wants q, q + 4, so the wrapper
//     permutes the K rows of both matrices within each slice (position
//     p < 4 holds row 2p, position p >= 4 row 2(p - 4) + 1); x's columns
//     are read in the same order.  The synthesis runs in passes of 112
//     output columns (56 accumulator registers beside G's 116).
// The wrapper hands over both matrices cut to the windows, interleaved,
// permuted, transposed to K-major (32-bit wgmma has no transpose) and
// split, one pair for each spectrum chunk: ana^T [2 NA, kp] (hi rows,
// then lo rows; kp = n_in rounded up to 8) and syn^T [2 s_rows, NA]
// (s_rows = n_out rounded up to 112).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kRows = 128;             // rows a block: two warpgroups of 64
constexpr int kThreads = 3 * 128;      // + the producer warpgroup
constexpr int kPass = 112;             // output columns a synthesis pass
constexpr int kStages = 10;
constexpr int kXBytes = kRows * 32;    // a stage's x chunk: 128 x 8 floats

constexpr int NA = 232;                // spectrum columns a product
constexpr int kABytes = NA * 32;       // ana^T's hi (or lo) K chunk
constexpr int kSBytes = kPass * 32;    // syn^T's hi (or lo) K chunk
constexpr int kStage = (kXBytes + 2 * kABytes + 1023) / 1024 * 1024;
constexpr int kSmem = kStages * kStage + 1024;  // + alignment

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// this warp is done with stage it: its arrival on the stage's empty
// barrier in both CTAs of the cluster (both read what the two producers
// multicast into it)
__device__ __forceinline__ void release(uint64_t* empty, int it, int lane) {
  if (lane == 0) {
    mbar_arrive_cluster(&empty[it % kStages], 0);
    mbar_arrive_cluster(&empty[it % kStages], 1);
  }
}

// Rotate the spectrum's k8 slice j in place: a thread's frequency k =
// k0 + 4 j + q of its two rows by phi = pi * (k * base), base = -2 shift / n;
// sincospif reduces its argument exactly, so phi's size (~19 rad at +-6
// px) costs no accuracy.
__device__ __forceinline__ void rotate(float (&f)[NA / 2], int j, int k0,
                                       int tq, const float (&base)[2]) {
  const float k = (float)(k0 + 4 * j + tq);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sn, cs;
    sincospif(__fmul_rn(k, base[h]), &sn, &cs);
    const float re = f[4 * j + 2 * h], im = f[4 * j + 2 * h + 1];
    f[4 * j + 2 * h] = re * cs - im * sn;
    f[4 * j + 2 * h + 1] = re * sn + im * cs;
  }
}

// Persistent, in clusters of two CTAs: cluster k takes the row tiles 2j
// and 2j + 1 (one each) for j = k, k + gridDim.x / 2, ...; the producers
// run ahead into the next tiles while the consumers finish these.  Both
// CTAs of a cluster need every matrix chunk: CTA 0's producer brings the
// hi half and CTA 1's the lo half, each multicast into both, so L2 serves
// each chunk once for 256 rows; a stage is free again when the consumers
// of both CTAs are done with it.
template <bool kLater>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
frac_shift_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap smap,
                  const float* __restrict__ shift, float* __restrict__ out,
                  int rows, int n_in, int n, int k0, int n_out, int s_rows) {
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = smem_align<1024>(smem_raw);
  const int tiles = (rows + kRows - 1) / kRows;
  const int nk1 = (n_in + 7) / 8;
  const int passes = (n_out + kPass - 1) / kPass;
  const int tid = threadIdx.x;
  const int rank = (int)cluster_rank();
  // a tile loop both CTAs of the cluster run the same number of times;
  // CTA 1's last tile may lie past the rows (TMA reads it as zeros, and
  // nothing of it is stored)
  const int first = blockIdx.x / 2, step = gridDim.x / 2;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 16);  // every consumer warp of both CTAs
    }
    mbar_fence_init();
  }
  cluster_sync();
  if (tid < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    int it = 0;
    for (int pair = first; tid == 0 && 2 * pair < tiles; pair += step) {
      const int tile = 2 * pair + rank;
      for (int kt = 0; kt < nk1; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
        uint8_t* b = smem + st * kStage;
        mbar_expect_tx(&full[st], kXBytes + 2 * kABytes);
        tma_load_2d(b, &xmap, &full[st], 8 * kt, tile * kRows);
        tma_load_2d_multicast(b + kXBytes + rank * kABytes, &amap,
                              &full[st], 8 * kt, rank * NA, 3);
      }
      // the next tile's x into L2 while this one's synthesis runs
      if (tile + 2 * step < tiles)
        for (int kt = 0; kt < nk1; ++kt)
          tma_prefetch_2d(&xmap, 8 * kt, (tile + 2 * step) * kRows);
      for (int p = 0; p < passes; ++p) {
        for (int j = 0; j < NA / 8; ++j, ++it) {
          const int st = it % kStages;
          mbar_wait(&empty[st], ((it / kStages) & 1) ^ 1);
          uint8_t* b = smem + st * kStage;
          mbar_expect_tx(&full[st], 2 * kSBytes);
          tma_load_2d_multicast(b + rank * kSBytes, &smap, &full[st],
                                8 * j, rank * s_rows + p * kPass, 3);
        }
      }
    }
    // neither CTA leaves while the other may still write into it
    __syncwarp();
    cluster_sync();
    return;
  }
  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile; a
  // thread rows lr and lr + 8 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = (tid >> 7) - 1, warp = (tid >> 5) & 3, lane = tid & 31;
  const int tq = lane & 3;
  const int lr = 64 * wg + 16 * warp + (lane >> 2);
  int it = 0;
  for (int pair = first; 2 * pair < tiles; pair += step) {
    const int tile = 2 * pair + rank;
    const int row[2] = {tile * kRows + lr, tile * kRows + lr + 8};
    float base[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      base[h] = row[h] < rows ? __fdiv_rn(-2.f * shift[row[h]], (float)n)
                              : 0.f;

    // analysis: F = x . ana, x's fragment split as it is read
    float f[NA / 2];
#pragma unroll
    for (int i = 0; i < NA / 2; ++i) f[i] = 0.f;
    for (int kt = 0; kt < nk1; ++kt, ++it) {
      mbar_wait(&full[it % kStages], (it / kStages) & 1);
      const uint8_t* b = smem + (it % kStages) * kStage;
      const float* xs = reinterpret_cast<const float*>(b);
      const float2 u =
          *reinterpret_cast<const float2*>(xs + lr * 8 + 2 * tq);
      const float2 v =
          *reinterpret_cast<const float2*>(xs + (lr + 8) * 8 + 2 * tq);
      uint32_t hi[4], lo[4];
      split(u.x, hi[0], lo[0]);
      split(v.x, hi[1], lo[1]);
      split(u.y, hi[2], lo[2]);
      split(v.y, hi[3], lo[3]);
      const uint64_t dh = gmma_desc(b + kXBytes, 16, 256, 3);
      const uint64_t dl = gmma_desc(b + kXBytes + kABytes, 16, 256, 3);
      wgmma_fence();
      wgmma_tf32<NA>(f, lo, dh);
      wgmma_tf32<NA>(f, hi, dl);
      wgmma_tf32<NA>(f, hi, dh);
      wgmma_commit();
      wgmma_wait<1>();
      if (kt > 0) release(empty, it - 1, lane);
    }
    wgmma_wait<0>();
    release(empty, it - 1, lane);

    // synthesis: out = G . syn, 112 columns a pass, G split per k8 slice;
    // the first pass rotates each slice of F into G just before its
    // products, while the previous slice's run on the tensor cores
    for (int p = 0; p < passes; ++p) {
      float acc[kPass / 2];
#pragma unroll
      for (int i = 0; i < kPass / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int j = 0; j < NA / 8; ++j) {
        if (p == 0) rotate(f, j, kLater ? k0 : 0, tq, base);
        uint32_t hi[4], lo[4];
        split(f[4 * j], hi[0], lo[0]);
        split(f[4 * j + 2], hi[1], lo[1]);
        split(f[4 * j + 1], hi[2], lo[2]);
        split(f[4 * j + 3], hi[3], lo[3]);
        mbar_wait(&full[(it + j) % kStages], ((it + j) / kStages) & 1);
        const uint8_t* b = smem + ((it + j) % kStages) * kStage;
        const uint64_t dh = gmma_desc(b, 16, 256, 3);
        const uint64_t dl = gmma_desc(b + kSBytes, 16, 256, 3);
        wgmma_fence();
        wgmma_tf32<kPass>(acc, lo, dh);
        wgmma_tf32<kPass>(acc, hi, dl);
        wgmma_tf32<kPass>(acc, hi, dh);
        wgmma_commit();
        wgmma_wait<1>();
        if (j > 0) release(empty, it + j - 1, lane);
      }
      it += NA / 8;
      wgmma_wait<0>();
      release(empty, it - 1, lane);
      // a later spectrum chunk adds to what the earlier ones stored
      const bool pairs = (n_out & 1) == 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= rows) continue;
        float* o = out + (int64_t)row[h] * n_out;
#pragma unroll
        for (int j = 0; j < kPass / 8; ++j) {
          const int col = p * kPass + 8 * j + 2 * tq;
          float a = acc[4 * j + 2 * h], c = acc[4 * j + 2 * h + 1];
          if (pairs && col + 1 < n_out) {
            float2* o2 = reinterpret_cast<float2*>(o + col);
            if constexpr (kLater) {
              const float2 was = *o2;
              a = was.x + a;
              c = was.y + c;
            }
            *o2 = make_float2(a, c);
          } else {
            if (col < n_out) o[col] = kLater ? o[col] + a : a;
            if (col + 1 < n_out) o[col + 1] = kLater ? o[col + 1] + c : c;
          }
        }
      }
    }
  }
  cluster_sync();
}

// The tf32 product alone, for the card tests: C [64, N] = A [64, k] B,
// with B^T [N, k] K-permuted within each 8 (as the wrapper permutes the
// DFT matrices) and brought in by TMA one k8 chunk at a time; one
// warpgroup, A's fragment read from device memory.
template <int N>
__global__ void __launch_bounds__(128)
tf32_probe_kernel(const __grid_constant__ CUtensorMap bmap,
                  const float* __restrict__ a, float* __restrict__ c,
                  int k) {
  __shared__ __align__(8) uint64_t bar;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint8_t* smem = smem_align<1024>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, tq = lane & 3;
  const int r = 16 * (tid >> 5) + (lane >> 2);
  if (tid == 0) {
    mbar_init(&bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  for (int kt = 0; kt < k / 8; ++kt) {
    if (tid == 0) {
      mbar_expect_tx(&bar, N * 32);
      tma_load_2d(smem, &bmap, &bar, 8 * kt, 0);
    }
    mbar_wait(&bar, kt & 1);
    const float2 u =
        *reinterpret_cast<const float2*>(a + r * k + 8 * kt + 2 * tq);
    const float2 v =
        *reinterpret_cast<const float2*>(a + (r + 8) * k + 8 * kt + 2 * tq);
    const uint32_t fr[4] = {tf32_rna(u.x), tf32_rna(v.x), tf32_rna(u.y),
                            tf32_rna(v.y)};
    wgmma_fence();
    wgmma_tf32<N>(d, fr, gmma_desc(smem, 16, 256, 3));
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // the chunk is free for the next load
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = c + (r + 8 * h) * N + 8 * j + 2 * tq;
      o[0] = d[4 * j + 2 * h];
      o[1] = d[4 * j + 2 * h + 1];
    }
}

// A tensor map over the row-major float32 matrix [rows, cols] (cols a
// multiple of 4, the base 16-byte aligned) in boxes of box_rows x 8
// columns, 32-byte swizzled or not; parts of a box past the matrix read
// as zero.
bool f32_map_2d(CUtensorMap* map, const void* base, uint64_t rows,
                uint64_t cols, uint32_t box_rows, bool swizzle) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 4};
  const cuuint32_t box[2] = {8, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(base), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kLater>
int launch(const float* x, const float* shift, const float* ana,
           const float* syn, float* out, int rows, int x_cols, int n_in,
           int n, int k0, int kp, int s_rows, int n_out, cudaStream_t stream) {
  CUtensorMap xmap, amap, smap;
  if (!f32_map_2d(&xmap, x, rows, x_cols, kRows, false) ||
      !f32_map_2d(&amap, ana, 2 * NA, kp, NA, true) ||
      !f32_map_2d(&smap, syn, 2 * s_rows, NA, kPass, true))
    return ERR_TENSOR_MAP;
  const cudaError_t err = cudaFuncSetAttribute(
      frac_shift_kernel<kLater>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return (int)err;
  // as many clusters as can be resident at once (at most one a tile pair)
  static int fit = 0;
  if (fit == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    const cudaError_t e =
        cudaOccupancyMaxActiveClusters(&fit, frac_shift_kernel<kLater>, &cfg);
    if (e != cudaSuccess || fit < 1) return e != cudaSuccess ? (int)e
                                                 : (int)cudaErrorInvalidValue;
  }
  const int pairs = (rows + 2 * kRows - 1) / (2 * kRows);
  frac_shift_kernel<kLater><<<2 * (pairs < fit ? pairs : fit), kThreads,
                              kSmem, stream>>>(xmap, amap, smap, shift, out,
                                               rows, n_in, n, k0, n_out,
                                               s_rows);
  return (int)cudaGetLastError();
}

template <int N>
int probe(const float* a, const float* bt, float* c, int k,
          cudaStream_t stream) {
  CUtensorMap bmap;
  if (!f32_map_2d(&bmap, bt, N, k, N, true)) return ERR_TENSOR_MAP;
  const int smem = N * 32 + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      tf32_probe_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  tf32_probe_kernel<N><<<1, 128, smem, stream>>>(bmap, a, c, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, x_cols] f32 (x_cols = n_in rounded up to 4, the padding zero;
// 16-byte aligned); shift [rows] f32; ana [2 NA, kp] f32 and syn
// [2 s_rows, NA] f32, the windowed DFT matrices of the spectrum chunk that
// starts at frequency k0 (a multiple of NA / 2) in the kernel's layout
// (ops/shift.py:_kernel_mats: kp = n_in rounded up to 8; s_rows = n_out
// rounded up to 112); out [rows, n_out] f32, written by the first chunk
// (k0 = 0) and added to by the later ones.  Other sizes return
// cudaErrorInvalidValue.
int frac_shift(const void* x, const void* shift, const void* ana,
               const void* syn, void* out, int rows, int x_cols, int n_in,
               int n, int k0, int kp, int s_rows, int n_out, void* stream) {
  if (x_cols % 4 || x_cols < n_in || kp % 8 || kp < n_in ||
      s_rows % kPass || s_rows < n_out || n_out < 1 || rows < 1 ||
      k0 < 0 || k0 % (NA / 2) || k0 > n / 2)
    return (int)cudaErrorInvalidValue;
  const auto* xs = (const float*)x;
  const auto* sh = (const float*)shift;
  const auto* a = (const float*)ana;
  const auto* sy = (const float*)syn;
  auto* o = (float*)out;
  auto st = (cudaStream_t)stream;
  return k0 == 0 ? launch<false>(xs, sh, a, sy, o, rows, x_cols, n_in, n, 0,
                                 kp, s_rows, n_out, st)
                 : launch<true>(xs, sh, a, sy, o, rows, x_cols, n_in, n, k0,
                                kp, s_rows, n_out, st);
}

// c [64, n] f32 = a [64, k] f32 . b, bt [n, k] = b^T permuted within each
// 8 columns as the DFT matrices are (k a multiple of 8, n = 112 or 232);
// the operands rounded to tf32, one product.
int tf32_probe(const void* a, const void* bt, void* c, int k, int n,
               void* stream) {
  const auto* as = (const float*)a;
  const auto* bs = (const float*)bt;
  auto* cs = (float*)c;
  auto st = (cudaStream_t)stream;
  if (k < 8 || k % 8) return (int)cudaErrorInvalidValue;
  switch (n) {
    case 112: return probe<112>(as, bs, cs, k, st);
    case 232: return probe<232>(as, bs, cs, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int code) { return error_string(code); }

}  // extern "C"
