// K17: block-ELL sparse x dense product Y = A.X.
//
// A is stored block-ELL: data [nbr, W, bm, bn] (row-major blocks), bcols
// [nbr, W] int32 block-column ids; padded blocks point at block-column 0 with
// zero data, so they add nothing and need no mask.  X is [n, K] and Y
// [nbr.bm, K], both row-major:
//
//   Y[i.bm + r, c] = sum_w sum_j data[i, w, r, j] . X[bcols[i, w].bn + j, c]
//
// Blocks are float32, or bf16 (`TA`); X and Y are float32.  A bf16 block
// element is widened to float32 where it is read from shared memory, and the
// same FMAs run in the same order, so the bf16 instance gives the float32
// instance's bits on the widened blocks.  (bf16 blocks with bf16 X run on
// the tensor cores: csrc/bsr_bf16.cu.)
//
// Replaces both TPU kernels of gflownet_spai_tpu/ops/bsr.py:
// `_spmm_bell_pallas` (a grid step per (block row, K tile, w) that streams one
// [bn, bk] X block into VMEM through the scalar-prefetched bcols) and
// `_spmm_bell_pallas_resident` (the whole [n, bk] X column tile held in VMEM,
// the W blocks reduced inside the kernel).  Their split is a VMEM matter; a
// GPU block reads X through L2 either way, so one kernel serves both.
//
// A block owns one block row i and one tile of kCols columns of X.  The row's
// W blocks are cut into chunks of kJ block columns ([bm, kJ] of A and the
// [kJ, kCols] rows of X that bcols selects).  The design follows what bounds
// the product on an H100:
//
// - Padding.  A row with fewer real blocks than W is padded with zero
//   blocks, and a real block may be zero in some chunks.  The block first
//   reads all of its row's A words in one pass (several independent 16-byte
//   loads per thread) and flags every chunk that holds a nonzero element
//   (csrc/bsr_common.cuh, scan_chunks); then
//   it stages and multiplies only the flagged chunks, in order.  This is
//   exact for any block-ELL (padded slots, explicit zero blocks, unsorted or
//   repeated block columns) and keeps no state between calls.  Skipped
//   chunks add no products: where X holds inf or NaN under an all-zero
//   chunk, the kernel gives a finite sum and the plain version NaN.
// - Shared-memory traffic.  Each thread keeps a register tile of kRm rows
//   (all of bm up to 16) x 4 adjacent columns: an X float4 read from shared
//   memory serves kRm rows, and A is read as broadcast words of 4 elements.
//   Float32 FMAs only (no TF32, no tensor cores: the JAX package computes
//   float32 blocks at precision="highest").
// - Warps per chunk.  kS warps split every chunk's kJ block columns, so a
//   chunk's FMAs are spread over kS warps; at the end the splits' sums are
//   added in split order (deterministic; each split sums its terms in
//   (w, j) order).
// - Latency.  The flagged chunks go through a cp.async ring of kStages
//   slots, the next two chunks' A and X arriving while this one's FMAs run
//   (one barrier per chunk); each listed chunk carries its first X row, so
//   staging waits on no global load.  A row's chunks are still a serial
//   chain: at a few percent of dense blocks the rows with the most real
//   blocks end the kernel.
// - L2.  A column tile of kCols = 128 is the grid's outer index: the blocks
//   that run at once share one [n, 128] slice of X (33.5 MB at n = 65,536,
//   inside the 50 MB L2), and A is read once per column tile.
//
// What bounds it: at a few percent of dense blocks, the X rows fetched from
// L2 (kJ.kCols words per flagged chunk) and the A words, padded ones
// included, read once per column tile; chip_smoke.py prints the byte and
// operation bounds of each run.

#include <cuda_runtime.h>

#include "bsr_common.cuh"

namespace {

using namespace bsr;
using bf16 = __nv_bfloat16;

// Register tile rows per thread (kRm) and warps splitting each chunk's kJ
// block columns (kS), by bm; a block has bm / kRm x kS warps.
template <int BM> struct Tile;
template <> struct Tile<8> { static constexpr int kRm = 8, kS = 4; };
template <> struct Tile<16> { static constexpr int kRm = 16, kS = 4; };
template <> struct Tile<32> { static constexpr int kRm = 16, kS = 4; };
template <> struct Tile<64> { static constexpr int kRm = 16, kS = 2; };
template <> struct Tile<128> { static constexpr int kRm = 16, kS = 2; };

template <int BM>
__host__ __device__ constexpr int threads() {
  return 32 * (BM / Tile<BM>::kRm) * Tile<BM>::kS;
}

// A row pitch in shared memory, in elements: a chunk row and 16 bytes
template <typename TA>
__host__ __device__ constexpr int a_stride() {
  return kJ + 16 / static_cast<int>(sizeof(TA));
}

// the ring's slots of A and X (reused for the split sums), then the flags,
// the list of nonzero chunks and their first X rows
template <typename TA, int BM>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * (BM * a_stride<TA>() * static_cast<int>(sizeof(TA)) + kJ * kCols * 4) >
                 BM * kCols * 4
             ? kStages * (BM * a_stride<TA>() * static_cast<int>(sizeof(TA)) + kJ * kCols * 4)
             : BM * kCols * 4;
}

template <typename TA, int BM>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<TA, BM>() + 3 * kMaxChunks * 4;
}

// four adjacent A elements of shared memory as float32 (bf16 widened exactly)
__device__ __forceinline__ float4 a4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 a4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}

// Block (i, t): block row i, columns t.kCols + 0..kCols-1.  Warp w: row
// group g = w % (bm / kRm) (rows g.kRm + 0..kRm-1) and split s = w / (bm /
// kRm) (block columns s.kJ/kS + 0..kJ/kS-1 of every chunk); lane l: columns
// 4l + 0..3.  VEC: K % 4 == 0 and X, Y 16-byte aligned (X staged and Y
// stored as float4); else element by element.  TA: float or bf16 blocks.
template <typename TA, int BM, bool VEC>
__global__ void __launch_bounds__(threads<BM>())
bell_spmm_kernel(const TA* __restrict__ data, const int* __restrict__ bcols, int W,
                 int bn, const float* __restrict__ x, int K, float* __restrict__ y) {
  constexpr int kRm = Tile<BM>::kRm, kS = Tile<BM>::kS, kG = BM / kRm;
  constexpr int kT = threads<BM>();
  constexpr int kJS = kJ / kS;        // block columns per split
  constexpr int kE = 16 / static_cast<int>(sizeof(TA));   // A elements per 16-byte word
  constexpr int kWR = kJ / kE;        // 16-byte words per chunk row
  constexpr int kF = BM * kWR;        // 16-byte words of A per chunk
  constexpr int kAStride = a_stride<TA>();
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  TA* a_s = reinterpret_cast<TA*>(smem);              // [kStages][BM][kAStride]
  float* x_s = reinterpret_cast<float*>(smem + kStages * BM * kAStride * sizeof(TA));
                                                      // [kStages][kJ][kCols]
  int* flag_s = reinterpret_cast<int*>(smem + ring_bytes<TA, BM>());   // [kMaxChunks]
  int* list_s = flag_s + kMaxChunks;                  // [kMaxChunks]
  int* xrow_s = list_s + kMaxChunks;                  // [kMaxChunks]
  __shared__ int count_s;

  const long long i = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = warp % kG, s = warp / kG;
  const int cj = bn / kJ, n_chunks = W * cj;
  const TA* arow = data + i * W * static_cast<long long>(BM) * bn;
  const int* brow = bcols + i * W;

  float4 acc[kRm];
#pragma unroll
  for (int q = 0; q < kRm; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  // stage listed chunk k into ring slot b (cp.async, not committed)
  auto stage = [&](int k, int b) {
    TA* as = a_s + b * BM * kAStride;
    const int c = list_s[k];
    for (int f = tid; f < kF; f += kT)
      cp_async16_l1(as + (static_cast<unsigned>(f) / kWR) * kAStride
                        + (static_cast<unsigned>(f) % kWR) * kE,
                    a_word<TA, BM>(arow, bn, cj, c, f));
    const long long xrow0 = xrow_s[k];
    float* xs = x_s + b * kJ * kCols;
    if constexpr (VEC) {
      for (int e = tid; e < kJ * kCols / 4; e += kT) {
        const int jj = e / (kCols / 4), col = c0 + (e % (kCols / 4)) * 4;
        const float* src = col < K ? x + (xrow0 + jj) * K + col : x;
        cp_async16(xs + e * 4, src, col < K ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kJ * kCols; e += kT) {
        const int jj = e / kCols, col = c0 + e % kCols;
        const float* src = col < K ? x + (xrow0 + jj) * K + col : x;
        cp_async4(xs + e, src, col < K ? 4 : 0);
      }
    }
  };
  // this warp's rows x its block columns of ring slot b
  auto compute = [&](int b) {
    const TA* as = a_s + b * BM * kAStride + g * kRm * kAStride + s * kJS;
    const float* xs = x_s + b * kJ * kCols + s * kJS * kCols + lane * 4;
#pragma unroll
    for (int j4 = 0; j4 < kJS; j4 += 4) {
      float4 xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xv[u] = *reinterpret_cast<const float4*>(xs + (j4 + u) * kCols);
#pragma unroll
      for (int q = 0; q < kRm; ++q) {
        const float4 a = a4(as + q * kAStride + j4);
        fma4(acc[q], a.x, xv[0]);
        fma4(acc[q], a.y, xv[1]);
        fma4(acc[q], a.z, xv[2]);
        fma4(acc[q], a.w, xv[3]);
      }
    }
  };

  // scan passes of kMaxChunks; the nonzero chunks of each go through a
  // cp.async ring, kStages - 1 staged ahead of the one being multiplied
  for (int s0 = 0; s0 < n_chunks; s0 += kMaxChunks) {
    const int L = scan_chunks<TA, BM, kT>(arow, brow, bn, s0, min(kMaxChunks, n_chunks - s0),
                                          flag_s, list_s, xrow_s, &count_s);
#pragma unroll
    for (int u = 0; u < kStages - 1; ++u) {
      if (u < L) stage(u, u);
      cp_async_commit();
    }
    for (int t = 0; t < L; ++t) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // chunk t is in; every thread is done with chunk t - 1
      if (t + kStages - 1 < L) stage(t + kStages - 1, (t + kStages - 1) % kStages);
      cp_async_commit();
      compute(t % kStages);
    }
    cp_async_wait<0>();
    __syncthreads();     // the ring and the list are free again
  }

  // add the splits' sums in split order (through the ring's memory), and
  // split 0 writes Y
  float* red = reinterpret_cast<float*>(smem);        // [BM][kCols]
  for (int t = 1; t < kS; ++t) {
    if (s == t) {
#pragma unroll
      for (int q = 0; q < kRm; ++q)
        *reinterpret_cast<float4*>(red + (g * kRm + q) * kCols + lane * 4) = acc[q];
    }
    __syncthreads();
    if (s == 0) {
#pragma unroll
      for (int q = 0; q < kRm; ++q) {
        const float4 p =
            *reinterpret_cast<const float4*>(red + (g * kRm + q) * kCols + lane * 4);
        acc[q].x += p.x;
        acc[q].y += p.y;
        acc[q].z += p.z;
        acc[q].w += p.w;
      }
    }
    __syncthreads();
  }
  if (s != 0) return;
  const int c = c0 + lane * 4;
#pragma unroll
  for (int q = 0; q < kRm; ++q) {
    float* yr = y + (i * BM + g * kRm + q) * K;
    if constexpr (VEC) {
      if (c < K) *reinterpret_cast<float4*>(yr + c) = acc[q];
    } else {
      if (c < K) yr[c] = acc[q].x;
      if (c + 1 < K) yr[c + 1] = acc[q].y;
      if (c + 2 < K) yr[c + 2] = acc[q].z;
      if (c + 3 < K) yr[c + 3] = acc[q].w;
    }
  }
}

template <typename TA, int BM, bool VEC>
int launch(const void* data, const int* bcols, int nbr, int W, int bn, const float* x,
           int K, float* y, cudaStream_t st) {
  constexpr int smem = smem_bytes<TA, BM>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bell_spmm_kernel<TA, BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(nbr), static_cast<unsigned>((K + kCols - 1) / kCols));
  bell_spmm_kernel<TA, BM, VEC><<<grid, threads<BM>(), smem, st>>>(
      static_cast<const TA*>(data), bcols, W, bn, x, K, y);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, bool VEC>
int dispatch(const void* d, const int* b, int nbr, int W, int bm, int bn, const float* x,
             int K, float* y, cudaStream_t st) {
  switch (bm) {
    case 8: return launch<TA, 8, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 16: return launch<TA, 16, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 32: return launch<TA, 32, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 64: return launch<TA, 64, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 128: return launch<TA, 128, VEC>(d, b, nbr, W, bn, x, K, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename TA>
int dispatch(const void* d, const int* b, int nbr, int W, int bm, int bn, const float* x,
             int K, float* y, int vec, cudaStream_t st) {
  return vec ? dispatch<TA, true>(d, b, nbr, W, bm, bn, x, K, y, st)
             : dispatch<TA, false>(d, b, nbr, W, bm, bn, x, K, y, st);
}

}  // namespace

// K17 on CUDA cores.  data [nbr, W, bm, bn] (16-byte aligned; float32 for
// types 0, bf16 for types 1), bcols [nbr, W], x [nbc.bn, K] and y [nbr.bm, K]
// float32; bm in {8, 16, 32, 64, 128}, bn a multiple of 32, at most 65,535
// column tiles of kCols.  vec: K % 4 == 0 and x, y 16-byte aligned.
extern "C" int bell_spmm(const void* data, const void* bcols, int nbr, int W, int bm,
                         int bn, const void* x, int K, void* y, int vec, int types,
                         void* stream) {
  if (nbr < 0 || W < 1 || bn < kJ || bn % kJ || K < 1 || (K + kCols - 1) / kCols > 65535
      || reinterpret_cast<unsigned long long>(data) % 16 || types < 0 || types > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbr == 0) return static_cast<int>(cudaGetLastError());
  const auto* b = static_cast<const int*>(bcols);
  const auto* xx = static_cast<const float*>(x);
  auto* yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  return types == 0 ? dispatch<float>(data, b, nbr, W, bm, bn, xx, K, yy, vec, st)
                    : dispatch<bf16>(data, b, nbr, W, bm, bn, xx, K, yy, vec, st);
}
