// K17: block-ELL sparse x dense product Y = A.X.
//
// A is stored block-ELL: data [nbr, W, bm, bn] (row-major blocks), bcols
// [nbr, W] int32 block-column ids; padded blocks point at block-column 0 with
// zero data, so they add nothing and need no mask.  X is [n, K] and Y
// [nbr.bm, K], both row-major:
//
//   Y[i.bm + r, c] = sum_w sum_j data[i, w, r, j] . X[bcols[i, w].bn + j, c]
//
// Replaces both TPU kernels of gflownet_spai_tpu/ops/bsr.py:
// `_spmm_bell_pallas` (a grid step per (block row, K tile, w) that streams one
// [bn, bk] X block into VMEM through the scalar-prefetched bcols) and
// `_spmm_bell_pallas_resident` (the whole [n, bk] X column tile held in VMEM,
// the W blocks reduced inside the kernel).  Their split is a VMEM matter; a
// GPU block reads X through L2 either way, so one kernel serves both.
//
// A block owns one block row i and one tile of kCols columns of X.  It walks
// the W blocks of the row in chunks of kJ block columns: each chunk stages
// the [bm, kJ] slice of A and the [kJ, kCols] rows of X that bcols selects in
// shared memory, then every thread adds bm / 4 outputs of one column in
// registers with float32 FMAs (no TF32, no tensor cores: the JAX package
// computes float32 blocks at precision="highest").  The column tiles of one
// block row are neighbouring blocks, so A's block is read from device memory
// about once and from L2 for the other tiles.
//
// What bounds it on an H100: operations or bytes, by the density.  A stored
// block costs 2.bm.bn.K flops against bm.bn words of A, and X and Y move once
// at best; chip_smoke.py computes which bound holds for each run.  Padded
// blocks (rows with fewer than W blocks) cost their FMAs too.  This first
// kernel issues one shared-memory load per FMA and runs well below the
// float32 rate.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 64;                  // X columns per block
constexpr int kGroups = kThreads / kCols;  // row groups: thread t owns column t % kCols
constexpr int kJ = 32;                     // block columns staged per chunk

template <int BM>
__global__ void __launch_bounds__(kThreads)
bell_spmm_kernel(const float* __restrict__ data, const int* __restrict__ bcols,
                 int W, int bn, const float* __restrict__ x, int K,
                 int col_tiles, float* __restrict__ y) {
  constexpr int kRowsPerThread = BM / kGroups;
  __shared__ float a_s[BM][kJ];
  __shared__ float x_s[kJ][kCols];
  const long long i = blockIdx.x / col_tiles;
  const int c0 = static_cast<int>(blockIdx.x % col_tiles) * kCols;
  const int tid = threadIdx.x;
  const int col = tid % kCols;
  const int grp = tid / kCols;
  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.f;

  for (int w = 0; w < W; ++w) {
    const float* blk = data + (i * W + w) * static_cast<long long>(BM) * bn;
    const long long xrow0 = static_cast<long long>(bcols[i * W + w]) * bn;
    for (int j0 = 0; j0 < bn; j0 += kJ) {
      for (int e = tid; e < BM * kJ; e += kThreads)
        a_s[e / kJ][e % kJ] = blk[(e / kJ) * static_cast<long long>(bn) + j0 + e % kJ];
      for (int e = tid; e < kJ * kCols; e += kThreads) {
        const int jj = e / kCols, c = c0 + e % kCols;
        x_s[jj][e % kCols] = c < K ? x[(xrow0 + j0 + jj) * K + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float xv = x_s[jj][col];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          acc[q] = fmaf(a_s[grp + kGroups * q][jj], xv, acc[q]);
      }
      __syncthreads();
    }
  }
  const int c = c0 + col;
  if (c >= K) return;
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q)
    y[(i * BM + grp + kGroups * q) * K + c] = acc[q];
}

template <int BM>
void launch(const float* data, const int* bcols, int nbr, int W, int bn,
            const float* x, int K, float* y, cudaStream_t st) {
  const int col_tiles = (K + kCols - 1) / kCols;
  bell_spmm_kernel<BM><<<static_cast<unsigned>(static_cast<long long>(nbr) * col_tiles),
                         kThreads, 0, st>>>(data, bcols, W, bn, x, K, col_tiles, y);
}

}  // namespace

// K17.  data [nbr, W, bm, bn], bcols [nbr, W], x [nbc.bn, K], y [nbr.bm, K];
// bm in {8, 16, 32, 64, 128}, bn a multiple of 32.
extern "C" int bell_spmm(const void* data, const void* bcols, int nbr, int W, int bm,
                         int bn, const void* x, int K, void* y, void* stream) {
  if (nbr < 0 || W < 1 || bn < kJ || bn % kJ || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbr == 0) return static_cast<int>(cudaGetLastError());
  const auto* d = static_cast<const float*>(data);
  const auto* b = static_cast<const int*>(bcols);
  const auto* xx = static_cast<const float*>(x);
  auto* yy = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8: launch<8>(d, b, nbr, W, bn, xx, K, yy, st); break;
    case 16: launch<16>(d, b, nbr, W, bn, xx, K, yy, st); break;
    case 32: launch<32>(d, b, nbr, W, bn, xx, K, yy, st); break;
    case 64: launch<64>(d, b, nbr, W, bn, xx, K, yy, st); break;
    case 128: launch<128>(d, b, nbr, W, bn, xx, K, yy, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
