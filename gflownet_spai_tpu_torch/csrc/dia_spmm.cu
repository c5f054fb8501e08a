// DIA sparse x dense products (SpMM) of the multi-RHS solvers:
//
//   K15  dia_spmm    Y = A.X          X, Y [n, K] row-major
//   K16  dia_spmm_t  Yt = (A.X)^T     Xt [K, h + n_pad + h] -> Yt [K, n_pad]
//
// Storage is row-scaled: data[s, i] = A[i, i + offs[s]], [ndiags, n_pad]
// row-major; each output is sum_s data[s, i].X[i + offs[s]], summed in
// offset order from zero.
//
// K15 replaces gflownet_spai_tpu/ops/dia.py `_spmm_dia_pallas`, which
// double-buffers [tr + 2h, kb] windows of X into VMEM because a TPU core
// cannot address HBM from its vector unit.  Here a warp owns one row and its
// lanes walk the K columns, so X's rows are read as coalesced 128-byte
// segments; a block of kRows rows first stages its data[s, i] words in shared
// memory, so each diagonal word is read from device memory once per row.
// The rows i + off of X that neighbouring warps read again come from L2.
//
// K16 replaces `_spmm_dia_t_pallas` (window DMAs of [kb, tr + 2h] so each
// right-hand side is one contiguous burst).  Here a thread owns one row of
// kRhs right-hand sides and keeps their sums in registers: each diagonal word
// is loaded once per block and serves all kRhs of them, and neighbouring
// threads read neighbouring words of each Xt row.  Consecutive blocks cover
// the same rows for the next kRhs right-hand sides, so their diagonal words
// come from L2.
//
// Both take any K (the TPU's K >= 128, K % 128 == 0 rule is a VMEM
// condition).  What bounds them on an H100: bytes of X and Y (2.ndiags flops
// per 8 bytes moved per element at ndiags = 5).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;         // K15: rows per block, one warp each
constexpr int kMaxDiags = 1024;  // K15: staged diagonal words per block
constexpr int kThreads = 256;    // K16
constexpr int kRhs = 16;         // K16: right-hand sides per thread

__global__ void __launch_bounds__(32 * kRows)
dia_spmm_kernel(const float* __restrict__ data, long long n_pad,
                const int* __restrict__ offs, int ndiags,
                const float* __restrict__ x, long long n, int K,
                float* __restrict__ y) {
  __shared__ float dv[kMaxDiags * kRows];
  __shared__ int off_s[kMaxDiags];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < ndiags * kRows; e += 32 * kRows) {
    const long long i = row0 + e % kRows;
    dv[e] = i < n ? data[(e / kRows) * n_pad + i] : 0.f;
  }
  for (int s = tid; s < ndiags; s += 32 * kRows) off_s[s] = offs[s];
  __syncthreads();
  const long long i = row0 + threadIdx.y;
  if (i >= n) return;
  for (int col = threadIdx.x; col < K; col += 32) {
    float acc = 0.f;
    for (int s = 0; s < ndiags; ++s) {
      const long long j = i + off_s[s];
      const float xv = (j >= 0 && j < n) ? x[j * K + col] : 0.f;
      acc += dv[s * kRows + threadIdx.y] * xv;
    }
    y[i * K + col] = acc;
  }
}

// Block b covers kThreads rows and right-hand sides [kRhs.(b % rhs_blocks),
// +kRhs).  xt points at logical column 0 of row 0; x_r[j] = xt[r.ldx + j]
// is read for -h <= j < n_pad + h.
__global__ void __launch_bounds__(kThreads)
dia_spmm_t_kernel(const float* __restrict__ data, long long n_pad,
                  const int* __restrict__ offs, int ndiags,
                  const float* __restrict__ xt, long long ldx, long long h,
                  int n_rhs, unsigned rhs_blocks, float* __restrict__ yt) {
  const long long i = (blockIdx.x / rhs_blocks) * static_cast<long long>(kThreads)
                      + threadIdx.x;
  if (i >= n_pad) return;
  const int r0 = static_cast<int>(blockIdx.x % rhs_blocks) * kRhs;
  const int nr = min(kRhs, n_rhs - r0);
  float acc[kRhs];
#pragma unroll
  for (int r = 0; r < kRhs; ++r) acc[r] = 0.f;
  for (int s = 0; s < ndiags; ++s) {
    const long long j = i + offs[s];
    if (j < -h || j >= n_pad + h) continue;   // adds 0.f: the sums are unchanged
    const float dw = data[s * n_pad + i];
#pragma unroll
    for (int r = 0; r < kRhs; ++r)
      if (r < nr) acc[r] += dw * xt[(r0 + r) * ldx + j];
  }
#pragma unroll
  for (int r = 0; r < kRhs; ++r)
    if (r < nr) yt[(r0 + r) * n_pad + i] = acc[r];
}

}  // namespace

// K15.  x, y: [n, K] row-major; ndiags <= kMaxDiags.
extern "C" int dia_spmm(const void* data, long long n_pad, const void* offs,
                        int ndiags, const void* x, long long n, int K, void* y,
                        void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    dia_spmm_kernel<<<static_cast<unsigned>((n + kRows - 1) / kRows), dim3(32, kRows), 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(data), n_pad, static_cast<const int*>(offs), ndiags,
        static_cast<const float*>(x), n, K, static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}

// K16.  xt points at column h of a [K][ldx] buffer, ldx = h + n_pad + h;
// yt is [K][n_pad].
extern "C" int dia_spmm_t(const void* data, long long n_pad, const void* offs,
                          int ndiags, const void* xt, long long ldx, int K, void* yt,
                          void* stream) {
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rhs_blocks = static_cast<unsigned>((K + kRhs - 1) / kRhs);
  const unsigned row_blocks = static_cast<unsigned>((n_pad + kThreads - 1) / kThreads);
  dia_spmm_t_kernel<<<row_blocks * rhs_blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), n_pad, static_cast<const int*>(offs), ndiags,
      static_cast<const float*>(xt), ldx, (ldx - n_pad) / 2, K, rhs_blocks,
      static_cast<float*>(yt));
  return static_cast<int>(cudaGetLastError());
}
