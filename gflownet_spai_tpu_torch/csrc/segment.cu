// K3: windowed source-row gather, vals[src] per edge slot.
//
// Replaces the TPU kernel gflownet_spai_tpu/ops/segment.py
// `_gather_win_kernel` (launched by `_gather_win_pallas`) together with the
// outlier overwrite that follows it in `_gather_rows_p`.  The TPU has no
// vector gather, so its kernel turns each tile's gather into onehot matmuls
// over two W-row windows; a GPU gathers natively, so this kernel reads the
// same window plan (blk, lsrc) and loads each row directly:
//
//   out[t*S + s, c] = vals[blk[t]*win + lsrc[t, s], c]   if 0 <= lsrc < 2*win
//                                                       and the row is < n
//                   = 0                                  otherwise
//
// then a second launch writes the outlier list over it:
//   out[out_slot[o], c] = vals[out_src[o], c]   for out_slot[o] < T*S.
//
// What bounds it on an H100: bytes (no arithmetic at all).  One thread per
// (slot, channel): neighbouring threads write neighbouring output words, so
// the stores coalesce; the rows read are clustered by the window plan, so
// the loads hit L1/L2 after the first touch of each window.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_win_kernel(const int* __restrict__ lsrc, const int* __restrict__ blk,
                  const float* __restrict__ vals, float* __restrict__ out,
                  long long total, int S, int D, int win, int n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long slot = i / D;
  const int c = static_cast<int>(i - slot * D);
  const int l = lsrc[slot];
  float v = 0.f;
  if (l >= 0 && l < 2 * win) {
    const long long r = static_cast<long long>(blk[slot / S]) * win + l;
    if (r < n) v = vals[r * D + c];
  }
  out[i] = v;
}

__global__ void __launch_bounds__(kThreads)
gather_fix_kernel(const int* __restrict__ out_slot,
                  const int* __restrict__ out_src,
                  const float* __restrict__ vals, float* __restrict__ out,
                  long long total, long long n_slots, int D, int n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long o = i / D;
  const int c = static_cast<int>(i - o * D);
  const long long slot = out_slot[o];
  if (slot < 0 || slot >= n_slots) return;   // padding entries are dropped
  const int src = out_src[o];
  out[slot * D + c] = (src >= 0 && src < n)
                          ? vals[static_cast<long long>(src) * D + c] : 0.f;
}

}  // namespace

extern "C" int gather_rows_windows_fwd(const void* lsrc, const void* blk,
                                       const void* out_slot,
                                       const void* out_src, const void* vals,
                                       void* out, int T, int S, int D,
                                       int win, int n, int n_out,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(T) * S * D;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    gather_win_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(lsrc), static_cast<const int*>(blk),
        static_cast<const float*>(vals), static_cast<float*>(out), total, S, D,
        win, n);
  }
  const long long fix_total = static_cast<long long>(n_out) * D;
  if (fix_total > 0) {
    const unsigned blocks = static_cast<unsigned>((fix_total + kThreads - 1) / kThreads);
    gather_fix_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(out_slot), static_cast<const int*>(out_src),
        static_cast<const float*>(vals), static_cast<float*>(out), fix_total,
        static_cast<long long>(T) * S, D, n);
  }
  return static_cast<int>(cudaGetLastError());
}
