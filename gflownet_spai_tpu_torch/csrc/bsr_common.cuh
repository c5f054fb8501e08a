// What the two block-ELL SpMM kernels (K17) share: csrc/bsr.cu (CUDA cores;
// float32 or bf16 blocks, float32 X) and csrc/bsr_bf16.cu (tensor cores;
// bf16 blocks and X).  Both give a block one block row i and one tile of
// kCols columns of X, cut the row's W blocks into chunks of kJ block columns,
// flag and list the chunks that hold a nonzero A element (scan_chunks), and
// stage only those through a ring of kStages cp.async slots.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bsr {

constexpr int kCols = 128;        // X columns per block
constexpr int kJ = 32;            // block columns per chunk
constexpr int kMaxChunks = 256;   // chunks flagged per scan pass
constexpr int kScanLoads = 8;     // scan loads in flight per thread
constexpr int kStages = 3;        // chunks in the cp.async ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The bits of a 32-bit word that hold its A elements' magnitudes: an element
// (a float32, or either bf16 half) is nonzero iff one of its bits is set, so
// -0 counts as zero and NaN as nonzero, as `v != 0.f` does
template <typename T>
__host__ __device__ constexpr unsigned magnitude_bits();
template <>
__host__ __device__ constexpr unsigned magnitude_bits<float>() { return 0x7fffffffu; }
template <>
__host__ __device__ constexpr unsigned magnitude_bits<__nv_bfloat16>() { return 0x7fff7fffu; }

// 16-byte word f of chunk c of a block row: A row f / kWR of the chunk, its
// elements kE.(f % kWR) + 0..kE-1 (rows of kJ elements, kWR words each)
template <typename T, int BM>
__device__ __forceinline__ const uint4* a_word(const T* arow, int bn, int cj, int c, int f) {
  constexpr unsigned kE = 16 / sizeof(T), kWR = kJ / kE;
  const int w = c / cj, j0 = (c - w * cj) * kJ;
  const unsigned uf = static_cast<unsigned>(f);
  return reinterpret_cast<const uint4*>(
      arow + (static_cast<long long>(w) * BM + uf / kWR) * bn + j0 + (uf % kWR) * kE);
}

// Flag the chunks s0 .. s0 + nch - 1 of the block row `arow` (block columns
// `brow`) that hold a nonzero A element, and list them in order in list_s,
// each with its first X row in xrow_s; returns how many.  Called by all kT
// threads of the block; one pass reads every A word once, kScanLoads
// independent 16-byte loads in flight per thread.
template <typename T, int BM, int kT>
__device__ int scan_chunks(const T* arow, const int* brow, int bn, int s0, int nch,
                           int* flag_s, int* list_s, int* xrow_s, int* count_s) {
  constexpr int kF = BM * kJ * static_cast<int>(sizeof(T)) / 16;   // words per chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cj = bn / kJ;
  for (int c = tid; c < nch; c += kT) flag_s[c] = 0;
  __syncthreads();
  for (int e0 = tid; e0 < nch * kF; e0 += kScanLoads * kT) {
    uint4 v[kScanLoads];
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u) {
      const int e = e0 + u * kT;
      v[u] = e < nch * kF ? __ldg(a_word<T, BM>(arow, bn, cj, s0 + e / kF, e % kF))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kScanLoads; ++u)
      if ((v[u].x | v[u].y | v[u].z | v[u].w) & magnitude_bits<T>())
        flag_s[(e0 + u * kT) / kF] = 1;
  }
  __syncthreads();
  if (warp == 0) {
    int base = 0;
    for (int c = 0; c < nch; c += 32) {
      const bool f = c + lane < nch && flag_s[c + lane];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) {
        const int k = base + __popc(m & ((1u << lane) - 1u)), ch = s0 + c + lane;
        const int w = ch / cj;
        list_s[k] = ch;
        xrow_s[k] = __ldg(brow + w) * bn + (ch - w * cj) * kJ;
      }
      base += __popc(m);
    }
    if (lane == 0) *count_s = base;
  }
  __syncthreads();
  return *count_s;
}

}  // namespace bsr
