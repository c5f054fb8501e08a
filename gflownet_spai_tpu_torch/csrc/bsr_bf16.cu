// K17 on bf16 blocks and bf16 X: the block-ELL sparse x dense product
// Y = A.X on the tensor cores.
//
// A is stored block-ELL: data [nbr, W, bm, bn] bf16 (row-major blocks),
// bcols [nbr, W] int32 block-column ids; padded blocks point at block-column
// 0 with zero data.  X is [n, K] and Y [nbr.bm, K], both bf16, row-major:
//
//   Y[i.bm + r, c] = bf16( sum_w sum_j data[i, w, r, j] . X[bcols[i, w].bn + j, c] )
//
// Replaces the bf16-block path of both TPU kernels of
// gflownet_spai_tpu/ops/bsr.py, `_spmm_bell_pallas` and
// `_spmm_bell_pallas_resident`: on bf16 blocks they make one bf16 MXU pass
// (precision "default") with float32 partial sums.  Here every product goes
// through the warp-level mma.sync m16n8k16 (bf16 operands, float32
// accumulators in registers).  A product of two bf16 values is exact in
// float32, so the sum differs from float32 arithmetic on the same values only
// in the order of its float32 additions, and Y is rounded to bf16 once, where
// it is stored.  (bf16 blocks with float32 X run on CUDA cores, csrc/bsr.cu.)
//
// The outer design is csrc/bsr.cu's (csrc/bsr_common.cuh): a block per (block
// row i, tile of kCols = 128 columns of X), column tiles the grid's outer
// index, so the blocks that run at once share an L2-resident [n, 128] slice
// of X; one scan of the row's A that flags every all-zero [bm, 32] chunk, and
// only the flagged chunks multiplied (exact for any BELL: padded slots,
// explicit zero blocks, unsorted or repeated block columns; where X holds inf
// or NaN under an all-zero chunk the sum stays finite, as the float32
// kernel's); the flagged chunks' A and X rows through a cp.async ring of
// kStages slots, one barrier per chunk; a fixed summation order and no
// atomics, so every launch gives the same bits.
//
// - Operands swapped.  The block computes Y^T = X^T.A^T: the MMA's M (16)
//   runs along X's 128 columns and its N (8) along A's bm rows.  Every bm in
//   {8, 16, 32, 64, 128} is a whole number of n8 tiles, bm = 8 included, with
//   no rows of zeros padded in (padding bm = 8 to the 16 rows of the
//   unswapped form would waste half of every MMA).  A chunk's row-major
//   [bm, 32] of A is the MMA's B operand as it lies ("col": ldmatrix without
//   .trans), and X's row-major rows give its A operand through
//   ldmatrix .trans.  An accumulator fragment then holds columns of Y, so
//   the bf16 tile goes through shared memory and out as 16-byte rows.
// - Warps.  kWM = 4 warps along X's columns (32 each: two m16 tiles) times
//   kWN along A's rows (bm / kWN each: kNT n8 tiles).  Per chunk a warp loads
//   its B fragments for both k16 steps of kJ = 32 once, then per k16 step and
//   m16 tile one ldmatrix .x4 .trans of X and kNT MMAs.  The row pitches
//   (80 bytes for A, 272 for X and the output) keep the 8 rows of every
//   ldmatrix on distinct banks.
// - Tails.  X columns at or past K are zero-filled where they are staged and
//   not stored; without 16-byte X rows (K % 8 != 0, or X unaligned, as for
//   spmv_bell's K = 1) X is staged and Y stored element by element.
//
// What bounds it: with (128,128) blocks at a few percent of dense the MMAs
// carry the work.  With (8,128) blocks each flagged 512-byte chunk of A
// pulls an 8 KB chunk of X rows (kJ.kCols bf16) from L2, and that L2
// traffic sets the pace before the MMAs do; chip_smoke.py prints the bounds
// and the L2 bytes of each case.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bsr_common.cuh"

namespace {

using namespace bsr;
using bf16 = __nv_bfloat16;

constexpr int kAStride = kJ + 8;         // A row pitch in shared memory (bf16)
constexpr int kXStride = kCols + 8;      // X and output row pitch (bf16)
constexpr int kWM = 4;                   // warps along X's columns
constexpr int kMT = kCols / kWM / 16;    // m16 tiles per warp
constexpr int kXW = kCols / 8;           // 16-byte words of a staged X row

// warps along A's rows, by bm
template <int BM> struct Warps;
template <> struct Warps<8> { static constexpr int kWN = 1; };
template <> struct Warps<16> { static constexpr int kWN = 1; };
template <> struct Warps<32> { static constexpr int kWN = 2; };
template <> struct Warps<64> { static constexpr int kWN = 2; };
template <> struct Warps<128> { static constexpr int kWN = 4; };

template <int BM>
__host__ __device__ constexpr int threads() {
  return 32 * kWM * Warps<BM>::kWN;
}

// the ring's slots of A and X (reused for the output tile), then the flags,
// the list of nonzero chunks and their first X rows
template <int BM>
__host__ __device__ constexpr int ring_bytes() {
  return 2 * (kStages * (BM * kAStride + kJ * kXStride) > BM * kXStride
                  ? kStages * (BM * kAStride + kJ * kXStride)
                  : BM * kXStride);
}

template <int BM>
__host__ __device__ constexpr int smem_bytes() {
  return ring_bytes<BM>() + 3 * kMaxChunks * 4;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices; lane l gives row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a.b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (i, t): block row i, columns t.kCols + 0..kCols-1.  Warp w: X columns
// (w % kWM).32 + 0..31, A rows (w / kWM).bm/kWN + 0..bm/kWN-1.  VEC: K % 8 ==
// 0 and X, Y 16-byte aligned (X staged and Y stored as 16-byte words); else
// element by element.
template <int BM, bool VEC>
__global__ void __launch_bounds__(threads<BM>())
bell_spmm_bf16_kernel(const bf16* __restrict__ data, const int* __restrict__ bcols, int W,
                      int bn, const bf16* __restrict__ x, int K, bf16* __restrict__ y) {
  constexpr int kWN = Warps<BM>::kWN, kRows = BM / kWN, kNT = kRows / 8;
  constexpr int kT = threads<BM>();
  constexpr int kF = BM * kJ / 8;         // 16-byte words of A per chunk, 4 a row
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  bf16* a_s = reinterpret_cast<bf16*>(smem);         // [kStages][BM][kAStride]
  bf16* x_s = a_s + kStages * BM * kAStride;         // [kStages][kJ][kXStride]
  int* flag_s = reinterpret_cast<int*>(smem + ring_bytes<BM>());   // [kMaxChunks]
  int* list_s = flag_s + kMaxChunks;                 // [kMaxChunks]
  int* xrow_s = list_s + kMaxChunks;                 // [kMaxChunks]
  __shared__ int count_s;

  const long long i = blockIdx.x;
  const int c0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % kWM, wn = warp / kWM;
  const int cj = bn / kJ, n_chunks = W * cj;
  const bf16* arow = data + i * W * static_cast<long long>(BM) * bn;
  const int* brow = bcols + i * W;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // stage listed chunk k into ring slot b (cp.async, not committed; the
  // element-by-element X path stores directly, read after the next barrier)
  auto stage = [&](int k, int b) {
    bf16* as = a_s + b * BM * kAStride;
    const int c = list_s[k];
    for (int f = tid; f < kF; f += kT)
      cp_async16_l1(as + (f >> 2) * kAStride + (f & 3) * 8,
                    a_word<bf16, BM>(arow, bn, cj, c, f));
    const long long xrow0 = xrow_s[k];
    bf16* xs = x_s + b * kJ * kXStride;
    if constexpr (VEC) {
      for (int e = tid; e < kJ * kXW; e += kT) {
        const int jj = e / kXW, cc = (e % kXW) * 8, col = c0 + cc;
        const bf16* src = col < K ? x + (xrow0 + jj) * K + col : x;
        cp_async16(xs + jj * kXStride + cc, src, col < K ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kJ * kCols; e += kT) {
        const int jj = e / kCols, cc = e % kCols, col = c0 + cc;
        xs[jj * kXStride + cc] =
            col < K ? x[(xrow0 + jj) * K + col] : __float2bfloat16_rn(0.f);
      }
    }
  };
  // this warp's tile of ring slot b: B fragments (A rows, both k16 steps)
  // once, then per k16 step and m16 tile an X fragment and kNT MMAs
  auto compute = [&](int b) {
    const bf16* as = a_s + b * BM * kAStride + (wn * kRows + (lane & 7)) * kAStride
                     + (lane >> 3) * 8;
    const bf16* xs = x_s + b * kJ * kXStride
                     + (((lane >> 4) & 1) * 8 + (lane & 7)) * kXStride
                     + wm * (kCols / kWM) + ((lane >> 3) & 1) * 8;
    uint32_t bfr[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) ldmatrix_x4(bfr[nt], as + nt * 8 * kAStride);
#pragma unroll
    for (int ks = 0; ks < kJ / 16; ++ks) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t afr[4];
        ldmatrix_x4_trans(afr, xs + ks * 16 * kXStride + mt * 16);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          mma_bf16(acc[mt][nt], afr, bfr[nt][2 * ks], bfr[nt][2 * ks + 1]);
      }
    }
  };

  // scan passes of kMaxChunks; the nonzero chunks of each go through a
  // cp.async ring, kStages - 1 staged ahead of the one being multiplied
  for (int s0 = 0; s0 < n_chunks; s0 += kMaxChunks) {
    const int L = scan_chunks<bf16, BM, kT>(arow, brow, bn, s0, min(kMaxChunks, n_chunks - s0),
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

  // the tile rounded to bf16 once, into shared memory as [BM][kCols] (the
  // ring's memory), then out as rows of Y
  bf16* out_s = reinterpret_cast<bf16*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int m = wm * (kCols / kWM) + mt * 16 + g, r = wn * kRows + nt * 8 + 2 * t4;
      out_s[r * kXStride + m] = __float2bfloat16_rn(acc[mt][nt][0]);
      out_s[(r + 1) * kXStride + m] = __float2bfloat16_rn(acc[mt][nt][1]);
      out_s[r * kXStride + m + 8] = __float2bfloat16_rn(acc[mt][nt][2]);
      out_s[(r + 1) * kXStride + m + 8] = __float2bfloat16_rn(acc[mt][nt][3]);
    }
  __syncthreads();
  bf16* yb = y + i * BM * K;
  if constexpr (VEC) {
    for (int e = tid; e < BM * kXW; e += kT) {
      const int r = e / kXW, cc = (e % kXW) * 8, col = c0 + cc;
      if (col < K)
        *reinterpret_cast<uint4*>(yb + static_cast<long long>(r) * K + col) =
            *reinterpret_cast<const uint4*>(out_s + r * kXStride + cc);
    }
  } else {
    for (int e = tid; e < BM * kCols; e += kT) {
      const int r = e / kCols, cc = e % kCols, col = c0 + cc;
      if (col < K) yb[static_cast<long long>(r) * K + col] = out_s[r * kXStride + cc];
    }
  }
}

template <int BM, bool VEC>
int launch(const bf16* data, const int* bcols, int nbr, int W, int bn, const bf16* x, int K,
           bf16* y, cudaStream_t st) {
  constexpr int smem = smem_bytes<BM>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bell_spmm_bf16_kernel<BM, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(static_cast<unsigned>(nbr), static_cast<unsigned>((K + kCols - 1) / kCols));
  bell_spmm_bf16_kernel<BM, VEC><<<grid, threads<BM>(), smem, st>>>(data, bcols, W, bn, x, K,
                                                                      y);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int dispatch(const bf16* d, const int* b, int nbr, int W, int bm, int bn, const bf16* x,
             int K, bf16* y, cudaStream_t st) {
  switch (bm) {
    case 8: return launch<8, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 16: return launch<16, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 32: return launch<32, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 64: return launch<64, VEC>(d, b, nbr, W, bn, x, K, y, st);
    case 128: return launch<128, VEC>(d, b, nbr, W, bn, x, K, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K17 on the tensor cores.  data [nbr, W, bm, bn] bf16 (16-byte aligned),
// bcols [nbr, W], x [nbc.bn, K] and y [nbr.bm, K] bf16; bm in {8, 16, 32, 64,
// 128}, bn a multiple of 32, at most 65,535 column tiles of kCols.  vec:
// K % 8 == 0 and x, y 16-byte aligned.
extern "C" int bell_spmm_bf16(const void* data, const void* bcols, int nbr, int W, int bm,
                              int bn, const void* x, int K, void* y, int vec, void* stream) {
  if (nbr < 0 || W < 1 || bn < kJ || bn % kJ || K < 1 || (K + kCols - 1) / kCols > 65535
      || reinterpret_cast<unsigned long long>(data) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbr == 0) return static_cast<int>(cudaGetLastError());
  const auto* d = static_cast<const bf16*>(data);
  const auto* b = static_cast<const int*>(bcols);
  const auto* xx = static_cast<const bf16*>(x);
  auto* yy = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  return vec ? dispatch<true>(d, b, nbr, W, bm, bn, xx, K, yy, st)
             : dispatch<false>(d, b, nbr, W, bm, bn, xx, K, yy, st);
}
