// K17 on bf16 blocks and bf16 X: the block-ELL sparse x dense product
// Y = A.X on Hopper's tensor cores (wgmma), fed by TMA.
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
// through wgmma (bf16 operands, float32 accumulators in registers).  A
// product of two bf16 values is exact in float32, so the sum differs from
// float32 arithmetic on the same values only in the order of its additions,
// and Y is rounded to bf16 once, where it is stored.  (bf16 blocks with
// float32 X run on CUDA cores, csrc/bsr.cu.)
//
// - The chunk list.  The wrapper (ops/bsr.py `_chunk_list`) makes once per
//   BELL's data, with device ops, per block row the count of its [bm, 32]
//   chunks that hold a word other than zero and their indices w.bn/32 + j in
//   slot order.  The kernel reads the list and never scans A: an all-zero
//   chunk (a padded slot, an explicit zero block, a zero chunk of a real
//   block) costs nothing and adds nothing, whatever X holds under it.
// - A block per (block row i, tile of Kc columns of X), block rows the fast
//   index, so the blocks that run at once share X's column tile in L2.  The
//   producer warps read the row's count, list and block columns in one
//   round trip, then keep a ring of kStages chunks in flight through TMA,
//   the four warps issuing the chunks in turn:
//   A's [bm, 32] chunk from a tensor map over data as [nbr.W.bm, bn]
//   (64-byte rows, 64-byte swizzle) and X's [32, Kc] rows as Kc / 64 boxes
//   of [32, 64] (128-byte swizzle), each stage's bytes counted on its full
//   mbarrier.  A is streamed (L2 evict-first), X kept (evict-last).  (Blocks
//   that walk several rows lost on the H100: the static split of rows of
//   binomial length left a tail.)
// - Operands swapped: the consumers compute Y^T = X^T.A^T.  wgmma's M (64)
//   runs along X's columns and its N = bm along A's rows, so every bm in
//   {8, 16, 32, 64, 128} is a legal width with no rows of zeros padded in.
//   A's row-major chunk is the K-major B operand as it lies; X's rows give
//   the A operand MN-major (the transpose bit bf16 allows).  Two k16 steps a
//   chunk.  CW consumer warpgroups of MT m64 tiles each own Kc = 64.CW.MT
//   columns; a warpgroup waits for its wgmmas on a chunk, then releases the
//   stage through its empty mbarrier, while the ring keeps the next chunks
//   in flight.  (A group kept in flight across chunks, wait_group 1, gave
//   wrong sums at bm >= 64 on the H100.)  No block-wide barrier per chunk.
//   setmaxnreg moves registers from the producer warpgroup to the
//   consumers.
// - Kc (ops/bsr.py `_col_tile`, a function of the shapes): 256 where the
//   grid still fills the card, so at K <= 256 A is read once; else 128 or 64.
// - Epilogue: the accumulators rounded to bf16 once into shared memory (the
//   ring's), then out as 16-byte rows; no column at or past K is stored.
// - Without TMA for X (K % 8 != 0, as spmv_bell's K = 1, or X off 16 bytes)
//   the producer warpgroup stages X element by element into the same
//   swizzled layout (Kc = 64) and Y is stored element by element.
// - A fixed summation order and no atomics: every launch gives the same bits.
//
// What bounds it: with (128,128) blocks at a few percent of dense, A's
// bytes from HBM and X's [32, Kc] rows from L2; with (8,128) blocks each
// 512-byte chunk of A pulls a 16 KB [32, 256] slice of X from L2, and that
// L2 traffic sets the pace.  chip_smoke.py prints the bounds, the L2 bytes
// of each case and an L2 read yardstick.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kJ = 32;                        // block columns per chunk: two k16 steps
constexpr int kTile = 64;                     // X columns per wgmma (its M)
constexpr int kXTileBytes = kJ * kTile * 2;   // one [32, 64] X box: 128-byte rows
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 40;
constexpr int kSmemPerSM = 233472;            // 228 KB, 1 KB of it reserved per block
constexpr int kSpinLimit = 1 << 24;           // mbarrier polls before a deadlock traps
constexpr int kEncodeError = 1000;            // + the CUresult of a failed tensor-map encode

// The kernel's shape for bm and CW consumer warpgroups of MT m64 tiles:
// threads, blocks an SM (its registers and shared memory follow; 3 at
// bm <= 16, where more blocks in flight beat a deeper ring on the H100),
// the registers setmaxnreg gives each role, the ring's stages, shared
// memory.
template <int BM, int CW, int MT>
struct Cfg {
  static constexpr int kThreads = 128 * (CW + 1);
  static constexpr int kKc = kTile * CW * MT;
  static constexpr int kMinBlocks = CW == 2 && BM * MT >= 128 ? 1 : CW == 2 && BM <= 16 ? 3 : 2;
  static constexpr int kRegs = 65536 / (kThreads * kMinBlocks) / 8 * 8;
  static constexpr int kConsumerRegs =
      (kRegs * (CW + 1) - kProducerRegs) / CW / 8 * 8 > 240
          ? 240
          : (kRegs * (CW + 1) - kProducerRegs) / CW / 8 * 8;
  static constexpr int kABytes = BM * kJ * 2;                     // one chunk of A
  static constexpr int kASlot = (kABytes + 1023) / 1024 * 1024;   // keeps stages 1024-aligned
  static constexpr int kXBytes = kXTileBytes * CW * MT;
  static constexpr int kStage = kXBytes + kASlot;
  static constexpr int kPitch = kKc + 8;                          // output tile row (bf16)
  static constexpr int kOutBytes = BM * kPitch * 2;
  static constexpr int kBudget = kSmemPerSM / kMinBlocks - 1024 - 1024 - 16 * kMaxStages;
  static constexpr int kStages = kBudget / kStage > kMaxStages ? kMaxStages : kBudget / kStage;
  static constexpr int kRing = kStages * kStage > kOutBytes ? kStages * kStage : kOutBytes;
  static constexpr int kSmem = 1024 + kRing + 16 * kStages;      // alignment, ring, barriers
  static_assert(kStages >= 4, "the ring holds at least 4 chunks");
  static_assert(kRegs * kThreads >= kProducerRegs * 128 + kConsumerRegs * 128 * CW,
                "setmaxnreg stays inside the block's registers");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete.  A deadlock (a fault
// of this file) traps after kSpinLimit polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == kSpinLimit) __trap();
  }
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// TMA: the box at (c0 innermost, c1) of `map` into shared memory at dst,
// its bytes counted on the mbarrier bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "l"(policy)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, swizzle mode (1: 128-byte, 2: 64-byte)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32 | swizzle << 62;
}

// X's [32, 64] box as wgmma's A operand, MN-major with 128-byte swizzle:
// 64 columns span one swizzle atom, 8-row groups lie 1024 bytes apart (the
// leading offset, between atoms along M, is not read at M = 64)
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return make_desc(addr, 1024, 1024, 1);
}

// A's [bm, 32] chunk as wgmma's B operand, K-major with 64-byte swizzle:
// rows of 64 bytes, 8-row groups 512 bytes apart
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  return make_desc(addr, 16, 512, 2);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma's
// asynchronous reads and writes of them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// d[64 x N] += X^T box [64 x 16] . A^T [16 x N] (descriptors xd, ad): A
// operand MN-major (transposed), B operand K-major, float32 accumulators
template <int N>
__device__ void wgmma(float (&d)[N / 2], uint64_t xd, uint64_t ad);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t xd, uint64_t ad) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(xd), "l"(ad), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t xd, uint64_t ad) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(xd), "l"(ad), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t xd, uint64_t ad) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(xd), "l"(ad), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t xd, uint64_t ad) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(xd), "l"(ad), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t xd, uint64_t ad) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(xd), "l"(ad), "r"(1));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Block b: block row i = b % nbr, X columns c0 = (b / nbr).Kc + 0..Kc-1
// (block rows the fast index).  Warpgroups 0..CW-1 consume, warpgroup CW
// produces.  TMA: X through its tensor map (K % 8 == 0, X 16-byte aligned;
// Y stored as 16-byte words); else (CW = MT = 1) X staged by the producer
// warpgroup element by element.
template <int BM, int CW, int MT, bool TMA>
__global__ void __launch_bounds__(Cfg<BM, CW, MT>::kThreads, Cfg<BM, CW, MT>::kMinBlocks)
bell_spmm_bf16_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap xmap, const int* __restrict__ list,
                      const int* __restrict__ bcols, int nbr, int W, int bn,
                      const bf16* __restrict__ x, int K, bf16* __restrict__ y) {
  using C = Cfg<BM, CW, MT>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;   // 1024-aligned: whole swizzle atoms
  uint8_t* ring_p = smem_raw + (ring - raw);
  bf16* out_s = reinterpret_cast<bf16*>(ring_p);   // the epilogue's tile, over the ring
  const uint32_t full = ring + C::kRing, empty = full + 8 * S;     // mbarriers

  const int i = static_cast<int>(blockIdx.x % static_cast<unsigned>(nbr));
  const int c0 = static_cast<int>(blockIdx.x / static_cast<unsigned>(nbr)) * C::kKc;
  const int kw = min(C::kKc, K - c0);     // this block's columns
  const int cj = bn / kJ, L = 1 + W * cj;   // chunks a block, list row length
  const int* lrow = list + static_cast<long long>(i) * L;
  const int tid = threadIdx.x, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, TMA ? 1 : 128);
      mbar_init(empty + 8 * s, 4 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid == 128 * CW) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&amap))
                 : "memory");
    if (TMA)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap))
                   : "memory");
  }
  __syncthreads();

  if (tid >= 128 * CW) {
    // ---- producer warpgroup ----
    setmaxnreg_dec<kProducerRegs>();
    // TMA: the four warps issue the chunks in turn (one warp issuing every
    // chunk lost on the H100: each issue held its warp ~0.5 us)
    const int ptid = tid - 128 * CW, pw = ptid >> 5;
    const int* brow = bcols + static_cast<long long>(i) * W;
    // the count, the first 32 entries and the first 32 block columns, in
    // flight together
    const int count = __ldg(lrow);
    int entry = lane < L - 1 ? __ldg(lrow + 1 + lane) : 0;
    const int bc = lane < W ? __ldg(brow + lane) : 0;
    const uint64_t pol_a = l2_policy_evict_first(), pol_x = l2_policy_evict_last();
    const int ntiles = (kw + kTile - 1) / kTile;
    const uint32_t tx = C::kABytes + (TMA ? ntiles * kXTileBytes : 0);
    for (int t0 = 0; t0 < count; t0 += 32) {
      // 32 list entries a pass, one a lane: A's box and X's first row
      if (t0 > 0) entry = t0 + lane < L - 1 ? __ldg(lrow + 1 + t0 + lane) : 0;
      const int w = entry / cj, jc = entry - w * cj;
      const int col = __shfl_sync(0xffffffffu, bc, w & 31);
      const int arow = (i * W + w) * BM, acol = jc * kJ;
      const int xrow = (W <= 32 ? col : __ldg(brow + w)) * bn + jc * kJ;
      const int n = min(32, count - t0);
      for (int u = 0; u < n; ++u) {
        const int t = t0 + u, s = t % S;
        if (TMA && (t & 3) != pw) continue;
        const int ar = __shfl_sync(0xffffffffu, arow, u);
        const int ac = __shfl_sync(0xffffffffu, acol, u);
        const int xr = __shfl_sync(0xffffffffu, xrow, u);
        const uint32_t st = ring + s * C::kStage;
        if constexpr (TMA) {
          if (lane == 0) {
            if (t >= S) mbar_wait(empty + 8 * s, ((t / S) - 1) & 1);
            mbar_arrive_tx(full + 8 * s, tx);
            tma_load(st + C::kXBytes, &amap, ac, ar, full + 8 * s, pol_a);
            for (int q = 0; q < ntiles; ++q)
              tma_load(st + q * kXTileBytes, &xmap, c0 + q * kTile, xr, full + 8 * s, pol_x);
          }
          __syncwarp();
        } else {
          // X's [32, kw] rows into the box layout TMA would give: 128-byte
          // rows, 16-byte word q of row j at q ^ (j % 8)
          if (t >= S) mbar_wait(empty + 8 * s, ((t / S) - 1) & 1);
          uint8_t* xs = ring_p + s * C::kStage;
          for (int e = ptid; e < kJ * kw; e += 128) {
            const int j = e / kw, cc = e - j * kw;
            *reinterpret_cast<bf16*>(xs + j * 128 + (((cc >> 3) ^ (j & 7)) << 4)
                                     + ((cc & 7) << 1)) =
                x[static_cast<long long>(xr + j) * K + c0 + cc];
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (ptid == 0) {
            mbar_arrive_tx(full + 8 * s, tx);
            tma_load(st + C::kXBytes, &amap, ac, ar, full + 8 * s, pol_a);
          } else {
            mbar_arrive(full + 8 * s);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  setmaxnreg_inc<C::kConsumerRegs>();
  const int count = __ldg(lrow);
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  float acc[MT][BM / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int k = 0; k < BM / 2; ++k) acc[mt][k] = 0.f;

  for (int t = 0; t < count; ++t) {
    const int s = t % S;
    mbar_wait(full + 8 * s, (t / S) & 1);
    __syncwarp();      // wgmma's .aligned instructions want the warp converged
    const uint32_t st = ring + s * C::kStage;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
    // every m64 tile, also one wholly past K whose box was not loaded (its
    // stale columns are never stored): a branch here made ptxas serialize
    // the wgmmas
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int q = wg * MT + mt;
#pragma unroll
      for (int ks = 0; ks < kJ / 16; ++ks)
        wgmma<BM>(acc[mt], x_desc(st + q * kXTileBytes + ks * 16 * 128),
                  a_desc(st + C::kXBytes + ks * 32));
    }
    wgmma_commit();
    wgmma_wait_all();   // chunk t's products are done: its stage is free
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // the tile rounded to bf16 once, into shared memory as [BM][Kc] (the
  // ring's, free once every consumer is done), then out as rows of Y.
  // Accumulator k of m64 tile q: Y row 8(k/4) + 2(lane%4) + k%2, column
  // 64q + 16.warp + lane/4 + 8((k/2)%2)
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = (wg * MT + mt) * kTile + 16 * warp + g;
#pragma unroll
    for (int k = 0; k < BM / 2; ++k) {
      const int r = 8 * (k >> 2) + 2 * t4 + (k & 1);
      out_s[r * C::kPitch + m + 8 * ((k >> 1) & 1)] = __float2bfloat16_rn(acc[mt][k]);
    }
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CW) : "memory");
  bf16* yb = y + static_cast<long long>(i) * BM * K + c0;
  if constexpr (TMA) {
    const int words = kw / 8;
    for (int e = tid; e < BM * words; e += 128 * CW) {
      const int r = e / words, cc = (e - r * words) * 8;
      *reinterpret_cast<uint4*>(yb + static_cast<long long>(r) * K + cc) =
          *reinterpret_cast<const uint4*>(out_s + r * C::kPitch + cc);
    }
  } else {
    for (int e = tid; e < BM * kw; e += 128 * CW) {
      const int r = e / kw, cc = e - r * kw;
      yb[static_cast<long long>(r) * K + cc] = out_s[r * C::kPitch + cc];
    }
  }
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime's entry
// point query (no link against libcuda); null where it is missing
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map: rows of `inner` elements `pitch` bytes apart,
// boxes of [box_rows, box_inner]
int encode(CUtensorMap* map, const void* ptr, unsigned long long inner,
           unsigned long long rows, unsigned long long pitch, unsigned box_inner,
           unsigned box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (!fn) return kEncodeError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {inner, rows}, strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_rows}, unit[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(r);
}

template <int BM, int CW, int MT, bool TMA>
int launch(const CUtensorMap& am, const CUtensorMap& xm, const int* list, const int* bcols,
           int nbr, int W, int bn, const bf16* x, int K, bf16* y, cudaStream_t st) {
  using C = Cfg<BM, CW, MT>;
  const auto kernel = bell_spmm_bf16_kernel<BM, CW, MT, TMA>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const long long blocks = static_cast<long long>(nbr) * ((K + C::kKc - 1) / C::kKc);
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), C::kThreads, C::kSmem, st>>>(am, xm, list, bcols,
                                                                        nbr, W, bn, x, K, y);
  return static_cast<int>(cudaGetLastError());
}

// Kc 256: two consumer warpgroups of two m64 tiles; 128: two of one; 64:
// one of one (the only width of the path without TMA for X)
template <int BM>
int by_width(int kc, bool tma, const CUtensorMap& am, const CUtensorMap& xm, const int* list,
             const int* bcols, int nbr, int W, int bn, const bf16* x, int K, bf16* y,
             cudaStream_t st) {
  if (!tma)
    return kc == 64 ? launch<BM, 1, 1, false>(am, xm, list, bcols, nbr, W, bn, x, K, y, st)
                    : static_cast<int>(cudaErrorInvalidValue);
  switch (kc) {
    case 64: return launch<BM, 1, 1, true>(am, xm, list, bcols, nbr, W, bn, x, K, y, st);
    case 128: return launch<BM, 2, 1, true>(am, xm, list, bcols, nbr, W, bn, x, K, y, st);
    case 256: return launch<BM, 2, 2, true>(am, xm, list, bcols, nbr, W, bn, x, K, y, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K17 on the tensor cores.  data [nbr, W, bm, bn] bf16 (16-byte aligned),
// bcols [nbr, W], list [nbr, 1 + W.bn/32] int32 (the chunk list), x [n, K]
// and y [nbr.bm, K] bf16; bm in {8, 16, 32, 64, 128}, bn a multiple of 32,
// nbr.W.bm and n below 2^31; kc the column tile (64, 128 or 256; 64 where
// tma is 0).  tma: K % 8 == 0 and x 16-byte aligned.  Returns a
// cudaError_t, or 1000 + the CUresult of a tensor-map encode that failed.
extern "C" int bell_spmm_bf16(const void* data, const void* bcols, const void* list, int nbr,
                              int W, int bm, int bn, const void* x, int n, int K, void* y,
                              int kc, int tma, void* stream) {
  if (nbr < 0 || W < 1 || bn < kJ || bn % kJ || K < 1 || n < 1
      || static_cast<long long>(nbr) * W * bm > INT_MAX
      || reinterpret_cast<unsigned long long>(data) % 16
      || (tma && (K % 8 || reinterpret_cast<unsigned long long>(x) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbr == 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap am{}, xm{};
  int rc = encode(&am, data, bn, static_cast<unsigned long long>(nbr) * W * bm, 2ull * bn, kJ,
                  bm, CU_TENSOR_MAP_SWIZZLE_64B);
  if (!rc && tma)
    rc = encode(&xm, x, K, n, 2ull * K, kTile, kJ, CU_TENSOR_MAP_SWIZZLE_128B);
  if (rc) return rc;
  const auto* l = static_cast<const int*>(list);
  const auto* b = static_cast<const int*>(bcols);
  const auto* xx = static_cast<const bf16*>(x);
  auto* yy = static_cast<bf16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 8: return by_width<8>(kc, tma, am, xm, l, b, nbr, W, bn, xx, K, yy, st);
    case 16: return by_width<16>(kc, tma, am, xm, l, b, nbr, W, bn, xx, K, yy, st);
    case 32: return by_width<32>(kc, tma, am, xm, l, b, nbr, W, bn, xx, K, yy, st);
    case 64: return by_width<64>(kc, tma, am, xm, l, b, nbr, W, bn, xx, K, yy, st);
    case 128: return by_width<128>(kc, tma, am, xm, l, b, nbr, W, bn, xx, K, yy, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

namespace {

template <int BM, int CW, int MT>
int config(int* out) {
  using C = Cfg<BM, CW, MT>;
  out[0] = C::kThreads;
  out[1] = C::kStages;
  out[2] = C::kSmem;
  out[3] = kProducerRegs;
  out[4] = C::kConsumerRegs;
  return 0;
}

template <int BM>
int config_by_width(int kc, int* out) {
  switch (kc) {
    case 64: return config<BM, 1, 1>(out);
    case 128: return config<BM, 2, 1>(out);
    case 256: return config<BM, 2, 2>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The kernel's shape at bm and column tile kc: out[0..4] = threads, ring
// stages, dynamic shared memory bytes, and the registers setmaxnreg gives a
// producer and a consumer thread.
extern "C" int bell_spmm_bf16_config(int bm, int kc, int* out) {
  switch (bm) {
    case 8: return config_by_width<8>(kc, out);
    case 16: return config_by_width<16>(kc, out);
    case 32: return config_by_width<32>(kc, out);
    case 64: return config_by_width<64>(kc, out);
    case 128: return config_by_width<128>(kc, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
