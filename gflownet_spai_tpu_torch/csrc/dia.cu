// DIA (diagonal-format) SpMV kernels of the validation path and the solvers:
//
//   K8   dia_spmv       y = A.x                  (one pass over the diagonals)
//   K12  dia_power      z = (scale.A)^k.x, or k affine passes cur <- scale.A.cur + c
//   K13  dia_cheby      k Chebyshev steps  dd <- a_p.dd + b_p.(r - A.z);  z <- z + dd
//
// (K10 and K11, the padded-IO and ping-pong SpMVs, K14, K12 on K
// right-hand sides, and K16 run on `dia_rhs.cu`'s row-tile kernel.)
//
// Storage is row-scaled: data[s, i] = A[i, i + offs[s]], [ndiags, n_pad]
// row-major.  x is read as zero outside the range the caller gives.
//
// K8 replaces gflownet_spai_tpu/ops/dia.py `_spmv_pallas` (x resident in
// VMEM) and its VMEM-fitting variants `_spmv_pallas_stream` (host-side halo
// tensor) and `_spmv_pallas_stream2` (in-kernel window DMAs).  A TPU kernel
// must stage x in VMEM and slice every diagonal statically; a GPU reads x
// from global memory, where L2 (50 MB) holds the vector.  Two paths, picked
// by the caller (`ops/dia.py` `_k8_skips`), with the same arithmetic:
//
// - rows (a dense or narrow band): one thread per output row loops over every
//   diagonal, neighbouring threads on neighbouring words of each diagonal
//   and of x, so every load coalesces.  What bounds it on an H100: bytes (2
//   flops per diagonal word).  The streamed passes of K12 run on it too.
// - skip (a band whose segments mostly hold zeros): a DIA built from an
//   unstructured matrix stores mostly zeros (orsirr_like150: 230 diagonals
//   of 22,528 rows for 112,125 nonzeros, 2.2% of the stored words), and
//   the rows path spends its time on one dependent load after another,
//   about 5 warps per SM.  With such a matrix the wrapper builds one flag
//   per (64-row tile, diagonal), set where
//   the segment holds a word other than zero (`ops/dia.py` `_segment_flags`;
//   NaN is set).  A term of a skipped segment is fma(+-0.0, x[j], acc),
//   which leaves acc as it is unless x[j] is inf or NaN (the term gives NaN)
//   or acc is -0.0 (the term may give +0.0, by the signs of x[j] and the
//   word).
//   So a first kernel marks x's 32-element chunks that hold an inf or a NaN
//   (reading x once), and the second, launched as its programmatic
//   dependant, gives each 64-row tile a CTA that lists in shared memory the
//   diagonals the tile needs: those flagged, and those whose window of x
//   touches a marked chunk.  Each row's thread loads x and the diagonal word
//   of up to kNeedBatch listed diagonals at once and adds them in offset
//   order; before each it walks the skipped diagonals since the last one,
//   reading their words, only where acc is -0.0 (rare: a sum that
//   underflowed).  Every row gets the rows path's bits, NaN and inf
//   included.  What bounds it: the flagged segments' bytes and x read once,
//   then the latency of the few loads a row waits on.
//
// K12 replaces `_spmv_pallas_power` (x resident) and `_spmv_pallas_power_stream`
// (x and c streamed by window DMAs); K13 replaces `_spmv_pallas_cheby`.  Each
// has two modes, chosen by the caller (`ops/dia.py` `_fused_plan`):
//
// - fused (rows > 0): one launch of thread-block clusters of C CTAs (1024
//   threads, one per SM), each cluster walking windows of C.S rows.  CTA
//   `rank` owns the S rows from row0 = w.out - Hk + rank.S of window w and
//   stages them once per call with 16-byte cp.async copies: each row's
//   diagonal words and its c (K12 with `add`) or its r and dd (K13), and
//   the input iterate with a halo of Rh = R rounded up to 4 elements (8
//   where a type is bf16) each side.  The k passes then run in shared
//   memory, so the diagonals are read from device memory once for all k
//   passes; only the iterate moves, between two shared buffers.  Each pass computes the CTA's Rh rows at
//   either edge first and stores them into its neighbours' halos
//   (st.async into distributed shared memory, completing bytes on the
//   neighbour's mbarrier), then its interior rows, which read no halo,
//   while those stores travel; the next pass waits only for its two
//   neighbours' bytes.  Only the two ends of a window see stale halos, one
//   reach further in per pass, so a window yields out = C.S - 2.Hk output
//   rows, Hk = (k-1).R rounded up as Rh: the halo is paid per cluster window,
//   and a pass computes only the rows that still reach an output row.  The
//   last pass writes the output rows to device memory, and the CTA then
//   stages its rows of the next window.  (A second staging area, loading
//   the next window during this one's passes, measured no faster on an
//   H100: it halves the rows a CTA holds, so a window repeats more rows.)
//   The caller picks C, S and the clusters launched from the shared-memory
//   budget, cudaOccupancyMaxActiveClusters and a cost model of this card;
//   it needs 1 <= ndiags <= 9 (the diagonals are unrolled), S and P
//   multiples of 4 elements (8 where a type is bf16), 16-byte aligned
//   staged buffers and, when C > 1, S >= Rh.
// - streamed (rows == 0): k launches of a one-pass kernel, the iterate
//   ping-ponging through global memory between the output buffer and a
//   caller-given [n_pad] scratch buffer, ordered so that the last pass
//   lands in the output.  It serves any reach, k and ndiags, and the shapes
//   where no window fits, where k short launches cost less than one fused
//   launch, or where a window would repeat most of its rows.
//
// Both modes run each row update through the same arithmetic (`PowerRow`,
// `cheby_dn`): the sum over the diagonals from zero in offset order as
// fused multiply-adds, then x scale, then + c; for K13 dn = a.dd +
// b.(r - t), then z + dn, each rounding explicit, so the two modes agree
// bit for bit and a solver's iteration count never depends on the mode.
// Rows outside [0, n_pad) read as zero at every pass after the first, as
// the reference's zero re-padding does; the first pass reads x on
// [-P, n_pad + P).  What bounds them on an H100: bytes, the diagonals once
// per call in the fused mode (plus the window ends' rows) and k times in
// the streamed one; in the fused mode also the passes' shared-memory
// traffic (2.ndiags + 2 words per row update) and the wait for the
// neighbours' edge rows.

// Element types (`dia_types.cuh`): every kernel is a template over the
// stored diagonals' type TD and the vectors' type TV, one instance per
// (TD, TV) in (float32, float32), (bf16, float32), (bf16, bf16), chosen
// by the `types` code each entry point takes.  Every multiply-add runs in
// float32 (a bf16 word is widened in a register where it is read) and
// each result is rounded once, where it is stored, to TV; on bf16 buffers
// K12 and K13 therefore round every pass's iterate (and K13's dd) to
// bf16.  In the fused mode the staged diagonals, the
// iterate's two buffers and the aux rows are held in shared memory in
// their stored types, so bf16 halves the staging bytes and the shared
// memory a row takes (a CTA then holds more rows, and a window repeats
// fewer); a 16-byte copy then carries 8 elements, so Rh, Hk, S and P are
// multiples of 8 elements where a bf16 type is involved (4 for float32),
// and the edge rows of a bf16 iterate go to the neighbours two to a
// 32-bit st.async.  What bounds the bf16 instances: bytes as above, with
// 2-byte diagonal words (and 2-byte vector words on bf16 buffers); the
// fused mode's passes read as many shared-memory words per row update as
// in float32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dia_types.cuh"

namespace {

namespace cg = cooperative_groups;
using dia_types::bf16;
using dia_types::from_f;
using dia_types::to_f;
using dia_types::with_types;

constexpr int kThreads = 256;      // K8 rows, K12 / K13 streamed
constexpr int kTileRows = 64;      // K8 skip: rows of a tile (the segment flags' tile)
constexpr int kNeedChunk = 256;    // K8 skip: diagonals listed in shared memory at a time
constexpr int kNeedBatch = 8;      // K8 skip: listed diagonals whose loads a row issues at once
constexpr int kScanThreads = 256;  // K8 skip: the x scan, 32 chunks of 32 elements a warp
constexpr int kFusedThreads = 1024;    // K12, K13 fused: one CTA per SM
constexpr int kMaxPasses = 32;
constexpr int kMaxCluster = 16;

struct Coeffs {
  float a[kMaxPasses];
  float b[kMaxPasses];
};

// One row of K12: scale.sum_s d_s.x_s (+ c), the sum from zero in offset
// order.  Every rounding is explicit, so the fused and the streamed mode
// (and K8, at scale 1 with no c) compute each row alike.
struct PowerRow {
  float acc = 0.f;
  __device__ __forceinline__ void add(float d, float x) { acc = __fmaf_rn(d, x, acc); }
  __device__ __forceinline__ float done(float scale) const { return __fmul_rn(acc, scale); }
  __device__ __forceinline__ float done(float scale, float c) const {
    return __fadd_rn(__fmul_rn(acc, scale), c);
  }
};

// K13's update of one row from t = (A.z)_i: dn = a.dd + b.(r - t).
__device__ __forceinline__ float cheby_dn(float a, float dd, float b, float r, float t) {
  return __fadd_rn(__fmul_rn(a, dd), __fmul_rn(b, __fsub_rn(r, t)));
}

// y[i] = scale.sum_s data[s, i].x[i + offs[s]] (+ c[i]) for i < rows: K8's
// rows path at scale 1 with no c, and one pass of K12's streamed mode.
template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const TD* __restrict__ data, long long ld,
                const int* __restrict__ offs, int ndiags,
                const TV* __restrict__ x, long long x_lo, long long x_hi,
                const TV* __restrict__ c, float scale,
                TV* __restrict__ y, long long rows) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= rows) return;
  PowerRow row;
  for (int s = 0; s < ndiags; ++s) {
    const long long j = i + offs[s];
    row.add(to_f(data[s * ld + i]), (j >= x_lo && j < x_hi) ? to_f(x[j]) : 0.f);
  }
  y[i] = from_f<TV>(c != nullptr ? row.done(scale, to_f(c[i])) : row.done(scale));
}

// K8 skip, first kernel: nonfinite[c] = 1 where x[x_lo + 32c, + 32) holds
// an inf or a NaN, for c < ceil((x_hi - x_lo) / 32).  A warp covers 32
// chunks: lane l loads element l of each, 32 coalesced loads in flight,
// and one ballot per chunk gives lane c its chunk's mark.
template <typename TV>
__global__ void __launch_bounds__(kScanThreads)
dia_x_nonfinite_kernel(const TV* __restrict__ x, long long x_lo, long long x_hi,
                       unsigned char* __restrict__ nonfinite) {
  // the SpMV kernel may be scheduled now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31;
  const long long chunk0 = (blockIdx.x * static_cast<long long>(kScanThreads) + threadIdx.x
                            - lane);      // the warp's first chunk (32 per warp)
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const long long e = x_lo + 32 * (chunk0 + k) + lane;
    v[k] = e < x_hi ? to_f(x[e]) : 0.f;
  }
  unsigned mine = 0;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const unsigned bad = __ballot_sync(0xffffffffu, !isfinite(v[k]));
    if (lane == k) mine = bad;
  }
  if (x_lo + 32 * (chunk0 + lane) < x_hi) nonfinite[chunk0 + lane] = mine != 0;
}

// The value of x a row reads at j: x[j] on [x_lo, x_hi), else zero; the
// load is made from a clamped address, so it needs no branch.
template <typename TV>
__device__ __forceinline__ float x_at(const TV* __restrict__ x, long long j, long long x_lo,
                                      long long x_hi) {
  const long long jc = j < x_lo ? x_lo : (j >= x_hi ? x_hi - 1 : j);
  const float v = to_f(x[jc]);
  return j >= x_lo && j < x_hi ? v : 0.f;
}

__device__ __forceinline__ bool is_neg_zero(float v) { return __float_as_uint(v) == 0x80000000u; }

// K8 skip, second kernel: CTA b owns the rows of tile b, [64b, 64b + 64),
// and reads flags[b][ndiags] and the first kernel's chunk marks.
template <typename TD, typename TV>
__global__ void __launch_bounds__(kTileRows)
dia_spmv_skip_kernel(const TD* __restrict__ data, long long ld, const int* __restrict__ offs,
                     int ndiags, const unsigned char* __restrict__ flags,
                     const unsigned char* __restrict__ nonfinite, const TV* __restrict__ x,
                     long long x_lo, long long x_hi, TV* __restrict__ y, long long rows) {
  __shared__ int s_off[kNeedChunk];
  __shared__ unsigned char s_flag[kNeedChunk];
  __shared__ unsigned char s_need[kNeedChunk];
  __shared__ int2 s_list[kNeedChunk];   // (offset, diagonal) of the listed diagonals
  __shared__ int s_count;
  const long long r0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const long long r_end = min(r0 + kTileRows, rows);
  const long long i = r0 + threadIdx.x;
  const unsigned char* tflags = flags + static_cast<long long>(blockIdx.x) * ndiags;
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int c0 = 0; c0 < ndiags; c0 += kNeedChunk) {
    const int cn = min(kNeedChunk, ndiags - c0);
    if (c0 > 0) __syncthreads();      // the previous chunk's lists are read
    for (int s = threadIdx.x; s < cn; s += kTileRows) {
      s_off[s] = offs[c0 + s];
      s_flag[s] = tflags[c0 + s] != 0;
    }
    if (c0 == 0) asm volatile("griddepcontrol.wait;" ::: "memory");   // the chunk marks
    for (int s = threadIdx.x; s < cn; s += kTileRows) {   // this thread's s_off, s_flag
      bool need = s_flag[s];
      const long long lo = max(r0 + s_off[s], x_lo), hi = min(r_end + s_off[s], x_hi);
      if (!need && lo < hi) {
        for (long long c = (lo - x_lo) >> 5; c <= (hi - 1 - x_lo) >> 5; ++c)
          need = need || nonfinite[c] != 0;
      }
      s_need[s] = need;
    }
    __syncthreads();
    if (threadIdx.x < 32) {              // list the needed diagonals in order
      int count = 0;
      for (int base = 0; base < cn; base += 32) {
        const int s = base + lane;
        const bool need = s < cn && s_need[s];
        const unsigned mask = __ballot_sync(0xffffffffu, need);
        if (need)
          s_list[count + __popc(mask & ((1u << lane) - 1))] = make_int2(s_off[s], s);
        count += __popc(mask);
      }
      if (lane == 0) s_count = count;
    }
    __syncthreads();
    const int m = s_count;
    int next = 0;                        // the first diagonal of this chunk not yet added
    // skipped diagonals [from, to): their words are +-0.0 and x finite
    // there, so they change acc only where it is -0.0
    auto skipped = [&](int from, int to) {
      if (i < rows && is_neg_zero(acc))
        for (int t = from; t < to; ++t)
          acc = __fmaf_rn(to_f(data[(c0 + t) * ld + i]), x_at(x, i + s_off[t], x_lo, x_hi),
                          acc);
    };
    for (int k0 = 0; k0 < m; k0 += kNeedBatch) {
      float xv[kNeedBatch], dv[kNeedBatch];
#pragma unroll
      for (int u = 0; u < kNeedBatch; ++u) {
        xv[u] = 0.f;
        dv[u] = 0.f;
        if (k0 + u < m && i < rows) {
          const int2 e = s_list[k0 + u];
          xv[u] = x_at(x, i + e.x, x_lo, x_hi);
          // a diagonal listed for x's inf / NaN alone: its word is +-0.0,
          // loaded all the same for the sign the rows path gives a -0.0 sum
          dv[u] = to_f(data[(c0 + e.y) * ld + i]);
        }
      }
      asm volatile("" ::: "memory");   // every load of the batch is issued before the first add
#pragma unroll
      for (int u = 0; u < kNeedBatch; ++u) {
        if (k0 + u < m) {
          const int s = s_list[k0 + u].y;
          skipped(next, s);
          acc = __fmaf_rn(dv[u], xv[u], acc);
          next = s + 1;
        }
      }
    }
    skipped(next, cn);
  }
  if (i < rows) y[i] = from_f<TV>(__fmul_rn(acc, 1.f));
}

// One pass of K13's streamed mode over rows [0, n_pad): t = A.z,
// dd <- a.dd + b.(r - t), z_out = z + dd (dd rounded to TV first, as it is
// stored).  dd_in may be dd_out (each thread reads and writes only its own
// row there).
template <typename TD, typename TV>
__global__ void __launch_bounds__(kThreads)
dia_cheby_pass_kernel(const TD* __restrict__ data, long long n_pad,
                      const int* __restrict__ offs, int ndiags,
                      const TV* __restrict__ z, long long z_lo, long long z_hi,
                      const TV* dd_in, const TV* __restrict__ r,
                      TV* __restrict__ z_out, TV* dd_out, float a, float b) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_pad) return;
  PowerRow t;
  for (int s = 0; s < ndiags; ++s) {
    const long long j = i + offs[s];
    t.add(to_f(data[s * n_pad + i]), (j >= z_lo && j < z_hi) ? to_f(z[j]) : 0.f);
  }
  const TV dn = from_f<TV>(cheby_dn(a, to_f(dd_in[i]), b, to_f(r[i]), t.acc));
  z_out[i] = from_f<TV>(__fadd_rn(to_f(z[i]), to_f(dn)));
  dd_out[i] = dn;
}

// --- K12 / K13 fused: cp.async staging, st.async halos, mbarriers ------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Stage rows [lo, lo + len) of a vector whose rows [vlo, vhi) exist (`src`
// points at row 0) into dst[0, len) with 16-byte cp.async copies spread
// over the CTA's threads; the rows that do not exist are zero-filled.  lo,
// len, vlo and vhi are multiples of the 16 / sizeof(T) elements of a copy,
// so each chunk lies wholly inside or outside.  The caller commits the
// group.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long lo, int len,
                                           long long vlo, long long vhi) {
  constexpr int kChunk = 16 / sizeof(T);
  for (int q = threadIdx.x; q < len / kChunk; q += blockDim.x) {
    const long long g = lo + static_cast<long long>(kChunk) * q;
    const bool in = g >= vlo && g < vhi;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst + kChunk * q)), "l"(src + (in ? g : vlo)),
                    "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Arrive on the mbarrier at shared::cluster address `bar` of another CTA,
// releasing this thread's (and, through a CTA barrier before, its CTA's)
// earlier accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(unsigned bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" :: "r"(bar)
               : "memory");
}

// Wait for the phase of `parity` to complete, with cluster-scope acquire:
// the bytes other CTAs stored here with st.async, and what they released
// before arriving, are then visible.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The shared::cluster address of `p` (a shared memory address of this CTA)
// in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// Store the 32-bit word w at `addr` in another CTA of the cluster and
// complete 4 bytes of the transaction count of its mbarrier `bar` (both
// shared::cluster).
__device__ __forceinline__ void push_word(unsigned addr, unsigned w, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(addr), "r"(w), "r"(bar) : "memory");
}

// The 32-bit word of 4 / sizeof(T) adjacent elements (the lower address in
// the low bits).
__device__ __forceinline__ unsigned word_of(const float* v) { return __float_as_uint(v[0]); }
__device__ __forceinline__ unsigned word_of(const bf16* v) {
  return static_cast<unsigned>(__bfloat16_as_ushort(v[0]))
         | (static_cast<unsigned>(__bfloat16_as_ushort(v[1])) << 16);
}

// Elements of a 16-byte staging copy of the narrower of the two types: Rh,
// Hk, S and P are multiples of it.
template <typename TD, typename TV>
constexpr int fused_align() {
  return 16 / static_cast<int>(sizeof(TD) < sizeof(TV) ? sizeof(TD) : sizeof(TV));
}

// Window w of a fused launch.  Buffers of Wb = S + 2.Rh elements hold rows
// row0 - Rh + j at index j; CTA `rank` of the cluster owns rows
// [row0, row0 + S) and writes the output rows [out0, out_end) among them.
struct FusedCta {
  long long out0, out_end, row0;
  int lo, hi;   // its rows [lo, hi) lie in [0, n_pad); the others stay zero
  __device__ FusedCta(int rank, int S, int Hk, long long out, long long n_pad, long long w) {
    out0 = w * out;
    out_end = min(out0 + out, n_pad);
    row0 = out0 - Hk + static_cast<long long>(rank) * S;
    lo = static_cast<int>(min(max(-row0, 0LL), static_cast<long long>(S)));
    hi = static_cast<int>(max(min(n_pad - row0, static_cast<long long>(S)),
                              static_cast<long long>(lo)));
  }
};

// Shared memory of a fused CTA: three mbarriers (the halos of A and B,
// and the neighbours' "done with the last window"; 32 bytes with padding),
// the iterate's two buffers A and B ([Wb] TV each), then the staging area:
// x[Wb] (the window's input iterate with its halos) and aux[kind][S] (K12
// with c: c; K13: r, dd), TV, then dg[nd][S], TD.  With Wb and S multiples
// of fused_align, every part starts 16-byte aligned.
template <typename TD, typename TV>
__host__ __device__ inline size_t fused_smem_bytes(int nd, int kind, int S, int Rh) {
  const size_t s = static_cast<size_t>(S);
  return 32 + sizeof(TV) * (3 * (s + 2 * Rh) + kind * s) + sizeof(TD) * nd * s;
}

// K12 (kKind 0, or 1 with c) and K13 (kKind 2) fused, for ND diagonals:
// see the header.  x is xq (K12) or zq (K13), a is cq or rq, ddq and dd_out
// only K13's.  Cluster blockIdx.x / C walks windows first, first + step, ...
// (step = the clusters launched), staging each (cp.async) once the
// previous one's passes are done.  Pass 1 reads the staged x and writes A;
// the next passes alternate between A and B, and the last one writes the
// output rows to device memory.  A pass computes only the rows
// that reach an output row of the window, (k - p).R around them.  Each
// pass but the last computes the rows within Rh of the CTA's two edges
// first and stores them into the neighbours' halos too (st.async of
// 32-bit words, one row of a float32 iterate or two of a bf16 one,
// completing bytes on the neighbour's mbarrier of that buffer), then the
// interior rows, which read no halo; the next pass first waits for the
// neighbours' bytes on its own mbarrier.  A neighbour stores pass p + 1
// into a halo only after it has received this CTA's pass p edge rows,
// which this CTA computes, from the halo of pass p - 1, before it sends
// them: no halo is overwritten before it is read.  After a window each CTA
// tells its neighbours (a remote mbarrier arrive) that its halos are free
// for the next window's first stores.
template <int kKind, int ND, typename TD, typename TV>
__global__ void __launch_bounds__(kFusedThreads, 1)
dia_fused_kernel(const TD* __restrict__ data, long long n_pad,
                 const int* __restrict__ offs, int reach, const TV* __restrict__ xq,
                 const TV* __restrict__ aq, const TV* __restrict__ ddq,
                 TV* __restrict__ zq, TV* __restrict__ dd_out, long long P, int k,
                 float scale, Coeffs cf, int S, int Rh, int Hk, long long out,
                 long long windows) {
  constexpr int kPack = 4 / sizeof(TV);   // iterate rows per pushed 32-bit word
  extern __shared__ __align__(16) unsigned char fused_smem[];
  const int Wb = S + 2 * Rh;
  uint64_t* halo_bar = reinterpret_cast<uint64_t*>(fused_smem);   // [2]: A's and B's halos
  uint64_t* free_bar = halo_bar + 2;     // the neighbours are done with their last window
  TV* A = reinterpret_cast<TV*>(fused_smem + 32);
  TV* B = A + Wb;
  TV* sx = B + Wb;   // the staging area
  TV* aux = sx + Wb;
  TV* dd = aux + S;
  TD* dg = reinterpret_cast<TD*>(aux + kKind * S);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long first = blockIdx.x / C, step = gridDim.x / C;
  const int n_win = first < windows ? static_cast<int>((windows - first + step - 1) / step) : 0;
  const int n_nbr = (rank > 0) + (rank < C - 1);
  const int tid = threadIdx.x;

  auto stage_window = [&](int t) {
    const FusedCta c(rank, S, Hk, out, n_pad, first + t * step);
    stage_rows(sx, xq + P, c.row0 - Rh, Wb, -P, n_pad + P);
#pragma unroll
    for (int d = 0; d < ND; ++d)
      stage_rows(dg + d * S, data + d * n_pad, c.row0, S, 0, n_pad);
    if (kKind >= 1) stage_rows(aux, aq + P, c.row0, S, 0, n_pad);
    if (kKind == 2) stage_rows(dd, ddq + P, c.row0, S, 0, n_pad);
    cp_async_commit();
  };

  if (tid == 0) {
    mbar_init(&halo_bar[0], 1);
    mbar_init(&halo_bar[1], 1);
    mbar_init(free_bar, n_nbr > 0 ? n_nbr : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < Rh; j += blockDim.x)   // halos no neighbour writes
    A[j] = A[Rh + S + j] = B[j] = B[Rh + S + j] = from_f<TV>(0.f);
  if (n_win > 0) stage_window(0);
  // every CTA of the cluster runs, its barriers initialised, before any
  // stores into it
  if (C > 1) cluster.sync(); else __syncthreads();

  int off[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) off[d] = offs[d];
  const int e_lo = min(Rh, S), e_hi = max(S - Rh, e_lo);   // edge rows: [0, e_lo) U [e_hi, S)
  const int n_edge = e_lo + (S - e_hi);
  const bool has_left = C > 1 && rank > 0, has_right = C > 1 && rank < C - 1;
  unsigned phases = 0;   // bit j: the parity of halo_bar[j]'s phase; bit 2: free_bar's
  for (int t = 0; t < n_win; ++t) {
    const bool next = t + 1 < n_win;
    cp_async_wait<0>();
    __syncthreads();   // the staged window, from every thread's copies
    if (t > 0 && C > 1) {   // the neighbours' halos are free
      mbar_wait_cluster(free_bar, (phases >> 2) & 1);
      phases ^= 4u;
    }
    const FusedCta c(rank, S, Hk, out, n_pad, first + t * step);
    int lo = c.lo, hi = c.hi;   // the rows this pass computes, the others give 0
    // row i's value at pass p from the previous iterate `src` (K13 also
    // stores row i's dd, rounded to TV, before z + dd uses it)
    auto row = [&](int p, int i, const TV* src) -> float {
      if (i < lo || i >= hi) {
        if (kKind == 2) dd[i] = from_f<TV>(0.f);
        return 0.f;
      }
      PowerRow acc;
      const TV* x = src + Rh + i;
#pragma unroll
      for (int d = 0; d < ND; ++d) acc.add(to_f(dg[d * S + i]), to_f(x[off[d]]));
      if (kKind == 2) {
        const TV dn = from_f<TV>(
            cheby_dn(cf.a[p - 1], to_f(dd[i]), cf.b[p - 1], to_f(aux[i]), acc.acc));
        dd[i] = dn;   // only this thread reads or writes row i of dd in a pass
        return __fadd_rn(to_f(x[0]), to_f(dn));
      }
      return kKind == 1 ? acc.done(scale, to_f(aux[i])) : acc.done(scale);
    };
    const TV* src = sx;
    TV* dst = A;
    for (int p = 1; p <= k; ++p) {
      // the rows that reach an output row, (k - p).R around [out0, out_end):
      // [clo, chi); of them, those outside [0, n_pad) are zero
      const long long cone = static_cast<long long>(k - p) * reach;
      const int clo = static_cast<int>(min(max(c.out0 - cone - c.row0, 0LL),
                                           static_cast<long long>(S)));
      const int chi = static_cast<int>(max(min(c.out_end + cone - c.row0,
                                               static_cast<long long>(S)),
                                           static_cast<long long>(clo)));
      lo = max(c.lo, clo);
      hi = min(c.hi, chi);
      const int b = (p & 1) ? 0 : 1;   // dst is A at odd passes, B at even ones
      if (p > 1 && C > 1) {            // the neighbours' pass p - 1 edge rows
        mbar_wait_cluster(&halo_bar[b ^ 1], (phases >> (b ^ 1)) & 1);
        phases ^= 1u << (b ^ 1);
      }
      if (p == k) {   // the output rows, to device memory
        for (int i = max(lo, static_cast<int>(c.out0 - c.row0)) + tid; i < hi;
             i += blockDim.x) {
          zq[P + c.row0 + i] = from_f<TV>(row(p, i, src));
          if (kKind == 2) dd_out[P + c.row0 + i] = dd[i];
        }
        break;
      }
      if (tid == 0 && C > 1)
        mbar_expect_tx(&halo_bar[b], static_cast<unsigned>(sizeof(TV)) * Rh * n_nbr);
      const unsigned left = has_left ? cluster_addr(dst + Rh + S, rank - 1) : 0;
      const unsigned left_bar = has_left ? cluster_addr(&halo_bar[b], rank - 1) : 0;
      const unsigned right = has_right ? cluster_addr(dst, rank + 1) : 0;
      const unsigned right_bar = has_right ? cluster_addr(&halo_bar[b], rank + 1) : 0;
      for (int q = tid; q < n_edge / kPack; q += blockDim.x) {
        const int e = kPack * q;
        const int i = e < e_lo ? e : e_hi + (e - e_lo);   // rows i .. i + kPack - 1
        TV v[kPack];
#pragma unroll
        for (int u = 0; u < kPack; ++u) {
          v[u] = from_f<TV>(row(p, i + u, src));
          dst[Rh + i + u] = v[u];
        }
        const unsigned bytes = static_cast<unsigned>(sizeof(TV)) * i;
        if (has_left && i < Rh) push_word(left + bytes, word_of(v), left_bar);
        if (has_right && i >= S - Rh)
          push_word(right + bytes - static_cast<unsigned>(sizeof(TV)) * (S - Rh), word_of(v),
                    right_bar);
      }
      for (int i = max(e_lo, clo) + tid; i < min(e_hi, chi); i += blockDim.x)
        dst[Rh + i] = from_f<TV>(row(p, i, src));
      __syncthreads();   // the next pass overwrites src
      src = dst;
      dst = dst == A ? B : A;
    }
    __syncthreads();   // the buffers and the stage are read
    if (tid == 0 && next) {
      if (has_left) mbar_arrive_remote(cluster_addr(free_bar, rank - 1));
      if (has_right) mbar_arrive_remote(cluster_addr(free_bar, rank + 1));
    }
    if (next) stage_window(t + 1);
  }
  // no CTA exits while a neighbour may still store into it: the last
  // window's stores all arrived before its last pass
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel; raise it
// only when a launch needs more than the last one set.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, size_t* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

// The index of a (TD, TV) instance: its `types` code.
template <typename TD, typename TV>
constexpr int type_code() {
  return sizeof(TD) == 4 ? 0 : sizeof(TV) == 4 ? 1 : 2;
}

// The fused kernel's instances: kind (0 K12, 1 K12 with c, 2 K13) by
// ndiags in [1, kFusedMaxDiags] by (TD, TV); wider matrices take the
// streamed mode.
constexpr int kFusedMaxDiags = 9;
size_t g_fused_smem[3][3][kFusedMaxDiags + 1] = {};
bool g_fused_wide[3][3][kFusedMaxDiags + 1] = {};

template <int kKind, typename TD, typename TV, typename F>
cudaError_t with_fused_nd(int nd, F f) {
  switch (nd) {
    case 1: return f(dia_fused_kernel<kKind, 1, TD, TV>);
    case 2: return f(dia_fused_kernel<kKind, 2, TD, TV>);
    case 3: return f(dia_fused_kernel<kKind, 3, TD, TV>);
    case 4: return f(dia_fused_kernel<kKind, 4, TD, TV>);
    case 5: return f(dia_fused_kernel<kKind, 5, TD, TV>);
    case 6: return f(dia_fused_kernel<kKind, 6, TD, TV>);
    case 7: return f(dia_fused_kernel<kKind, 7, TD, TV>);
    case 8: return f(dia_fused_kernel<kKind, 8, TD, TV>);
    case 9: return f(dia_fused_kernel<kKind, 9, TD, TV>);
    default: return cudaErrorInvalidValue;
  }
}

// f(kernel) on the instance of (kind, nd, TD, TV), after raising its
// shared memory limit to `smem` (and allowing clusters above 8 CTAs)
// where needed.
template <typename TD, typename TV, typename F>
cudaError_t with_fused_kernel(int kind, int nd, size_t smem, int C, F f) {
  if (kind < 0 || kind > 2 || nd < 1 || nd > kFusedMaxDiags) return cudaErrorInvalidValue;
  constexpr int tc = type_code<TD, TV>();
  auto g = [&](auto kern) {
    cudaError_t err = opt_in_smem(kern, smem, &g_fused_smem[tc][kind][nd]);
    if (err == cudaSuccess && C > 8 && !g_fused_wide[tc][kind][nd]) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      g_fused_wide[tc][kind][nd] = err == cudaSuccess;
    }
    return err != cudaSuccess ? err : f(kern);
  };
  return kind == 0 ? with_fused_nd<0, TD, TV>(nd, g)
       : kind == 1 ? with_fused_nd<1, TD, TV>(nd, g)
                   : with_fused_nd<2, TD, TV>(nd, g);
}

struct FusedLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  FusedLaunch(unsigned grid, int C, size_t smem, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(C);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kFusedThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// One fused launch of `kind` from the caller's C (cluster), S (rows) and
// cap on the clusters launched (those the card holds at once); each
// launched cluster walks its windows.  Refuses what the kernel cannot
// take: S and P multiples of fused_align (4 elements for float32, 8 where
// a type is bf16), S >= Rh when C > 1, a window yielding an output row and
// 16-byte aligned staged buffers.
template <typename TD, typename TV>
cudaError_t fused_launch(int kind, const TD* data, long long n_pad, const int* offs,
                         int ndiags, int reach, const TV* x, const TV* a, const TV* ddq,
                         TV* z, TV* ddo, long long P, int k, float scale, const Coeffs& cf,
                         int C, int S, int clusters, cudaStream_t st) {
  constexpr int al = fused_align<TD, TV>();
  if (k < 2 || k > kMaxPasses || C < 1 || C > kMaxCluster || S <= 0 || S % al != 0
      || clusters < 1 || reach < 0 || ndiags < 1
      || ndiags > kFusedMaxDiags || P % al != 0 || !aligned16(data) || !aligned16(x)
      || (kind >= 1 && !aligned16(a)) || (kind == 2 && !aligned16(ddq)))
    return cudaErrorInvalidValue;
  const int Rh = (reach + al - 1) / al * al;
  const int Hk = static_cast<int>((static_cast<long long>(k - 1) * reach + al - 1) / al * al);
  const long long out = static_cast<long long>(C) * S - 2LL * Hk;
  if (out <= 0 || (C > 1 && S < Rh)) return cudaErrorInvalidValue;
  const long long windows = (n_pad + out - 1) / out;
  const long long launched = windows < clusters ? windows : clusters;
  const size_t smem = fused_smem_bytes<TD, TV>(ndiags, kind, S, Rh);
  FusedLaunch l(static_cast<unsigned>(launched * C), C, smem, st);
  return with_fused_kernel<TD, TV>(kind, ndiags, smem, C, [&](auto kern) {
    return cudaLaunchKernelEx(&l.cfg, kern, data, n_pad, offs, reach, x, a, ddq, z, ddo, P, k,
                              scale, cf, S, Rh, Hk, out, windows);
  });
}

unsigned row_blocks(long long rows) {
  return static_cast<unsigned>((rows + kThreads - 1) / kThreads);
}

// The (TD, TV) of a `types` code, as the pointer types of a call.
#define DIA_TYPES(t)                          \
  using TD = typename decltype(t)::Data;      \
  using TV = typename decltype(t)::Vec

}  // namespace

// Every entry point takes `types`, the (diagonal, vector) element types:
// 0 (float32, float32), 1 (bf16, float32), 2 (bf16, bf16); the output and
// every buffer have the vector type.

// K8.  `x` points at logical index 0 of the vector; x[j] is read for
// x_lo <= j < x_hi and is zero elsewhere.  y gets `rows` rows (rows <= ld).
// skip == 0: the rows path.  skip != 0: the skip path, which reads `flags`
// ([ceil(ld / tile_rows), ndiags] bytes, nonzero where a tile's segment of a
// diagonal may hold a word other than +0.0) and marks x's chunks in
// `nonfinite` (ceil((x_hi - x_lo) / 32) bytes of scratch); it refuses
// another tile height than its own and an empty x range.
extern "C" int dia_spmv(const void* data, long long ld, const void* offs, int ndiags,
                        const void* flags, int tile_rows, const void* x, long long x_lo,
                        long long x_hi, void* y, long long rows, int skip, void* nonfinite,
                        int types, void* stream) {
  if (ndiags < 0 || rows < 0 || rows > ld || (skip && tile_rows != kTileRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  if (skip && x_lo >= x_hi) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    const TD* dat = static_cast<const TD*>(data);
    const int* off = static_cast<const int*>(offs);
    const TV* xv = static_cast<const TV*>(x);
    TV* yv = static_cast<TV*>(y);
    if (!skip) {
      dia_spmv_kernel<TD, TV><<<row_blocks(rows), kThreads, 0, st>>>(
          dat, ld, off, ndiags, xv, x_lo, x_hi, nullptr, 1.f, yv, rows);
      return cudaGetLastError();
    }
    unsigned char* nf = static_cast<unsigned char*>(nonfinite);
    const long long per = 32LL * kScanThreads;        // elements a scan CTA covers
    dia_x_nonfinite_kernel<TV><<<static_cast<unsigned>((x_hi - x_lo + per - 1) / per),
                                 kScanThreads, 0, st>>>(xv, x_lo, x_hi, nf);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((rows + kTileRows - 1) / kTileRows));
    cfg.blockDim = dim3(kTileRows);
    cfg.stream = st;
    cudaLaunchAttribute pdl[1];
    pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = pdl;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, dia_spmv_skip_kernel<TD, TV>, dat, ld, off, ndiags,
                              static_cast<const unsigned char*>(flags),
                              static_cast<const unsigned char*>(nf), xv, x_lo, x_hi, yv, rows);
  }));
}

// K12.  xq, cq (nullable) and zq are [P + n_pad + P] buffers; only zq's
// interior [P, P + n_pad) is written.  rows > 0: fused, at most `clusters`
// clusters of `cluster` CTAs owning `rows` rows each (`fused_launch` says
// what it takes); rows == 0: streamed, through
// `tmp` ([n_pad] elements; unused when k == 1).
extern "C" int dia_power(const void* data, long long n_pad, const void* offs,
                         int ndiags, int reach, const void* xq, const void* cq,
                         void* zq, long long P, int k, float scale, int cluster,
                         int rows, int clusters, void* tmp, int types, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    const TD* dat = static_cast<const TD*>(data);
    const int* off = static_cast<const int*>(offs);
    const TV* x = static_cast<const TV*>(xq);
    const TV* c = static_cast<const TV*>(cq);
    TV* z = static_cast<TV*>(zq);
    if (rows == 0) {
      const TV* src = x + P;
      for (int p = 1; p <= k; ++p) {
        TV* dst = (k - p) % 2 == 0 ? z + P : static_cast<TV*>(tmp);
        const long long lo = p == 1 ? -P : 0, hi = p == 1 ? n_pad + P : n_pad;
        dia_spmv_kernel<TD, TV><<<row_blocks(n_pad), kThreads, 0, st>>>(
            dat, n_pad, off, ndiags, src, lo, hi, c == nullptr ? nullptr : c + P, scale,
            dst, n_pad);
        src = dst;
      }
      return cudaGetLastError();
    }
    const cudaError_t err = fused_launch<TD, TV>(
        c != nullptr ? 1 : 0, dat, n_pad, off, ndiags, reach, x, c, nullptr, z, nullptr, P, k,
        scale, Coeffs{}, cluster, rows, clusters, st);
    return err != cudaSuccess ? err : cudaGetLastError();
  }));
}

// K13.  zq, ddq, rq, z_out, dd_out are [P + n_pad + P] buffers; `coeffs`
// is a host array a_1, b_1, ..., a_k, b_k (k <= 32).  Only the interiors of
// z_out and dd_out are written.  rows > 0: fused as K12; rows == 0:
// streamed, through `tmp` ([n_pad] elements; unused when k == 1).
extern "C" int dia_cheby(const void* data, long long n_pad, const void* offs,
                         int ndiags, int reach, const void* zq, const void* ddq,
                         const void* rq, void* z_out, void* dd_out, long long P,
                         int k, const float* coeffs, int cluster, int rows, int clusters,
                         void* tmp, int types, void* stream) {
  if (k < 1 || k > kMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    const TD* dat = static_cast<const TD*>(data);
    const int* off = static_cast<const int*>(offs);
    const TV* z = static_cast<const TV*>(zq);
    const TV* ddi = static_cast<const TV*>(ddq);
    const TV* r = static_cast<const TV*>(rq);
    TV* zo = static_cast<TV*>(z_out);
    TV* ddo = static_cast<TV*>(dd_out);
    if (rows == 0) {
      const TV* src = z + P;
      const TV* dd = ddi + P;
      for (int p = 1; p <= k; ++p) {
        TV* dst = (k - p) % 2 == 0 ? zo + P : static_cast<TV*>(tmp);
        const long long lo = p == 1 ? -P : 0, hi = p == 1 ? n_pad + P : n_pad;
        dia_cheby_pass_kernel<TD, TV><<<row_blocks(n_pad), kThreads, 0, st>>>(
            dat, n_pad, off, ndiags, src, lo, hi, dd, r + P, dst, ddo + P,
            coeffs[2 * p - 2], coeffs[2 * p - 1]);
        src = dst;
        dd = ddo + P;
      }
      return cudaGetLastError();
    }
    Coeffs cf;
    for (int p = 0; p < k; ++p) {
      cf.a[p] = coeffs[2 * p];
      cf.b[p] = coeffs[2 * p + 1];
    }
    const cudaError_t err = fused_launch<TD, TV>(2, dat, n_pad, off, ndiags, reach, z, r, ddi,
                                                 zo, ddo, P, k, 1.f, cf, cluster, rows,
                                                 clusters, st);
    return err != cudaSuccess ? err : cudaGetLastError();
  }));
}

// How many clusters of `cluster` CTAs with `smem` bytes of shared memory
// each of the fused kind (0 K12, 1 K12 with c, 2 K13) for `ndiags`
// diagonals and element `types` the card holds at once, into *active.
extern "C" int dia_fused_clusters(int kind, int ndiags, int types, int cluster,
                                  long long smem, int* active) {
  if (cluster < 1 || cluster > kMaxCluster || smem <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedLaunch l(static_cast<unsigned>(cluster), cluster, static_cast<size_t>(smem), nullptr);
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    return with_fused_kernel<TD, TV>(kind, ndiags, l.cfg.dynamicSmemBytes, cluster,
                                     [&](auto kern) {
      return cudaOccupancyMaxActiveClusters(active, kern, &l.cfg);
    });
  }));
}
