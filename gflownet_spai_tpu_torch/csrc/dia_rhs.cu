// The DIA kernels of the solver library that run on one row-tile kernel:
//
//   K10  dia_spmv_pp    y = scale.A.x in x's padded layout, halo blocks zeroed
//   K11  dia_spmv_pp    y = scale.A.x into the interior of a second buffer
//   K14  dia_power_rhs  Z = (scale.A)^k.X, or k affine passes Z <- scale.A.Z + C,
//                       on K right-hand sides, [K, P + n_pad + P] buffers
//   K16  dia_spmm_t     Yt = A.X for right-hand sides held as rows of Xt
//
// Storage is row-scaled: data[s, i] = A[i, i + offs[s]], [ndiags, n_pad]
// row-major.  Each output row is sum_s data[s, i].x[i + offs[s]], summed
// from zero in offset order as fused multiply-adds, with x read as zero
// outside the range [x_lo, x_hi) the caller gives.
//
// K16 replaces gflownet_spai_tpu/ops/dia.py `_spmm_dia_t_pallas` (window
// DMAs of [kb, tr + 2h] so each right-hand side is one contiguous burst);
// one pass of K14 replaces a pass of `_spmv_pallas_power_rhs`.  K10
// replaces `_spmv_pallas_io` / `_spmv_pallas_io_stream` (y in x's padded
// layout, halo blocks zeroed) and K11 `_spmv_pallas_pp` /
// `_spmv_pallas_pp_stream` (y into the interior of a second buffer, whose
// halo blocks are never written); each TPU pair differs only in whether x
// fits VMEM.  All run on one row-tile kernel (`dia_rhs_kernel`): K16 is
// its case scale 1 without c, a pass of K14 the case with scale and an
// optional c, K10 and K11 a pass of K14 on one right-hand side without c,
// K10 with the rows of its two halo blocks written as zeros by the same
// launch.
//
// What bounds them on an H100: bytes, each diagonal word once and each
// right-hand side's x and y once (2.ndiags flops per 8 bytes at float32).
// The one-thread-per-row loops this replaces reached 55-74% of that
// bound in float32 and 30-44% in bf16, where their bytes halve and their
// time barely moves: they issued one 4-byte (2-byte in bf16) load per
// diagonal and right-hand side and row, unaligned at the +-1 offsets, and
// K14 / K16 re-read the diagonals once per block of right-hand sides.
// Here:
//
// - a thread owns V consecutive rows (V = 4 on float32 vectors, 8 on bf16:
//   16 bytes of each right-hand side) and moves each of its diagonal words,
//   x windows, c and y in 16-byte accesses (8-byte ones for bf16 diagonals
//   with float32 vectors).  A window x[i0 + off, + V) at an offset that is
//   not a multiple of V is cut from two aligned 16-byte loads (the second
//   one is the neighbouring thread's first, from L1), with the shift a
//   compile-time case: no unaligned access remains;
// - a block covers a row tile for a group of up to G right-hand sides
//   (G.V = 32 float32 sums a thread), and the blocks of one row tile's
//   groups are consecutive in the grid, so they run together and the
//   diagonal words come from device memory about once per call (the other
//   groups read them from L2).  A block that loops over all the groups of
//   its tile instead was slower on an H100 at every K tried (the blocks of
//   neighbouring tiles, whose rows the far offsets read from L2, drift
//   apart).  Where the blocks would not fill the card (small n, few
//   right-hand sides) the group shrinks, down to one right-hand side;
// - with more than one right-hand side the offsets sit in shared memory,
//   loaded once per block, up to kMaxDiags of them; a wider band reads the
//   rest from global memory (through L1), so no band is refused;
// - one right-hand side (K10, K11; K14 and K16 at K = 1) has instances of
//   its own (G = 1): no group loop, 30-40 registers, so more blocks stay
//   resident, and the offsets read through L1 instead of being staged, so
//   a block's first loads wait for no staging round and no barrier (on an
//   H100 the multi-right-hand-side instance took 1.4x the one-thread-per-row
//   kernel's time at poisson1024 in float32).  Issuing the loads of 2, 3, 4
//   or 8 diagonals before their terms did not pay there: the registers it
//   took cost more resident blocks than the loads in flight gained.  Where
//   the 16-byte instance's blocks would not fill the card (a short band of
//   many diagonals: orsirr_like150's 230 at n_pad 22,528 gave 44 blocks)
//   or the buffers are not aligned, a thread takes one row, the loop of
//   the one-thread-per-row kernel this replaces;
// - a thread whose window reaches past [x_lo, x_hi) reads that diagonal's
//   words one by one (zero outside), and a launch whose buffers are not
//   aligned to V elements (n_pad, a leading dimension, x_lo, x_hi or the
//   halo not a multiple of V, or a pointer off 16 bytes) takes the scalar
//   instance of the same kernel: the same sums in the same order;
// - K10's halo blocks: the grid covers rows [-halo, n_pad + halo), and a
//   thread whose rows lie outside [0, n_pad) stores zeros there (16 bytes
//   at a time in the vector instance) and reads nothing, so the output
//   needs no clearing pass: K10's buffer is written once.
//
// K14's k passes are k launches of the row-tile kernel through a
// caller-given [K, n_pad] scratch buffer, ordered so that the last pass
// lands in the output; rows outside [0, n_pad) are zero at every pass after
// the first, which reads x on [-P, n_pad + P).  Holding a row tile's
// windows in shared memory across the k passes in one launch instead
// recomputes 2.k.R overlap rows per tile and leaves most SMs idle: on an
// H100 that lost to these passes at 276 of 277 shapes.
//
// Element types (`dia_types.cuh`): every kernel is a template over the
// stored diagonals' type TD and the vectors' type TV, instances (float32,
// float32), (bf16, float32), (bf16, bf16) by the `types` code of the entry
// points; every multiply-add in float32, each result rounded once to TV
// where it is stored (K14 rounds every pass's iterate).  On bf16 buffers a
// product of two bf16 values is exact in float32, so a result has the
// plain versions' bits.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <utility>

#include "dia_types.cuh"

namespace {

using dia_types::bf16;
using dia_types::from_f;
using dia_types::to_f;
using dia_types::with_types;

constexpr int kRowThreads = 128;   // the row-tile kernel
constexpr int kSums = 32;          // the row-tile kernel: float32 sums a thread holds
constexpr int kFillBlocks = 3;     // ... blocks per SM below which its groups shrink (one
                                   // right-hand side: a thread takes one row)
constexpr int kOneRowThreads = 256;  // threads of a block that takes one row a thread
constexpr int kMaxDiags = 12288;   // offsets a block stages (48 KB of shared memory); any
                                   // past them are read from global memory

// K14's value of a row: scale.acc (+ c), each rounding explicit.  On
// float32 diagonals scale.acc + c is one fused multiply-add, on bf16 ones
// a multiply and an add: the roundings of the one-pass kernel this
// replaces (as nvcc contracted its float32 instance).
template <typename TD>
__device__ __forceinline__ float rhs_value(float acc, float scale, bool has_c, float c) {
  if constexpr (sizeof(TD) == 4) {
    return has_c ? __fmaf_rn(acc, scale, c) : __fmul_rn(acc, scale);
  } else {
    const float v = __fmul_rn(acc, scale);
    return has_c ? __fadd_rn(v, c) : v;
  }
}

// V consecutive elements at p (aligned to their size) as float32.
__device__ __forceinline__ void load_v(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void unpack2(unsigned u, float* o) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  o[0] = f.x; o[1] = f.y;
}
__device__ __forceinline__ void load_v(const bf16* p, float (&o)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  unpack2(u.x, o); unpack2(u.y, o + 2);
}
__device__ __forceinline__ void load_v(const bf16* p, float (&o)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  unpack2(u.x, o); unpack2(u.y, o + 2); unpack2(u.z, o + 4); unpack2(u.w, o + 6);
}
__device__ __forceinline__ void store_v(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}
__device__ __forceinline__ void store_v(bf16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                            pack2(v[4], v[5]), pack2(v[6], v[7]));
}

// One diagonal's terms for a group of right-hand sides, vector path: xb
// points at the aligned element j0 - R of the group's first right-hand
// side, R = (j0 mod V); the window x[j0, + V) is words R.. of the two
// aligned vectors at xb (one when R == 0).
template <int R, int V, int G, typename TV>
__device__ __forceinline__ void add_window(const TV* __restrict__ xb, long long ldx, int ng,
                                           const float (&dv)[V], float (&acc)[G][V]) {
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r < ng) {
      float a[V], b[V];
      load_v(xb + r * ldx, a);
      if constexpr (R != 0) load_v(xb + r * ldx + V, b);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xv = R + v < V ? a[(R + v) % V] : b[(R + v) % V];
        acc[r][v] = __fmaf_rn(dv[v], xv, acc[r][v]);
      }
    }
  }
}

template <int V, int G, typename TV, int... Rs>
__device__ __forceinline__ void add_shifted(int rem, const TV* __restrict__ xb, long long ldx,
                                            int ng, const float (&dv)[V], float (&acc)[G][V],
                                            std::integer_sequence<int, Rs...>) {
  ((rem == Rs ? add_window<Rs, V, G>(xb, ldx, ng, dv, acc) : void()), ...);
}

// The row-tile kernel: y_r[i] = scale.sum_s data[s, i].x_r[i + offs[s]]
// (+ c_r[i]) for rows i < n_pad of right-hand sides r < n_rhs, x_r = x +
// r.ldx read for x_lo <= j < x_hi (zero elsewhere), c_r = c + r.ldc, y_r =
// y + r.ldy; kPower false: K16's y_r[i] = sum (no scale, no c).  Rows
// -halo <= i < 0 and n_pad <= i < n_pad + halo of y_r get zeros (K10's
// halo blocks; halo 0 otherwise).  Block b takes row tile b / groups and
// the gsz (<= G) right-hand sides from gsz.(b % groups); its thread t owns
// rows i0 = V.(tile.blockDim + t) - halo + [0, V).  kVec: V = 16 bytes of
// TV, n_pad, the leading dimensions, x_lo, x_hi and halo multiples of V,
// and x, y, c aligned to 16 bytes and data to V words.  G == 1 without
// kVec takes V = 1: one row a thread.
template <bool kVec, bool kPower, int V, int G, typename TD, typename TV>
__global__ void __launch_bounds__(kOneRowThreads)
dia_rhs_kernel(const TD* __restrict__ data, long long n_pad,
               const int* __restrict__ offs, int ndiags,
               const TV* __restrict__ x, long long ldx, long long x_lo, long long x_hi,
               const TV* __restrict__ c, long long ldc, float scale,
               TV* __restrict__ y, long long ldy, long long halo, int n_rhs, int gsz) {
  // the offsets: G > 1 stages them in shared memory (up to kMaxDiags); one
  // right-hand side reads them through L1, so its data loads need not wait
  // for a staging round and a barrier
  extern __shared__ int offs_s[];
  if constexpr (G > 1) {
    for (int s = threadIdx.x; s < min(ndiags, kMaxDiags); s += blockDim.x) offs_s[s] = offs[s];
    __syncthreads();
  }
  const auto offset = [&](int s) {
    return G > 1 && s < kMaxDiags ? offs_s[s] : __ldg(offs + s);
  };
  const int groups = G == 1 ? 1 : (n_rhs + gsz - 1) / gsz;
  const long long i0 = (blockIdx.x / groups * static_cast<long long>(blockDim.x) + threadIdx.x)
                       * V - halo;
  if (i0 >= n_pad + halo) return;
  const int g0 = static_cast<int>(blockIdx.x % groups) * gsz;
  const int ng = min(gsz, n_rhs - g0);
  // K10's halo rows: zeros, and nothing read for them
  const bool outside = i0 + V <= 0 || i0 >= n_pad;
  if (halo > 0 && (outside || (!kVec && V > 1))) {
    for (int r = 0; r < ng; ++r) {
      TV* yr = y + (g0 + r) * ldy + i0;
      if constexpr (kVec) {
        const float zero[V] = {};
        store_v(yr, zero);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          if ((i0 + v < 0 || i0 + v >= n_pad) && i0 + v < n_pad + halo) yr[v] = from_f<TV>(0.f);
      }
    }
  }
  if (outside) return;
  const TV* xg = x + g0 * ldx;
  float acc[G][V];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  // the terms of diagonal s whose x window reaches past [x_lo, x_hi): words
  // one by one, zero outside the range
  const auto add_words = [&](int s, const float (&dv)[V]) {
    const long long j0 = i0 + offset(s);
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if (r < ng) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const long long j = j0 + v;
          const float xv = j >= x_lo && j < x_hi ? to_f(xg[r * ldx + j]) : 0.f;
          acc[r][v] = __fmaf_rn(dv[v], xv, acc[r][v]);
        }
      }
    }
  };
  if constexpr (G == 1 && !kVec) {       // one row a thread, inside [0, n_pad)
    static_assert(V == 1, "the scalar instance on one right-hand side takes one row a thread");
    const auto add = [&](int s) {
      const long long j = i0 + offset(s);
      const float xv = j >= x_lo && j < x_hi ? to_f(xg[j]) : 0.f;
      acc[0][0] = __fmaf_rn(to_f(data[s * n_pad + i0]), xv, acc[0][0]);
    };
    // a long band unrolled by 8, so 8 diagonals' loads are in flight (on
    // an H100, orsirr_like150's 230 diagonals: 9% less time than nvcc's
    // own unrolling in float32, 32% in bf16 x float32); a short one as nvcc
    // unrolls it (unrolling by 8 cost poisson1024's 5 diagonals 23%)
    if (ndiags >= 8) {
#pragma unroll 8
      for (int s = 0; s < ndiags; ++s) add(s);
    } else {
      for (int s = 0; s < ndiags; ++s) add(s);
    }
  } else {
    for (int s = 0; s < ndiags; ++s) {
      const int off = offset(s);
      const TD* ds = data + s * n_pad + i0;
      float dv[V];
      if constexpr (kVec) {
        load_v(ds, dv);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) dv[v] = i0 + v >= 0 && i0 + v < n_pad ? to_f(ds[v]) : 0.f;
      }
      const long long j0 = i0 + off;
      bool inside = false;
      if constexpr (kVec) inside = j0 >= x_lo && j0 + V <= x_hi;
      if (inside) {
        if constexpr (kVec) {
          const int rem = off & (V - 1);     // off mod V
          add_shifted<V, G>(rem, xg + (j0 - rem), ldx, ng, dv, acc,
                            std::make_integer_sequence<int, V>{});
        }
      } else {
        add_words(s, dv);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= ng) break;
    const long long row = g0 + r;
    float out[V], cv[V] = {};
    if constexpr (kPower) {
      if (c != nullptr) {
        if constexpr (kVec) {
          load_v(c + row * ldc + i0, cv);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v)
            cv[v] = i0 + v >= 0 && i0 + v < n_pad ? to_f(c[row * ldc + i0 + v]) : 0.f;
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = rhs_value<TD>(acc[r][v], scale, c != nullptr, cv[v]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = acc[r][v];
    }
    TV* yr = y + row * ldy + i0;
    if constexpr (kVec) {
      store_v(yr, out);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (i0 + v >= 0 && i0 + v < n_pad) yr[v] = from_f<TV>(out[v]);
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// One launch of the row-tile kernel (K16 when kPower is false, else a
// pass of K14, or K10 / K11 at n_rhs 1 without c); takes its vector
// instance where the buffers allow it.  On one right-hand side a thread
// takes one row (the scalar instance, 256 threads a block) where the
// buffers do not allow the vector instance or its blocks would not fill
// the card (a short band of many diagonals).
template <bool kPower, typename TD, typename TV>
cudaError_t launch_rows(const TD* data, long long n_pad, const int* offs, int ndiags,
                        const TV* x, long long ldx, long long x_lo, long long x_hi,
                        const TV* c, long long ldc, float scale, TV* y, long long ldy,
                        long long halo, int n_rhs, cudaStream_t st) {
  constexpr int V = 16 / sizeof(TV);
  constexpr int G = kSums / V;
  const bool vec = n_pad % V == 0 && ldx % V == 0 && ldy % V == 0 && x_lo % V == 0
                   && x_hi % V == 0 && halo % V == 0 && aligned(x, 16) && aligned(y, 16)
                   && aligned(data, V * sizeof(TD))
                   && (c == nullptr || (ldc % V == 0 && aligned(c, 16)));
  const long long rows = n_pad + 2 * halo;
  const auto threads = [](int v) { return v == 1 ? kOneRowThreads : kRowThreads; };
  const auto tiles = [&](int v) { return (rows + v * threads(v) - 1) / (v * threads(v)); };
  const long long want = static_cast<long long>(kFillBlocks) * sm_count();
  const auto launch = [&](auto kern, int v, long long blocks, int gsz) {
    const size_t smem = n_rhs > 1 ? sizeof(int) * std::min(ndiags, kMaxDiags) : 0;
    if (blocks > 0)
      kern<<<static_cast<unsigned>(blocks), threads(v), smem, st>>>(
          data, n_pad, offs, ndiags, x, ldx, x_lo, x_hi, c, ldc, scale, y, ldy, halo, n_rhs,
          gsz);
    return cudaGetLastError();
  };
  if (n_rhs == 1) {
    if (vec && tiles(V) >= want)
      return launch(dia_rhs_kernel<true, kPower, V, 1, TD, TV>, V, tiles(V), 1);
    return launch(dia_rhs_kernel<false, kPower, 1, 1, TD, TV>, 1, tiles(1), 1);
  }
  // G right-hand sides a block, fewer where the blocks would not fill the card
  int gsz = std::min(G, n_rhs);
  while (gsz > 1 && tiles(V) * ((n_rhs + gsz - 1) / gsz) < want) gsz = (gsz + 1) / 2;
  const long long blocks = tiles(V) * ((n_rhs + gsz - 1) / gsz);
  if (vec) return launch(dia_rhs_kernel<true, kPower, V, G, TD, TV>, V, blocks, gsz);
  return launch(dia_rhs_kernel<false, kPower, V, G, TD, TV>, V, blocks, gsz);
}

#define DIA_TYPES(t)                          \
  using TD = typename decltype(t)::Data;      \
  using TV = typename decltype(t)::Vec

}  // namespace

// The entry points take `types`, the (diagonal, vector) element types:
// 0 (float32, float32), 1 (bf16, float32), 2 (bf16, bf16); the output and
// every buffer have the vector type.

// K16.  xt points at logical column 0 of right-hand side 0; xt[r.ldx + j]
// is read for x_lo <= j < x_hi and is zero elsewhere (the padded buffer of
// `dia_pad_xt`: x_lo = -h, x_hi = n_pad + h; an unpadded [K][n_pad] one: 0,
// n_pad).  yt is [K][n_pad].
extern "C" int dia_spmm_t(const void* data, long long n_pad, const void* offs,
                          int ndiags, const void* xt, long long ldx, long long x_lo,
                          long long x_hi, int K, void* yt, int types, void* stream) {
  if (K < 1 || ndiags < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    return launch_rows<false>(static_cast<const TD*>(data), n_pad,
                              static_cast<const int*>(offs), ndiags,
                              static_cast<const TV*>(xt), ldx, x_lo, x_hi,
                              static_cast<const TV*>(nullptr), 0, 1.f,
                              static_cast<TV*>(yt), n_pad, 0, K,
                              static_cast<cudaStream_t>(stream));
  }));
}

// K14.  xq, cq (nullable) and zq are [n_rhs][P + n_pad + P] buffers; only
// zq's interiors are written.  k passes of the row-tile kernel, through
// `tmp` ([n_rhs][n_pad] elements; unused when k == 1).
extern "C" int dia_power_rhs(const void* data, long long n_pad, const void* offs,
                             int ndiags, const void* xq, const void* cq, void* zq,
                             long long P, int n_rhs, int k, float scale, void* tmp,
                             int types, void* stream) {
  if (n_rhs < 1 || k < 1 || ndiags < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    const TV* c = static_cast<const TV*>(cq);
    TV* z = static_cast<TV*>(zq);
    const long long ld = n_pad + 2 * P;
    const TV* src = static_cast<const TV*>(xq) + P;
    long long ld_src = ld;
    for (int p = 1; p <= k; ++p) {
      const bool last = (k - p) % 2 == 0;
      TV* dst = last ? z + P : static_cast<TV*>(tmp);
      const long long ld_dst = last ? ld : n_pad;
      const long long lo = p == 1 ? -P : 0, hi = p == 1 ? n_pad + P : n_pad;
      const cudaError_t err = launch_rows<true>(
          static_cast<const TD*>(data), n_pad, static_cast<const int*>(offs), ndiags, src,
          ld_src, lo, hi, c == nullptr ? nullptr : c + P, ld, scale, dst, ld_dst, 0, n_rhs,
          st);
      if (err != cudaSuccess) return err;
      src = dst;
      ld_src = ld_dst;
    }
    return cudaSuccess;
  }));
}

// K10 (zero_halo != 0) and K11: one launch of the row-tile kernel on one
// right-hand side.  xq and yq are [P + n_pad + P] buffers, x read on
// [-P, n_pad + P).  K11 writes yq's interior [P, P + n_pad) only; K10
// writes all of yq, the halo blocks as zeros.
extern "C" int dia_spmv_pp(const void* data, long long n_pad, const void* offs,
                           int ndiags, const void* xq, void* yq, long long P,
                           float scale, int zero_halo, int types, void* stream) {
  return static_cast<int>(with_types(types, [&](auto t) {
    DIA_TYPES(t);
    const long long ld = n_pad + 2 * P;
    return launch_rows<true>(static_cast<const TD*>(data), n_pad,
                             static_cast<const int*>(offs), ndiags,
                             static_cast<const TV*>(xq) + P, ld, -P, n_pad + P,
                             static_cast<const TV*>(nullptr), 0, scale,
                             static_cast<TV*>(yq) + P, ld, zero_halo ? P : 0, 1,
                             static_cast<cudaStream_t>(stream));
  }));
}
