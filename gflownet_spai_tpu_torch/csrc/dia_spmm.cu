// DIA sparse x dense product (SpMM) of the multi-RHS solvers:
//
//   K15  dia_spmm    Y = A.X          X, Y [n, K] row-major
//
// (K16, the product on right-hand sides held as rows, runs on `dia_rhs.cu`.)
//
// Storage is row-scaled: data[s, i] = A[i, i + offs[s]], [ndiags, n_pad]
// row-major; each output is sum_s data[s, i].X[i + offs[s]], summed in
// offset order from zero.
//
// K15 replaces gflownet_spai_tpu/ops/dia.py `_spmm_dia_pallas`, which
// double-buffers [tr + 2h, kb] windows of X into VMEM because a TPU core
// cannot address HBM from its vector unit.  Here a thread owns 4 adjacent
// columns of kR consecutive rows: per diagonal it issues kR independent
// 16-byte loads of X (rows i + off, neighbouring threads on neighbouring
// columns), and it stores kR float4 of Y.  A block of qx x ty threads covers
// 4.qx columns of ty.kR rows and first stages those rows' data[s, i] words in
// shared memory,
// so each diagonal word is read from device memory once per column tile.  The
// grid walks the column tiles of a row block, then the next row block, so
// the rows i + off that neighbouring blocks read again come from L2 (at
// poisson1024 a halo of 1,024 rows x 1 KB).  A scalar path (4 single loads
// per thread) serves a K that is not a multiple of 4 or an X or Y that is
// not 16-byte aligned.
//
// It takes any K (the TPU's K >= 128, K % 128 == 0 rule is a VMEM
// condition).  What bounds it on an H100: bytes of X and Y (2.ndiags flops
// per 8 bytes moved per element at ndiags = 5, per 4 on bf16 vectors); it
// also reads each X row ndiags times, from L1 or L2 after the first.
//
// Element types (`dia_types.cuh`): it is a template over the stored
// diagonals' type TD and the vectors' type TV, instances (float32,
// float32), (bf16, float32) and (bf16, bf16) by the `types` code of the
// entry points; products and sums in float32, each output rounded once to
// TV.  It stages its diagonal words in shared memory as TD (2 bytes each
// in bf16), and its vector path moves 4 columns a thread: one 16-byte
// load or store of float32, one 8-byte one of bf16 (X and Y then need
// 8-byte alignment).

#include <cuda_runtime.h>

#include "dia_types.cuh"

namespace {

using dia_types::bf16;
using dia_types::from_f;
using dia_types::to_f;
using dia_types::with_types;

constexpr int kMaxDiags = 1024;  // K15: staged diagonals per block
constexpr int kSpmmThreads = 256;  // K15: threads per block (at most)
constexpr int kSpmmSmem = 227 * 1024;  // K15: shared memory a block may use
constexpr int kR = 4;            // K15: rows per thread (4 ran faster than 8 on an H100)

// Four adjacent columns of X or Y as float32: one 16-byte access of
// float32, one 8-byte access of bf16 (the lower column in the low bits).
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                            *reinterpret_cast<const unsigned*>(&b));
}

// Block (qx, ty) of K15: row block b / col_tiles, column tile b % col_tiles;
// thread (tx, ty) owns columns 4.(tile.qx + tx) + 0..3 of rows
// row0 + ty.kR + 0..kR-1.  Shared memory: dv [ndiags][rows] (TD) and the
// offsets.
template <bool VEC, typename TD, typename TV>
__global__ void __launch_bounds__(kSpmmThreads)
dia_spmm_kernel(const TD* __restrict__ data, long long n_pad,
                const int* __restrict__ offs, int ndiags,
                const TV* __restrict__ x, long long n, int K, int col_tiles,
                TV* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char spmm_smem[];
  TD* dv = reinterpret_cast<TD*>(spmm_smem);
  const int rows = blockDim.y * kR;
  int* off_s = reinterpret_cast<int*>(dv + ndiags * rows);
  const long long row0 = static_cast<long long>(blockIdx.x / col_tiles) * rows;
  const int c = 4 * ((blockIdx.x % col_tiles) * blockDim.x + threadIdx.x);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int e = tid; e < ndiags * rows; e += nt) {
    const long long i = row0 + e % rows;
    dv[e] = i < n ? data[(e / rows) * n_pad + i] : from_f<TD>(0.f);
  }
  for (int s = tid; s < ndiags; s += nt) off_s[s] = offs[s];
  __syncthreads();
  const int r0 = threadIdx.y * kR;
  const long long ib = row0 + r0;
  if (ib >= n || c >= K) return;
  float4 acc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
  for (int s = 0; s < ndiags; ++s) {
    const long long j0 = ib + off_s[s];
    const TD* dvs = dv + s * rows + r0;
    float4 xv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const long long j = j0 + r;
      const bool in = j >= 0 && j < n;
      if constexpr (VEC) {
        xv[r] = in ? load4(x + j * K + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        const TV* xr = x + j * K + c;
        xv[r].x = in ? to_f(__ldg(xr)) : 0.f;
        xv[r].y = in && c + 1 < K ? to_f(__ldg(xr + 1)) : 0.f;
        xv[r].z = in && c + 2 < K ? to_f(__ldg(xr + 2)) : 0.f;
        xv[r].w = in && c + 3 < K ? to_f(__ldg(xr + 3)) : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float d = to_f(dvs[r]);
      acc[r].x = fmaf(d, xv[r].x, acc[r].x);
      acc[r].y = fmaf(d, xv[r].y, acc[r].y);
      acc[r].z = fmaf(d, xv[r].z, acc[r].z);
      acc[r].w = fmaf(d, xv[r].w, acc[r].w);
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const long long i = ib + r;
    if (i >= n) break;
    TV* yr = y + i * K + c;
    if constexpr (VEC) {
      store4(yr, acc[r]);
    } else {
      yr[0] = from_f<TV>(acc[r].x);
      if (c + 1 < K) yr[1] = from_f<TV>(acc[r].y);
      if (c + 2 < K) yr[2] = from_f<TV>(acc[r].z);
      if (c + 3 < K) yr[3] = from_f<TV>(acc[r].w);
    }
  }
}

template <bool VEC, typename TD, typename TV>
cudaError_t launch_spmm(const TD* data, long long n_pad, const int* offs, int ndiags,
                        const TV* x, long long n, int K, TV* y, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        dia_spmm_kernel<VEC, TD, TV>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSpmmSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  // qx threads along the columns (a power of two up to 32, covering K / 4),
  // ty row groups: as many as the threads and the staged diagonals allow
  const int quads = (K + 3) / 4;
  int qx = 1;
  while (qx < 32 && qx < quads) qx *= 2;
  int ty = kSpmmThreads / qx;
  // shared memory: ndiags rows of TD words and the offsets
  auto smem_of = [&](int t) {
    return static_cast<size_t>(ndiags) * (sizeof(TD) * t * kR + sizeof(int));
  };
  while (ty > 1 && smem_of(ty) > static_cast<size_t>(kSpmmSmem)) ty /= 2;
  const int rows = ty * kR;
  const int col_tiles = (quads + qx - 1) / qx;
  const long long blocks = (n + rows - 1) / rows * col_tiles;
  dia_spmm_kernel<VEC, TD, TV><<<static_cast<unsigned>(blocks), dim3(qx, ty), smem_of(ty),
                                 st>>>(data, n_pad, offs, ndiags, x, n, K, col_tiles, y);
  return cudaGetLastError();
}

}  // namespace

// The entry point takes `types`, the (diagonal, vector) element types:
// 0 (float32, float32), 1 (bf16, float32), 2 (bf16, bf16).

// K15.  x, y: [n, K] row-major; ndiags <= kMaxDiags; vec: K % 4 == 0 and
// x, y aligned to 4 elements (16 bytes of float32, 8 of bf16).
extern "C" int dia_spmm(const void* data, long long n_pad, const void* offs,
                        int ndiags, const void* x, long long n, int K, void* y, int vec,
                        int types, void* stream) {
  if (ndiags < 1 || ndiags > kMaxDiags || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const auto* o = static_cast<const int*>(offs);
  auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(types, [&](auto t) {
    using TD = typename decltype(t)::Data;
    using TV = typename decltype(t)::Vec;
    const auto* d = static_cast<const TD*>(data);
    const auto* xx = static_cast<const TV*>(x);
    auto* yy = static_cast<TV*>(y);
    return vec ? launch_spmm<true>(d, n_pad, o, ndiags, xx, n, K, yy, st)
               : launch_spmm<false>(d, n_pad, o, ndiags, xx, n, K, yy, st);
  }));
}
