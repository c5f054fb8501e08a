// DIA (diagonal-format) SpMV kernels of the validation path and the solvers:
//
//   K8   dia_spmv       y = A.x                  (one pass over the diagonals)
//   K10  dia_spmv_pp    y = scale.A.x in x's padded layout, halo blocks zeroed
//   K11  dia_spmv_pp    y = scale.A.x into the interior of a second buffer
//   K12  dia_power      z = (scale.A)^k.x, or k affine passes cur <- scale.A.cur + c
//   K13  dia_cheby      k Chebyshev steps  dd <- a_p.dd + b_p.(r - A.z);  z <- z + dd
//   K14  dia_power_rhs  K12 on K right-hand sides at once
//
// Storage is row-scaled: data[s, i] = A[i, i + offs[s]], [ndiags, n_pad]
// row-major.  x is read as zero outside the range the caller gives.
//
// K8 replaces gflownet_spai_tpu/ops/dia.py `_spmv_pallas` (x resident in
// VMEM) and its VMEM-fitting variants `_spmv_pallas_stream` (host-side halo
// tensor) and `_spmv_pallas_stream2` (in-kernel window DMAs).  A TPU kernel
// must stage x in VMEM and slice every diagonal statically; a GPU reads x
// from global memory, where L2 (50 MB) holds the vector, so one kernel with
// no staging serves every matrix, whatever its halo.  One thread per output
// row loops over the diagonals: neighbouring threads read neighbouring words
// of each diagonal and of x, so every load coalesces.  What bounds it on an
// H100: bytes (2 flops per 4-byte diagonal word).  Nothing is sized by the
// halo, so a matrix whose halo is nearly the whole vector (a reordered
// unstructured matrix with 230 diagonals) takes the same path.
//
// K12 replaces `_spmv_pallas_power` (x resident) and `_spmv_pallas_power_stream`
// (x and c streamed by window DMAs); K13 replaces `_spmv_pallas_cheby`.  Each
// has two modes, chosen by the caller through `tr`:
//
// - tiled (tr > 0): temporal blocking.  Each block owns `tr` output rows and
//   computes k dependent passes in shared memory over a window that shrinks
//   by the matrix's true reach R = max|off| per pass (rows t0 - (k-p).R ..
//   t0 + tr + (k-p).R at pass p), so the iterate never goes back to device
//   memory between passes.  The overlap rows are computed redundantly by the
//   neighbouring blocks.  The window is 2.(tr + 2.k.R) words, so this mode
//   needs k.R below about 14,000 words of shared memory.
// - streamed (tr == 0): k launches of a one-pass kernel, the iterate
//   ping-ponging through global memory between the output buffer and a
//   caller-given [n_pad] scratch buffer, ordered so that the last pass
//   lands in the output.  It serves any reach and k (a 2D Poisson grid
//   above ~1800^2 at k = 8), which is what the TPU's streamed variant is for.
//
// In both, rows outside [0, n_pad) read as zero at every pass after the
// first, as the reference's zero re-padding does.  The diagonals are read
// from global memory (d.data directly: the per-tile widened copy
// `dia_power_data` existed only for Mosaic's block mapping).  What bounds
// them on an H100: bytes of the diagonals, once per k passes when tiled
// (while the redundant overlap rows stay small against tr; at the slice's
// shapes the overlap re-reads hit L2), k times when streamed.
//
// K10 and K11 (dia_spmv_pp) replace `_spmv_pallas_io` / `_spmv_pallas_io_stream`
// (y in x's padded layout, halo blocks zeroed) and `_spmv_pallas_pp` /
// `_spmv_pallas_pp_stream` (y into the interior of a second buffer, whose
// halo blocks are never written).  Each TPU pair differs only in whether x
// fits VMEM; here both are K8's one-thread-per-row SpMV with `scale`,
// writing at the pad offset P.  K10's threads that fall on the halo blocks
// write their zeros in the same launch.  Bound by bytes, as K8.
//
// K14 (dia_power_rhs) replaces `_spmv_pallas_power_rhs`: K12 on K
// right-hand sides, [K, P + n_pad + P] row-major buffers.  Each thread owns
// one row and keeps up to kRhs sums in registers, so a diagonal word read
// once serves every right-hand side of its block: the diagonals' traffic
// drops by that factor, which is what the TPU kernel is for.  Modes as K12:
// tiled (one block per row tile and block of kb <= kRhs right-hand sides,
// their kb windows in shared memory across the k passes) or streamed (k
// launches of the batched one-pass kernel through a [K, n_pad] scratch
// buffer); k = 1 is one batched pass.  Bound by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // K8, K10, K11, K14's one-pass kernel
constexpr int kTileThreads = 512;  // K12, K13, K14 tiled
constexpr int kMaxPasses = 32;
constexpr int kRhs = 8;            // K14: right-hand sides per block

struct Coeffs {
  float a[kMaxPasses];
  float b[kMaxPasses];
};

// y[i] = scale.sum_s data[s, i].x[i + offs[s]] (+ c[i]) for i < rows: K8 at
// scale 1 with no c, and one pass of K12's streamed mode.
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const float* __restrict__ data, long long ld,
                const int* __restrict__ offs, int ndiags,
                const float* __restrict__ x, long long x_lo, long long x_hi,
                const float* __restrict__ c, float scale,
                float* __restrict__ y, long long rows) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= rows) return;
  float acc = 0.f;
  for (int s = 0; s < ndiags; ++s) {
    const long long j = i + offs[s];
    const float xv = (j >= x_lo && j < x_hi) ? x[j] : 0.f;
    acc += data[s * ld + i] * xv;
  }
  float v = acc * scale;
  if (c != nullptr) v += c[i];
  y[i] = v;
}

// K10 and K11: thread t owns buffer row i = t - pad.  Rows in [0, rows) get
// scale.sum_s data[s, i].x[i + offs[s]]; with pad = P (K10) the rows of the
// two halo blocks [-P, 0) and [rows, rows + P) get zeros.
__global__ void __launch_bounds__(kThreads)
dia_spmv_pp_kernel(const float* __restrict__ data, long long ld,
                   const int* __restrict__ offs, int ndiags,
                   const float* __restrict__ x, long long x_lo, long long x_hi,
                   float scale, float* __restrict__ y, long long rows, long long pad) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x - pad;
  if (i >= rows + pad) return;
  if (i < 0 || i >= rows) {
    y[i] = 0.f;
    return;
  }
  float acc = 0.f;
  for (int s = 0; s < ndiags; ++s) {
    const long long j = i + offs[s];
    const float xv = (j >= x_lo && j < x_hi) ? x[j] : 0.f;
    acc += data[s * ld + i] * xv;
  }
  y[i] = acc * scale;
}

// One pass of K14 over rows [0, n_pad) of K right-hand sides: for each r,
// y_r[i] = scale.sum_s data[s, i].x_r[i + offs[s]] (+ c_r[i]), x_r = x + r.ldx
// read for x_lo <= j < x_hi.  Block b covers kThreads rows and right-hand
// sides [kRhs.(b % rhs_blocks), +kRhs): consecutive blocks share their rows,
// so the diagonal words they re-read come from L2.
__global__ void __launch_bounds__(kThreads)
dia_spmv_rhs_kernel(const float* __restrict__ data, long long n_pad,
                    const int* __restrict__ offs, int ndiags,
                    const float* __restrict__ x, long long ldx, long long x_lo,
                    long long x_hi, const float* __restrict__ c, long long ldc,
                    float scale, float* __restrict__ y, long long ldy, int n_rhs,
                    unsigned rhs_blocks) {
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
    if (j < x_lo || j >= x_hi) continue;   // adds 0.f: the sums are unchanged
    const float dv = data[s * n_pad + i];
#pragma unroll
    for (int r = 0; r < kRhs; ++r)
      if (r < nr) acc[r] += dv * x[(r0 + r) * ldx + j];
  }
#pragma unroll
  for (int r = 0; r < kRhs; ++r) {
    if (r < nr) {
      float v = acc[r] * scale;
      if (c != nullptr) v += c[(r0 + r) * ldc + i];
      y[(r0 + r) * ldy + i] = v;
    }
  }
}

// One pass of K13's streamed mode over rows [0, n_pad): t = A.z,
// dd <- a.dd + b.(r - t), z_out = z + dd.  dd_in may be dd_out (each
// thread reads and writes only its own row there).
__global__ void __launch_bounds__(kThreads)
dia_cheby_pass_kernel(const float* __restrict__ data, long long n_pad,
                      const int* __restrict__ offs, int ndiags,
                      const float* __restrict__ z, long long z_lo, long long z_hi,
                      const float* dd_in, const float* __restrict__ r,
                      float* __restrict__ z_out, float* dd_out, float a, float b) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= n_pad) return;
  float t = 0.f;
  for (int s = 0; s < ndiags; ++s) {
    const long long j = i + offs[s];
    const float zv = (j >= z_lo && j < z_hi) ? z[j] : 0.f;
    t += data[s * n_pad + i] * zv;
  }
  const float dn = a * dd_in[i] + b * (r[i] - t);
  z_out[i] = z[i] + dn;
  dd_out[i] = dn;
}

// One block per `tr` output rows.  smem: cur[W], nxt[W], offs[ndiags] with
// W = tr + 2.k.R; window index i holds row base + i, base = t0 - k.R.
template <bool kAffine>
__global__ void __launch_bounds__(kTileThreads)
dia_power_kernel(const float* __restrict__ data, long long n_pad,
                 const int* __restrict__ offs, int ndiags, int reach,
                 const float* __restrict__ xq, const float* __restrict__ cq,
                 float* __restrict__ zq, long long P, int k, float scale,
                 int tr) {
  extern __shared__ float smem[];
  const int W = tr + 2 * k * reach;
  float* cur = smem;
  float* nxt = smem + W;
  int* offs_s = reinterpret_cast<int*>(smem + 2 * W);
  const long long t0 = static_cast<long long>(blockIdx.x) * tr;
  const long long base = t0 - static_cast<long long>(k) * reach;
  for (int s = threadIdx.x; s < ndiags; s += blockDim.x) offs_s[s] = offs[s];
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long long row = base + i;
    cur[i] = (row >= -P && row < n_pad + P) ? xq[P + row] : 0.f;
  }
  __syncthreads();
  for (int p = 1; p <= k; ++p) {
    const int hi = W - p * reach;
    for (int i = p * reach + threadIdx.x; i < hi; i += blockDim.x) {
      const long long row = base + i;
      float v = 0.f;
      if (row >= 0 && row < n_pad) {
        float acc = 0.f;
        for (int s = 0; s < ndiags; ++s)
          acc += data[s * n_pad + row] * cur[i + offs_s[s]];
        v = acc * scale;
        if (kAffine) v += cq[P + row];
      }
      nxt[i] = v;
    }
    __syncthreads();
    float* const done = cur;
    cur = nxt;
    nxt = done;
  }
  for (int i = threadIdx.x; i < tr; i += blockDim.x) {
    const long long row = t0 + i;
    if (row < n_pad) zq[P + row] = cur[k * reach + i];
  }
}

// K14 tiled: block (blockIdx.x, blockIdx.y) owns rows [t0, t0 + tr) of
// right-hand sides [kb.blockIdx.y, +kb).  smem: cur[kb][W], nxt[kb][W],
// offs[ndiags] with W = tr + 2.k.R, window index i holding row t0 - k.R + i;
// buffers are [n_rhs][ld], ld = P + n_pad + P.
template <bool kAffine>
__global__ void __launch_bounds__(kTileThreads)
dia_power_rhs_kernel(const float* __restrict__ data, long long n_pad,
                     const int* __restrict__ offs, int ndiags, int reach,
                     const float* __restrict__ xq, const float* __restrict__ cq,
                     float* __restrict__ zq, long long P, int n_rhs, int k,
                     float scale, int tr, int kb) {
  extern __shared__ float smem[];
  const int W = tr + 2 * k * reach;
  const long long ld = n_pad + 2 * P;
  const int r0 = blockIdx.y * kb;
  const int nr = min(kb, n_rhs - r0);
  float* cur = smem;
  float* nxt = smem + static_cast<long long>(kb) * W;
  int* offs_s = reinterpret_cast<int*>(smem + 2LL * kb * W);
  const long long t0 = static_cast<long long>(blockIdx.x) * tr;
  const long long base = t0 - static_cast<long long>(k) * reach;
  for (int s = threadIdx.x; s < ndiags; s += blockDim.x) offs_s[s] = offs[s];
  for (int e = threadIdx.x; e < nr * W; e += blockDim.x) {
    const int r = e / W, i = e % W;
    const long long row = base + i;
    cur[e] = (row >= -P && row < n_pad + P) ? xq[(r0 + r) * ld + P + row] : 0.f;
  }
  __syncthreads();
  for (int p = 1; p <= k; ++p) {
    const int hi = W - p * reach;
    for (int i = p * reach + threadIdx.x; i < hi; i += blockDim.x) {
      const long long row = base + i;
      float acc[kRhs];
#pragma unroll
      for (int r = 0; r < kRhs; ++r) acc[r] = 0.f;
      const bool inside = row >= 0 && row < n_pad;
      if (inside) {
        for (int s = 0; s < ndiags; ++s) {
          const float dv = data[s * n_pad + row];
          const int j = i + offs_s[s];
#pragma unroll
          for (int r = 0; r < kRhs; ++r)
            if (r < nr) acc[r] += dv * cur[r * W + j];
        }
      }
#pragma unroll
      for (int r = 0; r < kRhs; ++r) {
        if (r < nr) {
          float v = 0.f;
          if (inside) {
            v = acc[r] * scale;
            if (kAffine) v += cq[(r0 + r) * ld + P + row];
          }
          nxt[r * W + i] = v;
        }
      }
    }
    __syncthreads();
    float* const done = cur;
    cur = nxt;
    nxt = done;
  }
  for (int e = threadIdx.x; e < nr * tr; e += blockDim.x) {
    const int r = e / tr, i = e % tr;
    const long long row = t0 + i;
    if (row < n_pad) zq[(r0 + r) * ld + P + row] = cur[r * W + k * reach + i];
  }
}

// One block per `tr` output rows.  smem: z0[Wz], z1[Wz], dd[Wd], offs with
// Wz = tr + 2.k.R (rows from t0 - k.R) and Wd = tr + 2.(k-1).R (rows from
// t0 - (k-1).R): z window index iz is dd index iz - R.
__global__ void __launch_bounds__(kTileThreads)
dia_cheby_kernel(const float* __restrict__ data, long long n_pad,
                 const int* __restrict__ offs, int ndiags, int reach,
                 const float* __restrict__ zq, const float* __restrict__ ddq,
                 const float* __restrict__ rq, float* __restrict__ z_out,
                 float* __restrict__ dd_out, long long P, int k, Coeffs cf,
                 int tr) {
  extern __shared__ float smem[];
  const int Wz = tr + 2 * k * reach;
  const int Wd = tr + 2 * (k - 1) * reach;
  float* cur = smem;
  float* nxt = smem + Wz;
  float* dd = smem + 2 * Wz;
  int* offs_s = reinterpret_cast<int*>(dd + Wd);
  const long long t0 = static_cast<long long>(blockIdx.x) * tr;
  const long long base = t0 - static_cast<long long>(k) * reach;
  for (int s = threadIdx.x; s < ndiags; s += blockDim.x) offs_s[s] = offs[s];
  for (int i = threadIdx.x; i < Wz; i += blockDim.x) {
    const long long row = base + i;
    cur[i] = (row >= -P && row < n_pad + P) ? zq[P + row] : 0.f;
  }
  for (int i = threadIdx.x; i < Wd; i += blockDim.x) {
    const long long row = base + reach + i;
    dd[i] = (row >= 0 && row < n_pad) ? ddq[P + row] : 0.f;
  }
  __syncthreads();
  for (int p = 1; p <= k; ++p) {
    const float a = cf.a[p - 1], b = cf.b[p - 1];
    const int hi = Wz - p * reach;
    for (int i = p * reach + threadIdx.x; i < hi; i += blockDim.x) {
      const long long row = base + i;
      float zn = 0.f, dn = 0.f;
      if (row >= 0 && row < n_pad) {
        float t = 0.f;
        for (int s = 0; s < ndiags; ++s)
          t += data[s * n_pad + row] * cur[i + offs_s[s]];
        dn = a * dd[i - reach] + b * (rq[P + row] - t);
        zn = cur[i] + dn;
      }
      dd[i - reach] = dn;   // only this thread reads or writes this index
      nxt[i] = zn;
    }
    __syncthreads();
    float* const done = cur;
    cur = nxt;
    nxt = done;
  }
  for (int i = threadIdx.x; i < tr; i += blockDim.x) {
    const long long row = t0 + i;
    if (row < n_pad) {
      z_out[P + row] = cur[k * reach + i];
      dd_out[P + row] = dd[(k - 1) * reach + i];
    }
  }
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

size_t g_power_smem[2] = {0, 0};
size_t g_power_rhs_smem[2] = {0, 0};
size_t g_cheby_smem = 0;

unsigned row_blocks(long long rows) {
  return static_cast<unsigned>((rows + kThreads - 1) / kThreads);
}

}  // namespace

// K8.  `x` points at logical index 0 of the vector; x[j] is read for
// x_lo <= j < x_hi and is zero elsewhere.  y gets `rows` rows.
extern "C" int dia_spmv(const void* data, long long ld, const void* offs,
                        int ndiags, const void* x, long long x_lo,
                        long long x_hi, void* y, long long rows, void* stream) {
  if (rows > 0) {
    dia_spmv_kernel<<<row_blocks(rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(data), ld, static_cast<const int*>(offs), ndiags,
        static_cast<const float*>(x), x_lo, x_hi, nullptr, 1.f, static_cast<float*>(y),
        rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// K12.  xq, cq (nullable) and zq are [P + n_pad + P] buffers; only zq's
// interior [P, P + n_pad) is written.  tr > 0: tiled, `tr` rows per block;
// tr == 0: streamed, through `tmp` ([n_pad] floats; unused when k == 1).
extern "C" int dia_power(const void* data, long long n_pad, const void* offs,
                         int ndiags, int reach, const void* xq, const void* cq,
                         void* zq, long long P, int k, float scale, int tr,
                         void* tmp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dat = static_cast<const float*>(data);
  const int* off = static_cast<const int*>(offs);
  const float* x = static_cast<const float*>(xq);
  const float* c = static_cast<const float*>(cq);
  float* z = static_cast<float*>(zq);
  if (tr == 0) {
    const float* src = x + P;
    for (int p = 1; p <= k; ++p) {
      float* dst = (k - p) % 2 == 0 ? z + P : static_cast<float*>(tmp);
      const long long lo = p == 1 ? -P : 0, hi = p == 1 ? n_pad + P : n_pad;
      dia_spmv_kernel<<<row_blocks(n_pad), kThreads, 0, st>>>(
          dat, n_pad, off, ndiags, src, lo, hi, c == nullptr ? nullptr : c + P, scale,
          dst, n_pad);
      src = dst;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * 2 * (tr + 2 * static_cast<size_t>(k) * reach)
                      + sizeof(int) * ndiags;
  const unsigned blocks = static_cast<unsigned>((n_pad + tr - 1) / tr);
  cudaError_t err;
  if (c != nullptr) {
    err = opt_in_smem(dia_power_kernel<true>, smem, &g_power_smem[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    dia_power_kernel<true><<<blocks, kTileThreads, smem, st>>>(
        dat, n_pad, off, ndiags, reach, x, c, z, P, k, scale, tr);
  } else {
    err = opt_in_smem(dia_power_kernel<false>, smem, &g_power_smem[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    dia_power_kernel<false><<<blocks, kTileThreads, smem, st>>>(
        dat, n_pad, off, ndiags, reach, x, nullptr, z, P, k, scale, tr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K13.  zq, ddq, rq, z_out, dd_out are [P + n_pad + P] buffers; `coeffs`
// is a host array a_1, b_1, ..., a_k, b_k (k <= 32).  Only the interiors of
// z_out and dd_out are written.  tr > 0: tiled, `tr` rows per block;
// tr == 0: streamed, through `tmp` ([n_pad] floats; unused when k == 1).
extern "C" int dia_cheby(const void* data, long long n_pad, const void* offs,
                         int ndiags, int reach, const void* zq, const void* ddq,
                         const void* rq, void* z_out, void* dd_out, long long P,
                         int k, const float* coeffs, int tr, void* tmp, void* stream) {
  if (k < 1 || k > kMaxPasses) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dat = static_cast<const float*>(data);
  const int* off = static_cast<const int*>(offs);
  const float* z = static_cast<const float*>(zq);
  const float* r = static_cast<const float*>(rq);
  float* zo = static_cast<float*>(z_out);
  float* ddo = static_cast<float*>(dd_out);
  if (tr == 0) {
    const float* src = z + P;
    const float* dd = static_cast<const float*>(ddq) + P;
    for (int p = 1; p <= k; ++p) {
      float* dst = (k - p) % 2 == 0 ? zo + P : static_cast<float*>(tmp);
      const long long lo = p == 1 ? -P : 0, hi = p == 1 ? n_pad + P : n_pad;
      dia_cheby_pass_kernel<<<row_blocks(n_pad), kThreads, 0, st>>>(
          dat, n_pad, off, ndiags, src, lo, hi, dd, r + P, dst, ddo + P,
          coeffs[2 * p - 2], coeffs[2 * p - 1]);
      src = dst;
      dd = ddo + P;
    }
    return static_cast<int>(cudaGetLastError());
  }
  Coeffs cf;
  for (int p = 0; p < k; ++p) {
    cf.a[p] = coeffs[2 * p];
    cf.b[p] = coeffs[2 * p + 1];
  }
  const size_t smem =
      sizeof(float) * (2 * (tr + 2 * static_cast<size_t>(k) * reach)
                       + tr + 2 * static_cast<size_t>(k - 1) * reach)
      + sizeof(int) * ndiags;
  cudaError_t err = opt_in_smem(dia_cheby_kernel, smem, &g_cheby_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_pad + tr - 1) / tr);
  dia_cheby_kernel<<<blocks, kTileThreads, smem, st>>>(
      dat, n_pad, off, ndiags, reach, z, static_cast<const float*>(ddq), r, zo, ddo, P,
      k, cf, tr);
  return static_cast<int>(cudaGetLastError());
}

// K10 (zero_halo != 0) and K11.  xq and yq are [P + n_pad + P] buffers.
// K11 writes yq's interior [P, P + n_pad) only; K10 writes all of yq, the
// halo blocks as zeros.
extern "C" int dia_spmv_pp(const void* data, long long n_pad, const void* offs,
                           int ndiags, const void* xq, void* yq, long long P,
                           float scale, int zero_halo, void* stream) {
  const long long pad = zero_halo ? P : 0;
  dia_spmv_pp_kernel<<<row_blocks(n_pad + 2 * pad), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), n_pad, static_cast<const int*>(offs), ndiags,
      static_cast<const float*>(xq) + P, -P, n_pad + P, scale,
      static_cast<float*>(yq) + P, n_pad, pad);
  return static_cast<int>(cudaGetLastError());
}

// K14.  xq, cq (nullable) and zq are [n_rhs][P + n_pad + P] buffers; only
// zq's interiors are written.  k == 1 or tr == 0: k batched passes, through
// `tmp` ([n_rhs][n_pad] floats; unused when k == 1); else tiled, `tr` rows
// and `kb` (<= kRhs) right-hand sides per block.
extern "C" int dia_power_rhs(const void* data, long long n_pad, const void* offs,
                             int ndiags, int reach, const void* xq, const void* cq,
                             void* zq, long long P, int n_rhs, int k, float scale,
                             int tr, int kb, void* tmp, void* stream) {
  if (n_rhs < 1 || k < 1 || kb < 1 || kb > kRhs)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dat = static_cast<const float*>(data);
  const int* off = static_cast<const int*>(offs);
  const float* x = static_cast<const float*>(xq);
  const float* c = static_cast<const float*>(cq);
  float* z = static_cast<float*>(zq);
  const long long ld = n_pad + 2 * P;
  if (tr == 0 || k == 1) {
    const unsigned rhs_blocks = static_cast<unsigned>((n_rhs + kRhs - 1) / kRhs);
    const float* src = x + P;
    long long ld_src = ld;
    for (int p = 1; p <= k; ++p) {
      const bool last = (k - p) % 2 == 0;
      float* dst = last ? z + P : static_cast<float*>(tmp);
      const long long ld_dst = last ? ld : n_pad;
      const long long lo = p == 1 ? -P : 0, hi = p == 1 ? n_pad + P : n_pad;
      dia_spmv_rhs_kernel<<<row_blocks(n_pad) * rhs_blocks, kThreads, 0, st>>>(
          dat, n_pad, off, ndiags, src, ld_src, lo, hi, c == nullptr ? nullptr : c + P,
          ld, scale, dst, ld_dst, n_rhs, rhs_blocks);
      src = dst;
      ld_src = ld_dst;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(kb)
                          * (tr + 2 * static_cast<size_t>(k) * reach)
                      + sizeof(int) * ndiags;
  const dim3 grid(static_cast<unsigned>((n_pad + tr - 1) / tr),
                  static_cast<unsigned>((n_rhs + kb - 1) / kb));
  cudaError_t err;
  if (c != nullptr) {
    err = opt_in_smem(dia_power_rhs_kernel<true>, smem, &g_power_rhs_smem[1]);
    if (err != cudaSuccess) return static_cast<int>(err);
    dia_power_rhs_kernel<true><<<grid, kTileThreads, smem, st>>>(
        dat, n_pad, off, ndiags, reach, x, c, z, P, n_rhs, k, scale, tr, kb);
  } else {
    err = opt_in_smem(dia_power_rhs_kernel<false>, smem, &g_power_rhs_smem[0]);
    if (err != cudaSuccess) return static_cast<int>(err);
    dia_power_rhs_kernel<false><<<grid, kTileThreads, smem, st>>>(
        dat, n_pad, off, ndiags, reach, x, nullptr, z, P, n_rhs, k, scale, tr, kb);
  }
  return static_cast<int>(cudaGetLastError());
}
