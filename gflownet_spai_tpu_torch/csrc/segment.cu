// K3: windowed source-row gather, vals[src] per edge slot, and its
// transpose K4 (the windowed scatter-add of the backward pass, below); then
// the tile segment ops K5 (softmax), K6 (sum) and K7 (broadcast) at the end
// of the file.
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

// K4, the transpose of K3: one thread per (slot, channel) of the cotangent
// g; in-window slots add their row into dv[blk*win + lsrc] (rows >= n are
// dropped), misses and padding add nothing.
__global__ void __launch_bounds__(kThreads)
scatter_win_kernel(const int* __restrict__ lsrc, const int* __restrict__ blk,
                   const float* __restrict__ g, float* __restrict__ dv,
                   long long total, int S, int D, int win, int n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long slot = i / D;
  const int c = static_cast<int>(i - slot * D);
  const int l = lsrc[slot];
  if (l < 0 || l >= 2 * win) return;
  const long long r = static_cast<long long>(blk[slot / S]) * win + l;
  if (r < n) atomicAdd(&dv[r * D + c], g[i]);
}

// The outliers' share of K4: dv[out_src[o]] += g[out_slot[o]].
__global__ void __launch_bounds__(kThreads)
scatter_fix_kernel(const int* __restrict__ out_slot,
                   const int* __restrict__ out_src,
                   const float* __restrict__ g, float* __restrict__ dv,
                   long long total, long long n_slots, int D, int n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= total) return;
  const long long o = i / D;
  const int c = static_cast<int>(i - o * D);
  const long long slot = out_slot[o];
  const int src = out_src[o];
  if (slot < 0 || slot >= n_slots || src < 0 || src >= n) return;
  atomicAdd(&dv[static_cast<long long>(src) * D + c], g[slot * D + c]);
}

}  // namespace

// K4: windowed scatter-add, the VJP of K3.  Replaces the TPU kernel
// gflownet_spai_tpu/ops/segment.py `_scatter_win_kernel` (launched by
// `_scatter_win_pallas`) together with the outlier fixup of
// `_gather_rows_bwd`.  The TPU kernel turns each tile's scatter into
// [D, S] x [S, W] onehot contractions onto two window partials, then adds
// the partials per window; a GPU scatters natively, so each (slot,
// channel) adds straight into the output row with a float atomicAdd:
//
//   dv[blk[t]*win + lsrc[t, s], c] += g[t*S + s, c]   (in-window, row < n)
//   dv[out_src[o], c]             += g[out_slot[o], c] (out_slot < T*S)
//
// dv [n, D] must be zero on entry (the wrapper allocates it with zeros).
// What bounds it on an H100: bytes (one add per input word).  Neighbouring
// threads read neighbouring words of g; the rows they add into cluster by
// the window plan, so the atomics resolve in L2.  The atomics make the
// order of each row's sum run-dependent: results differ from a sequential
// sum by rounding only.
extern "C" int scatter_rows_windows_bwd(const void* lsrc, const void* blk,
                                        const void* out_slot,
                                        const void* out_src, const void* g,
                                        void* dv, int T, int S, int D,
                                        int win, int n, int n_out,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(T) * S * D;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    scatter_win_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(lsrc), static_cast<const int*>(blk),
        static_cast<const float*>(g), static_cast<float*>(dv), total, S, D,
        win, n);
  }
  const long long fix_total = static_cast<long long>(n_out) * D;
  if (fix_total > 0) {
    const unsigned blocks = static_cast<unsigned>((fix_total + kThreads - 1) / kThreads);
    scatter_fix_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const int*>(out_slot), static_cast<const int*>(out_src),
        static_cast<const float*>(g), static_cast<float*>(dv), fix_total,
        static_cast<long long>(T) * S, D, n);
  }
  return static_cast<int>(cudaGetLastError());
}

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

// ---------------------------------------------------------------------------
// K5, K6, K7: segment softmax, segment sum and node -> slot broadcast over the
// node-tile layout.  Tile t has S edge slots; local_dst[t, s] is the slot's
// destination node within the tile (0..TN-1), TN for padding slots.
//
// They replace the TPU kernels of gflownet_spai_tpu/ops/segment.py
// `_softmax_kernel` (launched by `_softmax_pallas`), `_sum_kernel`
// (`_sum_pallas`) and `_broadcast_kernel` (`_broadcast_pallas`).  Mosaic has
// no vector scatter, so those build a [TN, S] onehot per tile and run every
// segment op as masked reductions and onehot matmuls: O(TN.S) work per tile
// for O(S) data.  The layout builders write each tile's local_dst
// non-decreasing with padding last, so each node's slots are one contiguous
// run [start, end); these kernels walk the runs instead, O(S.D) per tile, and
// sum each run in slot order, so the results are deterministic.  The wrapper
// checks the run invariant once per layout and refuses one that breaks it.
//
// One block per tile.  tile_runs() finds every node's run in shared memory;
// then
//   K5: a thread per (node, head) takes the run's max, the sum of exp and
//       writes exp(s - max) / max(sum, 1e-30); padding slots get 0 (the TPU
//       kernel masks with -1e30 where its jnp oracle uses -inf: the same for
//       finite scores);
//   K6: a thread per (node, feature) sums its run: [T, S, D] -> [T, TN, D];
//   K7: a thread per (slot, feature) reads its node's row, padding writes 0:
//       [T, TN, D] -> [T, S, D].
// What bounds them on an H100: bytes (a handful of operations per word).
// A hub node that owns hundreds of slots of a tile serialises on its one
// thread; K6 and K5 read a run's rows with one thread per node, which
// coalesces only across the features of a node.
// ---------------------------------------------------------------------------

namespace {

// start[v], end[v] of every node's run in tile slots lid[0, S); nodes with no
// slot get the empty run [0, 0).
__device__ void tile_runs(const int* __restrict__ lid, int S, int TN,
                          int* start, int* end) {
  for (int v = threadIdx.x; v < TN; v += blockDim.x) start[v] = end[v] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int l = lid[s];
    if (l < 0 || l >= TN) continue;
    if (s == 0 || lid[s - 1] != l) start[l] = s;
    if (s == S - 1 || lid[s + 1] != l) end[l] = s + 1;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
seg_softmax_kernel(const int* __restrict__ local_dst, const float* __restrict__ scores,
                   float* __restrict__ out, int S, int H, int TN) {
  extern __shared__ int runs[];
  const long long t = blockIdx.x;
  const int* lid = local_dst + t * S;
  tile_runs(lid, S, TN, runs, runs + TN);
  const float* sc = scores + t * H * S;
  float* o = out + t * H * S;
  for (int e = threadIdx.x; e < TN * H; e += blockDim.x) {
    const int v = e % TN, h = e / TN;
    const int s0 = runs[v], s1 = runs[TN + v];
    const float* row = sc + static_cast<long long>(h) * S;
    float m = -1e30f;
    for (int s = s0; s < s1; ++s) m = fmaxf(m, row[s]);
    float den = 0.f;
    for (int s = s0; s < s1; ++s) den += expf(row[s] - m);
    den = fmaxf(den, 1e-30f);
    for (int s = s0; s < s1; ++s) o[static_cast<long long>(h) * S + s] = expf(row[s] - m) / den;
  }
  for (int e = threadIdx.x; e < H * S; e += blockDim.x) {
    const int l = lid[e % S];
    if (l < 0 || l >= TN) o[e] = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
seg_sum_kernel(const int* __restrict__ local_dst, const float* __restrict__ vals,
               float* __restrict__ out, int S, int D, int TN) {
  extern __shared__ int runs[];
  const long long t = blockIdx.x;
  tile_runs(local_dst + t * S, S, TN, runs, runs + TN);
  const float* v = vals + t * S * D;
  for (int e = threadIdx.x; e < TN * D; e += blockDim.x) {
    const int node = e / D, d = e % D;
    float acc = 0.f;
    for (int s = runs[node]; s < runs[TN + node]; ++s)
      acc += v[static_cast<long long>(s) * D + d];
    out[t * TN * D + e] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
seg_broadcast_kernel(const int* __restrict__ local_dst, const float* __restrict__ node_vals,
                     float* __restrict__ out, int S, int D, int TN) {
  const long long t = blockIdx.x;
  const int* lid = local_dst + t * S;
  const float* nv = node_vals + t * TN * D;
  float* o = out + t * S * D;
  for (int e = threadIdx.x; e < S * D; e += blockDim.x) {
    const int l = lid[e / D];
    o[e] = (l >= 0 && l < TN) ? nv[static_cast<long long>(l) * D + e % D] : 0.f;
  }
}

int tile_launch_check(int T, int S, int D, int TN) {
  if (T < 0 || S < 1 || D < 1 || TN < 1 || TN > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// K5.  local_dst [T, S] int32 (sorted runs), scores and out [T, H, S].
extern "C" int segment_softmax_tiles_fwd(const void* local_dst, const void* scores,
                                         void* out, int T, int S, int H, int TN,
                                         void* stream) {
  if (int rc = tile_launch_check(T, S, H, TN)) return rc;
  if (T > 0)
    seg_softmax_kernel<<<T, kThreads, 2 * TN * sizeof(int),
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(local_dst), static_cast<const float*>(scores),
        static_cast<float*>(out), S, H, TN);
  return static_cast<int>(cudaGetLastError());
}

// K6.  vals [T, S, D] -> out [T, TN, D].
extern "C" int segment_sum_tiles_fwd(const void* local_dst, const void* vals, void* out,
                                     int T, int S, int D, int TN, void* stream) {
  if (int rc = tile_launch_check(T, S, D, TN)) return rc;
  if (T > 0)
    seg_sum_kernel<<<T, kThreads, 2 * TN * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(local_dst), static_cast<const float*>(vals),
        static_cast<float*>(out), S, D, TN);
  return static_cast<int>(cudaGetLastError());
}

// K7.  node_vals [T, TN, D] -> out [T, S, D].
extern "C" int segment_broadcast_tiles_fwd(const void* local_dst, const void* node_vals,
                                           void* out, int T, int S, int D, int TN,
                                           void* stream) {
  if (int rc = tile_launch_check(T, S, D, TN)) return rc;
  if (T > 0)
    seg_broadcast_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(local_dst), static_cast<const float*>(node_vals),
        static_cast<float*>(out), S, D, TN);
  return static_cast<int>(cudaGetLastError());
}
