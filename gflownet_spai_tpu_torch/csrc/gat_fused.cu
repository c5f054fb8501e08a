// K1: fused GATv2 tile forward, one block per node tile.
//
// Replaces the TPU kernel gflownet_spai_tpu/ops/gat_fused.py `_fwd_kernel`
// (launched by `_run_fwd`).  Per tile of TN destination nodes and S edge
// slots it computes
//
//   msg    = xs[slot] + xd[local_dst] + attr * w_e        (uniform rows broadcast)
//   act    = LeakyReLU(msg)
//   score  = per head h: sum_d act[h*D + d] * att[h, d]
//   alpha  = segment softmax of score over the slots of each node, shifted by
//            the node's own (per-segment) max; padding slots
//            (local_dst outside [0, TN)) get alpha = 0
//   out[v] = sum over the slots of node v of xs[slot] * alpha[head]
//
// What bounds it on an H100: bytes.  Each slot does ~8*H*D + 4*H flops on a
// few 4-byte inputs, far below the card's ~20 flops per byte of f32 balance.
// What the design does about it: every slot-sized intermediate (msg, act,
// scores, exp, alpha) stays in registers and is recomputed in each of the
// three passes instead of being written out; only the per-(node, head)
// max and normaliser and the [TN, H*D] output accumulator live in shared
// memory (12 KB at TN = 128, H*D = 16), so device memory sees each input
// read at most three times (from L1/L2 after the first) and the output
// written once.  The passes loop over the slots, so any S works.
//
// The onehot matmuls of the TPU kernel become shared-memory atomics.  Their
// order changes from run to run, so the normaliser and output sums differ
// from a sequential sum by rounding (the max is order-independent and exact).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxHeads = 8;
constexpr int kThreads = 256;

// Float max on shared memory through integer atomics: with the sign bit
// clear the float order is the signed-int order; with it set it is the
// reverse of the unsigned order, so atomicMin picks the larger float.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

struct TileArgs {
  const int* local_dst;  // [T, S]
  const float* attr;     // [T, S]
  const float* xs;       // [1, HD] (uniform) or [T*S, HD]
  const float* xd;       // [1, HD] (uniform) or [T*TN, HD]
  int S, TN, H, D;
  int xs_uniform, xd_uniform;
  float slope;
};

// Scores of one real slot for every head, and a pointer to its source row.
__device__ __forceinline__ const float* slot_scores(
    const TileArgs& a, const float* s_we, const float* s_att, long long slot,
    long long node, float* sc) {
  const int HD = a.H * a.D;
  const float e = a.attr[slot];
  const float* xs_row = a.xs_uniform ? a.xs : a.xs + slot * HD;
  const float* xd_row = a.xd_uniform ? a.xd : a.xd + node * HD;
  for (int h = 0; h < a.H; ++h) {
    float acc = 0.f;
    for (int d = 0; d < a.D; ++d) {
      const int k = h * a.D + d;
      // (xs + xd) + attr*w_e, rounded step by step as the plain version does
      const float m = __fadd_rn(__fadd_rn(xs_row[k], xd_row[k]),
                                __fmul_rn(e, s_we[k]));
      const float act = m > 0.f ? m : a.slope * m;
      acc = fmaf(act, s_att[k], acc);
    }
    sc[h] = acc;
  }
  return xs_row;
}

__global__ void __launch_bounds__(kThreads)
gat_tile_fused_fwd_kernel(TileArgs a, const float* __restrict__ w_e,
                          const float* __restrict__ att,
                          float* __restrict__ out) {
  extern __shared__ float smem[];
  const int H = a.H, D = a.D, TN = a.TN, S = a.S;
  const int HD = H * D;
  float* s_max = smem;              // [TN * H] per-segment max
  float* s_den = s_max + TN * H;    // [TN * H] softmax normaliser
  float* s_out = s_den + TN * H;    // [TN * HD] output accumulator
  float* s_we = s_out + TN * HD;    // [HD]
  float* s_att = s_we + HD;         // [HD]

  const int t = blockIdx.x;
  const long long slot0 = static_cast<long long>(t) * S;
  const long long node0 = static_cast<long long>(t) * TN;
  for (int i = threadIdx.x; i < TN * H; i += blockDim.x) {
    s_max[i] = -INFINITY;
    s_den[i] = 0.f;
  }
  for (int i = threadIdx.x; i < TN * HD; i += blockDim.x) s_out[i] = 0.f;
  for (int i = threadIdx.x; i < HD; i += blockDim.x) {
    s_we[i] = w_e[i];
    s_att[i] = att[i];
  }
  __syncthreads();

  float sc[kMaxHeads];
  // pass 1: per-segment max of the scores
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    for (int h = 0; h < H; ++h) atomic_max_float(&s_max[v * H + h], sc[h]);
  }
  __syncthreads();
  // pass 2: normaliser of each segment
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    for (int h = 0; h < H; ++h)
      atomicAdd(&s_den[v * H + h], expf(sc[h] - s_max[v * H + h]));
  }
  __syncthreads();
  // pass 3: alpha-weighted sum of the source rows into each node
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    const float* xs_row = slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    for (int h = 0; h < H; ++h) {
      const float den = s_den[v * H + h];
      const float alpha = den > 0.f ? expf(sc[h] - s_max[v * H + h]) / den : 0.f;
      for (int d = 0; d < D; ++d) {
        const int k = h * D + d;
        atomicAdd(&s_out[v * HD + k], xs_row[k] * alpha);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TN * HD; i += blockDim.x)
    out[node0 * HD + i] = s_out[i];
}

}  // namespace

extern "C" int gat_tile_fused_fwd(const void* local_dst, const void* attr,
                                  const void* xs, const void* xd,
                                  const void* w_e, const void* att, void* out,
                                  int T, int S, int TN, int H, int D,
                                  int xs_uniform, int xd_uniform, float slope,
                                  void* stream) {
  if (H < 1 || H > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  TileArgs a{static_cast<const int*>(local_dst), static_cast<const float*>(attr),
             static_cast<const float*>(xs), static_cast<const float*>(xd),
             S, TN, H, D, xs_uniform, xd_uniform, slope};
  const size_t smem = sizeof(float) * (2 * TN * H + TN * H * D + 2 * H * D);
  if (T > 0) {
    gat_tile_fused_fwd_kernel<<<T, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const float*>(w_e), static_cast<const float*>(att),
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
