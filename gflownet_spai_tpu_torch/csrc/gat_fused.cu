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
//
// K2: the fused backward, one block per node tile.  Replaces the TPU kernel
// gflownet_spai_tpu/ops/gat_fused.py `_bwd_kernel` (launched by `_run_bwd`),
// which recomputes the forward in VMEM and emits d(xs), d(xd) and per-tile
// d(att), d(w_e).  Here the block reruns K1's passes 1-2 (the same device
// code, so alpha is K1's), then two passes over the slots: one sums
// alpha * al_bar per (node, head) into shared memory, the other forms every
// gradient.  The TPU kernel's onehot products are gathers of g at the
// slot's node and segment sums through shared-memory atomics here; the
// per-tile sums (d(att), d(w_e), and d(xs), d(xd) of uniform rows) reduce
// across each warp with shuffles before one shared atomic per warp.
// What bounds it on an H100: bytes, like K1 (~20 flops per slot and
// channel against 4-byte inputs).  Slot-sized intermediates stay in
// registers and are recomputed per pass; device memory sees g and the
// inputs read from L1/L2 after the first pass, and each output written
// once.  The atomic sums make the gradients' rounding run-dependent.

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

// Passes 1 and 2 of K1 and K2: the per-(node, head) max and softmax
// normaliser of the tile's scores, into shared memory.  Both kernels run
// this same code, so K2 recomputes alpha exactly as K1 computed it.
__device__ void segment_softmax_stats(const TileArgs& a, const float* s_we,
                                      const float* s_att, float* s_max,
                                      float* s_den, long long slot0,
                                      long long node0) {
  const int H = a.H, TN = a.TN;
  float sc[kMaxHeads];
  // pass 1: per-segment max of the scores
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    for (int h = 0; h < H; ++h) atomic_max_float(&s_max[v * H + h], sc[h]);
  }
  __syncthreads();
  // pass 2: normaliser of each segment
  for (int s = threadIdx.x; s < a.S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    for (int h = 0; h < H; ++h)
      atomicAdd(&s_den[v * H + h], expf(sc[h] - s_max[v * H + h]));
  }
  __syncthreads();
}

// alpha of one (slot, head) from its score and its segment's statistics.
__device__ __forceinline__ float slot_alpha(const float* s_max,
                                            const float* s_den, int i,
                                            float score) {
  const float den = s_den[i];
  return den > 0.f ? expf(score - s_max[i]) / den : 0.f;
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
  segment_softmax_stats(a, s_we, s_att, s_max, s_den, slot0, node0);

  float sc[kMaxHeads];
  // pass 3: alpha-weighted sum of the source rows into each node
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    const float* xs_row = slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    for (int h = 0; h < H; ++h) {
      const float alpha = slot_alpha(s_max, s_den, v * H + h, sc[h]);
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

// Sum of v over the warp, added into *acc by lane 0.  Every lane of the
// warp must call it (inactive slots pass 0).
__device__ __forceinline__ void warp_add(float* acc, float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(acc, v);
}

// K2: the VJP of K1 with recompute.  g: [T*TN, HD] cotangent of out.
// Per slot s of node v (alpha, msg, act recomputed as K1 computes them):
//   al_bar[h] = sum_d g[v, hD+d] * xs[s, hD+d]
//   seg[v, h] = sum over the slots of v of alpha * al_bar      (pass 3)
//   s_bar[h]  = alpha * (al_bar - seg[v, h])                    (pass 4)
//   act_bar   = s_bar[h] * att[h, d];  m_bar = leaky'(msg) * act_bar
//   dxs[s]    = g[v] * alpha + m_bar   (per slot; per-tile sum if uniform)
//   dxd[v]   += m_bar                  (per node; per-tile sum if uniform)
//   datt     += act * s_bar[h];   dwe += attr * m_bar          (per tile)
// Per-tile partials go to [T, HD] outputs, summed by the wrapper.
__global__ void __launch_bounds__(kThreads)
gat_tile_fused_bwd_kernel(TileArgs a, const float* __restrict__ w_e,
                          const float* __restrict__ att,
                          const float* __restrict__ g,
                          float* __restrict__ dxs, float* __restrict__ dxd,
                          float* __restrict__ datt, float* __restrict__ dwe) {
  extern __shared__ float smem[];
  const int H = a.H, D = a.D, TN = a.TN, S = a.S;
  const int HD = H * D;
  float* s_max = smem;               // [TN * H]
  float* s_den = s_max + TN * H;     // [TN * H]
  float* s_seg = s_den + TN * H;     // [TN * H] sum of alpha * al_bar
  float* s_we = s_seg + TN * H;      // [HD]
  float* s_att = s_we + HD;          // [HD]
  float* s_dxs = s_att + HD;         // [HD] per-tile sum (uniform xs)
  float* s_dxd1 = s_dxs + HD;        // [HD] per-tile sum (uniform xd)
  float* s_datt = s_dxd1 + HD;       // [HD]
  float* s_dwe = s_datt + HD;        // [HD]
  float* s_dxd = s_dwe + HD;         // [TN * HD] per node (non-uniform xd)

  const int t = blockIdx.x;
  const long long slot0 = static_cast<long long>(t) * S;
  const long long node0 = static_cast<long long>(t) * TN;
  for (int i = threadIdx.x; i < TN * H; i += blockDim.x) {
    s_max[i] = -INFINITY;
    s_den[i] = 0.f;
    s_seg[i] = 0.f;
  }
  for (int i = threadIdx.x; i < HD; i += blockDim.x) {
    s_we[i] = w_e[i];
    s_att[i] = att[i];
    s_dxs[i] = s_dxd1[i] = s_datt[i] = s_dwe[i] = 0.f;
  }
  if (!a.xd_uniform)
    for (int i = threadIdx.x; i < TN * HD; i += blockDim.x) s_dxd[i] = 0.f;
  __syncthreads();
  segment_softmax_stats(a, s_we, s_att, s_max, s_den, slot0, node0);

  float sc[kMaxHeads];
  // pass 3: seg[v, h] = sum over the slots of v of alpha * al_bar
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int v = a.local_dst[slot0 + s];
    if (v < 0 || v >= TN) continue;
    const float* xs_row = slot_scores(a, s_we, s_att, slot0 + s, node0 + v, sc);
    const float* g_row = g + (node0 + v) * HD;
    for (int h = 0; h < H; ++h) {
      float al_bar = 0.f;
      for (int d = 0; d < D; ++d) al_bar = fmaf(g_row[h * D + d], xs_row[h * D + d], al_bar);
      atomicAdd(&s_seg[v * H + h],
                slot_alpha(s_max, s_den, v * H + h, sc[h]) * al_bar);
    }
  }
  __syncthreads();

  // pass 4: every output.  The loop runs the same number of times in every
  // lane of a warp, so the per-tile sums can reduce across the warp.
  float alpha[kMaxHeads], s_bar[kMaxHeads];
  for (int base = 0; base < S; base += blockDim.x) {
    const int s = base + threadIdx.x;
    const int v = s < S ? a.local_dst[slot0 + s] : -1;
    const bool real = v >= 0 && v < TN;
    const long long slot = slot0 + s;
    const float* xs_row = a.xs;
    const float* xd_row = a.xd;
    const float* g_row = g;
    float e = 0.f;
    if (real) {
      xs_row = slot_scores(a, s_we, s_att, slot, node0 + v, sc);
      xd_row = a.xd_uniform ? a.xd : a.xd + (node0 + v) * HD;
      g_row = g + (node0 + v) * HD;
      e = a.attr[slot];
      for (int h = 0; h < H; ++h) {
        float al_bar = 0.f;
        for (int d = 0; d < D; ++d) al_bar = fmaf(g_row[h * D + d], xs_row[h * D + d], al_bar);
        alpha[h] = slot_alpha(s_max, s_den, v * H + h, sc[h]);
        s_bar[h] = alpha[h] * (al_bar - s_seg[v * H + h]);
      }
    }
    for (int h = 0; h < H; ++h) {
      for (int d = 0; d < D; ++d) {
        const int k = h * D + d;
        float dxs_k = 0.f, m_bar = 0.f, act = 0.f, sb = 0.f;
        if (real) {
          const float m = __fadd_rn(__fadd_rn(xs_row[k], xd_row[k]),
                                    __fmul_rn(e, s_we[k]));
          act = m > 0.f ? m : a.slope * m;
          sb = s_bar[h];
          const float act_bar = sb * s_att[k];
          m_bar = m > 0.f ? act_bar : a.slope * act_bar;
          dxs_k = g_row[k] * alpha[h] + m_bar;
        }
        if (!a.xs_uniform) {
          if (s < S) dxs[slot * HD + k] = dxs_k;
        } else {
          warp_add(&s_dxs[k], dxs_k);
        }
        if (!a.xd_uniform) {
          if (real) atomicAdd(&s_dxd[v * HD + k], m_bar);
        } else {
          warp_add(&s_dxd1[k], m_bar);
        }
        warp_add(&s_datt[k], act * sb);
        warp_add(&s_dwe[k], e * m_bar);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < HD; i += blockDim.x) {
    const long long o = static_cast<long long>(t) * HD + i;
    if (a.xs_uniform) dxs[o] = s_dxs[i];
    if (a.xd_uniform) dxd[o] = s_dxd1[i];
    datt[o] = s_datt[i];
    dwe[o] = s_dwe[i];
  }
  if (!a.xd_uniform)
    for (int i = threadIdx.x; i < TN * HD; i += blockDim.x)
      dxd[node0 * HD + i] = s_dxd[i];
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

extern "C" int gat_tile_fused_bwd(const void* local_dst, const void* attr,
                                  const void* xs, const void* xd,
                                  const void* w_e, const void* att,
                                  const void* g, void* dxs, void* dxd,
                                  void* datt, void* dwe, int T, int S, int TN,
                                  int H, int D, int xs_uniform, int xd_uniform,
                                  float slope, void* stream) {
  if (H < 1 || H > kMaxHeads) return static_cast<int>(cudaErrorInvalidValue);
  TileArgs a{static_cast<const int*>(local_dst), static_cast<const float*>(attr),
             static_cast<const float*>(xs), static_cast<const float*>(xd),
             S, TN, H, D, xs_uniform, xd_uniform, slope};
  const size_t smem = sizeof(float) * (3 * TN * H + 6 * H * D
                                       + (xd_uniform ? 0 : TN * H * D));
  if (T > 0) {
    gat_tile_fused_bwd_kernel<<<T, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        a, static_cast<const float*>(w_e), static_cast<const float*>(att),
        static_cast<const float*>(g), static_cast<float*>(dxs),
        static_cast<float*>(dxd), static_cast<float*>(datt),
        static_cast<float*>(dwe));
  }
  return static_cast<int>(cudaGetLastError());
}
