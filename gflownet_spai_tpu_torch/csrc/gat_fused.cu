// K1: fused GATv2 tile forward.  Replaces the TPU kernel
// gflownet_spai_tpu/ops/gat_fused.py `_fwd_kernel` (launched by `_run_fwd`).
// Per tile of TN destination nodes and S edge slots it computes
//
//   msg    = xs[slot] + xd[node] + attr * w_e        (uniform rows broadcast)
//   act    = LeakyReLU(msg)
//   score  = per head h: sum_d act[h*D + d] * att[h, d]
//   alpha  = segment softmax of score over the slots of each node, shifted by
//            the node's own max; padding slots (local_dst outside [0, TN))
//            get alpha = 0
//   out[v] = sum over the slots of node v of xs[slot] * alpha[head]
//
// K2: the fused backward (`_bwd_kernel` / `_run_bwd` in JAX): the VJP of K1
// with the forward recomputed, emitting d(xs), d(xd), d(att) and d(w_e).
//
// Work is node-major.  The wrapper derives once per layout where each
// node's run of slots starts ([T, TN + 1]; the last column counts the real
// slots) and, where a node's slots are not already adjacent, the slot order
// that makes them runs; the kernels read the slots through it.  A node gets
// G lanes (a power of two <= 32): for each of its H heads, P channel lanes
// (each owning up to 8 consecutive channels of the head) times Q slot lanes
// (lane q takes the run's slots q, q + Q, ...).  A head's score is summed
// over its P channel lanes with shuffles; the Q slot lanes' softmax states
// are merged with shuffles after the run.  Every merge is an xor butterfly,
// so all lanes of a head hold the same bits.  A block holds 128 lanes, so a
// tile's nodes spread over TN * G / 128 blocks: 4 at layer 1's G = 4, and
// where the runs are long Q (and G) grow, so even a one-tile bucket gets
// several.
//
// K1 walks each lane's slots once: an online softmax keeps the running max,
// the rescaled normaliser and the weighted sum of the lane's channels in
// registers; after the merge one lane per channel group writes the node's
// output (zeros for a node with no slot).  K2 walks them twice: pass 1 finds
// the max, the normaliser and seg[v, h] = sum alpha * al_bar online; pass 2
// recomputes alpha and forms every gradient, writing d(xs) per slot (zero
// rows for padding slots) and summing d(xd) over the run.  The loads of up
// to 4 of a lane's slots are issued together, and kept in registers for
// pass 2 when they are all of the lane's slots.  Each kernel has an
// instance per channels-per-lane bound (4, 8) and per uniform / per-slot
// xs and xd; with a uniform xs, xs + xd and al_bar are formed once per
// node instead of per slot.
//
// No atomics: K2's per-tile sums (d(att), d(w_e), and d(xs), d(xd) of
// uniform rows) reduce in a fixed order, first within each block (shuffles
// over the slot lanes and the warp, then warp by warp) into one row per
// block, then in a second kernel of 1024 threads that sums the rows in
// block order.  It is launched as a programmatic dependent of the first
// (Hopper's griddepcontrol), so it is resident and waiting when the last
// block finishes.  Two launches on the same inputs give the same bits.
//
// What bounds them on an H100: bytes in principle (a few flops per 4-byte
// input), in practice latency: a launch moves well under a microsecond of
// HBM traffic, so its time is the chain of dependent loads, softmax steps,
// shuffles of its slowest lane, plus (K2) the row sums.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxHeads = 8;
constexpr int kMaxC = 8;        // channels per lane (instances for 4 and 8)
constexpr int kThreads = 128;   // the most lanes in a block
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 4;        // K2's per-channel sums: datt, dwe, dxs, dxd (at most)
constexpr int kSumThreads = 1024;   // K2's row-sum kernel
constexpr int kMaxHD = 256;     // H * D under the lane plan's limits
constexpr float kNoScore = -1e30f;   // the plain version's masked-max floor

struct GatArgs {
  const int* starts;   // [T, TN + 1] run starts (positions); [t, TN]: real slots
  const int* order;    // [T, S] position -> slot within the tile, or null
  const float* attr;   // [T*S]
  const float* xs;     // [1, HD] (uniform) or [T*S, HD]
  const float* xd;     // [1, HD] (uniform) or [T*TN, HD]
  const float* w_e;    // [HD]
  const float* att;    // [HD]
  int T, S, TN, H, D;
  int P;               // channel lanes per head (a power of two)
  int Q;               // slot lanes (a power of two)
  int G;               // lanes per node: H*P*Q rounded up to a power of two
  int xs_uniform, xd_uniform;
  int vec;             // 16-byte loads and stores of a lane's channels
  float slope;
};

// A lane's place: head h (>= H: the lane idles), slot lane q, first
// channel k0 and channel count nc (0 where the head's channels ran out);
// shuffle masks of the P lanes that share its q (the head's score) and of
// the Q lanes that share its channels (the run's merge).
struct Lane {
  int h, q, k0, nc;
  unsigned score_mask, run_mask;
};

__device__ __forceinline__ Lane lane_geometry(const GatArgs& a, int l) {
  Lane L;
  L.q = l & (a.Q - 1);
  const int hp = l / a.Q;
  L.h = hp / a.P;
  const int p = hp & (a.P - 1);          // channel lane
  const int C = (a.D + a.P - 1) / a.P;
  L.k0 = L.h * a.D + p * C;
  L.nc = L.h < a.H ? max(0, min(C, a.D - p * C)) : 0;
  const int wl = threadIdx.x & 31;
  const int head0 = (wl & ~(a.P * a.Q - 1)) | L.q;   // this q's lane of channel lane 0
  L.score_mask = 0u;
  for (int i = 0; i < a.P; ++i) L.score_mask |= 1u << (head0 + i * a.Q);
  L.run_mask = a.Q == 32 ? 0xffffffffu : ((1u << a.Q) - 1u) << (wl & ~(a.Q - 1));
  return L;
}

template <int MC>
__device__ __forceinline__ void load_ch(const float* __restrict__ p,
                                        float (&r)[MC], int nc, bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < MC; c += 4) {
      if (c < nc) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p + c));
        r[c] = q.x; r[c + 1] = q.y; r[c + 2] = q.z; r[c + 3] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < nc) r[c] = __ldg(p + c);
  }
}

template <int MC>
__device__ __forceinline__ void store_ch(float* __restrict__ p,
                                         const float (&r)[MC], int nc,
                                         bool vec) {
  if (vec) {
#pragma unroll
    for (int c = 0; c < MC; c += 4)
      if (c < nc)
        *reinterpret_cast<float4*>(p + c) = make_float4(r[c], r[c + 1], r[c + 2], r[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < MC; ++c)
      if (c < nc) p[c] = r[c];
  }
}

// Sum over lanes lane ^ first, lane ^ 2*first, ... below `end` (an xor
// butterfly: every lane gets the same bits).
__device__ __forceinline__ float xor_sum(float v, int first, int end, unsigned mask) {
  for (int off = first; off < end; off <<= 1) v += __shfl_xor_sync(mask, v, off);
  return v;
}

// What a lane reads for one slot: its index, the edge scalar, and (per-slot
// rows, XSU false) the lane's channels of the source row.
template <int MC>
struct SlotIn {
  long long slot;
  float e;
  float xs[MC];
};

template <int MC, bool XSU>
__device__ __forceinline__ void fetch_slot(const GatArgs& a, const Lane& L,
                                           long long tS, int pos, SlotIn<MC>& s) {
  s.slot = tS + (a.order ? __ldg(a.order + tS + pos) : pos);
  s.e = __ldg(a.attr + s.slot);
  if (!XSU) load_ch(a.xs + s.slot * (a.H * a.D) + L.k0, s.xs, L.nc, a.vec);
}

// A lane's slots whose loads are issued together: positions i0, i0 + Q, ...
template <int MC>
struct Group {
  static constexpr int kSize = MC <= 4 ? 4 : 2;
  SlotIn<MC> s[kSize];
};

template <int MC, bool XSU>
__device__ __forceinline__ void fetch_group(const GatArgs& a, const Lane& L,
                                            long long tS, int i0, int end,
                                            Group<MC>& grp) {
#pragma unroll
  for (int u = 0; u < Group<MC>::kSize; ++u)
    if (i0 + u * a.Q < end) fetch_slot<MC, XSU>(a, L, tS, i0 + u * a.Q, grp.s[u]);
}

// The node's constants of a lane: w_e, att, xd (and, XSU, xs and xs + xd).
template <int MC, bool XSU, bool XDU>
struct NodeIn {
  float we[MC] = {}, at[MC] = {}, xd[MC] = {}, xs[MC] = {}, base[MC] = {};

  __device__ __forceinline__ NodeIn(const GatArgs& a, const Lane& L, long long node) {
    const int HD = a.H * a.D;
    load_ch(a.w_e + L.k0, we, L.nc, a.vec);
    load_ch(a.att + L.k0, at, L.nc, a.vec);
    load_ch(a.xd + (XDU ? 0 : node * HD) + L.k0, xd, L.nc, a.vec);
    if (XSU) {
      load_ch(a.xs + L.k0, xs, L.nc, a.vec);
#pragma unroll
      for (int c = 0; c < MC; ++c) base[c] = __fadd_rn(xs[c], xd[c]);
    }
  }

  // The slot's source row (its own, or the uniform one) and xs + xd.
  __device__ __forceinline__ void slot_rows(const SlotIn<MC>& s, float (&x)[MC],
                                            float (&b)[MC]) const {
#pragma unroll
    for (int c = 0; c < MC; ++c) {
      x[c] = XSU ? xs[c] : s.xs[c];
      b[c] = XSU ? base[c] : __fadd_rn(s.xs[c], xd[c]);
    }
  }
};

// msg of the lane's channels and its head's score: (xs + xd) + attr*w_e,
// rounded step by step as the plain version does.
template <int MC>
__device__ __forceinline__ float head_score(const GatArgs& a, const Lane& L,
                                            float e, const float (&base)[MC],
                                            const float (&we)[MC],
                                            const float (&at)[MC],
                                            float (&msg)[MC]) {
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < MC; ++c) {
    if (c < L.nc) {
      msg[c] = __fadd_rn(base[c], __fmul_rn(e, we[c]));
      const float act = msg[c] > 0.f ? msg[c] : a.slope * msg[c];
      part = fmaf(act, at[c], part);
    }
  }
  return xor_sum(part, a.Q, a.P * a.Q, L.score_mask);
}

// al_bar of the lane's head: sum of g * xs over the head's channels.
template <int MC>
__device__ __forceinline__ float head_al(const GatArgs& a, const Lane& L,
                                         const float (&gv)[MC], const float (&xs)[MC]) {
  float al = 0.f;
#pragma unroll
  for (int c = 0; c < MC; ++c)
    if (c < L.nc) al = fmaf(gv[c], xs[c], al);
  return xor_sum(al, a.Q, a.P * a.Q, L.score_mask);
}

// One online-softmax step: with a new max the sums so far are rescaled by
// r; returns the weight exp(score - max) of this slot.
__device__ __forceinline__ float online_step(float sc, float& m, float& den,
                                             float& r) {
  if (sc > m) {
    r = expf(m - sc);
    m = sc;
    den *= r;
    return 1.f;
  }
  r = 1.f;
  return expf(sc - m);
}

// Merge the Q slot lanes' softmax states: (m, den) and N sums rescaled with
// them.  Symmetric in the two lanes, so every lane ends with the same bits.
template <int N>
__device__ __forceinline__ void merge_runs(const GatArgs& a, const Lane& L,
                                           float& m, float& den, float (&sums)[N]) {
  for (int off = 1; off < a.Q; off <<= 1) {
    const float mo = __shfl_xor_sync(L.run_mask, m, off);
    const float deno = __shfl_xor_sync(L.run_mask, den, off);
    const float mn = fmaxf(m, mo);
    const float r = expf(m - mn), ro = expf(mo - mn);
    den = den * r + deno * ro;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float so = __shfl_xor_sync(L.run_mask, sums[i], off);
      sums[i] = sums[i] * r + so * ro;
    }
    m = mn;
  }
}

// The node (tile t, node v) a lane works on, and its lane within the node.
struct NodeSlot {
  int t, chunk, chunks, v, l;
};

__device__ __forceinline__ NodeSlot node_of(const GatArgs& a) {
  NodeSlot n;
  const int npb = kThreads / a.G;
  n.chunks = (a.TN + npb - 1) / npb;
  n.t = blockIdx.x / n.chunks;
  n.chunk = blockIdx.x - n.t * n.chunks;
  n.v = n.chunk * npb + threadIdx.x / a.G;
  n.l = threadIdx.x & (a.G - 1);
  return n;
}

// XSU / XDU: xs / xd is one uniform row (layer 1 of the policy).
template <int MC, bool XSU, bool XDU>
__global__ void __launch_bounds__(kThreads)
gat_tile_fused_fwd_kernel(GatArgs a, float* __restrict__ out) {
  const NodeSlot n = node_of(a);
  const Lane L = lane_geometry(a, n.l);
  // a whole head's lanes leave together, so the shuffles stay complete
  if (n.v >= a.TN || L.h >= a.H) return;
  const long long node = static_cast<long long>(n.t) * a.TN + n.v;
  const NodeIn<MC, XSU, XDU> in(a, L, node);
  const int* st = a.starts + static_cast<long long>(n.t) * (a.TN + 1);
  const int beg = __ldg(st + n.v), end = __ldg(st + n.v + 1);
  const long long tS = static_cast<long long>(n.t) * a.S;
  const int step = a.Q * Group<MC>::kSize;

  float m = kNoScore, den = 0.f, acc[MC] = {};
  for (int i0 = beg + L.q; i0 < end; i0 += step) {
    Group<MC> grp;
    fetch_group<MC, XSU>(a, L, tS, i0, end, grp);
#pragma unroll
    for (int u = 0; u < Group<MC>::kSize; ++u) {
      if (i0 + u * a.Q >= end) break;
      float xs[MC], base[MC], msg[MC] = {};
      in.slot_rows(grp.s[u], xs, base);
      const float sc = head_score(a, L, grp.s[u].e, base, in.we, in.at, msg);
      float r;
      const float p = online_step(sc, m, den, r);
      den += p;
#pragma unroll
      for (int c = 0; c < MC; ++c)
        if (c < L.nc) acc[c] = fmaf(p, xs[c], acc[c] * r);
    }
  }
  merge_runs(a, L, m, den, acc);
  if (L.q != 0) return;
  float o[MC];
#pragma unroll
  for (int c = 0; c < MC; ++c) o[c] = den > 0.f ? acc[c] / den : 0.f;
  store_ch(out + node * (a.H * a.D) + L.k0, o, L.nc, a.vec);
}

// Column sums of n rows of ncol floats (ncol a multiple of 4, rows 16-byte
// aligned) into s_tot, in a fixed order: thread group k sums rows k,
// k + groups, ... in turn, then the groups' sums are added pairwise in a
// fixed tree.
__device__ void sum_rows(const float* rows, int n, int ncol, float* s_tot,
                         float4* s_col) {
  const int quads = ncol / 4;
  const int qw = min(quads, static_cast<int>(blockDim.x));
  const int groups = blockDim.x / qw;
  const int grp = threadIdx.x / qw, ql = threadIdx.x - grp * qw;
  int half = 1;
  while (2 * half < groups) half <<= 1;
  for (int q0 = 0; q0 < quads; q0 += qw) {
    const int cq = q0 + ql;
    const bool mine = grp < groups && cq < quads;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (mine) {
#pragma unroll 8
      for (int b = grp; b < n; b += groups) {
        const float4 x = __ldcg(reinterpret_cast<const float4*>(
            rows + static_cast<long long>(b) * ncol) + cq);
        s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
      }
    }
    s_col[threadIdx.x] = s;
    __syncthreads();
    for (int st = groups > 1 ? half : 0; st >= 1; st >>= 1) {
      if (mine && grp < st && grp + st < groups) {
        const float4 y = s_col[threadIdx.x + st * qw];
        s.x += y.x; s.y += y.y; s.z += y.z; s.w += y.w;
        s_col[threadIdx.x] = s;
      }
      __syncthreads();
    }
    if (grp == 0 && cq < quads) {
      s_tot[4 * cq] = s.x; s_tot[4 * cq + 1] = s.y;
      s_tot[4 * cq + 2] = s.z; s_tot[4 * cq + 3] = s.w;
    }
    __syncthreads();
  }
}

// K2.  g: [T*TN, HD] cotangent of out.  Per slot s of node v:
//   al_bar[h] = sum_d g[v, hD+d] * xs[s, hD+d]
//   seg[v, h] = sum over the slots of v of alpha * al_bar       (pass 1)
//   s_bar[h]  = alpha * (al_bar - seg[v, h])                     (pass 2)
//   act_bar   = s_bar[h] * att[h, d];  m_bar = leaky'(msg) * act_bar
//   dxs[s]    = g[v] * alpha + m_bar   (per slot; summed if uniform)
//   dxd[v]    = sum over the slots of v of m_bar   (summed if uniform)
//   datt      = sum of act * s_bar[h];  dwe = sum of attr * m_bar
// al_bar - seg is formed as (al_bar - al0) - (seg - al0), al0 the al_bar of
// the run's first slot: where every slot of a node has the same al_bar
// (uniform xs) s_bar is exactly 0, as it is in exact arithmetic, instead of
// the rounding of seg (which summed over a bucket swamps d(att) and d(w_e)).
//
// The per-tile sums: each block writes one row of column sums to part
// ([gridDim.x, sum_stride(XSU, XDU, HD)]: d(att), d(w_e), then d(xs) if XSU
// and d(xd) if XDU, zero-padded to a multiple of 4), which
// gat_tile_fused_bwd_sum_kernel adds up.  At most 6 blocks' registers fit
// an SM beside each other, so layer 1's largest bucket (704 blocks) runs
// in one wave.
__host__ __device__ constexpr int sum_count(bool xsu, bool xdu) {
  return 2 + (xsu ? 1 : 0) + (xdu ? 1 : 0);
}

__host__ __device__ inline int sum_stride(int nsum, int HD) {
  return (nsum * HD + 3) / 4 * 4;
}

template <int MC, bool XSU, bool XDU>
__global__ void __launch_bounds__(kThreads, MC <= 4 ? 6 : 3)
gat_tile_fused_bwd_kernel(GatArgs a, const float* __restrict__ g,
                          float* __restrict__ dxs, float* __restrict__ dxd,
                          float* __restrict__ part) {
  constexpr int NS = sum_count(XSU, XDU);
  __shared__ float s_red[kWarps][32 * NS * MC];
  // the row-sum kernel may be scheduled now; it waits for this grid to end
  asm volatile("griddepcontrol.launch_dependents;");
  const NodeSlot n = node_of(a);
  const Lane L = lane_geometry(a, n.l);
  const int HD = a.H * a.D;
  const bool vec = a.vec;
  const long long tS = static_cast<long long>(n.t) * a.S;
  const int* st = a.starts + static_cast<long long>(n.t) * (a.TN + 1);

  // per-slot d(xs): zero rows for the tile's padding slots, shared out
  // over the tile's blocks
  if (!XSU) {
    const int pad0 = __ldg(st + a.TN);
    const int cnt = (a.S - pad0) * HD;
    for (int i = n.chunk * kThreads + threadIdx.x; i < cnt; i += n.chunks * kThreads) {
      const int pos = pad0 + i / HD;
      const long long slot = tS + (a.order ? __ldg(a.order + tS + pos) : pos);
      dxs[slot * HD + i % HD] = 0.f;
    }
  }

  // the lane's sums: d(att), d(w_e), then d(xs) if XSU and d(xd) if XDU
  float x[NS * MC] = {};
  if (n.v < a.TN && L.h < a.H) {
    const long long node = static_cast<long long>(n.t) * a.TN + n.v;
    const NodeIn<MC, XSU, XDU> in(a, L, node);
    float gv[MC] = {};
    load_ch(g + node * HD + L.k0, gv, L.nc, vec);
    const int beg = __ldg(st + n.v), end = __ldg(st + n.v + 1);
    const int step = a.Q * Group<MC>::kSize;
    const float al_u = XSU ? head_al(a, L, gv, in.xs) : 0.f;

    // pass 1: max, normaliser and sum of exp * (al_bar - alq), online per
    // lane (alq the al_bar of the lane's first slot), then shifted to al0
    // (slot lane 0's, the run's first slot) and merged over the slot lanes
    float m = kNoScore, den = 0.f, num[1] = {0.f}, alq = al_u;
    Group<MC> grp;
    for (int i0 = beg + L.q; i0 < end; i0 += step) {
      fetch_group<MC, XSU>(a, L, tS, i0, end, grp);
#pragma unroll
      for (int u = 0; u < Group<MC>::kSize; ++u) {
        if (i0 + u * a.Q >= end) break;
        float xs[MC], base[MC], msg[MC] = {};
        in.slot_rows(grp.s[u], xs, base);
        const float sc = head_score(a, L, grp.s[u].e, base, in.we, in.at, msg);
        const float al = XSU ? al_u : head_al(a, L, gv, xs);
        if (!XSU && i0 + u * a.Q == beg + L.q) alq = al;
        float r;
        const float p = online_step(sc, m, den, r);
        den += p;
        num[0] = fmaf(p, al - alq, num[0] * r);
      }
    }
    const float al0 = XSU ? al_u
        : __shfl_sync(L.run_mask, alq, (threadIdx.x & 31) & ~(a.Q - 1));
    num[0] = fmaf(den, alq - al0, num[0]);       // 0 where al_bar is uniform
    merge_runs(a, L, m, den, num);
    const float seg = den > 0.f ? num[0] / den : 0.f;   // seg[v, h] - al0
    const bool held = beg + L.q + step >= end;   // pass 1's group holds every slot

    // pass 2: alpha again, and every gradient
    float ndxd[MC] = {};
    for (int i0 = beg + L.q; i0 < end; i0 += step) {
      if (!held) fetch_group<MC, XSU>(a, L, tS, i0, end, grp);
#pragma unroll
      for (int u = 0; u < Group<MC>::kSize; ++u) {
        if (i0 + u * a.Q >= end) break;
        const SlotIn<MC>& cur = grp.s[u];
        float xs[MC], base[MC], msg[MC] = {};
        in.slot_rows(cur, xs, base);
        const float sc = head_score(a, L, cur.e, base, in.we, in.at, msg);
        const float al = XSU ? al_u : head_al(a, L, gv, xs);
        const float alpha = den > 0.f ? expf(sc - m) / den : 0.f;
        const float sb = alpha * ((al - al0) - seg);
        float dx[MC] = {};
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          if (c < L.nc) {
            const float act = msg[c] > 0.f ? msg[c] : a.slope * msg[c];
            const float ab = sb * in.at[c];
            const float mb = msg[c] > 0.f ? ab : a.slope * ab;
            dx[c] = fmaf(gv[c], alpha, mb);
            ndxd[c] += mb;
            x[c] = fmaf(act, sb, x[c]);
            x[MC + c] = fmaf(cur.e, mb, x[MC + c]);
            if (XSU) x[2 * MC + c] += dx[c];
          }
        }
        if (!XSU) store_ch(dxs + cur.slot * HD + L.k0, dx, L.nc, vec);
      }
    }
    if (XDU) {
#pragma unroll
      for (int c = 0; c < MC; ++c) x[(NS - 1) * MC + c] += ndxd[c];
    } else {
      for (int off = 1; off < a.Q; off <<= 1) {
#pragma unroll
        for (int c = 0; c < MC; ++c) ndxd[c] += __shfl_xor_sync(L.run_mask, ndxd[c], off);
      }
      if (L.q == 0) store_ch(dxd + node * HD + L.k0, ndxd, L.nc, vec);
    }
  }

  // the block's sums: over the slot lanes and the warp's nodes (lanes l,
  // l ^ 1, ... below Q and l + G, ... own the same channels), all NS * MC
  // values a level at a time, then warp by warp, in a fixed order
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int owners = a.G / a.Q;        // channel groups of a node
  for (int off = 1; off < 32; off <<= 1) {
    if (off >= a.Q && off < a.G) continue;   // lanes of other channels
#pragma unroll
    for (int i = 0; i < NS * MC; ++i) x[i] += __shfl_xor_sync(0xffffffffu, x[i], off);
  }
  if (wl < a.G && (wl & (a.Q - 1)) == 0) {
#pragma unroll
    for (int i = 0; i < NS * MC; ++i) s_red[warp][(wl / a.Q) * NS * MC + i] = x[i];
  }
  __syncthreads();
  const int stride = sum_stride(NS, HD);
  float* row = part + static_cast<long long>(blockIdx.x) * stride;
  for (int j = threadIdx.x; j < owners * NS * MC; j += kThreads) {
    const int o = j / (NS * MC), k = (j / MC) % NS, c = j % MC;
    const Lane O = lane_geometry(a, o * a.Q);
    if (c < O.nc) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += s_red[w][j];
      row[k * HD + O.k0 + c] = s;
    }
  }
  for (int j = NS * HD + threadIdx.x; j < stride; j += kThreads) row[j] = 0.f;
}

// K2's second kernel, one block: the column sums of the nb block rows, in
// block order, into d(att), d(w_e) and the uniform rows' d(xs), d(xd).
__global__ void __launch_bounds__(kSumThreads)
gat_tile_fused_bwd_sum_kernel(const float* __restrict__ part, int nb, int HD,
                              int xs_uniform, int xd_uniform,
                              float* __restrict__ dxs, float* __restrict__ dxd,
                              float* __restrict__ datt, float* __restrict__ dwe) {
  __shared__ float4 s_col[kSumThreads];
  __shared__ float s_tot[kSums * kMaxHD];
  // wait until the first kernel has finished and its rows are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int ns = 2 + xs_uniform + xd_uniform;
  sum_rows(part, nb, sum_stride(ns, HD), s_tot, s_col);
  for (int j = threadIdx.x; j < ns * HD; j += blockDim.x) {
    const int k = j / HD, ch = j - k * HD;
    if (k == 0) datt[ch] = s_tot[j];
    else if (k == 1) dwe[ch] = s_tot[j];
    else if (k == 2 && xs_uniform) dxs[ch] = s_tot[j];
    else dxd[ch] = s_tot[j];
  }
}

// Checks the lane plan and fills the launch arguments and the block
// count; 0 or a CUDA error.
int make_args(GatArgs& a, long long& blocks, const void* starts,
              const void* order, const void* attr, const void* xs,
              const void* xd, const void* w_e, const void* att, int T, int S,
              int TN, int H, int D, int P, int Q, int xs_uniform,
              int xd_uniform, int vec, float slope) {
  const bool pow2 = P >= 1 && Q >= 1 && P <= 32 && Q <= 32 && !(P & (P - 1))
                    && !(Q & (Q - 1));
  if (H < 1 || H > kMaxHeads || D < 1 || !pow2 || (D + P - 1) / P > kMaxC
      || T < 0 || S < 0 || TN < 0
      || static_cast<long long>(T) * S * H * D >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int G = 1;
  while (G < H * P * Q) G <<= 1;
  if (G > 32 || H * D > kMaxHD) return static_cast<int>(cudaErrorInvalidValue);
  const int npb = kThreads / G;
  blocks = static_cast<long long>(T) * ((TN + npb - 1) / npb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a = GatArgs{static_cast<const int*>(starts), static_cast<const int*>(order),
              static_cast<const float*>(attr), static_cast<const float*>(xs),
              static_cast<const float*>(xd), static_cast<const float*>(w_e),
              static_cast<const float*>(att), T, S, TN, H, D, P, Q, G,
              xs_uniform, xd_uniform, vec, slope};
  return 0;
}

template <int MC, bool XSU, bool XDU>
void launch_fwd(dim3 grid, cudaStream_t s, const GatArgs& a, float* out) {
  gat_tile_fused_fwd_kernel<MC, XSU, XDU><<<grid, kThreads, 0, s>>>(a, out);
}

template <int MC, bool XSU, bool XDU>
void launch_bwd(dim3 grid, cudaStream_t s, const GatArgs& a, const float* g,
                float* dxs, float* dxd, float* part) {
  gat_tile_fused_bwd_kernel<MC, XSU, XDU><<<grid, kThreads, 0, s>>>(a, g, dxs, dxd, part);
}

// The instance for the channels per lane and the uniform rows.
template <template <int, bool, bool> class F, typename... Args>
void dispatch(const GatArgs& a, Args... args) {
  const bool narrow = (a.D + a.P - 1) / a.P <= 4;
  const int key = (narrow ? 4 : 0) + (a.xs_uniform ? 2 : 0) + (a.xd_uniform ? 1 : 0);
  switch (key) {
    case 7: F<4, true, true>::run(args...); break;
    case 6: F<4, true, false>::run(args...); break;
    case 5: F<4, false, true>::run(args...); break;
    case 4: F<4, false, false>::run(args...); break;
    case 3: F<8, true, true>::run(args...); break;
    case 2: F<8, true, false>::run(args...); break;
    case 1: F<8, false, true>::run(args...); break;
    default: F<8, false, false>::run(args...); break;
  }
}

template <int MC, bool XSU, bool XDU>
struct Fwd {
  template <typename... Args>
  static void run(Args... args) { launch_fwd<MC, XSU, XDU>(args...); }
};

template <int MC, bool XSU, bool XDU>
struct Bwd {
  template <typename... Args>
  static void run(Args... args) { launch_bwd<MC, XSU, XDU>(args...); }
};

}  // namespace

extern "C" int gat_tile_fused_fwd(const void* starts, const void* order,
                                  const void* attr, const void* xs,
                                  const void* xd, const void* w_e,
                                  const void* att, void* out, int T, int S,
                                  int TN, int H, int D, int P, int Q,
                                  int xs_uniform, int xd_uniform, int vec,
                                  float slope, void* stream) {
  GatArgs a;
  long long blocks = 0;
  const int bad = make_args(a, blocks, starts, order, attr, xs, xd, w_e, att, T,
                            S, TN, H, D, P, Q, xs_uniform, xd_uniform, vec,
                            slope);
  if (bad) return bad;
  if (blocks > 0)
    dispatch<Fwd>(a, dim3(static_cast<unsigned>(blocks)),
                  static_cast<cudaStream_t>(stream), a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// part: [T * ceil(TN * G / 128), (2 + xs_uniform + xd_uniform) * H * D
// rounded up to a multiple of 4] float32 scratch.  Two kernels: the
// per-node work and the row sums (a programmatic dependent launch).
extern "C" int gat_tile_fused_bwd(const void* starts, const void* order,
                                  const void* attr, const void* xs,
                                  const void* xd, const void* w_e,
                                  const void* att, const void* g, void* dxs,
                                  void* dxd, void* datt, void* dwe, void* part,
                                  int T, int S, int TN, int H, int D, int P,
                                  int Q, int xs_uniform, int xd_uniform,
                                  int vec, float slope, void* stream) {
  GatArgs a;
  long long blocks = 0;
  const int bad = make_args(a, blocks, starts, order, attr, xs, xd, w_e, att, T,
                            S, TN, H, D, P, Q, xs_uniform, xd_uniform, vec,
                            slope);
  if (bad) return bad;
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *o0 = static_cast<float*>(dxs), *o1 = static_cast<float*>(dxd),
        *pp = static_cast<float*>(part);
  dispatch<Bwd>(a, dim3(static_cast<unsigned>(blocks)), s, a,
                static_cast<const float*>(g), o0, o1, pp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kSumThreads);
  cfg.stream = s;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, gat_tile_fused_bwd_sum_kernel, static_cast<const float*>(part),
      static_cast<int>(blocks), H * D, xs_uniform, xd_uniform, o0, o1,
      static_cast<float*>(datt), static_cast<float*>(dwe)));
}
