// K3: the windowed source-row gather, vals[src] per edge slot, and its
// transpose K4 (the scatter-add of the backward pass), each one launch over
// every slot-width bucket of a layer; then the tile segment ops K5
// (softmax), K6 (sum) and K7 (broadcast) at the end of the file.
//
// K3 replaces the TPU kernel gflownet_spai_tpu/ops/segment.py
// `_gather_win_kernel` (launched by `_gather_win_pallas`) together with the
// outlier overwrite that follows it in `_gather_rows_p`; K4 replaces
// `_scatter_win_kernel` (launched by `_scatter_win_pallas`) together with
// the outlier fixup of `_gather_rows_bwd`.  The TPU has no vector gather or
// scatter, so those turn each tile's rows into onehot matmuls over two
// W-row windows, one pallas_call per bucket, and patch the outliers
// afterwards.  A GPU gathers natively.  The wrapper (ops/segment.py
// `row_plan`) folds the buckets' window plans (blk, lsrc, the outlier
// lists) once per layout into one effective source row per slot, over the
// buckets' slots laid end to end (bucket b's from off[b]), with n meaning
// "no row", and into its inverse in CSR form (row_ptr [n + 1]; each row's
// slots in ascending order):
//
//   K3:  out_b[s - off[b], :] = vals[rows[s], :]    (0 where rows[s] == n)
//   K4:  dv[r, :] = sum of g_b[s - off[b], :] over the slots s of row r
//
// What bounds both on an H100: bytes (K3 does no arithmetic, K4 one add per
// word read), about 5 MB a call on the slice's layout, 1.5 us at 3.35 TB/s:
// as long as one launch's fixed cost, so one launch serves every bucket,
// with the buckets' row pointers and slot offsets passed by value.  A
// thread moves one 16-byte chunk of a row (float4) where D % 4 == 0 and
// every row pointer is 16-byte aligned, one float otherwise (another
// instance of the same kernel).
//
// K4 uses no atomics and no memset.  A thread owns one chunk of one row of
// dv: it issues the loads of up to kBatch of the row's slot indices, then
// of their cotangents, then adds them in ascending slot order starting
// from 0, and writes the row (0 where no slot reads it).  That is the order
// in which index_add_ on the CPU sums, so the plain version gives the same
// bits.  A row read by more than kHubSlots slots (a hub) is summed by a
// warp: lane l adds the row's slots l, l + 32, l + 64, ... in ascending
// order, then the 32 lane sums merge by an xor butterfly over lane
// distances 16, 8, 4, 2, 1.  Every order is fixed, so two launches give the
// same bits.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 128;   // K3, K4: small blocks, to spread ~45k rows over every SM
constexpr int kMaxBuckets = 8;
constexpr int kHubSlots = 32;      // rows read by more slots are summed by a warp
constexpr int kBatch = 16;         // slots of a row whose loads are in flight together

// Each bucket's [T_b*S_b, D] slot rows (K3's outputs, K4's cotangents; a
// null K4 cotangent reads as zeros) and the global slot where it starts.
struct Buckets {
  float* ptr[kMaxBuckets];
  int off[kMaxBuckets];
  int nb;
};

template <typename V> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int kWords = 1;
  __device__ static float zero() { return 0.f; }
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float add(float a, float b) { return a + b; }
  __device__ static float shfl_xor(float a, int m) {
    return __shfl_xor_sync(0xffffffffu, a, m);
  }
};

template <> struct Chunk<float4> {
  static constexpr int kWords = 4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
  __device__ static float4 shfl_xor(float4 a, int m) {
    return make_float4(__shfl_xor_sync(0xffffffffu, a.x, m),
                       __shfl_xor_sync(0xffffffffu, a.y, m),
                       __shfl_xor_sync(0xffffffffu, a.z, m),
                       __shfl_xor_sync(0xffffffffu, a.w, m));
  }
};

// The bucket that global slot s lies in: its row pointer, and s's index
// within it.  Constant indices only, so the table stays in parameter space.
__device__ __forceinline__ float* bucket_row(const Buckets& bt, int s, int& local) {
  float* p = bt.ptr[0];
  int o = 0;
#pragma unroll
  for (int b = 1; b < kMaxBuckets; ++b)
    if (b < bt.nb && s >= bt.off[b]) {
      p = bt.ptr[b];
      o = bt.off[b];
    }
  local = s - o;
  return p;
}

template <typename V>
__device__ __forceinline__ V slot_chunk(const Buckets& bt, int s, int q, int c) {
  int local;
  const float* g = bucket_row(bt, s, local);
  return g ? Chunk<V>::load(g + (static_cast<long long>(local) * q + c) * Chunk<V>::kWords)
           : Chunk<V>::zero();
}

// K3: one thread per (slot, chunk) of the buckets' slots; q chunks a row.
template <typename V>
__global__ void __launch_bounds__(kRowThreads)
gather_rows_kernel(const int* __restrict__ rows, const float* __restrict__ vals,
                   const Buckets bt, int total, int q, int n) {
  const int i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= total) return;
  const int s = i / q, c = i - s * q;
  const int r = __ldg(rows + s);
  const V v = static_cast<unsigned>(r) < static_cast<unsigned>(n)
                  ? Chunk<V>::load(vals + (static_cast<long long>(r) * q + c) * Chunk<V>::kWords)
                  : Chunk<V>::zero();
  int local;
  float* out = bucket_row(bt, s, local);
  *reinterpret_cast<V*>(out + (static_cast<long long>(local) * q + c) * Chunk<V>::kWords) = v;
}

// K4: blocks [0, row_blocks) give a thread to each (row, chunk) of dv and
// skip hubs; the blocks after them give a warp to each hub row in `hubs`.
template <typename V>
__global__ void __launch_bounds__(kRowThreads)
scatter_rows_kernel(const int* __restrict__ row_ptr, const int* __restrict__ slots,
                    const int* __restrict__ hubs, const Buckets bt,
                    float* __restrict__ dv, int n, int q, int row_blocks, int n_hubs) {
  constexpr int W = Chunk<V>::kWords;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const int i = blockIdx.x * kRowThreads + threadIdx.x;
    if (i >= n * q) return;
    const int r = i / q, c = i - r * q;
    const int beg = __ldg(row_ptr + r), end = __ldg(row_ptr + r + 1);
    if (end - beg > kHubSlots) return;
    V acc = Chunk<V>::zero();
    for (int k0 = beg; k0 < end; k0 += kBatch) {
      int idx[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) idx[j] = k0 + j < end ? __ldg(slots + k0 + j) : -1;
      V x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        x[j] = idx[j] >= 0 ? slot_chunk<V>(bt, idx[j], q, c) : Chunk<V>::zero();
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (k0 + j < end) acc = Chunk<V>::add(acc, x[j]);
    }
    *reinterpret_cast<V*>(dv + (static_cast<long long>(r) * q + c) * W) = acc;
    return;
  }
  const int w = ((blockIdx.x - row_blocks) * kRowThreads + threadIdx.x) >> 5;
  if (w >= n_hubs) return;                      // the whole warp
  const int lane = threadIdx.x & 31;
  const int r = __ldg(hubs + w);
  const int beg = __ldg(row_ptr + r), end = __ldg(row_ptr + r + 1);
  for (int c = 0; c < q; ++c) {
    V acc = Chunk<V>::zero();
    for (int k = beg + lane; k < end; k += 32)
      acc = Chunk<V>::add(acc, slot_chunk<V>(bt, __ldg(slots + k), q, c));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc = Chunk<V>::add(acc, Chunk<V>::shfl_xor(acc, m));
    if (lane == 0) *reinterpret_cast<V*>(dv + (static_cast<long long>(r) * q + c) * W) = acc;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

// The by-value table from the wrapper's arrays (nb row pointers, nb + 1
// slot offsets from 0, ascending); false where they do not fit.  `vec`:
// D % 4 == 0 and every row pointer, `other` (vals or dv) too, is 16-byte
// aligned, so a thread may move 16-byte chunks.
bool fill_buckets(Buckets& bt, void* const* ptrs, const int* offs, int nb, int D,
                  const void* other, bool& vec) {
  if (nb < 1 || nb > kMaxBuckets || D < 1 || offs[0] != 0) return false;
  vec = D % 4 == 0 && aligned16(other);
  for (int b = 0; b < kMaxBuckets; ++b) {
    const bool used = b < nb;
    if (used && offs[b + 1] < offs[b]) return false;
    bt.ptr[b] = used ? static_cast<float*>(ptrs[b]) : nullptr;
    bt.off[b] = used ? offs[b] : 0;
    vec = vec && aligned16(bt.ptr[b]);
  }
  bt.nb = nb;
  return true;
}

bool fits_int(long long a, long long b) { return a >= 0 && b >= 0 && a * b < (1LL << 31); }

}  // namespace

// K3 over nb buckets: rows int32 [offs[nb]] (the effective source rows),
// vals [n, D], outs[b] [offs[b + 1] - offs[b], D].
extern "C" int gather_rows_buckets_fwd(const void* rows, const void* vals,
                                       void* const* outs, const int* offs, int nb,
                                       int D, int n, void* stream) {
  Buckets bt;
  bool vec = false;
  if (!fill_buckets(bt, outs, offs, nb, D, vals, vec) || !fits_int(offs[nb], D) ||
      !fits_int(n, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = vec ? D / 4 : D;
  const int total = offs[nb] * q;
  if (total > 0) {
    const unsigned blocks = static_cast<unsigned>((total + kRowThreads - 1) / kRowThreads);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* r = static_cast<const int*>(rows);
    const float* v = static_cast<const float*>(vals);
    if (vec)
      gather_rows_kernel<float4><<<blocks, kRowThreads, 0, st>>>(r, v, bt, total, q, n);
    else
      gather_rows_kernel<float><<<blocks, kRowThreads, 0, st>>>(r, v, bt, total, q, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 over nb buckets: row_ptr int32 [n + 1], slots int32 [row_ptr[n]] (the
// global slots of each row, ascending), hubs int32 [n_hubs] (the rows read
// by more than kHubSlots slots), gs[b] [offs[b + 1] - offs[b], D] or null
// (zeros) -> dv [n, D], every row written.
extern "C" int scatter_rows_buckets_bwd(const void* row_ptr, const void* slots,
                                        const void* hubs, void* const* gs,
                                        const int* offs, int nb, int D, int n,
                                        int n_hubs, void* dv, void* stream) {
  Buckets bt;
  bool vec = false;
  if (!fill_buckets(bt, gs, offs, nb, D, dv, vec) || !fits_int(offs[nb], D) ||
      !fits_int(n, D) || !fits_int(n_hubs, 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q = vec ? D / 4 : D;
  const int row_blocks = (n * q + kRowThreads - 1) / kRowThreads;
  const int hub_blocks = (n_hubs * 32 + kRowThreads - 1) / kRowThreads;
  if (row_blocks + hub_blocks > 0) {
    const unsigned blocks = static_cast<unsigned>(row_blocks + hub_blocks);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* rp = static_cast<const int*>(row_ptr);
    const int* sl = static_cast<const int*>(slots);
    const int* hb = static_cast<const int*>(hubs);
    float* out = static_cast<float*>(dv);
    if (vec)
      scatter_rows_kernel<float4><<<blocks, kRowThreads, 0, st>>>(
          rp, sl, hb, bt, out, n, q, row_blocks, n_hubs);
    else
      scatter_rows_kernel<float><<<blocks, kRowThreads, 0, st>>>(
          rp, sl, hb, bt, out, n, q, row_blocks, n_hubs);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K5, K6, K7: segment softmax, segment sum and node -> slot broadcast over the
// node-tile layout.  Tile t has S edge slots; local_dst[t, s] is the slot's
// destination node within the tile, and a slot whose id lies outside
// [0, TN) is padding.
//
// They replace the TPU kernels of gflownet_spai_tpu/ops/segment.py
// `_softmax_kernel` (launched by `_softmax_pallas`), `_sum_kernel`
// (`_sum_pallas`) and `_broadcast_kernel` (`_broadcast_pallas`).  Mosaic has
// no vector scatter, so those build a [TN, S] onehot per tile and run every
// segment op as masked reductions and onehot matmuls: O(TN.S) work per tile
// for O(S) data, for any local_dst.  K5's backward is the same VJP as
// `_softmax_tiles_bwd`, which there takes a `_sum_pallas` and a
// `_broadcast_pallas` with the heads as the feature axis.
//
// K5 and K6 walk each node's run of slots instead, O(S) per tile and head,
// in a fixed order, so the results are deterministic.  The wrapper passes
// the layout's run starts [T, TN + 1] (ops/segment.py `layout_runs`,
// computed once per layout): node v's slots are positions starts[t, v] ..
// starts[t, v + 1] - 1, padding positions starts[t, TN] .. S - 1.  Where
// the builders' order holds (ids non-decreasing per tile, padding last) a
// position is a slot; otherwise the wrapper also passes `order` [T, S], the
// slot at each position (a stable sort by node, padding last), and every
// slot access goes through it.  No kernel reads local_dst but K7.
//
// What bounds them on an H100: bytes (a few operations per word).  On the
// generic GATv2 layer's layout (T 352, S 1,152, TN 128) K5 moves 13 MB at
// H 4, K7 writes 26 MB at D 16 and K6 reads 12.9 MB: a few microseconds,
// so each call needs a grid that fills every SM.
//
//   K5: [T, H, S] scores -> [T, H, S].  A grid over (tile, (head, node)
//       group).  A (node, head) gets L slot lanes; lane l holds the slots
//       of the run's positions start + l, start + l + L, ... and their
//       scores in registers (kRunRegs of them, so a run of up to
//       L.kRunRegs slots is read once; a longer run reads its tail again
//       in each pass).  The lanes merge the max, then the sum of
//       exp(s - max) in ascending order, by an xor butterfly over lane
//       distances 1, 2, ..., L/2 (float max and add commute, so every lane
//       ends with the same bits), and each lane writes
//       exp(s - max) / max(sum, 1e-30) for its slots.  First of all, the
//       TN.L threads of a (tile, head) write 0 at its padding positions,
//       adjacent threads at adjacent positions, so those stores overlap the
//       run's loads.  The TPU kernel masks with -1e30 where its jnp oracle
//       uses -inf: the same for finite scores.  (Measured on an H100 at
//       the slice's layout: staging a group's span in shared memory, a
//       thread per position, or all heads of a node in one thread were
//       each slower.)
//   K5 backward: y, g [T, H, S] -> dx = y (g - sum over the run of y.g),
//       0 on padding.  The same grid, lanes, registers and butterfly; the
//       products are rounded before they are added (no FMA), as the plain
//       version's y * g is.
//   K6: [T, S, D] -> [T, TN, D].  A grid over (tile, node group).  A node
//       gets G = P.R lanes: lane (r, p) adds chunks p, p + P, ... of the
//       run's rows start + r, start + r + R, ... in ascending order (loads
//       batched ahead of the adds), then the R slot lanes merge by an xor
//       butterfly over lane distances P, 2P, ..., G/2 and the lanes with
//       r == 0 write the row; a node with no slot writes 0.  Adjacent lanes
//       read adjacent chunks of one row, and adjacent nodes' spans are
//       adjacent, so a warp reads contiguous memory where there is no
//       `order`.  The wrapper picks R from the layout's mean run (two or
//       three slots a lane) and P from the row's chunks; R alone sets the
//       order of the sums.  No atomics, no memset.
//   K7: [T, TN, D] -> [T, S, D].  A grid over (tile, slot chunk): a thread
//       reads its slot's local id once and moves one chunk of the slot's
//       row; padding slots write 0 without a read.  Bit-exact: it only moves
//       values.
//
// K5 moves single floats: a node's run is a span of one head's row that is
// rarely 16-byte aligned at the slice's run lengths (4.49 slots on
// average).  For K6 and K7 a chunk is 16 bytes (float4) where D % 4 == 0
// and the pointers are 16-byte aligned, one float otherwise (a scalar
// instance of the same kernel); the widths the generic layer uses (16, 4)
// are template constants, so no thread divides by D.  K7 at D 1 gives a
// thread 4 adjacent slots (an int4 of ids, a float4 of outputs; S is a
// multiple of 128).
// ---------------------------------------------------------------------------

namespace {

constexpr int kTileThreads = 128;   // K5, K6, K7
constexpr int kSumBatch = 4;        // K6: slots of a lane whose loads are in flight together
constexpr int kRunRegs = 4;         // K5: positions of a lane's share held in registers

// The slot at position p of a tile's run order (ORD false: the identity,
// and `ord` is not read).  Each kernel that takes an order has an instance
// without one, so the builders' layouts pay nothing for it.
template <bool ORD>
__device__ __forceinline__ int slot_at(const int* __restrict__ ord, int p) {
  return ORD ? __ldg(ord + p) : p;
}

// What K5's forward and backward share: the (tile, head, node, lane) of a
// thread and the run of its node.  Threads past the last head (the grid's
// ragged edge) get an empty run and take part in the butterflies.
struct RunLane {
  long long row;    // offset of the (tile, head) row of S values
  const int* ord;   // the tile's order, or null
  int beg, end;     // the node's positions
  int first;        // this lane's first position: beg + l
  int pad, idx;     // the tile's first padding position; the thread's index in its (tile, head)
  bool live;
};

__device__ __forceinline__ RunLane run_lane(const int* __restrict__ starts,
                                            const int* __restrict__ order, int S,
                                            int H, int TN, int ll) {
  RunLane r;
  const long long t = blockIdx.x;
  const int i = blockIdx.y * kTileThreads + threadIdx.x;
  const int hv = i >> ll, h = hv / TN, v = hv - h * TN;
  r.live = h < H;
  r.idx = i - h * (TN << ll);
  r.row = (t * H + (r.live ? h : 0)) * S;
  r.ord = order ? order + t * S : nullptr;
  r.beg = r.end = r.pad = 0;
  if (r.live) {
    const int* st = starts + t * (TN + 1);
    r.beg = __ldg(st + v);
    r.end = __ldg(st + v + 1);
    r.pad = __ldg(st + TN);
  }
  r.first = r.beg + (i & ((1 << ll) - 1));
  return r;
}

__device__ __forceinline__ float lanes_max(float x, int L) {
  for (int m = 1; m < L; m <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float lanes_sum(float x, int L) {
  for (int m = 1; m < L; m <<= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

// 0 at every padding position of the (tile, head) row: thread idx of the
// row's TN.L threads takes positions pad + idx, pad + idx + TN.L, ...
// Issued before the run's loads, so the stores overlap their latency.
template <bool ORD>
__device__ __forceinline__ void zero_padding(const RunLane& r, float* __restrict__ out,
                                             int S, int stride) {
  if (!r.live) return;
  for (int p = r.pad + r.idx; p < S; p += stride) out[r.row + slot_at<ORD>(r.ord, p)] = 0.f;
}

// The slots of a lane's first kRunRegs positions (-1 past the run).
template <bool ORD>
__device__ __forceinline__ void lane_slots(const RunLane& r, int L, int (&sl)[kRunRegs]) {
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j) {
    const int p = r.first + j * L;
    sl[j] = p < r.end ? slot_at<ORD>(r.ord, p) : -1;
  }
}

// K5.  Grid (T, blocks of H.TN.L threads a tile); L = 1 << ll lanes a
// (node, head).  No thread returns before the butterflies.
template <bool ORD>
__global__ void __launch_bounds__(kTileThreads)
seg_softmax_kernel(const int* __restrict__ starts, const int* __restrict__ order,
                   const float* __restrict__ scores, float* __restrict__ out, int S,
                   int H, int TN, int ll) {
  const int L = 1 << ll;
  const RunLane r = run_lane(starts, order, S, H, TN, ll);
  zero_padding<ORD>(r, out, S, TN * L);
  const float* x = scores + r.row;
  int sl[kRunRegs];
  lane_slots<ORD>(r, L, sl);
  float e[kRunRegs];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j) {
    e[j] = sl[j] >= 0 ? __ldg(x + sl[j]) : -INFINITY;
    m = fmaxf(m, e[j]);
  }
  const int tail = r.first + kRunRegs * L;
  for (int p = tail; p < r.end; p += L) m = fmaxf(m, __ldg(x + slot_at<ORD>(r.ord, p)));
  m = lanes_max(m, L);
  float den = 0.f;
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j)
    if (sl[j] >= 0) {
      e[j] = expf(e[j] - m);
      den = __fadd_rn(den, e[j]);
    }
  for (int p = tail; p < r.end; p += L)
    den = __fadd_rn(den, expf(__ldg(x + slot_at<ORD>(r.ord, p)) - m));
  den = fmaxf(lanes_sum(den, L), 1e-30f);
  float* y = out + r.row;
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j)
    if (sl[j] >= 0) y[sl[j]] = e[j] / den;
  for (int p = tail; p < r.end; p += L) {
    const int s = slot_at<ORD>(r.ord, p);
    y[s] = expf(__ldg(x + s) - m) / den;
  }
}

// K5 backward: the forward's grid and lanes.
template <bool ORD>
__global__ void __launch_bounds__(kTileThreads)
seg_softmax_bwd_kernel(const int* __restrict__ starts, const int* __restrict__ order,
                       const float* __restrict__ y, const float* __restrict__ g,
                       float* __restrict__ dx, int S, int H, int TN, int ll) {
  const int L = 1 << ll;
  const RunLane r = run_lane(starts, order, S, H, TN, ll);
  zero_padding<ORD>(r, dx, S, TN * L);
  const float* yr = y + r.row;
  const float* gr = g + r.row;
  int sl[kRunRegs];
  lane_slots<ORD>(r, L, sl);
  float ys[kRunRegs], gs[kRunRegs];
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j) {
    ys[j] = sl[j] >= 0 ? __ldg(yr + sl[j]) : 0.f;
    gs[j] = sl[j] >= 0 ? __ldg(gr + sl[j]) : 0.f;
  }
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j)
    if (sl[j] >= 0) dot = __fadd_rn(dot, __fmul_rn(ys[j], gs[j]));
  const int tail = r.first + kRunRegs * L;
  for (int p = tail; p < r.end; p += L) {
    const int s = slot_at<ORD>(r.ord, p);
    dot = __fadd_rn(dot, __fmul_rn(__ldg(yr + s), __ldg(gr + s)));
  }
  dot = lanes_sum(dot, L);
  float* d = dx + r.row;
#pragma unroll
  for (int j = 0; j < kRunRegs; ++j)
    if (sl[j] >= 0) d[sl[j]] = __fmul_rn(ys[j], __fsub_rn(gs[j], dot));
  for (int p = tail; p < r.end; p += L) {
    const int s = slot_at<ORD>(r.ord, p);
    d[s] = __fmul_rn(__ldg(yr + s), __fsub_rn(__ldg(gr + s), dot));
  }
}

// K6.  Grid (T, node blocks of a tile); Q chunks a row (0: q_rt, at run
// time); P = 1 << lp chunk lanes and R = 1 << lr slot lanes a node; the
// run's positions go through `order` where it is not null.  No thread
// returns early: every lane of a warp takes part in the butterfly.
template <typename V, int Q, bool ORD>
__global__ void __launch_bounds__(kTileThreads)
seg_sum_kernel(const int* __restrict__ starts, const int* __restrict__ order,
               const float* __restrict__ vals, float* __restrict__ out, int S, int TN,
               int q_rt, int lp, int lr) {
  constexpr int W = Chunk<V>::kWords;
  const int q = Q > 0 ? Q : q_rt;
  const int lg = lp + lr, P = 1 << lp, R = 1 << lr;
  const long long t = blockIdx.x;
  const int v = (blockIdx.y * kTileThreads + threadIdx.x) >> lg;
  const int g = threadIdx.x & ((1 << lg) - 1);
  const int p = g & (P - 1), r = g >> lp;
  int beg = 0, end = 0;
  if (v < TN) {
    const int* st = starts + t * (TN + 1) + v;
    beg = __ldg(st);
    end = __ldg(st + 1);
  }
  const float* span = vals + t * S * q * W;
  const int* ord = order ? order + t * S : nullptr;
  for (int c0 = 0; c0 < q; c0 += P) {
    const int c = c0 + p;
    V acc = Chunk<V>::zero();
    if (c < q) {
      for (int s0 = beg + r; s0 < end; s0 += kSumBatch * R) {
        V x[kSumBatch];
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) {
          const int s = s0 + j * R;
          x[j] = s < end ? Chunk<V>::load(
                               span + (static_cast<long long>(slot_at<ORD>(ord, s)) * q + c) * W)
                         : Chunk<V>::zero();
        }
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j)
          if (s0 + j * R < end) acc = Chunk<V>::add(acc, x[j]);
      }
    }
    for (int m = P; m < (1 << lg); m <<= 1) acc = Chunk<V>::add(acc, Chunk<V>::shfl_xor(acc, m));
    if (r == 0 && c < q && v < TN)
      *reinterpret_cast<V*>(out + ((t * TN + v) * q + c) * W) = acc;
  }
}

// K7.  Grid (T, chunk blocks of a tile); a thread moves chunk c of slot s.
template <typename V, int Q>
__global__ void __launch_bounds__(kTileThreads)
seg_broadcast_kernel(const int* __restrict__ local_dst, const float* __restrict__ node_vals,
                     float* __restrict__ out, int S, int TN, int q_rt) {
  constexpr int W = Chunk<V>::kWords;
  const int q = Q > 0 ? Q : q_rt;
  const long long t = blockIdx.x;
  const int i = blockIdx.y * kTileThreads + threadIdx.x;
  if (i >= S * q) return;
  const int s = i / q, c = i - s * q;
  const int l = __ldg(local_dst + t * S + s);
  const V x = static_cast<unsigned>(l) < static_cast<unsigned>(TN)
                  ? Chunk<V>::load(node_vals + ((t * TN + l) * q + c) * W)
                  : Chunk<V>::zero();
  *reinterpret_cast<V*>(out + ((t * S + s) * q + c) * W) = x;
}

// K7 at D 1: a thread moves slots 4j .. 4j + 3 of its tile.
__global__ void __launch_bounds__(kTileThreads)
seg_broadcast_quad_kernel(const int* __restrict__ local_dst,
                          const float* __restrict__ node_vals, float* __restrict__ out,
                          int S, int TN) {
  const long long t = blockIdx.x;
  const int j = blockIdx.y * kTileThreads + threadIdx.x;
  if (4 * j >= S) return;
  const int4 l = __ldg(reinterpret_cast<const int4*>(local_dst + t * S) + j);
  const float* row = node_vals + t * TN;
  const unsigned tn = static_cast<unsigned>(TN);
  float4 x;
  x.x = static_cast<unsigned>(l.x) < tn ? __ldg(row + l.x) : 0.f;
  x.y = static_cast<unsigned>(l.y) < tn ? __ldg(row + l.y) : 0.f;
  x.z = static_cast<unsigned>(l.z) < tn ? __ldg(row + l.z) : 0.f;
  x.w = static_cast<unsigned>(l.w) < tn ? __ldg(row + l.w) : 0.f;
  reinterpret_cast<float4*>(out + t * S)[j] = x;
}

int tile_launch_check(int T, int S, int D, int TN) {
  if (T < 0 || S < 1 || D < 1 || TN < 1 || TN > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// The second grid dimension of a K5, K6 or K7 launch: `work` threads of a tile.
bool tile_grid(long long work, dim3& grid, int T) {
  const long long blocks = (work + kTileThreads - 1) / kTileThreads;
  if (blocks > 65535) return false;
  grid = dim3(static_cast<unsigned>(T), static_cast<unsigned>(blocks > 0 ? blocks : 1));
  return true;
}

bool pow2_log(int x, int& lg) {
  if (x < 1 || (x & (x - 1))) return false;
  for (lg = 0; (1 << lg) < x; ++lg) {}
  return true;
}

// K6's instance for the chunk type, the row's chunks and whether there is
// an order.
template <typename V, int Q>
void sum_launch(dim3 grid, cudaStream_t st, const int* s, const int* od, const float* v,
                float* o, int S, int TN, int q, int lp, int lr) {
  if (od)
    seg_sum_kernel<V, Q, true><<<grid, kTileThreads, 0, st>>>(s, od, v, o, S, TN, q, lp, lr);
  else
    seg_sum_kernel<V, Q, false><<<grid, kTileThreads, 0, st>>>(s, od, v, o, S, TN, q, lp, lr);
}

// K5 and its backward: the grid and lanes they share.  L slot lanes a
// (node, head), a power of two up to 32.
bool softmax_grid(int T, int S, int H, int TN, int L, dim3& grid, int& ll) {
  return tile_launch_check(T, S, H, TN) == 0 && pow2_log(L, ll) && L <= 32 &&
         tile_grid(static_cast<long long>(H) * TN * L, grid, T);
}

}  // namespace

// K5.  starts [T, TN + 1] int32, order [T, S] int32 or null (see above),
// scores and out [T, H, S].
extern "C" int segment_softmax_tiles_fwd(const void* starts, const void* order,
                                         const void* scores, void* out, int T, int S,
                                         int H, int TN, int L, void* stream) {
  dim3 grid;
  int ll = 0;
  if (!softmax_grid(T, S, H, TN, L, grid, ll)) return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* s = static_cast<const int*>(starts);
    const int* od = static_cast<const int*>(order);
    const float* x = static_cast<const float*>(scores);
    float* o = static_cast<float*>(out);
    if (od)
      seg_softmax_kernel<true><<<grid, kTileThreads, 0, st>>>(s, od, x, o, S, H, TN, ll);
    else
      seg_softmax_kernel<false><<<grid, kTileThreads, 0, st>>>(s, od, x, o, S, H, TN, ll);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5 backward.  y, g and dx [T, H, S]; the rest as K5.
extern "C" int segment_softmax_tiles_bwd(const void* starts, const void* order,
                                         const void* y, const void* g, void* dx, int T,
                                         int S, int H, int TN, int L, void* stream) {
  dim3 grid;
  int ll = 0;
  if (!softmax_grid(T, S, H, TN, L, grid, ll)) return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* s = static_cast<const int*>(starts);
    const int* od = static_cast<const int*>(order);
    const float* yp = static_cast<const float*>(y);
    const float* gp = static_cast<const float*>(g);
    float* d = static_cast<float*>(dx);
    if (od)
      seg_softmax_bwd_kernel<true><<<grid, kTileThreads, 0, st>>>(s, od, yp, gp, d, S, H, TN, ll);
    else
      seg_softmax_bwd_kernel<false><<<grid, kTileThreads, 0, st>>>(s, od, yp, gp, d, S, H, TN,
                                                                    ll);
  }
  return static_cast<int>(cudaGetLastError());
}

// K6.  starts [T, TN + 1] int32 and order [T, S] int32 or null (as K5),
// vals [T, S, D] -> out [T, TN, D].  vec: 16-byte chunks (D % 4 == 0, vals
// and out 16-byte aligned); P chunk lanes and R slot lanes a node, powers
// of two with P.R <= 32.
extern "C" int segment_sum_tiles_fwd(const void* starts, const void* order,
                                     const void* vals, void* out, int T, int S, int D,
                                     int TN, int vec, int P, int R, void* stream) {
  int lp = 0, lr = 0;
  dim3 grid;
  if (int rc = tile_launch_check(T, S, D, TN)) return rc;
  if (!pow2_log(P, lp) || !pow2_log(R, lr) || P * R > 32 ||
      (vec && (D % 4 || !aligned16(vals) || !aligned16(out))) ||
      !tile_grid(static_cast<long long>(TN) * P * R, grid, T))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* s = static_cast<const int*>(starts);
    const int* od = static_cast<const int*>(order);
    const float* v = static_cast<const float*>(vals);
    float* o = static_cast<float*>(out);
    if (vec && D == 16)
      sum_launch<float4, 4>(grid, st, s, od, v, o, S, TN, 4, lp, lr);
    else if (vec && D == 4)
      sum_launch<float4, 1>(grid, st, s, od, v, o, S, TN, 1, lp, lr);
    else if (vec)
      sum_launch<float4, 0>(grid, st, s, od, v, o, S, TN, D / 4, lp, lr);
    else if (D == 1)
      sum_launch<float, 1>(grid, st, s, od, v, o, S, TN, 1, lp, lr);
    else
      sum_launch<float, 0>(grid, st, s, od, v, o, S, TN, D, lp, lr);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7.  node_vals [T, TN, D] -> out [T, S, D]; the instance follows D and the
// pointers' alignment.
extern "C" int segment_broadcast_tiles_fwd(const void* local_dst, const void* node_vals,
                                           void* out, int T, int S, int D, int TN,
                                           void* stream) {
  if (int rc = tile_launch_check(T, S, D, TN)) return rc;
  const bool quad = D == 1 && S % 4 == 0 && aligned16(local_dst) && aligned16(out);
  const bool vec = D % 4 == 0 && aligned16(node_vals) && aligned16(out);
  const int q = vec ? D / 4 : D;
  dim3 grid;
  if (!tile_grid(quad ? S / 4 : static_cast<long long>(S) * q, grid, T))
    return static_cast<int>(cudaErrorInvalidValue);
  if (T > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int* l = static_cast<const int*>(local_dst);
    const float* v = static_cast<const float*>(node_vals);
    float* o = static_cast<float*>(out);
    if (quad)
      seg_broadcast_quad_kernel<<<grid, kTileThreads, 0, st>>>(l, v, o, S, TN);
    else if (vec && D == 16)
      seg_broadcast_kernel<float4, 4><<<grid, kTileThreads, 0, st>>>(l, v, o, S, TN, 4);
    else if (vec && D == 4)
      seg_broadcast_kernel<float4, 1><<<grid, kTileThreads, 0, st>>>(l, v, o, S, TN, 1);
    else if (vec)
      seg_broadcast_kernel<float4, 0><<<grid, kTileThreads, 0, st>>>(l, v, o, S, TN, q);
    else if (D == 1)
      seg_broadcast_kernel<float, 1><<<grid, kTileThreads, 0, st>>>(l, v, o, S, TN, 1);
    else
      seg_broadcast_kernel<float, 0><<<grid, kTileThreads, 0, st>>>(l, v, o, S, TN, q);
  }
  return static_cast<int>(cudaGetLastError());
}
