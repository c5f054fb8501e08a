"""Row-block fixed-pattern SpGEMM: ``‖M·A − I‖_F`` for unstructured seed
patterns as batched dense products (counterpart of
``gflownet_spai_tpu/sparse/rowblock.py``).

C = M·A row r only reads M's row-r values, a contiguous slice of the
row-major seed values, and pattern(C) is static, so the map from M's row-r
values to C's row-r values is a constant dense block ``G_r[c, k] = A[k-th
col of M row r, c-th col of C row r]``.  For a batch of masked value
vectors, C's row r is ``G_r @ m_window_r``: rows bucketed by padded (c_r,
m_r) size class give a handful of batched products ``[R, cp, mp] @ [R, mp,
B]`` (``torch.bmm``, float32 without TF32, as the JAX package's
``precision="highest"``).  The residual needs no C:
``‖C − I‖²_F = Σ_buckets Σ_{r,c} (y[r,c,b] − δ)² + (#rows whose C pattern
misses the diagonal)``; padding contributes exactly 0.

The host planner (``build_rowblock_plan``) is the JAX package's numpy code,
so every integer array of a plan and its float32 G blocks equal the JAX
plan's.  The products are plain PyTorch, as the JAX package's are
``jnp.einsum``s.

Two choices of the port:

* **bf16 G blocks** (``gemm_dtype=torch.bfloat16``): the JAX package rounds
  the window values to bf16 and multiplies on the matrix unit with float32
  accumulation.  The port rounds the same operands to bf16 and multiplies
  them as float32 (the products of two bf16 values are exact in float32),
  so the result is float32 with float32 sums; a bf16 ``bmm`` would return
  bf16.  The residual stays in the seed values' dtype.
* **Deterministic overflow rows**: the JAX package sums the overflow
  sub-plan with ``segment_sum``; the port lays the overflow slots out at
  plan time in groups of equal padded pair count (``ov_groups``), so the sum
  is a fixed-order dense reduction and a second call gives the same bits
  (``index_add_`` on CUDA floats would not).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .._device import resolve_device
from .ops import f32_exact
from .types import COO


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _size_class(x: int, align: int = 8, step: float = 1.5) -> int:
    """Pad-to-class: multiples of ``align`` up to 4·align, then a ×``step``-
    spaced ladder (step=1.5: 48, 64, 96, 128, 192, …) — bounds per-row
    padding waste at <step× while keeping the bucket count small."""
    x = max(x, 1)
    if x <= 4 * align:
        return _round_up(x, align)
    c = 4 * align
    while c < x:
        c = _round_up(max(int(c * step), c + 1), align)
    return c


@dataclasses.dataclass(frozen=True, eq=False)
class RowBlockPlan:
    """Static plan for C = M·A with fixed patterns, M values variable;
    tensors on one device.

    Per-bucket tensors (tuples, one entry per size class):
      gvals[b]    : [R, cp, mp] dense G blocks (A values placed); [R, mp,
                    cp] when ``layout="mc"``; [R, mp, mp] Gram blocks
                    H_r = G_rᵀG_r when ``compress="gram"``
      win_idx[b]  : int64[R, mp] indices into m_vals (padding points at the
                    appended 0)
      diag_pos[b] : int64[R] position of (r, r) in C row r's pattern, or cp
      out_pos[b]  : int64[R, cp] flat position in the row-major C pattern
                    (padding → out_nnz)
      lin[b]      : [R, mp] 2·G_rᵀe_r (gram only)
      onehot[b]   : [R, cp] the δ of each slot, in the accumulation dtype
                    (derived from diag_pos; exact plans only)

    Overflow rows (too wide or too sparse for a dense block) go through a
    pair sub-plan: ``ov_pair_m`` (M value per pair), ``ov_w`` (A value),
    ``ov_seg`` (overflow C slot), ``ov_diag`` and ``ov_out_pos`` per slot,
    as the JAX plan holds them, and ``ov_groups``, the same pairs laid out
    per slot: tuples (pair M index [S_g, k_g] (padding → nnz_m), pair A
    value [S_g, k_g] (padding 0), δ [S_g], C position [S_g]) for slots of
    at most k_g pairs, k_g a power of two.

    Window order (``order="window"``): the plan defines the edge
    enumeration, ``edge_perm`` mapping a new edge id to its sorted-CSR
    entry; bucket b's windows are the contiguous slice
    ``m_vals[win_off[b] : win_off[b] + R_b·win_w[b]]``.
    """

    gvals: Tuple[torch.Tensor, ...]
    win_idx: Tuple[torch.Tensor, ...]
    diag_pos: Tuple[torch.Tensor, ...]
    out_pos: Tuple[torch.Tensor, ...]
    ov_pair_m: torch.Tensor
    ov_w: torch.Tensor
    ov_seg: torch.Tensor
    ov_diag: torch.Tensor
    ov_out_pos: torch.Tensor
    out_row: torch.Tensor         # int64[out_nnz] pattern of C (row-major)
    out_col: torch.Tensor
    shape: Tuple[int, int]
    nnz_m: int = 0
    out_nnz: int = 0
    n_missing_diag: int = 0       # rows of C with no diagonal slot
    npairs: int = 0               # true (unpadded) multiply count
    n_overflow_slots: int = 0     # C slots handled by the pair sub-plan
    layout: str = "cm"
    compress: str = "none"
    n_bucket_diag: int = 0        # gram: bucket rows whose C row has a diagonal
    lin: Tuple[torch.Tensor, ...] = ()
    win_off: Tuple[int, ...] = ()
    win_w: Tuple[int, ...] = ()
    edge_perm: torch.Tensor | None = None
    onehot: Tuple[torch.Tensor, ...] = ()
    ov_groups: Tuple[Tuple[torch.Tensor, ...], ...] = ()

    @property
    def padded_slots(self) -> int:
        return sum(int(g.shape[0] * g.shape[1] * g.shape[2]) for g in self.gvals)


def _to_scipy_csr(coo: COO, pattern_only: bool = False):
    import scipy.sparse as sp

    h = coo.numpy()
    data = np.ones(coo.nnz, np.float64) if pattern_only else h.data.astype(np.float64)
    m = sp.csr_matrix((data, (h.row, h.col)), shape=coo.shape)
    m.sort_indices()
    return m


def _overflow_groups(ov_pair_m, ov_w, ov_seg, ov_diag, ov_out_pos, nnz_m, S):
    """The overflow pairs laid out per slot: slots grouped by their pair
    count rounded up to a power of two, each group a dense [S_g, k_g]
    gather (pairs of a slot in their sub-plan order, padding a pair of
    value 0 on the appended zero).  Host numpy."""
    if S == 0:
        return []
    order = np.argsort(ov_seg, kind="stable")
    counts = np.bincount(ov_seg, minlength=S)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    width = 1 << np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
    groups = []
    for k in np.unique(width):
        slots = np.nonzero(width == k)[0]
        j = np.arange(k)[None, :]
        inside = j < counts[slots][:, None]
        src = order[np.where(inside, starts[slots][:, None] + j, 0)]
        groups.append((np.where(inside, ov_pair_m[src], nnz_m),
                       np.where(inside, ov_w[src], 0.0).astype(ov_w.dtype),
                       ov_diag[slots], ov_out_pos[slots]))
    return groups


def build_rowblock_plan(m_pattern: COO, a: COO, gemm_dtype=torch.float32,
                        max_block_slots: int = 32768, pad_ratio_cap: float = 64.0,
                        class_step: float = 1.5, layout: str = "cm",
                        compress: str = "none", order: str = "sorted",
                        device=None) -> RowBlockPlan:
    """Host-side symbolic phase (once per seed pattern), on ``device``
    (CUDA unless the caller asks for another).

    ``m_pattern``: the seed, row-major sorted and deduplicated (its entry
    order is the m_vals order the numeric phase consumes).  ``a``: the
    system matrix with values.  Rows whose dense block would exceed
    ``max_block_slots`` (cp·mp after class padding) or inflate the multiply
    count more than ``pad_ratio_cap``× go to the overflow sub-plan.
    ``class_step``: size-class ladder spacing.  ``layout``: G-block axis
    order, ``cm`` [R, cp, mp] or ``mc`` [R, mp, cp].  ``compress="gram"``:
    per-row Gram blocks H_r = G_rᵀG_r and the linear term 2·G_rᵀe_r, so the
    residual is Σ_r (k_rᵀH_rk_r − linᵀk_r) + consts (relative error up to
    ~eps·n/res², reward path only; ``numeric`` raises).  ``order="window"``:
    rows bucket by their exact window width and the plan defines a new edge
    enumeration (``edge_perm``) in which each bucket's windows are one
    contiguous slice of m_vals; the caller permutes the seed by it
    (``env.spai.make_env`` does).
    """
    import scipy.sparse as sp

    device = resolve_device(device)
    n, _ = m_pattern.shape
    mh = m_pattern.numpy()
    mkey = mh.row.astype(np.int64) * m_pattern.shape[1] + mh.col
    if len(mkey) and not np.all(np.diff(mkey) > 0):
        raise ValueError("m_pattern must be row-major sorted and deduplicated"
                         " (coo_sort_dedup)")
    m_csr = _to_scipy_csr(m_pattern, pattern_only=True)
    a_csr = _to_scipy_csr(a)
    # symbolic product pattern, canonical (sorted cols per row)
    c_pat = (m_csr @ sp.csr_matrix(
        (np.ones(a_csr.nnz), a_csr.indices, a_csr.indptr), shape=a.shape))
    c_pat.sort_indices()
    c_indptr = c_pat.indptr.astype(np.int64)
    c_cols = c_pat.indices.astype(np.int64)
    m_indptr = m_csr.indptr.astype(np.int64)
    m_cols = m_csr.indices.astype(np.int64)

    m_r = np.diff(m_indptr)                      # [n] window widths
    c_r = np.diff(c_indptr)                      # [n] C row widths
    live = m_r > 0                               # rows that produce output

    # pair p = (M entry i, A entry j), C slot o; dense-block coordinates
    # (row r, jc = o − c_indptr[r], jm = i − m_indptr[r])
    a_counts = np.diff(a_csr.indptr)[m_cols]     # per-M-entry pair counts
    pair_i = np.repeat(np.arange(len(m_cols)), a_counts)
    offs = np.concatenate([[0], np.cumsum(a_counts)])
    within = np.arange(int(a_counts.sum())) - np.repeat(offs[:-1], a_counts)
    pair_j = a_csr.indptr[m_cols[pair_i]] + within
    m_rows = np.repeat(np.arange(n), m_r)        # row of M entry i
    r_of_pair = m_rows[pair_i]
    jm = pair_i - m_indptr[r_of_pair]
    # each pair's position within its (sorted) C row by ONE global
    # searchsorted: each row's keys are offset into a disjoint range
    acol = a_csr.indices[pair_j].astype(np.int64)
    stride = a.shape[1] + 1
    keyed_ccols = c_cols + np.repeat(np.arange(n), c_r) * stride
    jc = np.searchsorted(keyed_ccols, acol + r_of_pair * stride)
    jc = jc - c_indptr[r_of_pair]

    if layout not in ("cm", "mc"):
        raise ValueError(f"unknown rowblock layout {layout!r}")
    if compress not in ("none", "gram"):
        raise ValueError(f"unknown rowblock compress {compress!r}")
    if order not in ("sorted", "window"):
        raise ValueError(f"unknown rowblock order {order!r}")
    if compress == "gram" or order == "window":
        layout = "cm"        # staging layout; gram blocks are [R, mp, mp]

    def _classes_of(widths):
        table = np.array([_size_class(int(x), step=class_step) for x in
                          range(int(widths.max()) + 1)] or [8])
        return table[widths]

    # window mode: the m-axis buckets by EXACT width
    mp_class = m_r.copy() if order == "window" else _classes_of(m_r)
    cp_class = _classes_of(c_r)
    pairs_r = np.zeros(n, np.int64)
    np.add.at(pairs_r, np.repeat(np.arange(n), m_r), a_counts)
    block_slots = cp_class.astype(np.int64) * mp_class
    overflow = live & ((block_slots > max_block_slots)
                       | (block_slots > pad_ratio_cap * np.maximum(pairs_r, 1)))
    key_of_row = cp_class * (2 ** 32) + mp_class
    live_rows = np.nonzero(live & ~overflow)[0]
    uniq_keys, inv = np.unique(key_of_row[live_rows], return_inverse=True)
    r_order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[r_order], np.arange(len(uniq_keys) + 1))
    classes = {
        (int(k // (2 ** 32)), int(k % (2 ** 32))):
            live_rows[r_order[bounds[i]:bounds[i + 1]]]
        for i, k in enumerate(uniq_keys)
    }

    # diagonal bookkeeping (same keyed-searchsorted trick)
    dsearch = np.searchsorted(keyed_ccols, np.arange(n) * stride + np.arange(n))
    found = (dsearch < c_indptr[1:]) & (dsearch >= c_indptr[:-1])
    found &= np.where(found, c_cols[np.minimum(dsearch, len(c_cols) - 1)]
                      == np.arange(n), False)
    diag_present = found
    dpos_all = np.where(found, dsearch - c_indptr[:-1], -1)

    stage_dt = np.float64 if gemm_dtype == torch.float64 else np.float32
    a_data = np.asarray(a_csr.data, stage_dt)
    bucket_of_row = np.full(n, -1)
    slot_of_row = np.full(n, -1)
    nb = len(classes)
    g_np, w_np, d_np, o_np = [None] * nb, [None] * nb, [None] * nb, [None] * nb
    win_off, win_w, perm_parts = [], [], []
    off_acc = 0
    for b, (key, rows) in enumerate(sorted(classes.items())):
        cp, mp = key
        rows = np.asarray(rows)
        bucket_of_row[rows] = b
        slot_of_row[rows] = np.arange(len(rows))
        R = len(rows)
        g_np[b] = np.zeros((R, cp, mp) if layout == "cm" else (R, mp, cp), stage_dt)
        col_ids = np.arange(mp)[None, :]
        if order == "window":
            # windows land contiguously in the permuted enumeration
            w_np[b] = off_acc + np.arange(R)[:, None] * mp + col_ids
            perm_parts.append((m_indptr[rows][:, None] + col_ids).ravel())
            win_off.append(int(off_acc))
            win_w.append(int(mp))
            off_acc += R * mp
        else:
            w_np[b] = np.where(col_ids < m_r[rows][:, None],
                               m_indptr[rows][:, None] + col_ids, len(m_cols))
        d_np[b] = np.where(dpos_all[rows] >= 0, dpos_all[rows], cp)
        oc = np.arange(cp)[None, :]
        o_np[b] = np.where(oc < c_r[rows][:, None],
                           c_indptr[rows][:, None] + oc, len(c_cols))
    # scatter all pair values into the dense blocks: one stable argsort
    # groups pairs by bucket, then each bucket scatters its contiguous slice
    pb_b = bucket_of_row[r_of_pair]
    pb_s = slot_of_row[r_of_pair]
    pair_vals = a_data[pair_j]
    border = np.argsort(pb_b, kind="stable")
    bbounds = np.searchsorted(pb_b[border], np.arange(nb + 1) - 0.5)
    for b in range(nb):
        sl = border[bbounds[b]:bbounds[b + 1]]
        if layout == "cm":
            g_np[b][pb_s[sl], jc[sl], jm[sl]] = pair_vals[sl]
        else:
            g_np[b][pb_s[sl], jm[sl], jc[sl]] = pair_vals[sl]

    # gram compression: fold the cp dimension into per-row quadratic forms
    lin_np = []
    n_bucket_diag = 0
    if compress == "gram":
        for b in range(nb):
            G = g_np[b]                                   # [R, cp, mp]
            R, cp, mp = G.shape
            d = d_np[b]
            has = d < cp
            n_bucket_diag += int(has.sum())
            lin = 2.0 * G[np.arange(R), np.where(has, d, 0), :]
            lin[~has] = 0.0
            g_np[b] = np.einsum("rcm,rcn->rmn", G, G, optimize=True).astype(stage_dt)
            lin_np.append(lin.astype(stage_dt))

    # overflow sub-plan (pair path for the routed-out rows)
    ov_rows = np.nonzero(overflow)[0]
    ov_c = c_r[ov_rows]
    S = int(ov_c.sum())
    slot_base = np.zeros(n, np.int64)
    if len(ov_rows):
        slot_base[ov_rows] = np.concatenate([[0], np.cumsum(ov_c)[:-1]])
    sel = overflow[r_of_pair]
    ov_pair_m = pair_i[sel]
    ov_w = a_data[pair_j[sel]]
    edge_perm = None
    if order == "window":
        # overflow rows' windows close out the permuted enumeration
        o_starts = m_indptr[ov_rows]
        o_lens = m_r[ov_rows]
        tot = int(o_lens.sum())
        tail = (np.repeat(o_starts, o_lens) + np.arange(tot)
                - np.repeat(np.concatenate([[0], np.cumsum(o_lens)[:-1]])
                            if len(o_lens) else np.zeros(0, np.int64), o_lens))
        edge_perm = np.concatenate(perm_parts + [tail]).astype(np.int64)
        if len(edge_perm) != len(m_cols):
            raise AssertionError("window permutation must cover every edge")
        inv_perm = np.empty(len(m_cols), np.int64)
        inv_perm[edge_perm] = np.arange(len(m_cols))
        ov_pair_m = inv_perm[ov_pair_m]
    ov_seg = slot_base[r_of_pair[sel]] + jc[sel]
    within_slot = np.arange(S) - np.repeat(slot_base[ov_rows], ov_c)
    ov_out_pos = np.repeat(c_indptr[ov_rows], ov_c) + within_slot
    ov_diag = within_slot == np.repeat(dpos_all[ov_rows], ov_c)

    idx = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    vals = lambda x: torch.as_tensor(x, device=device).to(gemm_dtype)
    acc_dt = _acc_dtype(gemm_dtype)
    onehot = () if compress == "gram" else tuple(
        (torch.arange(g.shape[1] if layout == "cm" else g.shape[2], device=device)[None, :]
         == idx(d)[:, None]).to(acc_dt) for g, d in zip(g_np, d_np))
    groups = _overflow_groups(ov_pair_m, ov_w, ov_seg, ov_diag, ov_out_pos,
                              len(m_cols), S)
    return RowBlockPlan(
        gvals=tuple(vals(g) for g in g_np),
        win_idx=tuple(idx(w) for w in w_np),
        diag_pos=tuple(idx(d) for d in d_np),
        out_pos=tuple(idx(o) for o in o_np),
        ov_pair_m=idx(ov_pair_m), ov_w=vals(ov_w), ov_seg=idx(ov_seg),
        ov_diag=torch.as_tensor(ov_diag, device=device),
        ov_out_pos=idx(ov_out_pos),
        out_row=idx(np.repeat(np.arange(n), c_r)), out_col=idx(c_cols),
        shape=(m_pattern.shape[0], a.shape[1]),
        nnz_m=int(len(m_cols)), out_nnz=int(len(c_cols)),
        n_missing_diag=int(n - diag_present.sum()), npairs=int(len(pair_i)),
        n_overflow_slots=S, layout=layout, compress=compress,
        n_bucket_diag=n_bucket_diag, lin=tuple(vals(x) for x in lin_np),
        win_off=tuple(win_off), win_w=tuple(win_w),
        edge_perm=None if edge_perm is None else idx(edge_perm),
        onehot=onehot,
        ov_groups=tuple((idx(pm), vals(pw), torch.as_tensor(pd, device=device),
                         idx(pp)) for pm, pw, pd, pp in groups),
    )


# ---------------------------------------------------------------------------
# Numeric phase
# ---------------------------------------------------------------------------

def _acc_dtype(gemm_dtype) -> torch.dtype:
    """Accumulation dtype: float32 for bf16 storage, else the storage dtype."""
    return torch.float32 if gemm_dtype == torch.bfloat16 else gemm_dtype


def _operand(x: torch.Tensor, gemm_dtype) -> torch.Tensor:
    """A product operand as the JAX package feeds its matrix unit (rounded
    to the storage dtype), in the accumulation dtype."""
    return x.to(gemm_dtype).to(_acc_dtype(gemm_dtype))


def _windows(plan: RowBlockPlan, m_vals: torch.Tensor):
    """Per bucket, the [R, mp, B] windows of the [B, nnz_m] values: static
    slices of a window-order plan, else a gather through ``win_idx``."""
    B = m_vals.shape[0]
    if plan.win_off:
        return [m_vals[:, off:off + g.shape[0] * w].reshape(B, g.shape[0], w)
                .permute(1, 2, 0) for g, off, w in zip(plan.gvals, plan.win_off,
                                                       plan.win_w)]
    kt = torch.cat([m_vals, m_vals.new_zeros((B, 1))], dim=1).T   # [nnz + 1, B]
    return [kt[idx] for idx in plan.win_idx]


def residual_sq_batch(plan: RowBlockPlan, m_vals: torch.Tensor) -> torch.Tensor:
    """``‖M·A − I‖²_F`` for a batch of M value vectors ``m_vals`` [B,
    nnz_m] (the seed values masked per trajectory) → [B] in m_vals' dtype.
    One window read and one batched product per bucket; no host sync."""
    B = m_vals.shape[0]
    acc = m_vals.new_zeros((B,))
    with f32_exact():
        for b, kwin in enumerate(_windows(plan, m_vals)):
            g = plan.gvals[b]
            gk, kk = _operand(g, g.dtype), _operand(kwin, g.dtype)  # kk [R, mp, B]
            if plan.compress == "gram":
                t = torch.bmm(gk, kk)                                  # [R, mp, B]
                q = torch.sum(t * kk, dim=1)                           # [R, B]
                lin = torch.bmm(_operand(plan.lin[b], g.dtype)[:, None, :], kk)[:, 0]
                acc = acc + torch.sum(q - lin, dim=0).to(acc.dtype)
            elif plan.layout == "mc":
                y = torch.bmm(kk.transpose(1, 2), gk)                  # [R, B, cp]
                acc = acc + torch.sum(torch.square(y - plan.onehot[b][:, None, :]),
                                      dim=(0, 2)).to(acc.dtype)
            else:
                y = torch.bmm(gk, kk)                                  # [R, cp, B]
                acc = acc + torch.sum(torch.square(y - plan.onehot[b][..., None]),
                                      dim=(0, 1)).to(acc.dtype)
    acc = acc + _overflow_residual_sq(plan, m_vals)
    return acc + (plan.n_missing_diag + plan.n_bucket_diag)


def _overflow_residual_sq(plan: RowBlockPlan, m_vals: torch.Tensor) -> torch.Tensor:
    """Σ(c − δ)² over the overflow slots, [B, nnz] → [B]: each group's slots
    summed over their padded pair lists in a fixed order; exactly 0 when no
    row overflowed."""
    out = m_vals.new_zeros((m_vals.shape[0],))
    if not plan.ov_groups:
        return out
    m_ext = torch.cat([m_vals, m_vals.new_zeros((m_vals.shape[0], 1))], dim=1)
    for pm, pw, pdiag, _ in plan.ov_groups:
        c = torch.sum(m_ext[:, pm] * pw.to(m_vals.dtype), dim=-1) - pdiag.to(m_vals.dtype)
        out = out + torch.sum(c * c, dim=-1)
    return out


def residual_norm_batch(plan: RowBlockPlan, m_vals: torch.Tensor) -> torch.Tensor:
    # the gram form's cancellation can leave the sum slightly negative when
    # the true residual is tiny: clamp so sqrt never gives NaN
    return torch.sqrt(torch.clamp_min(residual_sq_batch(plan, m_vals), 0.0))


def numeric(plan: RowBlockPlan, m_vals: torch.Tensor) -> torch.Tensor:
    """Values of C = M·A on the (row-major) static pattern for one value
    vector [nnz_m] (testing and C-materialising callers; the reward path
    never calls this)."""
    if plan.compress == "gram":
        raise NotImplementedError(
            "gram-compressed plans carry quadratic forms, not G — C values "
            "are unavailable (build with compress='none' for numeric())")
    kt = torch.cat([m_vals, m_vals.new_zeros((1,))])
    out = m_vals.new_zeros((plan.out_nnz + 1,))
    with f32_exact():
        for g, idx, opos in zip(plan.gvals, plan.win_idx, plan.out_pos):
            gk, kk = _operand(g, g.dtype), _operand(kt[idx], g.dtype)   # kk [R, mp]
            if plan.layout == "cm":
                y = torch.bmm(gk, kk[:, :, None])[:, :, 0]
            else:
                y = torch.bmm(kk[:, None, :], gk)[:, 0, :]
            out[opos.reshape(-1)] = y.reshape(-1).to(out.dtype)
    m_ext = torch.cat([m_vals, m_vals.new_zeros((1,))])
    for pm, pw, _, pos in plan.ov_groups:
        out[pos] = torch.sum(m_ext[pm] * pw.to(m_vals.dtype), dim=-1)
    return out[:plan.out_nnz]


def out_coo(plan: RowBlockPlan, c_data: torch.Tensor) -> COO:
    return COO(row=plan.out_row, col=plan.out_col, data=c_data, shape=plan.shape)
