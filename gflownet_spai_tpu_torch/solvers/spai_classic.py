"""Classic (static-pattern) SPAI: min ‖A·M − I‖_F column by column
(counterpart of ``gflownet_spai_tpu/solvers/spai_classic.py``).

For a prescribed pattern, column j solves the small dense least-squares
problem min ‖A[I_j, J_j]·m_j − e_j[I_j]‖₂ (J_j the allowed support, I_j
the union of A's row patterns over J_j).  The symbolic work (index sets,
bucketing by padded size, the gathers of the dense submatrices) runs once
on the host in numpy; each bucket is then one batched ``torch.linalg.qr``
and triangular solve on the device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from .._device import resolve_device
from ..sparse.convert import coo_sort_dedup, coo_to_scipy
from ..sparse.types import COO


def power_pattern(a: COO, k: int = 1, max_nnz_per_col: int | None = None) -> COO:
    """Pattern of A^k (boolean product, host-side) as an all-ones host
    COO — the standard static SPAI pattern family."""
    A = coo_to_scipy(a)
    B = (abs(A) > 0).astype(np.int8)
    P = B.copy()
    for _ in range(k - 1):
        P = ((P @ B) > 0).astype(np.int8)
    P = P.tocsc()
    if max_nnz_per_col is not None:
        # keep the largest-|A^k| entries per column (weight = walk counts)
        W = abs(A)
        for _ in range(k - 1):
            W = W @ abs(A)
        W = W.tocsc()
        Pt = P.T.tolil()     # row j of Pᵀ = column j of P
        for j in range(Pt.shape[0]):
            rows = np.asarray(Pt.rows[j])
            if len(rows) > max_nnz_per_col:
                w = np.asarray(W[rows, j].todense()).ravel()
                keep = rows[np.argsort(-w, kind="stable")[:max_nnz_per_col]]
                Pt.rows[j] = sorted(int(r) for r in keep)
                Pt.data[j] = [1] * max_nnz_per_col
        P = Pt.T.tocsc()
    coo = P.tocoo()
    return coo_sort_dedup(COO(row=coo.row.astype(np.int32),
                              col=coo.col.astype(np.int32),
                              data=np.ones(len(coo.row), np.asarray(a.numpy().data).dtype),
                              shape=a.shape))


@dataclasses.dataclass
class _Bucket:
    cols: np.ndarray        # [C] column ids
    a_sub: torch.Tensor     # [C, mI, mJ] dense gathered submatrices
    rhs: torch.Tensor       # [C, mI] e_j restricted to I_j
    j_rows: np.ndarray      # [C, mJ] M-row of each solution entry (−1 pad)


class SpaiPlan:
    """Host-built plan: per-column index sets bucketed by padded size, the
    gathers vectorised (one scipy SpGEMM for the I_j sets, one
    ``searchsorted`` of A's row-major keys per bucket chunk)."""

    _CHUNK = 65536   # bucket-fill chunk (bounds the [C, mI, mJ] temporaries)

    def __init__(self, a: COO, pattern: COO, pad: int = 8,
                 dtype=torch.float32, device=None):
        device = resolve_device(device)
        if not isinstance(dtype, torch.dtype):          # a numpy dtype
            dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        A = coo_to_scipy(a).tocsc()
        P = coo_to_scipy(pattern).tocsc()
        n, ncols = a.shape
        self.shape, self.dtype, self.device = a.shape, dtype, device

        # empty pattern columns fall back to {j}
        P = P.copy()
        lenJ0 = np.diff(P.indptr)
        if (lenJ0 == 0).any():
            empt = np.nonzero(lenJ0 == 0)[0]
            P = (P + sp.csc_matrix((np.ones(len(empt)), (empt, empt)),
                                   shape=P.shape)).tocsc()
        S = ((abs(A) @ abs(P)) > 0).tocsc()          # I_j = S[:, j] pattern

        lenJ = np.diff(P.indptr)
        lenI = np.maximum(np.diff(S.indptr), 1)
        mJ_all = -(-np.maximum(lenJ, 1) // pad) * pad
        # room for the live rows plus one unit row per padded column (R
        # stays full-rank with zero padded solution entries)
        mI_all = -(-(lenI + (mJ_all - lenJ)) // pad) * pad

        Ar = A.tocsr()
        Ar.sort_indices()
        base = np.int64(ncols + 1)
        a_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(Ar.indptr))
        gkeys = a_rows * base + Ar.indices
        gdata = Ar.data

        sizes = np.stack([mI_all, mJ_all], 1)
        uniq, inv = np.unique(sizes, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        self.buckets: List[_Bucket] = []
        for bi, (mI, mJ) in enumerate(uniq):
            js_all = np.nonzero(inv == bi)[0].astype(np.int32)
            subs, rhss, jrs = [], [], []
            for lo in range(0, len(js_all), self._CHUNK):
                js = js_all[lo:lo + self._CHUNK]
                C = len(js)
                ar = np.arange(mJ)
                validJ = ar[None, :] < lenJ[js][:, None]            # [C, mJ]
                Jpos = P.indptr[js][:, None] + np.minimum(
                    ar[None, :], np.maximum(lenJ[js][:, None] - 1, 0))
                J_mat = np.where(validJ, P.indices[Jpos], ncols)    # sentinel
                ai = np.arange(mI)
                validI = ai[None, :] < lenI[js][:, None]            # [C, mI]
                Ipos = S.indptr[js][:, None] + np.minimum(
                    ai[None, :], np.maximum(lenI[js][:, None] - 1, 0))
                I_mat = np.where(validI, S.indices[Ipos], n)        # sentinel

                keys = (I_mat[:, :, None].astype(np.int64) * base
                        + J_mat[:, None, :])                        # [C,mI,mJ]
                pos = np.searchsorted(gkeys, keys.ravel())
                pos_c = np.minimum(pos, len(gkeys) - 1)
                hit = (pos < len(gkeys)) & (gkeys[pos_c] == keys.ravel())
                a_sub = np.where(hit, gdata[pos_c], 0.0).reshape(C, mI, mJ)

                # padded columns: a unit entry on a dedicated tail row
                padJ = ~validJ
                tail_rows = (mI - mJ + ar)[None, :]
                c_ids = np.broadcast_to(np.arange(C)[:, None], padJ.shape)
                t_ids = np.broadcast_to(ar[None, :], padJ.shape)
                r_ids = np.broadcast_to(tail_rows, padJ.shape)
                a_sub[c_ids[padJ], r_ids[padJ], t_ids[padJ]] = 1.0

                rhs = (I_mat == js[:, None]).astype(np.float64)     # e_j|I
                subs.append(a_sub); rhss.append(rhs)
                jrs.append(np.where(validJ, J_mat, -1).astype(np.int32))
            as_t = lambda x: torch.as_tensor(np.concatenate(x), dtype=dtype,
                                             device=device)
            self.buckets.append(_Bucket(cols=js_all, a_sub=as_t(subs),
                                        rhs=as_t(rhss), j_rows=np.concatenate(jrs)))

    def solve(self) -> COO:
        """Solve every bucket (batched QR) and assemble M as a host COO."""
        rows_out, cols_out, vals_out = [], [], []
        for b in self.buckets:
            q, r = torch.linalg.qr(b.a_sub)                # [C,mI,mJ], [C,mJ,mJ]
            qtb = torch.einsum("cij,ci->cj", q, b.rhs)
            m = torch.linalg.solve_triangular(r, qtb[..., None], upper=True)[..., 0]
            m = m.cpu().numpy()
            live = b.j_rows >= 0
            rows_out.append(b.j_rows[live])
            cols_out.append(np.broadcast_to(b.cols[:, None], b.j_rows.shape)[live])
            vals_out.append(m[live])
        return coo_sort_dedup(COO(row=np.concatenate(rows_out).astype(np.int32),
                                  col=np.concatenate(cols_out).astype(np.int32),
                                  data=np.concatenate(vals_out), shape=self.shape),
                              sum_duplicates=False)


def spai_classic(a: COO, pattern: COO | None = None, k: int = 1, pad: int = 8,
                 dtype=torch.float32, device=None) -> COO:
    """One-call classic SPAI: M minimising ‖A·M − I‖_F on ``pattern``
    (default: the pattern of A^k), solved in ``dtype`` (torch or numpy)
    on ``device``; a host COO."""
    if pattern is None:
        pattern = power_pattern(a, k)
    return SpaiPlan(a, pattern, pad=pad, dtype=dtype, device=device).solve()
