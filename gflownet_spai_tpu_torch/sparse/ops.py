"""SpMV and SpMM over the COO / CSR / ELL / BSR containers, the
fixed-pattern SpGEMM and the ‖C − I‖_F² norm (counterpart of
``gflownet_spai_tpu/sparse/ops.py``), in plain PyTorch.

The containers' arrays must be tensors on the right-hand side's device
(``.to(device)``).  BSR's block products (and ELL's SpMM) run in full
float32, without TF32, as the JAX package's ``precision="highest"``.

The patterns of A and B never change while a model trains or samples, only
their values, so the symbolic product runs once on the host (the native
library where it is built and B is canonical, else numpy) and
the numeric phase is a gather · multiply · ``index_add_`` on the device.
A GPU gathers natively, so this pair plan is the reward path of the port.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import native
from .._device import resolve_device
from .types import BSR, COO, CSR, ELL


@contextlib.contextmanager
def f32_exact():
    """Float32 matrix products without TF32 inside the block (the JAX
    package's ``precision="highest"``); the caller's setting is restored."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def _rows_sum(vals: torch.Tensor, rows, nrows: int) -> torch.Tensor:
    out = vals.new_zeros((nrows,) + tuple(vals.shape[1:]))
    return out.index_add_(0, rows.long(), vals)


def spmv_coo(a: COO, x: torch.Tensor) -> torch.Tensor:
    # a gather of x, a product and one index_add_ into the rows
    return _rows_sum(a.data * x[a.col], a.row, a.shape[0])


def spmv_csr(a: CSR, x: torch.Tensor) -> torch.Tensor:
    return spmv_coo(a.tocoo(), x)


def spmv_ell(a: ELL, x: torch.Tensor) -> torch.Tensor:
    # gather + product + row sum; padded slots add 0
    return torch.sum(a.data * x[a.cols], dim=1)


def spmv_bsr(a: BSR, x: torch.Tensor) -> torch.Tensor:
    xb = x.reshape(-1, a.blockshape[1])[a.indices]          # [nblocks, bn]
    yb = torch.sum(a.data * xb[:, None, :], dim=2)          # [nblocks, bm]
    return _rows_sum(yb, a.block_rows(), a.shape[0] // a.blockshape[0]) \
        .reshape(a.shape[0])


def spmv(a, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a COO, CSR, ELL or BSR matrix (or a dense one)."""
    for kind, fn in ((COO, spmv_coo), (CSR, spmv_csr), (ELL, spmv_ell), (BSR, spmv_bsr)):
        if isinstance(a, kind):
            return fn(a, x)
    return a @ x


def spmm_coo(a: COO, b: torch.Tensor) -> torch.Tensor:
    return _rows_sum(a.data[:, None] * b[a.col], a.row, a.shape[0])


def spmm_ell(a: ELL, b: torch.Tensor) -> torch.Tensor:
    with f32_exact():
        return torch.einsum("rw,rwc->rc", a.data, b[a.cols])


def spmm_bsr(a: BSR, b: torch.Tensor) -> torch.Tensor:
    bm, bn = a.blockshape
    bb = b.reshape(-1, bn, b.shape[1])[a.indices]               # [nblocks, bn, K]
    with f32_exact():
        yb = torch.bmm(a.data, bb)                              # [nblocks, bm, K]
    return _rows_sum(yb, a.block_rows(), a.shape[0] // bm).reshape(a.shape[0], b.shape[1])


def spmm(a, b: torch.Tensor) -> torch.Tensor:
    """Y = A·B for a COO, CSR, ELL or BSR matrix (or a dense one) and a
    dense B [n, K]."""
    if isinstance(a, CSR):
        a = a.tocoo()
    for kind, fn in ((COO, spmm_coo), (ELL, spmm_ell), (BSR, spmm_bsr)):
        if isinstance(a, kind):
            return fn(a, b)
    with f32_exact():
        return a @ b


class SpGEMMPlan:
    """Symbolic product plan for ``C = A @ B`` with static patterns.

    Attributes (int64 tensors on ``device``):
      out_row/out_col : pattern of C              [out_nnz]
      pair_a          : index into A.data         [npairs]
      pair_b          : index into B.data         [npairs]
      pair_out        : index into C.data         [npairs] (sorted asc)
    """

    def __init__(self, a_coo: COO, b_coo: COO, device=None):
        device = resolve_device(device)
        a, b = a_coo.numpy(), b_coo.numpy()
        ar, ac = a.row.astype(np.int64), a.col.astype(np.int64)
        br, bc = b.row.astype(np.int64), b.col.astype(np.int64)
        n_mid = a_coo.shape[1]
        if b_coo.shape[0] != n_mid:
            raise ValueError("inner dims mismatch")
        ncols = b_coo.shape[1]
        b_key = br * ncols + bc
        if native.available() and (len(b_key) == 0 or np.all(np.diff(b_key) > 0)):
            # B canonical (row-major, no duplicates): its CSR data order is
            # b_coo.data's order, and A's entry alone orders a slot's pairs
            indptr_b = np.zeros(n_mid + 1, np.int64)
            np.add.at(indptr_b, br + 1, 1)
            out_row, out_col, pair_a, pair_b, pair_out = native.spgemm_plan(
                ar, ac, n_mid, ncols, np.cumsum(indptr_b), bc)
            # the library leaves a slot's pairs in no fixed order: put them in
            # the numpy path's (by A's entry), so both sum alike
            order = np.argsort(pair_out * max(len(ar), 1) + pair_a, kind="stable")
            pair_a, pair_b, pair_out = pair_a[order], pair_b[order], pair_out[order]
        else:
            out_row, out_col, pair_a, pair_b, pair_out = _pairs(ar, ac, br, bc,
                                                               n_mid, ncols)
        as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
        self.shape = (a_coo.shape[0], ncols)
        self.out_row = as_t(out_row)
        self.out_col = as_t(out_col)
        self.pair_a = as_t(pair_a)
        self.pair_b = as_t(pair_b)
        self.pair_out = as_t(pair_out)
        self.out_nnz = int(len(out_row))
        self.npairs = int(len(pair_a))

    def numeric(self, a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        """Values of C on the precomputed pattern.  ``a_data`` may carry
        leading batch dims ([..., nnz(A)] → [..., out_nnz])."""
        prod = a_data[..., self.pair_a] * b_data[self.pair_b]
        out = prod.new_zeros(prod.shape[:-1] + (self.out_nnz,))
        return out.index_add_(-1, self.pair_out, prod)

    def out_coo(self, c_data: torch.Tensor) -> COO:
        return COO(row=self.out_row, col=self.out_col, data=c_data, shape=self.shape)


def _pairs(ar, ac, br, bc, n_mid: int, ncols: int):
    """The symbolic product in numpy: (out_row, out_col, pair_a, pair_b,
    pair_out), the pattern row-major, a slot's pairs by A's entry."""
    # bucket B's entries by row (= A's col) to enumerate contributing pairs
    order_b = np.argsort(br, kind="stable")
    br_s, idx_b = br[order_b], order_b
    starts = np.searchsorted(br_s, np.arange(n_mid))
    ends = np.searchsorted(br_s, np.arange(n_mid) + 1)
    counts = (ends - starts)[ac]
    pair_a = np.repeat(np.arange(len(ar)), counts)
    offs = np.concatenate([[0], np.cumsum(counts)])
    within = np.arange(counts.sum()) - np.repeat(offs[:-1], counts)
    pair_b = idx_b[starts[ac[pair_a]] + within]
    uniq, inv = np.unique(ar[pair_a] * ncols + bc[pair_b], return_inverse=True)
    order = np.argsort(inv, kind="stable")
    return uniq // ncols, uniq % ncols, pair_a[order], pair_b[order], inv[order]


def spgemm(a: COO, b: COO) -> COO:
    """General sparse × sparse product (symbolic and numeric in one call),
    on the device of ``a``'s values (the CPU for numpy arrays)."""
    device = a.data.device if isinstance(a.data, torch.Tensor) else "cpu"
    plan = SpGEMMPlan(a, b, device=device)
    as_t = lambda x: torch.as_tensor(x, device=device)
    return plan.out_coo(plan.numeric(as_t(a.data), as_t(b.data)))


def frobenius_sq_minus_identity(row, col, data: torch.Tensor, n: int) -> torch.Tensor:
    """``‖C − I‖_F²`` for sparse C in COO arrays (static pattern), by the
    closed form Σ c² − 2 Σ_diag c + n (diagonal positions missing from the
    pattern each contribute 1).  ``data`` may carry leading batch dims."""
    diag = (row == col).to(data.dtype)
    s2 = torch.sum(data * data, dim=-1)
    sd = torch.sum(diag * data, dim=-1)
    return s2 - 2.0 * sd + n


def transpose_perm(coo: COO) -> np.ndarray:
    """Host-side permutation from COO entries to the transposed
    (column-major) order."""
    h = coo.numpy()
    key = h.col.astype(np.int64) * coo.shape[0] + h.row
    return np.argsort(key, kind="stable")


def eye_coo(n: int, dtype=np.float32) -> COO:
    """The n × n identity as a host COO."""
    idx = np.arange(n, dtype=np.int32)
    return COO(row=idx, col=idx, data=np.ones(n, dtype), shape=(n, n))
