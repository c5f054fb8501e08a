"""COO SpMV, the fixed-pattern SpGEMM and the ‖C − I‖_F² norm
(counterpart of ``gflownet_spai_tpu/sparse/ops.py``: ``spmv_coo`` :23 and
:112-214).

The patterns of A and B never change while a model trains or samples, only
their values, so the symbolic product runs once on the host (numpy) and
the numeric phase is a gather · multiply · ``index_add_`` on the device.
A GPU gathers natively, so this pair plan is the reward path of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from .types import COO


def spmv(a: COO, x: torch.Tensor) -> torch.Tensor:
    """y = A·x for a COO matrix of tensors on x's device: a gather of x,
    a product and one ``index_add_`` into the rows (``spmv_coo``)."""
    prod = a.data * x[a.col]
    return prod.new_zeros((a.shape[0],)).index_add_(0, a.row, prod)


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
        ncols = b_coo.shape[1]
        key = ar[pair_a] * ncols + bc[pair_b]
        uniq, inv = np.unique(key, return_inverse=True)
        order = np.argsort(inv, kind="stable")

        as_t = lambda x: torch.as_tensor(x, dtype=torch.int64, device=device)
        self.shape = (a_coo.shape[0], ncols)
        self.out_row = as_t(uniq // ncols)
        self.out_col = as_t(uniq % ncols)
        self.pair_a = as_t(pair_a[order])
        self.pair_b = as_t(pair_b[order])
        self.pair_out = as_t(inv[order])
        self.out_nnz = int(len(uniq))
        self.npairs = int(len(pair_a))

    def numeric(self, a_data: torch.Tensor, b_data: torch.Tensor) -> torch.Tensor:
        """Values of C on the precomputed pattern.  ``a_data`` may carry
        leading batch dims ([..., nnz(A)] → [..., out_nnz])."""
        prod = a_data[..., self.pair_a] * b_data[self.pair_b]
        out = prod.new_zeros(prod.shape[:-1] + (self.out_nnz,))
        return out.index_add_(-1, self.pair_out, prod)


def frobenius_sq_minus_identity(row, col, data: torch.Tensor, n: int) -> torch.Tensor:
    """``‖C − I‖_F²`` for sparse C in COO arrays (static pattern), by the
    closed form Σ c² − 2 Σ_diag c + n (diagonal positions missing from the
    pattern each contribute 1).  ``data`` may carry leading batch dims."""
    diag = (row == col).to(data.dtype)
    s2 = torch.sum(data * data, dim=-1)
    sd = torch.sum(diag * data, dim=-1)
    return s2 - 2.0 * sd + n
