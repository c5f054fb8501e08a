"""Preconditioner operators of the validation harness (counterpart of
``gflownet_spai_tpu/solvers/precond.py``):

* ``ilu_solve_op`` — the reference's baseline (LU)⁻¹ from an incomplete
  factorisation (reference GFlowNet100.py:126-132): dense triangular solves
  up to ``dense_max_n`` rows, the level-scheduled sparse solves above;
* ``spai_op`` / ``spai_op_sym`` — apply a sampled SPAI matrix M (COO or
  DIA; DIA rides K8), or ½(M + Mᵀ) for CG;
* ``jacobi_op`` — diagonal scaling.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..ops.dia import DIA, dia_transpose
from ..sparse.types import COO
from .linop import LinOp, as_linop


def _dense_ilu_apply(data, x):
    Ld, Ud = data
    y = torch.linalg.solve_triangular(Ld, x.to(Ld.dtype)[:, None], upper=False)
    z = torch.linalg.solve_triangular(Ud, y, upper=True)[:, 0]
    return z.to(x.dtype)   # keep the solver's carry dtype


def _dense(m: COO, device) -> torch.Tensor:
    m = m.to(device)
    out = torch.zeros(m.shape, dtype=m.data.dtype, device=device)
    return out.index_put_((m.row, m.col), m.data, accumulate=True)


def ilu_solve_op(L: COO, U: COO, dense_max_n: int = 4096, device=None) -> LinOp:
    """x ↦ U⁻¹ L⁻¹ x in the factors' dtype.  Dense triangular solves up to
    ``dense_max_n`` rows; larger factors use the level-scheduled sparse
    solves (``solvers.trisolve``), so memory stays O(nnz)."""
    device = resolve_device(device)
    if L.shape[0] > dense_max_n:
        from .trisolve import sparse_ilu_solve_op

        op = sparse_ilu_solve_op(L, U, device=device)
        if op is not None:
            return op
    return LinOp(data=(_dense(L, device), _dense(U, device)), fn=_dense_ilu_apply)


def spai_op(m) -> LinOp:
    """x ↦ M x — the sampled sparse approximate inverse, COO (of tensors)
    or DIA (K8)."""
    return as_linop(m)


def _sym_apply(data, x):
    m, mt = data
    return 0.5 * (m(x) + mt(x))


def spai_op_sym(m) -> LinOp:
    """x ↦ ½(M + Mᵀ)x — the symmetrised apply CG needs (a thinned or
    classic SPAI M is generally nonsymmetric even for SPD A)."""
    if isinstance(m, DIA):
        mt = dia_transpose(m)
    else:
        mt = COO(row=m.col, col=m.row, data=m.data, shape=(m.shape[1], m.shape[0]))
    return LinOp(data=(as_linop(m), as_linop(mt)), fn=_sym_apply)


def _diag_apply(inv, x):
    return inv * x


def jacobi_op(a: COO) -> LinOp:
    """x ↦ D⁻¹x (rows with a zero diagonal pass x through); ``a`` holds
    tensors on the solve's device."""
    diag = a.data.new_zeros((a.shape[0],)).index_add_(
        0, a.row, torch.where(a.row == a.col, a.data, 0.0))
    inv = torch.where(diag != 0, 1.0 / diag, 1.0)
    return LinOp(data=inv, fn=_diag_apply)
