"""Batched preconditioned CG over the transposed-RHS DIA SpMM (counterpart
of ``gflownet_spai_tpu/solvers/multirhs.py``).

Solves ``A·X = B`` for K right-hand sides at once, held in [K, n] layout
(each system a contiguous row), so each application of a DIA operator is
one ``spmm_dia_t_rows`` (K16, on the [K_pad, n_pad] iterate itself): the
diagonals are read once per iteration for all K systems.  The systems are
independent (batched CG, not block-Krylov): each has its own α, β and
convergence flag; a converged system freezes (α = 0) while the rest run,
and its residual history reads NaN from then on.  Vectors and scalars stay
on the device; whether every system is done comes to the host once per
iteration for the loop's test.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.dia import DIA, _round_up, _spmm_t_tiles, spmm_dia_t_rows
from .linop import LinOp


class CGMultiResult(NamedTuple):
    xt: torch.Tensor          # [K, n] solutions
    residuals: torch.Tensor   # [maxiter, K] ‖r_k‖ history, NaN once converged
    iterations: torch.Tensor  # int32[K]
    converged: torch.Tensor   # bool[K]


def _dia_apply_t(d: DIA, vt: torch.Tensor) -> torch.Tensor:
    """[Kp, n_pad] → [Kp, n_pad] through K16, which reads vt as zero
    outside [0, n_pad): the values of JAX's apply on its zero-padded
    buffer, without the copy.  vt is rounded to the diagonals' dtype first,
    as JAX's buffer of that dtype rounds it (rows beyond n stay zero
    because the diagonals are zero there)."""
    return spmm_dia_t_rows(d, vt.to(d.data.dtype))


def _as_multi_op(op):
    if op is None or not isinstance(op, DIA):
        return op        # None, a LinOp or a callable on [Kp, n_pad]
    return LinOp(data=op, fn=_dia_apply_t)


def _cg_multi_impl(a_op, bt, x0t, m_op, maxiter: int, rtol: float, atol: float):
    def rowdot(u, v):
        return torch.sum(u * v, dim=1)

    bnorm = torch.sqrt(rowdot(bt, bt))
    tol = torch.clamp(rtol * bnorm, min=atol)
    x = torch.zeros_like(bt) if x0t is None else x0t
    r = bt - a_op(x)
    z = m_op(r) if m_op is not None else r
    p = z
    rz = rowdot(r, z)
    done = torch.sqrt(rowdot(r, r)) <= tol
    iters = torch.where(done, 0, maxiter).to(torch.int32)
    hist = torch.full((maxiter, bt.shape[0]), float("nan"), dtype=bt.dtype,
                      device=bt.device)
    # the inactive systems' divide guard (a padded system is all zeros, so
    # its pᵀAp is 0): a normal float32, as the JAX package's XLA flushes
    # subnormals
    tiny = torch.tensor(1e-30, dtype=bt.dtype, device=bt.device)
    it = 0
    while it < maxiter and not bool(done.all()):
        ap = a_op(p)
        active = ~done
        alpha = torch.where(active, rz / torch.where(active, rowdot(p, ap), tiny), 0.0)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        z = m_op(r) if m_op is not None else r
        rz_new = rowdot(r, z)
        beta = torch.where(active, rz_new / torch.where(active, rz, tiny), 0.0)
        p = torch.where(active[:, None], z + beta[:, None] * p, p)
        rnorm = torch.sqrt(rowdot(r, r))
        hist[it] = torch.where(active, rnorm, float("nan"))
        newly = active & (rnorm <= tol)
        iters = torch.where(newly, it + 1, iters).to(torch.int32)
        done = done | newly
        rz = torch.where(active, rz_new, rz)
        it += 1
    return CGMultiResult(xt=x, residuals=hist, iterations=iters, converged=done)


def cg_multi(a, bt: torch.Tensor, x0t: Optional[torch.Tensor] = None, m=None,
             maxiter: int = 1000, rtol: float = 1e-5,
             atol: float = 0.0) -> CGMultiResult:
    """Batched preconditioned CG for ``bt`` in [K, n] layout.

    ``a`` / ``m``: DIA matrices (K16) or LinOps / callables mapping [Kp,
    n_pad] → [Kp, n_pad].  With a DIA ``a`` the systems are padded to K_pad
    rows (a multiple of ``_spmm_t_tiles``' kb, all-zero systems that are
    converged from the start) and n_pad columns.  Returns solutions in
    [K, n] layout with per-system residual histories, iteration counts and
    convergence flags."""
    a_op, m_op = _as_multi_op(a), _as_multi_op(m)
    k, n = bt.shape
    if isinstance(a, DIA):
        kb, _ = _spmm_t_tiles(a, max(8, _round_up(k, 8)))
        kp, n_pad = _round_up(k, kb), a.n_pad

        def _pad(vt):
            return torch.nn.functional.pad(vt.to(a.data.dtype),
                                           (0, n_pad - vt.shape[1], 0, kp - vt.shape[0]))

        btp = _pad(bt)
        x0t = _pad(x0t) if x0t is not None else None
    else:
        btp = bt
    res = _cg_multi_impl(a_op, btp, x0t, m_op, maxiter, rtol, atol)
    return CGMultiResult(xt=res.xt[:k, :n], residuals=res.residuals[:, :k],
                         iterations=res.iterations[:k], converged=res.converged[:k])
