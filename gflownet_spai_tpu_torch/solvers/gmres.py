"""Restarted GMRES with per-iteration residual history (counterpart of
``gflownet_spai_tpu/solvers/gmres.py``: ``_gmres_impl`` :39-169,
``gmres_matrix`` :219 and ``solve_with_gmres`` :226).

Parity target: the reference's ``solve_with_gmres`` (reference
GFlowNet100.py:61-93), scipy ``gmres`` with x0 = 0 and one callback per
inner iteration.  The Arnoldi basis ``V`` and the operator applies stay
on the device; the orthogonalisation is CGS2 (classical Gram–Schmidt with
one reorthogonalisation) as four ``torch.matmul`` calls against the basis,
in the working dtype (a float32 matrix-vector product takes no TF32 path).
The small Hessenberg column comes to the host once per inner iteration,
where the Givens rotations, the residual recurrence and the
back-substitution run in numpy in the same dtype, as JAX computes them on
its device; that one copy is also the loop's stopping test.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .linop import as_linop


class GMRESResult(NamedTuple):
    x: torch.Tensor
    residuals: torch.Tensor   # [maxiter] preconditioned residual norms, NaN-padded
    iterations: int           # inner iterations executed
    converged: bool           # recurrence hit tol OR recomputed residual ≤ tol
    final_residual: float = float("nan")   # recomputed ‖M(b − A·x)‖ at exit


def _identity(x):
    return x


def _np_dtype(t: torch.Tensor):
    return np.float64 if t.dtype == torch.float64 else np.float32


def gmres(a_op, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          m_op=None, restart: int = 30, maxiter: int = 1000,
          rtol: float = 1e-5, atol: float = 0.0,
          side: str = "left") -> GMRESResult:
    """Preconditioned restarted GMRES(m), scipy-compatible semantics.

    ``side='left'`` solves ``M A x = M b`` and converges on
    ``‖M(b − A x)‖ ≤ max(rtol·‖M b‖, atol)``; ``side='right'`` solves
    ``A M u = b`` with ``x = M u``, whose history is the true residual.
    ``a_op`` / ``m_op`` may be callables, LinOps or sparse containers."""
    a_op: Callable = as_linop(a_op)
    m_op = as_linop(m_op) if m_op is not None else _identity
    left = side == "left"
    pre = m_op if left else _identity
    inner = (lambda v: m_op(a_op(v))) if left else (lambda v: a_op(m_op(v)))
    n, dev, dtype = b.shape[0], b.device, b.dtype
    f = _np_dtype(b)
    tiny = f(1e-38)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    bnorm = f(torch.linalg.vector_norm(pre(b)).item())
    tol = max(f(rtol) * bnorm, f(atol))

    hist = np.full((maxiter,), np.nan, f)
    it, done = 0, False
    while not done and it < maxiter:
        r = pre(b - a_op(x))
        beta = f(torch.linalg.vector_norm(r).item())
        V = torch.zeros((restart + 1, n), dtype=dtype, device=dev)
        V[0] = r / max(beta, tiny)
        H = np.zeros((restart + 1, restart), f)
        cs = np.zeros((restart,), f)
        sn = np.zeros((restart,), f)
        g = np.zeros((restart + 1,), f)
        g[0] = beta
        it0 = it
        for j in range(restart):
            if done:
                break
            w = inner(V[j])
            h1 = torch.matmul(V, w)
            w = w - torch.matmul(V.T, h1)
            h2 = torch.matmul(V, w)
            w = w - torch.matmul(V.T, h2)
            hlast = torch.linalg.vector_norm(w)
            V[j + 1] = w / torch.clamp(hlast, min=1e-38)
            hcol_t = h1 + h2
            hcol_t[j + 1] = hlast
            hcol = hcol_t.cpu().numpy().astype(f)    # the iteration's one sync
            for i in range(j):                  # previous Givens rotations
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i] = hi
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = hcol[j] / max(denom, tiny)
            s = hcol[j + 1] / max(denom, tiny)
            hcol[j], hcol[j + 1] = denom, f(0.0)
            H[:, j] = hcol
            cs[j], sn[j] = c, s
            g[j + 1] = -s * g[j]
            g[j] = c * g[j]
            resid = abs(g[j + 1])
            hist[it] = resid
            it += 1
            done = bool(resid <= tol) or it >= maxiter
        # back-substitution on the rotated upper-triangular H
        steps = min(it - it0, restart)
        y = np.zeros((restart,), f)
        for i in range(steps - 1, -1, -1):
            num = g[i] - np.dot(H[i, :restart], y)
            y[i] = num / (H[i, i] if H[i, i] != 0 else f(1.0))
        dx = torch.matmul(V[:restart].T, torch.as_tensor(y, device=dev))
        x = x + (dx if left else m_op(dx))

    final_res = float(torch.linalg.vector_norm(pre(b - a_op(x))))
    # scipy-parity convergence: the Givens recurrence reaching tol counts;
    # the recomputed residual is exposed as final_residual
    rec_ok = it > 0 and bool(hist[it - 1] <= tol)
    return GMRESResult(x=x, residuals=torch.as_tensor(hist, device=dev),
                       iterations=it, converged=rec_ok or final_res <= tol,
                       final_residual=final_res)


def gmres_matrix(a, b: torch.Tensor, m=None, restart: int = 30, maxiter: int = 1000,
                 rtol: float = 1e-5) -> GMRESResult:
    """GMRES with sparse-container operands (``gmres`` on ``as_linop`` of
    each)."""
    return gmres(as_linop(a), b, m_op=None if m is None else as_linop(m),
                 restart=restart, maxiter=maxiter, rtol=rtol)


def solve_with_gmres(a, b: torch.Tensor, m=None, maxiter: int = 10260,
                     restart: int = 20, rtol: float = 1e-5, side: str = "left"):
    """Reference-harness wrapper (GFlowNet100.py:61-93): x0 = 0, residual
    history, iteration count, wall-clock seconds (the device synchronised
    at the end).  Defaults are the reference's: scipy ``gmres``'s restart
    is 20."""
    t0 = time.time()
    res = gmres(a, b, m_op=m, restart=restart, maxiter=maxiter, rtol=rtol,
                side=side)
    if res.x.is_cuda:
        torch.cuda.synchronize(res.x.device)
    elapsed = time.time() - t0
    return res.x, res.residuals[:res.iterations], res.iterations, elapsed
