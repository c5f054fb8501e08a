"""Preconditioned conjugate gradients with residual history (counterpart
of ``gflownet_spai_tpu/solvers/cg.py``): the same history and
iteration-count semantics as GMRES.  Vectors and scalars stay on the
device; ‖r‖ comes to the host once per iteration for the stopping test.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .linop import as_linop


class CGResult(NamedTuple):
    x: torch.Tensor
    residuals: torch.Tensor   # [maxiter] ‖r_k‖ history, NaN-padded
    iterations: int
    converged: bool


def _identity(x):
    return x


def cg(a_op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, m_op=None,
       maxiter: int = 1000, rtol: float = 1e-5, atol: float = 0.0) -> CGResult:
    """Preconditioned CG; ``a_op`` / ``m_op`` may be callables, LinOps or
    sparse containers.  Stops on ``‖r‖ ≤ max(rtol·‖b‖, atol)``."""
    a_op = as_linop(a_op)
    m_op = as_linop(m_op) if m_op is not None else _identity
    f = np.float64 if b.dtype == torch.float64 else np.float32
    x = torch.zeros_like(b) if x0 is None else x0
    tol = max(f(rtol) * f(torch.linalg.vector_norm(b).item()), f(atol))
    r = b - a_op(x)
    z = m_op(r)
    # one carry dtype: a float64 operator on a float32 b promotes it all
    dt = torch.promote_types(r.dtype, z.dtype)
    x, r, z = x.to(dt), r.to(dt), z.to(dt)
    p = z
    rz = torch.dot(r, z)
    hist = np.full((maxiter,), np.nan, f)
    it = 0
    done = bool(f(torch.linalg.vector_norm(r).item()) <= tol)
    while not done and it < maxiter:
        ap = a_op(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_op(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        rnorm = f(torch.linalg.vector_norm(r).item())
        hist[it] = rnorm
        it += 1
        done = bool(rnorm <= tol)
    return CGResult(x=x, residuals=torch.as_tensor(hist, device=b.device),
                    iterations=it, converged=done)


def cg_matrix(a, b: torch.Tensor, m=None, maxiter: int = 1000,
              rtol: float = 1e-5) -> CGResult:
    """CG with sparse-container operands (``cg`` on ``as_linop`` of each)."""
    return cg(as_linop(a), b, m_op=None if m is None else as_linop(m),
              maxiter=maxiter, rtol=rtol)


def solve_with_cg(a, b: torch.Tensor, m=None, maxiter: int = 1000,
                  rtol: float = 1e-5):
    """Harness wrapper mirroring ``solve_with_gmres``."""
    t0 = time.time()
    res = cg(a, b, m_op=m, maxiter=maxiter, rtol=rtol)
    if res.x.is_cuda:
        torch.cuda.synchronize(res.x.device)
    elapsed = time.time() - t0
    return res.x, res.residuals[:res.iterations], res.iterations, elapsed
