"""BiCGStab for nonsymmetric systems: no restarts, two operator applies per
iteration (counterpart of ``gflownet_spai_tpu/solvers/bicgstab.py``).

Vectors and scalars stay on the device; the iteration's stop flag and ‖r‖
come to the host together once per iteration.  A collapse of ρ, ω or r̂ᵀv
(Lanczos breakdown) freezes the iterate and stops, as does a residual that
runs away (> 10⁶·‖b‖) or turns non-finite: substituting an epsilon would
corrupt x.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .linop import as_linop


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    residuals: torch.Tensor   # [maxiter] ‖r‖ history, NaN-padded
    iterations: int
    converged: bool           # the true residual ‖b − A·x‖ ≤ tol at exit


def _identity(x):
    return x


def bicgstab(a_op, b: torch.Tensor, x0: Optional[torch.Tensor] = None, m_op=None,
             maxiter: int = 1000, rtol: float = 1e-5,
             atol: float = 0.0) -> BiCGStabResult:
    """Right-preconditioned BiCGStab (``m_op`` ≈ A⁻¹ applied to the search
    directions, scipy-style); ``a_op`` / ``m_op`` may be callables, LinOps
    or sparse containers.  Stops on ‖r‖ ≤ max(rtol·‖b‖, atol)."""
    a_op = as_linop(a_op)
    m_op = as_linop(m_op) if m_op is not None else _identity
    f = np.float64 if b.dtype == torch.float64 else np.float32
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = torch.linalg.vector_norm(b)
    tol = torch.clamp(rtol * bnorm, min=atol)
    eps = torch.tensor(1e-38, dtype=b.dtype, device=b.device)
    small = eps * 1e6
    r = b - a_op(x)
    rhat = r
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    hist = np.full((maxiter,), np.nan, f)
    it = 0
    done = bool(torch.linalg.vector_norm(r) <= tol)
    while not done and it < maxiter:
        rho_new = torch.dot(rhat, r)
        breakdown = (rho_new.abs() < small) | (omega.abs() < small)
        beta = (rho_new / torch.where(rho == 0, eps, rho)) * (
            alpha / torch.where(omega == 0, eps, omega))
        p = r + beta * (p - omega * v)
        phat = m_op(p)
        v = a_op(phat)
        rv = torch.dot(rhat, v)
        breakdown = breakdown | (rv.abs() < small)
        alpha = rho_new / torch.where(rv == 0, eps, rv)
        s = r - alpha * v
        snorm = torch.linalg.vector_norm(s)
        half_done = snorm <= tol          # x + α·p̂ is already good enough
        shat = m_op(s)
        t = a_op(shat)
        tt = torch.dot(t, t)
        omega = torch.dot(t, s) / torch.where(tt == 0, eps, tt)
        x_half = x + alpha * phat
        r_full = s - omega * t
        rnorm = torch.where(half_done, snorm, torch.linalg.vector_norm(r_full))
        stop = (breakdown | half_done | (rnorm > 1e6 * bnorm) | (rnorm <= tol)
                | ~torch.isfinite(rnorm))
        x = torch.where(breakdown, x, torch.where(half_done, x_half, x_half + omega * shat))
        r = torch.where(breakdown, r, torch.where(half_done, s, r_full))
        rho = rho_new
        stop_h, rnorm_h = torch.stack([stop.to(b.dtype), rnorm]).tolist()   # one sync
        hist[it] = rnorm_h
        it += 1
        done = bool(stop_h)
    converged = bool(torch.linalg.vector_norm(b - a_op(x)) <= tol)
    return BiCGStabResult(x=x, residuals=torch.as_tensor(hist, device=b.device),
                          iterations=it, converged=converged)


def solve_with_bicgstab(a, b: torch.Tensor, m=None, maxiter: int = 1000,
                        rtol: float = 1e-5):
    """Harness wrapper mirroring ``solve_with_gmres``."""
    t0 = time.time()
    res = bicgstab(a, b, m_op=m, maxiter=maxiter, rtol=rtol)
    if res.x.is_cuda:
        torch.cuda.synchronize(res.x.device)
    elapsed = time.time() - t0
    return res.x, res.residuals[:res.iterations], res.iterations, elapsed
