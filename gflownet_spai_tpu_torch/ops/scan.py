"""First-order linear recurrence and suffix log-sum-exp with analytic
adjoints (counterpart of ``gflownet_spai_tpu/ops/scan.py``).

``linear_scan(a, b, axis)`` computes ``h_t = a_t·h_{t−1} + b_t``
(``h_{−1} = 0``) by Hillis–Steele doubling, O(log T) passes of plain
tensor ops (the JAX package runs an XLA associative scan, not a kernel).
Its backward is the one reverse scan of the analytic adjoint:

    g_t = ĥ_t + a_{t+1}·g_{t+1},   ∂L/∂b_t = g_t,   ∂L/∂a_t = g_t·h_{t−1}

``suffix_logsumexp(x)`` is ``s_t = logsumexp(x[t:])`` along the last axis;
its adjoint ``∂L/∂x_u = e^{x_u−s_u}·D_u`` with
``D_u = e^{s_u−s_{u−1}}·D_{u−1} + ŝ_u`` is one ``linear_scan`` whose
exponents are all ≤ 0, and it stays finite where ``x`` or ``s`` is −inf.
"""

from __future__ import annotations

import torch


def _scan(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward recurrence along ``dim`` by doubling: after the pass with
    stride k, (A_t, B_t) compose the 2k steps ending at t."""
    A, B = a, b
    T = b.shape[dim]
    k = 1
    while k < T:
        lo_a = A.narrow(dim, 0, T - k)
        lo_b = B.narrow(dim, 0, T - k)
        hi_a = A.narrow(dim, k, T - k)
        hi_b = B.narrow(dim, k, T - k)
        B = torch.cat([B.narrow(dim, 0, k), hi_a * lo_b + hi_b], dim)
        A = torch.cat([A.narrow(dim, 0, k), hi_a * lo_a], dim)
        k *= 2
    return B


class _LinearScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, dim):
        h = _scan(a, b, dim)
        ctx.dim = dim
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, hbar):
        a, h = ctx.saved_tensors
        dim = ctx.dim
        T = h.shape[dim]
        # a_{t+1}, with 1 past the end (no successor)
        a_next = torch.cat([a.narrow(dim, 1, T - 1),
                            torch.ones_like(a.narrow(dim, 0, 1))], dim)
        g = _scan(a_next.flip(dim), hbar.flip(dim), dim).flip(dim)
        h_prev = torch.cat([torch.zeros_like(h.narrow(dim, 0, 1)),
                            h.narrow(dim, 0, T - 1)], dim)
        return g * h_prev, g, None


def linear_scan(a: torch.Tensor, b: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t along ``axis``; ``a`` broadcasts to ``b``'s
    shape (its gradient is summed back by autograd)."""
    dim = axis % b.dim()
    return _LinearScan.apply(a.expand_as(b), b, dim)


def _suffix_lse(x: torch.Tensor) -> torch.Tensor:
    return torch.logcumsumexp(x.flip(-1), dim=-1).flip(-1)


class _SuffixLogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = _suffix_lse(x)
        ctx.save_for_backward(x, s)
        return s

    @staticmethod
    def backward(ctx, sbar):
        x, s = ctx.saved_tensors
        finite = torch.isfinite(s)
        prev = torch.cat([s[..., :1], s[..., :-1]], -1)
        both = finite & torch.isfinite(prev)
        a = torch.where(both, torch.exp(torch.clamp_max(
            s - torch.where(both, prev, 0.0), 0.0)), 0.0)
        r = torch.where(finite & (sbar != 0), sbar, 0.0)
        d = _scan(a, r, x.dim() - 1)
        e = torch.exp(torch.clamp_max(x - torch.where(finite, s, 0.0), 0.0))
        return torch.where(torch.isfinite(x) & finite, e * d, 0.0)


def suffix_logsumexp(x: torch.Tensor) -> torch.Tensor:
    """s_t = logsumexp(x[t:]) along the last axis, with the analytic
    adjoint (finite on −inf lanes)."""
    return _SuffixLogSumExp.apply(x)
