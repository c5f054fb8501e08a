"""Weighted Jacobi (one or K right-hand sides) and Chebyshev polynomial
preconditioners on the fused DIA kernels (counterpart of
``gflownet_spai_tpu/solvers/stationary.py``).

Weighted Jacobi for A·x = b with weight ω::

    x ← x + ω·D⁻¹·(b − A·x)  =  M·x + c,   M = I − ω·D⁻¹·A,  c = ω·D⁻¹·b

M has A's offsets, so k sweeps fuse into one read of its diagonals (K12,
``ops.dia.spmv_dia_power`` with ``add=c``).  The Chebyshev semi-iteration
fuses k steps the same way (K13, ``spmv_dia_cheby``), and
``jacobi_multirhs`` runs k sweeps of K systems per diagonal read (K14,
``spmv_dia_power_rhs``).  The fused k comes
from the TPU's VMEM model (``ops.dia``), kept for parity: sweeps round up
to a multiple of 2k and the Chebyshev degree to a multiple of k, so k is
part of the operator a row of the harness applies.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import torch

from ..ops.dia import (DIA, dia_cheby_ok, dia_pad_pp, dia_pad_pp_rhs,
                       dia_power_ok, dia_power_rhs_ok, dia_power_tile, dia_pp_tile,
                       spmm_dia_t, spmv_dia, spmv_dia_cheby, spmv_dia_padded,
                       spmv_dia_power, spmv_dia_power_rhs)
from .linop import LinOp


def _pick_power_config(m: DIA, fuse_k: int, sweeps: int) -> tuple[int, int]:
    """(k, tile) for the fused affine kernel: among feasible fused configs
    (per-k tiles from ``dia_power_tile``) the one with the least modeled
    HBM elements per sweep per row (TPU model, verbatim for parity).
    Returns (1, 0) when no fused config beats the unfused affine sweep."""
    h, nd = m.halo, m.ndiags
    best_k, best_tr = 1, 0
    best_cost = float(nd + 3)          # unfused: data + x + c + out per row
    kk = min(fuse_k, max(1, sweeps // 2))
    while kk >= 2:
        tr = dia_power_tile(m, kk)
        if tr:
            win_d = tr + 2 * (kk - 1) * h
            if dia_power_ok(m, kk, tr):
                win_x, win_c = tr, tr
            else:
                win_x, win_c = tr + 2 * kk * h, win_d
            cost = (nd * win_d + win_x + win_c + tr) / (kk * tr)
            # a modeled tie against the unfused baseline prefers the fused
            # kernel; among fused configs the first (largest-k) winner stays
            if cost < best_cost or (best_k == 1 and cost == best_cost):
                best_k, best_tr, best_cost = kk, tr, cost
        kk //= 2
    return best_k, best_tr


class JacobiResult(NamedTuple):
    x: torch.Tensor          # [n] solution estimate ([K, n] for K systems)
    residual: torch.Tensor   # ‖b − A·x‖₂ at exit (scalar, or [K])
    iterations: int          # sweeps performed


def _safe_diag(d: DIA):
    if 0 not in d.offsets:
        raise ValueError("Jacobi needs an explicit main diagonal")
    diag = d.data[d.offsets.index(0)]
    nz = diag.abs() > 0
    return diag, nz, torch.where(nz, diag, 1.0)


def jacobi_iteration_matrix(d: DIA, omega: float = 2.0 / 3.0) -> DIA:
    """M = I − ω·D⁻¹·A in DIA with A's offsets.  Rows with a zero or
    missing diagonal keep x unchanged (an identity row) — including the
    padding rows [n, n_pad), whose main-diagonal entry is 1."""
    diag, nz, safe = _safe_diag(d)
    c = d.offsets.index(0)
    rows = []
    for s in range(d.ndiags):
        if s == c:
            rows.append(torch.where(nz, torch.full_like(diag, 1.0 - omega), 1.0))
        else:
            rows.append(torch.where(nz, -omega * d.data[s] / safe, 0.0))
    return dataclasses.replace(d, data=torch.stack(rows))


def jacobi_constant(d: DIA, b: torch.Tensor, omega: float = 2.0 / 3.0) -> torch.Tensor:
    """c = ω·D⁻¹·b padded to [n_pad] (b [n], or [K, n] → [K, n_pad])."""
    _, nz, safe = _safe_diag(d)
    bp = torch.nn.functional.pad(b.to(d.data.dtype), (0, d.n_pad - b.shape[-1]))
    return torch.where(nz, omega * bp / safe, 0.0)


def spmv_dia_pingpong_affine(m: DIA, xq: torch.Tensor, zq: torch.Tensor,
                             cq: torch.Tensor) -> torch.Tensor:
    """One affine sweep z = M·x + c in the padded layout (the unfused k = 1
    path): the SpMV is ``spmv_dia_padded`` (K8 on CUDA tensors); writes
    zq's interior in place and returns zq."""
    p = (xq.shape[0] - m.n_pad) // 2
    zq[p:p + m.n_pad] = spmv_dia_padded(m, xq) + cq[p:p + m.n_pad]
    return zq


def _sweep_pairs(m: DIA, xq, zq, cq, k: int, pairs: int):
    """``pairs`` fixed-role call pairs x → z → x of k sweeps each (the
    kernels read ``m.data``, so no ``dia_power_data`` windows are made)."""
    for _ in range(pairs):
        if k > 1:
            spmv_dia_power(m, None, xq, zq, k=k, add=cq)
            spmv_dia_power(m, None, zq, xq, k=k, add=cq)
        else:
            spmv_dia_pingpong_affine(m, xq, zq, cq)
            spmv_dia_pingpong_affine(m, zq, xq, cq)
    return xq


def jacobi(d: DIA, b: torch.Tensor, x0: torch.Tensor | None = None,
           omega: float = 2.0 / 3.0, iters: int = 100,
           fuse_k: int = 8) -> JacobiResult:
    """``iters`` weighted-Jacobi sweeps (rounded up to a multiple of 2k so
    the fused ping-pong chain stays fixed-role), then the true residual."""
    m = jacobi_iteration_matrix(d, omega)
    k, trk = _pick_power_config(m, fuse_k, iters)
    c = jacobi_constant(d, b, omega)
    tr = trk or dia_pp_tile(m) or m.halo
    cq = dia_pad_pp(m, c[:d.n], tr=tr)
    x_init = torch.zeros((d.n,), dtype=d.data.dtype, device=d.data.device) \
        if x0 is None else x0
    xq = dia_pad_pp(m, x_init, tr=tr)
    pairs = max(1, -(-iters // (2 * k)))
    xq = _sweep_pairs(m, xq, torch.zeros_like(xq), cq, k, pairs)
    x = xq[tr:tr + d.n]
    r = b.to(x.dtype) - spmv_dia(d, x)
    return JacobiResult(x=x, residual=torch.linalg.vector_norm(r),
                        iterations=pairs * 2 * k)


# --- polynomial-Jacobi preconditioner operator ---------------------------

def _jacobi_sweeps_apply(data, r, *, k: int, pairs: int, n: int,
                         tile: int | None = None):
    m, c_scale = data
    c = c_scale * torch.nn.functional.pad(r.to(m.data.dtype), (0, m.n_pad - r.shape[0]))
    cq = dia_pad_pp(m, c[:n], tr=tile)
    tr = (cq.shape[0] - m.n_pad) // 2             # P from the buffer
    xq = _sweep_pairs(m, torch.zeros_like(cq), torch.zeros_like(cq), cq, k, pairs)
    return xq[tr:tr + n].to(r.dtype)


def jacobi_sweeps_op(d: DIA, omega: float = 2.0 / 3.0, sweeps: int = 16,
                     fuse_k: int = 8) -> LinOp:
    """LinOp r ↦ x_sweeps — weighted-Jacobi sweeps from a zero guess, the
    polynomial preconditioner P = Σ_{i<sweeps} Mⁱ·ωD⁻¹ (symmetric for
    symmetric A, SPD for 0 < ω·λmax(D⁻¹A) < 2, so valid for CG).  Runs
    K12 at k sweeps per diagonal read when the selection fuses (k ≥ 2),
    else the unfused sweep; ``info`` holds k, the tile and the sweeps it
    applies (rounded up to a multiple of 2k)."""
    m = jacobi_iteration_matrix(d, omega)
    k, trk = _pick_power_config(m, fuse_k, sweeps)
    pairs = max(1, -(-sweeps // (2 * k)))
    _, nz, safe = _safe_diag(d)
    c_scale = torch.where(nz, omega / safe, 0.0)
    return LinOp(data=(m, c_scale),
                 fn=partial(_jacobi_sweeps_apply, k=k, pairs=pairs, n=d.n,
                            tile=trk or None),
                 info={"k": k, "tile": trk or dia_pp_tile(m) or m.halo,
                       "sweeps": pairs * 2 * k, "omega": omega})


# --- Chebyshev polynomial preconditioner ----------------------------------

def estimate_lmax(d: DIA, iters: int = 20, seed: int = 0,
                  v0: torch.Tensor | None = None) -> torch.Tensor:
    """Power-iteration estimate of λmax(A) (a scalar tensor).  The start
    vector is standard normal, drawn in float64 on the CPU from a torch
    generator seeded with ``seed``, so a matrix on the card and its copy on
    the CPU start alike (JAX draws another stream from the same seed:
    ``v0`` takes a given start vector instead)."""
    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.randn((d.n,), generator=gen, dtype=torch.float64).to(
            device=d.data.device, dtype=d.data.dtype)
    v = v0 / torch.linalg.vector_norm(v0)
    for _ in range(iters):
        w = spmv_dia(d, v)
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    w = spmv_dia(d, v)
    return torch.dot(v, w) / torch.dot(v, v)


def chebyshev_coeffs(lmin: float, lmax: float, degree: int):
    """Per-step (aᵢ, bᵢ) of the Chebyshev semi-iteration for A·z = r from
    z₀ = 0 (Saad, Iterative Methods, Alg. 12.1), written uniformly as
    dᵢ = aᵢ·dᵢ₋₁ + bᵢ·(r − A·zᵢ), zᵢ₊₁ = zᵢ + dᵢ with a₀ = 0, b₀ = 1/θ."""
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta
    coeffs = [(0.0, 1.0 / theta)]
    rho_prev = 1.0 / sigma1
    for _ in range(1, degree):
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        coeffs.append((rho * rho_prev, 2.0 * rho / delta))
        rho_prev = rho
    return coeffs


def _chebyshev_apply(d, r, *, coeffs, n: int):
    rr = r[:n]
    z = torch.zeros_like(rr)
    dd = torch.zeros_like(rr)
    for (a, b) in coeffs:
        dd = a * dd + b * (rr - spmv_dia(d, z))
        z = z + dd
    return z.to(r.dtype)


def _chebyshev_apply_fused(d, r, *, coeff_calls, k: int, n: int):
    rq = dia_pad_pp(d, r[:n].to(d.data.dtype))
    tr = (rq.shape[0] - d.n_pad) // 2             # P from the buffer
    bufs = [torch.zeros_like(rq) for _ in range(4)]   # zA, ddA, zB, ddB
    for i, cc in enumerate(coeff_calls):
        src, dst = (0, 2) if i % 2 == 0 else (2, 0)
        spmv_dia_cheby(d, None, bufs[src], bufs[src + 1], rq,
                       bufs[dst], bufs[dst + 1], cc, k)
    final = 0 if len(coeff_calls) % 2 == 0 else 2
    return bufs[final][tr:tr + n].to(r.dtype)


def chebyshev_op(d: DIA, lmax: float, lmin: float | None = None,
                 degree: int = 16, fuse_k: int = 4) -> LinOp:
    """LinOp r ↦ z_degree — the degree-``degree`` Chebyshev approximation
    of A⁻¹r over [lmin, lmax] (``lmin`` defaults to lmax/30).  When the
    fused kernel's selection admits k ≥ 2 (``dia_cheby_ok``), the apply
    runs k steps per diagonal read (K13) and the degree rounds up to a
    multiple of k; else one K8 SpMV per step.  ``info`` holds k and the
    degree applied."""
    if lmin is None:
        lmin = lmax / 30.0
    k = 1
    kk = min(fuse_k, max(1, degree // 2))
    while kk >= 2:
        if dia_cheby_ok(d, kk):
            k = kk
            break
        kk //= 2
    info = {"k": k, "tile": dia_pp_tile(d) or d.halo, "lmax": float(lmax),
            "lmin": float(lmin)}
    if k > 1:
        degree_eff = -(-degree // k) * k
        coeffs = chebyshev_coeffs(float(lmin), float(lmax), degree_eff)
        coeff_calls = tuple(tuple(coeffs[i:i + k]) for i in range(0, degree_eff, k))
        return LinOp(data=d,
                     fn=partial(_chebyshev_apply_fused, coeff_calls=coeff_calls,
                                k=k, n=d.n),
                     info={**info, "degree": degree_eff})
    coeffs = tuple(chebyshev_coeffs(float(lmin), float(lmax), degree))
    return LinOp(data=d, fn=partial(_chebyshev_apply, coeffs=coeffs, n=d.n),
                 info={**info, "degree": degree})


# --- multi-RHS weighted Jacobi (fused over sweeps and right-hand sides) --

def _multirhs_config(m: DIA, fuse_k: int, sweeps: int, n_rhs: int) -> tuple[int, int]:
    """(k, tile) of ``jacobi_multirhs``: the single-RHS choice, k halved
    until the TPU's multi-RHS model fits (``dia_power_rhs_ok``)."""
    k, trk = _pick_power_config(m, fuse_k, sweeps)
    while k > 1 and not dia_power_rhs_ok(m, k, n_rhs, trk or dia_pp_tile(m)):
        k //= 2
        trk = dia_power_tile(m, k) if k > 1 else 0
    return k, trk


def jacobi_multirhs(d: DIA, b: torch.Tensor, x0: torch.Tensor | None = None,
                    omega: float = 2.0 / 3.0, iters: int = 100,
                    fuse_k: int = 8) -> JacobiResult:
    """Weighted Jacobi for K systems A·X = B at once (``b``: [K, n]): k
    sweeps of all K per diagonal read (K14, ``spmv_dia_power_rhs``, any k).
    The fused k is the single-RHS selection's, halved until the TPU's
    multi-RHS model fits (``dia_power_rhs_ok``), so it can be 1 where one
    system would fuse; sweeps round up to a multiple of 2k.  The ping-pong
    pair is updated in place.  Residuals per system ([K]), from one K16
    SpMM over all K."""
    n_rhs = b.shape[0]
    m = jacobi_iteration_matrix(d, omega)
    k, trk = _multirhs_config(m, fuse_k, iters, n_rhs)
    c = jacobi_constant(d, b, omega)               # [K, n_pad]
    tr = trk or dia_pp_tile(m) or m.halo
    cq = dia_pad_pp_rhs(m, c[:, :d.n], tr=tr)
    x_init = torch.zeros((n_rhs, d.n), dtype=d.data.dtype, device=d.data.device) \
        if x0 is None else x0
    xq = dia_pad_pp_rhs(m, x_init, tr=tr)
    zq = torch.zeros_like(xq)
    pairs = max(1, -(-iters // (2 * k)))
    for _ in range(pairs):
        spmv_dia_power_rhs(m, None, xq, zq, k=k, add=cq)
        spmv_dia_power_rhs(m, None, zq, xq, k=k, add=cq)
    x = xq[:, tr:tr + d.n]
    r = b.to(x.dtype) - spmm_dia_t(d, x)
    return JacobiResult(x=x, residual=torch.linalg.vector_norm(r, dim=-1),
                        iterations=pairs * 2 * k)
