"""Aggregation V-cycle preconditioner on the fused DIA kernels (counterpart
of ``gflownet_spai_tpu/solvers/multigrid.py``).

Coarsening is size-2 aggregation on the (RCM-ordered) row index::

    P z_c = repeat(z_c, 2)           (piecewise-constant prolongation)
    R r   = ½·(r[0::2] + r[1::2])    (its scaled adjoint, R = ½ Pᵀ)
    A_c   = R A P                    (Galerkin; DIA again, offsets ≈ off/2)

Consecutive-index aggregation suits banded / RCM-ordered matrices and
halves the bandwidth per level, so every coarse operator stays DIA.  The
Galerkin product is one ``index_add_`` over index maps built on the host
when the operator is made.  Every smoothing sweep runs on the fused kernels
(weighted Jacobi: K12 at the selection's k, or the unfused K8 sweep;
Chebyshev: ``chebyshev_op``, K13 or K8), and the residuals on K8.  With
equal pre- and post-smoothing and R ∝ Pᵀ the cycle is symmetric for
symmetric A, so CG may use it while it stays positive definite.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..ops.dia import (DIA, _ALIGN, _k8_share, _round_up, dia_pad_pp, dia_pp_tile,
                       spmv_dia)
from .linop import LinOp
from .stationary import (_pick_power_config, _safe_diag, _sweep_pairs, chebyshev_op,
                         estimate_lmax, jacobi_iteration_matrix)


def galerkin_coarse_dia(d: DIA) -> DIA:
    """A_c = ½ Pᵀ A P for size-2 aggregation, in DIA: one ``index_add_``
    of the halved diagonal entries into the coarse diagonals, over index
    maps built on the host (float atomics on the card, so an entry's sum
    of up to 8 terms is taken in a run-dependent order)."""
    n = d.n
    n_c = (n + 1) // 2
    src_list, ii_list, dc_list = [], [], []
    for s, off in enumerate(d.offsets):
        lo, hi = max(0, -off), min(n, n - off)
        if hi <= lo:
            continue
        i = np.arange(lo, hi, dtype=np.int64)
        src_list.append(s * d.n_pad + i)
        ii_list.append(i // 2)
        dc_list.append((i + off) // 2 - i // 2)
    if not src_list:
        raise ValueError("empty matrix")
    src = np.concatenate(src_list)
    big_i = np.concatenate(ii_list)
    dc = np.concatenate(dc_list)
    c_offs = np.unique(dc)
    n_cpad = _round_up(n_c, _ALIGN)
    dst = np.searchsorted(c_offs, dc) * n_cpad + big_i
    dev = d.data.device
    flat = torch.zeros((len(c_offs) * n_cpad,), dtype=d.data.dtype, device=dev)
    flat.index_add_(0, torch.as_tensor(dst, device=dev),
                    0.5 * d.data.reshape(-1)[torch.as_tensor(src, device=dev)])
    # nnz counts every stored word of A that ``dst`` maps, zeros included;
    # A_c's share of segments holding an entry is estimated as A's (K8's rule)
    return DIA(data=flat.reshape(len(c_offs), n_cpad),
               offsets=tuple(int(o) for o in c_offs), shape=(n_c, n_c),
               nnz=int(len(dst)), seg_share=_k8_share(d))


def restrict(r: torch.Tensor) -> torch.Tensor:
    """½·(r[0::2] + r[1::2]) with odd-length zero pad: [n] → [(n+1)//2]."""
    rp = torch.nn.functional.pad(r, (0, r.shape[0] % 2))
    return 0.5 * rp.reshape(-1, 2).sum(dim=1)


def prolong(z_c: torch.Tensor, n: int) -> torch.Tensor:
    """Piecewise-constant interpolation: [(n+1)//2] → [n]."""
    return torch.repeat_interleave(z_c, 2)[:n]


def _level_setup(a: DIA, omega: float, sweeps_max: int, fuse_k: int):
    """A level's weighted-Jacobi smoother: (meta, (A, M, ω·D⁻¹))."""
    m = jacobi_iteration_matrix(a, omega)
    k, trk = _pick_power_config(m, fuse_k, sweeps_max)
    _, nz, safe = _safe_diag(a)
    c_scale = torch.where(nz, omega / safe, 0.0)
    meta = {"k": k, "tr": trk or dia_pp_tile(m) or m.halo, "n": a.n}
    return meta, (a, m, c_scale)


def _sweeps(meta, level, r, x0, sweeps: int):
    """``sweeps`` weighted-Jacobi sweeps on A·x = r from ``x0`` (None: a
    zero start), rounded up to a ping-pong pair of k-sweep calls."""
    _, m, c_scale = level
    k, tr, n = meta["k"], meta["tr"], meta["n"]
    if sweeps <= 0:
        return r * 0 if x0 is None else x0[:n]
    c = c_scale * torch.nn.functional.pad(r.to(m.data.dtype), (0, m.n_pad - r.shape[0]))
    cq = dia_pad_pp(m, c[:n], tr=tr)
    xq = torch.zeros_like(cq) if x0 is None \
        else dia_pad_pp(m, x0[:n].to(m.data.dtype), tr=tr)
    pairs = max(1, -(-sweeps // (2 * k)))
    return _sweep_pairs(m, xq, torch.zeros_like(cq), cq, k, pairs)[tr:tr + n]


def _vcycle_apply(levels, r, *, metas, pre: int, post: int, coarse_sweeps: int,
                  gamma: int = 1):
    r = r.to(levels[0][0].data.dtype)
    last = len(metas) - 1

    def coarse_solve(l, rc):
        """γ recursive visits of level l (γ = 1: V-cycle, γ = 2: W-cycle)."""
        zc = cycle(l, rc)
        for _ in range(gamma - 1):
            if l == last:
                break              # re-visiting the coarsest gains nothing
            zc = zc + cycle(l, rc - spmv_dia(levels[l][0], zc))
        return zc

    def cycle(l, rl):
        meta, lvl = metas[l], levels[l]
        if l == last:
            return _sweeps(meta, lvl, rl, None, coarse_sweeps)
        z = _sweeps(meta, lvl, rl, None, pre)
        zc = coarse_solve(l + 1, restrict(rl - spmv_dia(lvl[0], z)))
        z = z + prolong(zc, meta["n"])
        return _sweeps(meta, lvl, rl, z, post)

    return cycle(0, r[:metas[0]["n"]])


def _vcycle_apply_cheb(levels, r, *, gamma: int = 1):
    """Chebyshev-smoothed cycle; ``levels``: per level (A, smoother LinOp,
    coarse LinOp or None).  Post-smoothing from z is z + S(r − A·z), the
    same polynomial, so the cycle stays symmetric."""
    r = r.to(levels[0][0].data.dtype)
    last = len(levels) - 1

    def coarse_solve(l, rc):
        zc = cycle(l, rc)
        for _ in range(gamma - 1):
            if l == last:
                break
            zc = zc + cycle(l, rc - spmv_dia(levels[l][0], zc))
        return zc

    def cycle(l, rl):
        a, smooth, coarse = levels[l]
        if l == last:
            return coarse(rl)
        z = smooth(rl)
        z = z + prolong(coarse_solve(l + 1, restrict(rl - spmv_dia(a, z))), a.n)
        return z + smooth(rl - spmv_dia(a, z))

    return cycle(0, r[:levels[0][0].n])


def vcycle_op(d: DIA, omega: float = 2.0 / 3.0, pre: int = 2, post: int = 2,
              levels: int = 2, coarse_sweeps: int = 16, fuse_k: int = 8,
              min_coarse_n: int = 2048, smoother: str = "jacobi",
              cheb_degree: int = 8, cheb_lmin_ratio: float = 4.0,
              cheb_coarse_degree: int = 32, gamma: int = 1) -> LinOp:
    """LinOp r ↦ z: one aggregation cycle on A.

    ``levels`` counts grids including the finest; coarsening stops early
    at ``min_coarse_n`` rows.  ``smoother="jacobi"``: ``pre`` / ``post``
    weighted-Jacobi sweeps (``coarse_sweeps`` on the coarsest level), the
    fused k chosen from the sweeps a level runs.  ``smoother="chebyshev"``:
    a degree-``cheb_degree`` Chebyshev polynomial on [λmax /
    ``cheb_lmin_ratio``, λmax] per level (λmax = 1.05·``estimate_lmax``,
    20 power iterations), the coarsest level one degree-
    ``cheb_coarse_degree`` polynomial on [λmax/30, λmax].  ``gamma=2``
    re-descends once more from every intermediate level (a W-cycle).
    ``info`` holds the levels built and each level's fused k."""
    if levels < 2:
        raise ValueError("vcycle_op needs levels >= 2")
    info = {"smoother": smoother, "gamma": gamma}
    a = d
    if smoother == "chebyshev":
        built = []
        for l in range(levels):
            is_coarse = l == levels - 1 or a.n <= min_coarse_n
            lmax = 1.05 * float(estimate_lmax(a, iters=20))
            sm = chebyshev_op(a, lmax=lmax, lmin=lmax / cheb_lmin_ratio,
                              degree=cheb_degree, fuse_k=fuse_k)
            co = chebyshev_op(a, lmax=lmax, lmin=lmax / 30.0, degree=cheb_coarse_degree,
                              fuse_k=fuse_k) if is_coarse else None
            built.append((a, sm, co))
            if is_coarse:
                break
            a = galerkin_coarse_dia(a)
        info.update(levels=len(built), k=[(co or sm).info["k"] for _, sm, co in built])
        return LinOp(data=tuple(built), fn=partial(_vcycle_apply_cheb, gamma=gamma),
                     info=info)
    metas, datas = [], []
    for l in range(levels):
        # k comes from the sweeps this level runs, so pre = 2 runs 2 sweeps
        # and not one fused 2·fuse_k block; odd counts round up to a pair
        is_coarse = l == levels - 1 or a.n <= min_coarse_n
        lvl_sweeps = (coarse_sweeps if is_coarse
                      else min((s for s in (pre, post) if s > 0), default=1))
        meta, data = _level_setup(a, omega, lvl_sweeps, fuse_k)
        metas.append(meta)
        datas.append(data)
        if is_coarse:
            break
        a = galerkin_coarse_dia(a)
    info.update(levels=len(metas), k=[meta["k"] for meta in metas])
    return LinOp(data=tuple(datas),
                 fn=partial(_vcycle_apply, metas=tuple(metas), pre=pre, post=post,
                            coarse_sweeps=coarse_sweeps, gamma=gamma),
                 info=info)
