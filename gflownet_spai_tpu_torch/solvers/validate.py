"""Validation harness: GMRES/CG iteration-count comparison (counterpart of
``gflownet_spai_tpu/solvers/validate.py``).

The reference's acceptance metric: solve ``A x = b`` unpreconditioned, with
ILU and with the sampled SPAI, and compare iteration counts, residuals and
wall-clock (reference GFlowNet100.py:61-93, 98-132).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .._device import resolve_device
from ..env import ilu as ilu_mod
from ..env import spai
from ..sparse.ops import spmv
from ..sparse.types import COO
from .cg import solve_with_cg
from .gmres import solve_with_gmres
from .precond import ilu_solve_op, spai_op


@dataclasses.dataclass
class SolveReport:
    iterations: int
    elapsed: float
    final_residual: float
    converged: bool

    def to_dict(self):
        return dataclasses.asdict(self)


def true_residual(a: COO, b: torch.Tensor, x: torch.Tensor) -> float:
    """‖b − A x‖ / ‖b‖, the solver-independent acceptance number."""
    return float(torch.linalg.vector_norm(b - spmv(a, x))
                 / torch.linalg.vector_norm(b))


def _report(a, b, x, residuals, iters, elapsed, rtol) -> SolveReport:
    """``converged`` is judged on the true residual ‖b − A x‖ ≤ rtol·‖b‖
    (a maxiter-exhausted run must not report success from its history)."""
    final = float(residuals[-1]) if len(residuals) else float("nan")
    return SolveReport(iterations=iters, elapsed=elapsed, final_residual=final,
                       converged=true_residual(a, b, x) <= rtol)


def validate_preconditioners(
    a: COO,
    b: Optional[torch.Tensor] = None,
    sampled_m: Optional[COO] = None,
    maxiter: int = 10260,
    restart: int = 30,
    method: str = "gmres",
    seed_method: str = "ilu0",
    jacobi_poly: int = 0,
    device=None,
) -> Dict[str, SolveReport]:
    """The reference comparison: none vs ILU(0) vs (optionally) the sampled
    SPAI, plus a polynomial-Jacobi row with ``jacobi_poly`` sweeps.  ``a``
    and ``sampled_m`` may be host or device COO matrices; the solves run
    on ``device`` (CUDA unless the caller asks for another)."""
    del seed_method   # the ILU baseline always comes from ilu0
    device = resolve_device(device)
    ad = a.to(device)
    n = a.shape[0]
    if b is None:
        b = torch.ones((n,), dtype=ad.data.dtype, device=device)
    solve = solve_with_gmres if method == "gmres" else solve_with_cg
    rtol = 1e-5
    kw = dict(maxiter=maxiter, rtol=rtol)
    if method == "gmres":
        kw["restart"] = restart

    out: Dict[str, SolveReport] = {}
    out["none"] = _report(ad, b, *solve(ad, b, None, **kw), rtol=100 * rtol)
    L, U = ilu_mod.ilu0(a)
    out["ilu"] = _report(ad, b, *solve(ad, b, ilu_solve_op(L, U, device=device), **kw),
                         rtol=100 * rtol)
    if sampled_m is not None:
        out["spai"] = _report(ad, b, *solve(ad, b, spai_op(sampled_m.to(device)), **kw),
                              rtol=100 * rtol)
    if jacobi_poly > 0:
        from ..ops.dia import coo_to_dia
        from .stationary import jacobi_sweeps_op

        op = jacobi_sweeps_op(coo_to_dia(a, device=device), sweeps=jacobi_poly)
        out["jacobi_poly"] = _report(ad, b, *solve(ad, b, op, **kw), rtol=100 * rtol)
    return out


def best_sampled_matrix(env, actions: torch.Tensor, rewards: torch.Tensor) -> COO:
    """The highest-reward sampled preconditioner of a batch of
    trajectories, as a COO matrix on the env's device (the DIA env's edges
    in its (diagonal, row) enumeration)."""
    from ..env import spai_dia

    best = int(torch.argmax(rewards))
    keep = spai.keep_mask_from_actions(actions[best], env.num_edges)
    if isinstance(env, spai_dia.SpaiDiaEnv):
        seed = spai_dia.edge_coo(env).to(keep.device)
    else:
        seed = env.seed
    return COO(row=seed.row, col=seed.col,
               data=seed.data * keep.to(seed.data.dtype), shape=seed.shape)
