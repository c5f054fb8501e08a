"""Iterative solvers (GMRES, CG, BiCGStab, batched multi-RHS CG), the
preconditioners (ILU, SPAI, polynomial Jacobi and Chebyshev, the
aggregation V-cycle), multi-RHS weighted Jacobi and the validation harness
(counterpart of ``gflownet_spai_tpu/solvers``)."""

from .bicgstab import BiCGStabResult, bicgstab, solve_with_bicgstab
from .cg import CGResult, cg, cg_matrix, solve_with_cg
from .gmres import GMRESResult, gmres, gmres_matrix, solve_with_gmres
from .linop import LinOp, as_linop
from .multigrid import galerkin_coarse_dia, vcycle_op
from .multirhs import CGMultiResult, cg_multi
from .precond import ilu_solve_op, jacobi_op, spai_op, spai_op_sym
from .spai_classic import SpaiPlan, power_pattern, spai_classic
from .stationary import (JacobiResult, chebyshev_coeffs, chebyshev_op,
                         estimate_lmax, jacobi, jacobi_iteration_matrix,
                         jacobi_multirhs, jacobi_sweeps_op)
from .trisolve import TriSolvePlan, sparse_ilu_solve_op
from .validate import SolveReport, best_sampled_matrix, validate_preconditioners

__all__ = [
    "BiCGStabResult", "bicgstab", "solve_with_bicgstab",
    "CGResult", "cg", "cg_matrix", "solve_with_cg",
    "GMRESResult", "gmres", "gmres_matrix", "solve_with_gmres",
    "LinOp", "as_linop",
    "galerkin_coarse_dia", "vcycle_op",
    "CGMultiResult", "cg_multi",
    "ilu_solve_op", "jacobi_op", "spai_op", "spai_op_sym",
    "SpaiPlan", "power_pattern", "spai_classic",
    "JacobiResult", "chebyshev_coeffs", "chebyshev_op", "estimate_lmax",
    "jacobi", "jacobi_iteration_matrix", "jacobi_multirhs", "jacobi_sweeps_op",
    "TriSolvePlan", "sparse_ilu_solve_op",
    "SolveReport", "best_sampled_matrix", "validate_preconditioners",
]
