"""Iterative solvers (GMRES, CG), preconditioners and the validation
harness (counterpart of ``gflownet_spai_tpu/solvers``, without BiCGStab,
the multi-RHS solvers and multigrid)."""

from .cg import CGResult, cg, solve_with_cg
from .gmres import GMRESResult, gmres, solve_with_gmres
from .linop import LinOp, as_linop
from .precond import ilu_solve_op, jacobi_op, spai_op, spai_op_sym
from .spai_classic import SpaiPlan, power_pattern, spai_classic
from .stationary import (JacobiResult, chebyshev_coeffs, chebyshev_op,
                         estimate_lmax, jacobi, jacobi_iteration_matrix,
                         jacobi_sweeps_op)
from .trisolve import TriSolvePlan, sparse_ilu_solve_op
from .validate import SolveReport, best_sampled_matrix, validate_preconditioners

__all__ = [
    "CGResult", "cg", "solve_with_cg",
    "GMRESResult", "gmres", "solve_with_gmres",
    "LinOp", "as_linop",
    "ilu_solve_op", "jacobi_op", "spai_op", "spai_op_sym",
    "SpaiPlan", "power_pattern", "spai_classic",
    "JacobiResult", "chebyshev_coeffs", "chebyshev_op", "estimate_lmax",
    "jacobi", "jacobi_iteration_matrix", "jacobi_sweeps_op",
    "TriSolvePlan", "sparse_ilu_solve_op",
    "SolveReport", "best_sampled_matrix", "validate_preconditioners",
]
