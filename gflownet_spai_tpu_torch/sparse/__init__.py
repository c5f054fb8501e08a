"""Sparse containers, conversions, IO, the COO SpMV and the fixed-pattern
SpGEMM."""

from . import gallery
from .convert import coo_sort_dedup, coo_to_scipy, scipy_to_coo
from .io import read_mtx, write_mtx
from .ops import SpGEMMPlan, frobenius_sq_minus_identity, spmv
from .types import COO

__all__ = [
    "COO", "coo_sort_dedup", "coo_to_scipy", "scipy_to_coo", "read_mtx", "write_mtx",
    "SpGEMMPlan", "frobenius_sq_minus_identity", "spmv", "gallery",
]
