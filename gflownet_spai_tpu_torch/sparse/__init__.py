"""Sparse containers, conversions, IO and the fixed-pattern SpGEMM."""

from . import gallery
from .convert import coo_sort_dedup, coo_to_scipy, scipy_to_coo
from .io import read_mtx
from .ops import SpGEMMPlan, frobenius_sq_minus_identity
from .types import COO

__all__ = [
    "COO", "coo_sort_dedup", "coo_to_scipy", "scipy_to_coo", "read_mtx",
    "SpGEMMPlan", "frobenius_sq_minus_identity", "gallery",
]
