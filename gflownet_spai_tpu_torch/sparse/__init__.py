"""Sparse containers, conversions, IO and the plain PyTorch sparse ops
(counterpart of ``gflownet_spai_tpu/sparse``)."""

from . import gallery
from .convert import (coo_sort_dedup, coo_to_csr, coo_to_scipy, csr_to_bsr,
                      csr_to_ell, scipy_to_coo, to_coo)
from .io import read_mtx, read_mtx_csr, read_mtx_vector, write_mtx
from .ops import (SpGEMMPlan, eye_coo, frobenius_sq_minus_identity, spgemm, spmm,
                  spmv)
from .types import BSR, COO, CSR, ELL

__all__ = [
    "BSR", "COO", "CSR", "ELL",
    "coo_sort_dedup", "coo_to_csr", "coo_to_scipy", "csr_to_bsr",
    "csr_to_ell", "scipy_to_coo", "to_coo",
    "read_mtx", "read_mtx_csr", "read_mtx_vector", "write_mtx",
    "SpGEMMPlan", "eye_coo", "frobenius_sq_minus_identity",
    "spgemm", "spmm", "spmv", "gallery",
]
