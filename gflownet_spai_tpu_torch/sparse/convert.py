"""Host-side format conversions (counterpart of
``gflownet_spai_tpu/sparse/convert.py``).  Patterns are static, so these
run once in numpy at setup time and return numpy-backed containers
(``.to(device)`` moves them)."""

from __future__ import annotations

import numpy as np

from .types import BSR, COO, CSR, ELL, to_numpy


def coo_sort_dedup(coo: COO, sum_duplicates: bool = True) -> COO:
    """Canonicalise a COO matrix: row-major sort, duplicates summed."""
    h = coo.numpy()
    n = coo.shape[1]
    key = h.row.astype(np.int64) * n + h.col.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, data = key[order], h.data[order]
    if sum_duplicates and len(key):
        uniq, inv = np.unique(key, return_inverse=True)
        summed = np.zeros(len(uniq), dtype=data.dtype)
        np.add.at(summed, inv, data)
        key, data = uniq, summed
    return COO(row=(key // n).astype(np.int32), col=(key % n).astype(np.int32),
               data=data, shape=coo.shape)


def coo_to_csr(coo: COO, canonical: bool = False) -> CSR:
    """COO → CSR; ``canonical`` says the entries are already row-major
    sorted without duplicates (else they are sorted and summed first)."""
    h = coo.numpy() if canonical else coo_sort_dedup(coo)
    indptr = np.zeros(coo.shape[0] + 1, dtype=np.int32)
    np.add.at(indptr, h.row.astype(np.int64) + 1, 1)
    return CSR(indptr=np.cumsum(indptr, dtype=np.int32), indices=h.col,
               data=h.data, shape=coo.shape)


def csr_to_ell(csr: CSR, width: int | None = None, pad_multiple: int = 1) -> ELL:
    """CSR → padded ELLPACK.  ``width`` defaults to the max row length,
    rounded up to ``pad_multiple``."""
    indptr, indices, data = (to_numpy(csr.indptr), to_numpy(csr.indices),
                             to_numpy(csr.data))
    counts = np.diff(indptr)
    w = int(counts.max()) if len(counts) and width is None else (width or 1)
    w = max(w, 1)
    w = -(-w // pad_multiple) * pad_multiple
    nrows = csr.shape[0]
    cols = np.zeros((nrows, w), dtype=np.int32)
    vals = np.zeros((nrows, w), dtype=data.dtype)
    for i in range(nrows):
        lo, hi = indptr[i], indptr[i + 1]
        k = hi - lo
        if k > w:
            raise ValueError(f"row {i} has {k} nnz > ELL width {w}")
        cols[i, :k] = indices[lo:hi]
        vals[i, :k] = data[lo:hi]
    return ELL(cols=cols, data=vals, shape=csr.shape)


def csr_to_bsr(csr: CSR, blockshape=(8, 128)) -> BSR:
    """CSR → block CSR.  Only blocks holding at least one entry are
    stored; the shape must be a multiple of the block shape."""
    bm, bn = blockshape
    m, n = csr.shape
    if m % bm or n % bn:
        raise ValueError(f"shape {csr.shape} not divisible by block {blockshape}")
    indptr, indices, data = (to_numpy(csr.indptr), to_numpy(csr.indices),
                             to_numpy(csr.data))
    row = np.repeat(np.arange(m, dtype=np.int32), np.diff(indptr))
    brow, bcol = row // bm, indices // bn
    key = brow.astype(np.int64) * (n // bn) + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    blocks = np.zeros((len(uniq), bm, bn), dtype=data.dtype)
    blocks[inv, row % bm, indices % bn] = data
    bindptr = np.zeros(m // bm + 1, dtype=np.int32)
    np.add.at(bindptr, (uniq // (n // bn)).astype(np.int64) + 1, 1)
    return BSR(indptr=np.cumsum(bindptr, dtype=np.int32),
               indices=(uniq % (n // bn)).astype(np.int32), data=blocks,
               shape=csr.shape)


def to_coo(x) -> COO:
    """Any container (or a dense array) as COO."""
    if isinstance(x, COO):
        return x
    if isinstance(x, (CSR, ELL, BSR)):
        return x.tocoo()
    return COO.fromdense(x)


def scipy_to_coo(sp_matrix) -> COO:
    """scipy.sparse → canonical COO."""
    c = sp_matrix.tocoo()
    return coo_sort_dedup(COO(row=c.row.astype(np.int32),
                              col=c.col.astype(np.int32),
                              data=np.asarray(c.data), shape=c.shape))


def coo_to_scipy(coo: COO):
    import scipy.sparse as sp

    h = coo.numpy()
    return sp.coo_matrix((h.data, (h.row, h.col)), shape=coo.shape).tocsr()
