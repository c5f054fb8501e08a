"""Host-side format conversions (counterpart of
``gflownet_spai_tpu/sparse/convert.py``: ``coo_sort_dedup``,
``scipy_to_coo``, ``coo_to_scipy``).  Patterns are static, so these run
once in numpy at setup time."""

from __future__ import annotations

import numpy as np

from .types import COO


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
