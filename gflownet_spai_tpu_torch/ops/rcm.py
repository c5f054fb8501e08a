"""Reverse Cuthill–McKee bandwidth reduction and band statistics, on the
host (counterpart of ``gflownet_spai_tpu/ops/rcm.py``).

RCM permutes rows and columns to cluster nonzeros near the main diagonal,
after which ``coo_to_dia`` stores few distinct diagonals.  ``bandwidth``
and ``n_diagonals`` also resolve ``env_format="auto"`` in
``train.loop.setup``.  The ordering runs in the native library where it
is built, else as the same BFS in numpy.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..sparse.convert import coo_sort_dedup, coo_to_scipy
from ..sparse.types import COO


def bandwidth(coo: COO) -> int:
    if coo.nnz == 0:
        return 0
    h = coo.numpy()
    return int(np.abs(h.row.astype(np.int64) - h.col.astype(np.int64)).max())


def n_diagonals(coo: COO) -> int:
    h = coo.numpy()
    return int(len(np.unique(h.col.astype(np.int64) - h.row.astype(np.int64))))


def rcm_permutation(coo: COO) -> np.ndarray:
    """RCM ordering of the symmetrized adjacency graph: ``perm`` such that
    ``A[perm][:, perm]`` has (near-)minimal bandwidth.  Each connected
    component starts from its minimum-degree node; neighbours join the
    queue in ascending degree order."""
    n = coo.shape[0]
    A = coo_to_scipy(coo)
    G = (abs(A) + abs(A).T).tocsr()   # symmetrize
    indptr, indices = G.indptr, G.indices
    if native.available():
        return native.rcm(indptr, indices)
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in np.argsort(degree, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        order[pos] = seed
        head, pos = pos, pos + 1
        while head < pos:
            u = order[head]
            head += 1
            nbrs = indices[indptr[u]:indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs):
                nbrs = nbrs[np.argsort(degree[nbrs], kind="stable")]
                visited[nbrs] = True
                order[pos:pos + len(nbrs)] = nbrs
                pos += len(nbrs)
    return order[::-1].copy()   # the "reverse" in RCM


def permute(coo: COO, perm: np.ndarray) -> COO:
    """Symmetric permutation B = A[perm][:, perm] (B[i,j] = A[perm[i], perm[j]]),
    as a row-major sorted host COO."""
    h = coo.numpy()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return coo_sort_dedup(COO(row=inv[h.row].astype(np.int32),
                              col=inv[h.col].astype(np.int32),
                              data=h.data, shape=coo.shape),
                          sum_duplicates=False)


def rcm_reorder(coo: COO):
    """(permuted matrix, perm).  Solve ``A x = b`` as ``B y = b[perm];
    x[perm] = y``."""
    perm = rcm_permutation(coo)
    return permute(coo, perm), perm
