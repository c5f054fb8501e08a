"""ILU factorizations and the seed pattern (counterpart of
``gflownet_spai_tpu/env/ilu.py``).

The GFlowNet's action space is the nnz set of L @ U from an incomplete LU
of A.  This is one-off host setup, so it runs in numpy/scipy:

* ``ilu0``         — ILU(0) (no fill, no pivoting), in the native library
  where it is built, else in numpy;
* ``spilu_lu``     — scipy SuperLU ``spilu``;
* ``seed_pattern`` — the L @ U product as a COO matrix, the env's M0, or
  (``method="spai"``) the classic SPAI of A.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..sparse.convert import coo_to_scipy, scipy_to_coo
from ..sparse.types import COO


def ilu0(a: COO):
    """ILU(0) on the sparsity pattern of A, no pivoting.  Returns
    ``(L, U)`` as COO with unit-diagonal L (diagonal stored).  The native
    library, where it is built, runs the loop below in the same order."""
    import scipy.sparse as sp

    A = coo_to_scipy(a).tocsr().astype(np.float64)
    A.sort_indices()
    n = A.shape[0]
    if native.available():
        return _split_lu(sp.csr_matrix(
            (native.ilu0_values(A.indptr, A.indices, A.data), A.indices, A.indptr),
            shape=(n, n)))
    indptr, indices, data = A.indptr, A.indices, A.data.copy()
    # column-position lookup per row for O(1) pattern membership
    pos = [dict(zip(indices[indptr[i]:indptr[i + 1]],
                    range(indptr[i], indptr[i + 1]))) for i in range(n)]
    for i in range(n):
        row_i = pos[i]
        for jp in range(indptr[i], indptr[i + 1]):
            j = indices[jp]
            if j >= i:
                continue
            # L factor: a_ij / u_jj
            jj = pos[j].get(j)
            if jj is None or data[jj] == 0.0:
                raise ZeroDivisionError(f"zero pivot at row {j} in ILU(0)")
            lij = data[jp] / data[jj]
            data[jp] = lij
            # eliminate: a_ik -= l_ij * u_jk for k > j, k in pattern(i)
            for kp in range(indptr[j], indptr[j + 1]):
                k = indices[kp]
                if k <= j:
                    continue
                ip = row_i.get(k)
                if ip is not None:
                    data[ip] -= lij * data[kp]
    return _split_lu(sp.csr_matrix((data, indices, indptr), shape=(n, n)))


def _split_lu(LU):
    """The combined L\\U values → (L with its unit diagonal, U) as COO."""
    import scipy.sparse as sp

    L = sp.tril(LU, k=-1) + sp.eye(LU.shape[0], format="csr")
    U = sp.triu(LU, k=0)
    return scipy_to_coo(L), scipy_to_coo(U)


def spilu_lu(a: COO, **spilu_kwargs):
    """scipy ``spilu`` factorization → (L, U) as COO.  SuperLU permutes
    rows and columns; as in the reference, the permutation is dropped —
    the pattern is what matters here."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    ilu = spla.spilu(coo_to_scipy(a).tocsc(), **spilu_kwargs)
    L = sp.tril(ilu.L.tocsr(), format="csr")
    U = sp.triu(ilu.U.tocsr(), format="csr")
    return scipy_to_coo(L), scipy_to_coo(U)


def seed_pattern(a: COO, method: str = "ilu0", dtype=np.float32, **kwargs) -> COO:
    """Initial preconditioner matrix M0 = L @ U, whose nnz set becomes the
    GFlowNet action space.  ``pattern`` seeds with A's own pattern."""
    if method == "ilu0":
        L, U = ilu0(a)
    elif method == "spilu":
        L, U = spilu_lu(a, **kwargs)
    elif method == "pattern":
        h = a.numpy()
        return COO(row=h.row, col=h.col, data=h.data.astype(dtype), shape=a.shape)
    elif method == "spai":
        # the classic-SPAI approximate inverse min ‖A·M − I‖_F, so thinning
        # trades preconditioner quality against cost (host setup: the
        # batched QR runs on the CPU)
        from ..solvers.spai_classic import spai_classic

        return spai_classic(a, k=kwargs.get("k", 1), dtype=dtype, device="cpu")
    else:
        raise ValueError(f"unknown seed method {method!r}")
    seed = scipy_to_coo((coo_to_scipy(L) @ coo_to_scipy(U)).tocoo())
    return COO(row=seed.row, col=seed.col, data=seed.data.astype(dtype),
               shape=seed.shape)
