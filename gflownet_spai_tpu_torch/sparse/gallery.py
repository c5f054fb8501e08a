"""Test-matrix gallery (counterpart of ``gflownet_spai_tpu/sparse/gallery.py``).

Host-side numpy generators of structurally comparable stand-ins for the
SuiteSparse matrices the reference uses (the ``*_like`` names are honest:
these are synthetic).  ``get(name)`` resolves a gallery name, including the
parametric ``poisson<k>``, ``convdiff<n>``, ``convdiff2d<k>`` and
``orsirr_like<k>``.
"""

from __future__ import annotations

import warnings

import numpy as np

from .convert import coo_sort_dedup
from .types import COO


def _coo(row, col, data, shape) -> COO:
    return coo_sort_dedup(COO(row=np.asarray(row).astype(np.int32),
                              col=np.asarray(col).astype(np.int32),
                              data=np.asarray(data), shape=shape))


def poisson2d(k: int, dtype=np.float64) -> COO:
    """5-point 2D Laplacian on a k×k grid → (k², k²) SPD matrix."""
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    rows = [i]; cols = [i]; vals = [np.full(n, 4.0, dtype)]
    for off, mask in ((-k, r > 0), (k, r < k - 1), (-1, c > 0), (1, c < k - 1)):
        rows.append(i[mask]); cols.append(i[mask] + off)
        vals.append(np.full(mask.sum(), -1.0, dtype))
    return _coo(np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), (n, n))


def conv_diffusion(n: int, beta: float = 0.5, dtype=np.float64) -> COO:
    """1D convection-diffusion (central differences): nonsymmetric
    tridiagonal, olm500-style."""
    i = np.arange(n)
    rows = np.concatenate([i, i[1:], i[:-1]])
    cols = np.concatenate([i, i[1:] - 1, i[:-1] + 1])
    vals = np.concatenate([
        np.full(n, 2.0, dtype),
        np.full(n - 1, -1.0 - beta, dtype),
        np.full(n - 1, -1.0 + beta, dtype),
    ])
    return _coo(rows, cols, vals, (n, n))


def random_spd(n: int, density: float = 0.02, seed: int = 0, dtype=np.float64) -> COO:
    """Diagonally dominant random sparse SPD matrix."""
    rng = np.random.default_rng(seed)
    nnz_off = max(1, int(density * n * n / 2))
    r = rng.integers(0, n, nnz_off)
    c = rng.integers(0, n, nnz_off)
    keep = r != c
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r)) * 0.5
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    dense_rowsum = np.zeros(n)
    np.add.at(dense_rowsum, r, np.abs(v))
    np.add.at(dense_rowsum, c, np.abs(v))
    diag = dense_rowsum + 1.0
    vals = np.concatenate([v, v, diag]).astype(dtype)
    return _coo(rows, cols, vals, (n, n))


def conv_diffusion_2d(k: int, beta: float = 0.6, dtype=np.float64) -> COO:
    """2D convection-diffusion on a k×k grid, upwinded in x: 5-point
    nonsymmetric (orsirr/sherman-style reservoir operator).  n = k²."""
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    rows = [i]; cols = [i]; vals = [np.full(n, 4.0, dtype)]
    for off, mask, v in (
        (-k, r > 0, -1.0),            # north (diffusion only)
        (k, r < k - 1, -1.0),         # south
        (-1, c > 0, -1.0 - beta),     # west  (upwind-strengthened)
        (1, c < k - 1, -1.0 + beta),  # east  (weakened)
    ):
        rows.append(i[mask]); cols.append(i[mask] + off)
        vals.append(np.full(mask.sum(), v, dtype))
    return _coo(np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals), (n, n))


def orsirr_like(k: int, beta: float = 0.6, jump_frac: float = 0.01,
                seed: int = 0, dtype=np.float64) -> COO:
    """Nonsymmetric unstructured stand-in: 2D convection-diffusion plus
    ``jump_frac``·n random long-range couplings (well connections in a
    reservoir model), which defeat the banded DIA path."""
    base = conv_diffusion_2d(k, beta, dtype)
    n = k * k
    rng = np.random.default_rng(seed)
    m = max(1, int(jump_frac * n))
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    rows = np.concatenate([base.row, r[keep]])
    cols = np.concatenate([base.col, c[keep]])
    vals = np.concatenate([base.data, rng.standard_normal(keep.sum()) * 0.1])
    return _coo(rows, cols, vals.astype(dtype), (n, n))


def hangglider_like(T: int = 1466, h: float = 0.05, eps: float = 1e-2,
                    dtype=np.float64) -> COO:
    """Trajectory-optimization KKT stand-in for SuiteSparse hangGlider_3:
    K = [[Q, Bᵀ], [B, −εI]] with a tridiagonal SPD Hessian Q over 4T primal
    variables and banded dynamics constraints B (3(T−1) rows).  The default
    T = 1466 gives n = 7T − 3 = 10,259."""
    np_, nc = 4 * T, 3 * (T - 1)
    n = np_ + nc
    rows, cols, vals = [], [], []
    i = np.arange(np_)
    rows.append(i); cols.append(i)
    vals.append(2.0 + 0.1 * np.cos(0.01 * i))
    rows.append(i[:-1]); cols.append(i[:-1] + 1)
    vals.append(np.full(np_ - 1, -0.5))
    rows.append(i[:-1] + 1); cols.append(i[:-1])
    vals.append(np.full(np_ - 1, -0.5))
    k = np.repeat(np.arange(T - 1), 3)
    j = np.tile(np.arange(3), T - 1)
    crow = np_ + 3 * k + j
    for ccol, v in ((4 * (k + 1) + j, np.ones(nc)),
                    (4 * k + j, -np.ones(nc)),
                    (4 * k + 3, -h * (1.0 + 0.2 * j))):
        rows.append(crow); cols.append(ccol); vals.append(v)      # B
        rows.append(ccol); cols.append(crow); vals.append(v)      # Bᵀ
    d = np.arange(np_, n)
    rows.append(d); cols.append(d); vals.append(np.full(nc, -eps))
    return _coo(np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals).astype(dtype), (n, n))


def lf10_like(dtype=np.float64) -> COO:
    """18×18 banded SPD matrix, the scale of the LF10 test matrix."""
    n = 18
    rows, cols, vals = [], [], []
    for i in range(n):
        rows.append(i); cols.append(i); vals.append(4.0 + 0.1 * i)
        for d in (1, 2):
            if i + d < n:
                rows.append(i); cols.append(i + d); vals.append(-1.0 / d)
                rows.append(i + d); cols.append(i); vals.append(-1.0 / d)
    return _coo(rows, cols, np.asarray(vals, dtype), (n, n))


GALLERY = {
    "LF10_like": lambda: lf10_like(),
    "bcsstk03_like": lambda: random_spd(112, density=0.05, seed=3),
    "olm500_like": lambda: conv_diffusion(500),
    "hangGlider3_like": lambda: hangglider_like(),
    "poisson32": lambda: poisson2d(32),
}

#: Bare SuiteSparse names of the stand-ins; they resolve with a warning.
_ALIASES = {"LF10": "LF10_like", "bcsstk03": "bcsstk03_like",
            "olm500": "olm500_like"}

_PARAMETRIC = (
    ("poisson", poisson2d),
    ("convdiff2d", conv_diffusion_2d),
    ("convdiff", conv_diffusion),
    ("orsirr_like", orsirr_like),
)


def get(name: str) -> COO:
    """Gallery lookup, including the parametric families (``poisson128``
    = 5-point Laplacian on a 128×128 grid, ``orsirr_like150`` = n 22,500)."""
    if name in _ALIASES:
        warnings.warn(
            f"gallery name {name!r} is a synthetic stand-in, not the "
            f"SuiteSparse matrix; use {_ALIASES[name]!r} (or a real .mtx "
            "path) — the alias keeps working but will stay noisy",
            stacklevel=2,
        )
        name = _ALIASES[name]
    if name in GALLERY:
        return GALLERY[name]()
    for prefix, make in _PARAMETRIC:
        if name.startswith(prefix) and name[len(prefix):].isdigit():
            return make(int(name[len(prefix):]))
    raise KeyError(name)
