"""Matrix Market reader (counterpart of ``gflownet_spai_tpu/sparse/io.py``
``read_mtx``, on its pure-Python path): coordinate and array formats,
general / symmetric / skew-symmetric, real / integer / pattern fields."""

from __future__ import annotations

import gzip

import numpy as np

from .convert import coo_sort_dedup
from .types import COO


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mtx(path, dtype=np.float64) -> COO:
    """Parse a Matrix Market file into a canonical (sorted) COO."""
    with _open(path) as f:
        header = f.readline().strip().lower().split()
        if len(header) < 5 or header[0] != "%%matrixmarket":
            raise ValueError(f"{path}: not a Matrix Market file")
        _, obj, fmt, field, symmetry = header[:5]
        if obj != "matrix":
            raise ValueError(f"{path}: unsupported object {obj!r}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        dims = line.split()
        if fmt == "coordinate":
            nrows, ncols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            body = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
            if body.shape[0] != nnz:
                raise ValueError(f"{path}: expected {nnz} entries, got {body.shape[0]}")
            row = body[:, 0].astype(np.int64) - 1
            col = body[:, 1].astype(np.int64) - 1
            if field == "pattern":
                data = np.ones(nnz, dtype=dtype)
            else:
                data = body[:, 2].astype(dtype)
        elif fmt == "array":
            nrows, ncols = int(dims[0]), int(dims[1])
            vals = np.loadtxt(f).ravel().astype(dtype)
            if symmetry == "general":
                return COO.fromdense(vals.reshape(ncols, nrows).T)  # column-major
            full = np.zeros((nrows, ncols), dtype=dtype)
            k = 0
            for j in range(ncols):
                for i in range(j, nrows):
                    full[i, j] = vals[k]
                    k += 1
            sign = -1.0 if symmetry == "skew-symmetric" else 1.0
            return COO.fromdense(full + sign * np.triu(full.T, 1))
        else:
            raise ValueError(f"{path}: unsupported format {fmt!r}")

    if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
        off = row != col
        sign = -1.0 if symmetry == "skew-symmetric" else 1.0
        row, col = (np.concatenate([row, col[off]]),
                    np.concatenate([col, row[off]]))
        data = np.concatenate([data, sign * data[off]])
    return coo_sort_dedup(COO(row=row.astype(np.int32), col=col.astype(np.int32),
                              data=data, shape=(nrows, ncols)),
                          sum_duplicates=False)
