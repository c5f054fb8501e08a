"""Matrix Market IO (counterpart of ``gflownet_spai_tpu/sparse/io.py``):
``read_mtx`` (coordinate and array formats, general / symmetric /
skew-symmetric, real / integer / pattern fields; coordinate files that are
not gzipped go through the native parser where the library is built) and
``write_mtx``."""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

from .. import native
from .convert import coo_sort_dedup, coo_to_csr
from .types import COO, CSR, to_numpy


def _open(path):
    path = str(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mtx(path, dtype=np.float64) -> COO:
    """Parse a Matrix Market file into a canonical (sorted) COO.

    Coordinate files that are not gzipped go through the native C++ parser
    where the library is built (``native.available()``); a file it does not
    take (array format, complex or hermitian) falls through to the Python
    parser below."""
    if not str(path).endswith(".gz"):
        if native.available():
            try:
                nr, nc, rows, cols, vals = native.parse_mtx(path)
            except ValueError:
                pass
            else:
                return COO(row=rows.astype(np.int32), col=cols.astype(np.int32),
                           data=vals.astype(dtype), shape=(nr, nc))
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


def write_mtx(path, coo: COO, comment: str = "") -> None:
    """Write a COO matrix (numpy or tensors) in Matrix Market
    coordinate/real/general format."""
    row = to_numpy(coo.row) + 1
    col = to_numpy(coo.col) + 1
    data = to_numpy(coo.data)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"%{line}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {len(data)}\n")
        for r, c, v in zip(row, col, data):
            f.write(f"{r} {c} {v:.17g}\n")


def read_mtx_vector(path, dtype=np.float64) -> np.ndarray:
    """A dense vector from .mtx (densified and flattened)."""
    return to_numpy(read_mtx(path, dtype=dtype).todense()).ravel()


def read_mtx_csr(path, dtype=np.float64) -> CSR:
    """A .mtx file straight to CSR."""
    return coo_to_csr(read_mtx(path, dtype=dtype), canonical=True)
