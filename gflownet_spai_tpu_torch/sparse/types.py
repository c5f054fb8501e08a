"""Sparse matrix containers.

Counterpart of ``gflownet_spai_tpu/sparse/types.py``: ``COO``, ``CSR``,
``ELL`` and ``BSR``.  Host-side setup code holds numpy arrays;
``.to(device)`` moves a matrix onto a device as torch tensors (int64
indices, so they index directly).  ``todense()`` returns a torch tensor on
the arrays' device (the CPU for numpy arrays).

Padding convention (ELL): padded entries have column 0 and value 0, so no
masking is needed in inner loops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

Shape = Tuple[int, int]


def to_numpy(x) -> np.ndarray:
    """``x`` as a numpy array (a host copy when it is a device tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _as_t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(to_numpy(x), dtype=dtype, device=device)


def _scatter_dense(shape, index, data) -> torch.Tensor:
    """Dense tensor of ``shape`` with ``data`` added at ``index`` (a tuple
    of index arrays, duplicates summed)."""
    data = torch.as_tensor(data)
    out = data.new_zeros(shape)
    idx = tuple(torch.as_tensor(i, device=data.device).long() for i in index)
    return out.index_put_(idx, data, accumulate=True)


def _repeat_rows(counts, nrows: int, like):
    """Row id of each stored entry, ``repeat(arange(nrows), counts)``, as
    the same kind of array as ``like``."""
    if isinstance(like, torch.Tensor):
        return torch.repeat_interleave(
            torch.arange(nrows, dtype=like.dtype, device=like.device), counts.long())
    return np.repeat(np.arange(nrows, dtype=np.int32), counts)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix: ``row``/``col`` int[nnz], ``data``
    [nnz], as numpy arrays (host) or torch tensors (device)."""

    row: Any
    col: Any
    data: Any
    shape: Shape

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def numpy(self) -> "COO":
        return COO(row=to_numpy(self.row), col=to_numpy(self.col),
                   data=to_numpy(self.data), shape=self.shape)

    def to(self, device) -> "COO":
        """Torch tensors on ``device`` (indices as int64)."""
        return COO(row=_as_t(self.row, device, torch.int64),
                   col=_as_t(self.col, device, torch.int64),
                   data=_as_t(self.data, device), shape=self.shape)

    def todense(self) -> torch.Tensor:
        return _scatter_dense(self.shape, (self.row, self.col), self.data)

    def with_data(self, data) -> "COO":
        return dataclasses.replace(self, data=data)

    @staticmethod
    def fromdense(a, tol: float = 0.0) -> "COO":
        a = to_numpy(a)
        r, c = np.nonzero(np.abs(a) > tol)
        return COO(row=r.astype(np.int32), col=c.astype(np.int32),
                   data=a[r, c], shape=a.shape)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row: ``indptr`` int[nrows + 1], ``indices``
    int[nnz], ``data`` [nnz]."""

    indptr: Any
    indices: Any
    data: Any
    shape: Shape

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    def to(self, device) -> "CSR":
        return CSR(indptr=_as_t(self.indptr, device, torch.int64),
                   indices=_as_t(self.indices, device, torch.int64),
                   data=_as_t(self.data, device), shape=self.shape)

    def tocoo(self) -> COO:
        row = _repeat_rows(self.indptr[1:] - self.indptr[:-1], self.shape[0],
                           self.indices)
        return COO(row=row, col=self.indices, data=self.data, shape=self.shape)

    def todense(self) -> torch.Tensor:
        return self.tocoo().todense()

    def with_data(self, data) -> "CSR":
        return dataclasses.replace(self, data=data)


@dataclasses.dataclass(frozen=True)
class ELL:
    """Padded ELLPACK: ``cols`` int[nrows, width], ``data`` [nrows, width].
    Padded slots hold column 0 and value 0."""

    cols: Any
    data: Any
    shape: Shape

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    def to(self, device) -> "ELL":
        return ELL(cols=_as_t(self.cols, device, torch.int64),
                   data=_as_t(self.data, device), shape=self.shape)

    def tocoo(self) -> COO:
        """The stored nonzeros (padding and explicit zeros dropped)."""
        return COO.fromdense(to_numpy(self.todense()))

    def todense(self) -> torch.Tensor:
        rows = np.broadcast_to(np.arange(self.shape[0])[:, None], tuple(self.cols.shape))
        return _scatter_dense(self.shape, (rows.reshape(-1), self.cols.reshape(-1)),
                              self.data.reshape(-1))


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block CSR with dense (bm, bn) blocks: ``indptr`` int[nrows/bm + 1],
    ``indices`` int[nblocks] (block-column ids), ``data`` [nblocks, bm, bn]."""

    indptr: Any
    indices: Any
    data: Any
    shape: Shape

    @property
    def blockshape(self) -> Shape:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    def to(self, device) -> "BSR":
        return BSR(indptr=_as_t(self.indptr, device, torch.int64),
                   indices=_as_t(self.indices, device, torch.int64),
                   data=_as_t(self.data, device), shape=self.shape)

    def block_rows(self):
        """Block-row id of each stored block."""
        return _repeat_rows(self.indptr[1:] - self.indptr[:-1],
                            self.shape[0] // self.blockshape[0], self.indices)

    def tocoo(self) -> COO:
        """The stored nonzeros (explicit zeros of the blocks dropped)."""
        return COO.fromdense(to_numpy(self.todense()))

    def todense(self) -> torch.Tensor:
        bm, bn = self.blockshape
        m, n = self.shape
        out = _scatter_dense((m // bm, n // bn, bm, bn),
                             (self.block_rows(), self.indices), self.data)
        return out.permute(0, 2, 1, 3).reshape(self.shape)


SparseMatrix = (COO, CSR, ELL, BSR)
