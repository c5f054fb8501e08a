"""Sparse matrix containers.

Counterpart of ``gflownet_spai_tpu/sparse/types.py`` (``COO`` only in this
slice).  Host-side setup code holds numpy arrays; ``COO.to(device)`` moves
a matrix onto a device as torch tensors (int64 indices, so they index
directly).
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
        as_t = lambda x, dt=None: torch.as_tensor(
            to_numpy(x), dtype=dt, device=device)
        return COO(row=as_t(self.row, torch.int64),
                   col=as_t(self.col, torch.int64),
                   data=as_t(self.data), shape=self.shape)

    def with_data(self, data) -> "COO":
        return dataclasses.replace(self, data=data)

    @staticmethod
    def fromdense(a, tol: float = 0.0) -> "COO":
        a = np.asarray(a)
        r, c = np.nonzero(np.abs(a) > tol)
        return COO(row=r.astype(np.int32), col=c.astype(np.int32),
                   data=a[r, c], shape=a.shape)
