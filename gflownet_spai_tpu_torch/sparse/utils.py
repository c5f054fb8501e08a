"""Sparse-tensor utilities on the COO container (counterpart of
``gflownet_spai_tpu/sparse/utils.py``): the flat ``1 × m·n`` round trip,
sparse one-hot, concatenation and the flat delete-action view of the
reference's ``gflownet/utils.py``.

Each function takes a COO of torch tensors (``COO.to(device)``) and
returns one on the same device.
"""

from __future__ import annotations

import torch

from .types import COO


def flatten_coo(coo: COO) -> COO:
    """[m, n] → [1, m·n] with linear indices ``row·n + col``."""
    m, n = coo.shape
    lin = coo.row.long() * n + coo.col.long()
    return COO(row=torch.zeros_like(coo.row),
               col=lin if m * n >= 2**31 else lin.to(coo.col.dtype),
               data=coo.data, shape=(1, m * n))


def unflatten_coo(coo: COO, shape) -> COO:
    """[1, m·n] → [m, n]."""
    m, n = shape
    if tuple(coo.shape) != (1, m * n):
        raise ValueError(
            f"cannot unflatten {coo.shape} into {shape}: element counts differ")
    lin = coo.col.long()
    return COO(row=(lin // n).to(torch.int32), col=(lin % n).to(torch.int32),
               data=coo.data, shape=(m, n))


def sparse_one_hot(indices: torch.Tensor, num_classes: int) -> COO:
    """[B] indices → sparse one-hot [B, num_classes]."""
    b = indices.shape[0]
    return COO(row=torch.arange(b, dtype=torch.int32, device=indices.device),
               col=indices.to(torch.int32),
               data=torch.ones(b, dtype=torch.float32, device=indices.device),
               shape=(b, num_classes))


def concat_coo(mats, axis: int = 0) -> COO:
    """Concatenate COO matrices along an axis."""
    if axis not in (0, 1):
        raise ValueError("axis must be 0 or 1")
    rows, cols, vals = [], [], []
    offset, other = 0, None
    for m in mats:
        if other is None:
            other = m.shape[1 - axis]
        elif m.shape[1 - axis] != other:
            raise ValueError("non-concat dims must match")
        rows.append(m.row + (offset if axis == 0 else 0))
        cols.append(m.col + (offset if axis == 1 else 0))
        vals.append(m.data)
        offset += m.shape[axis]
    shape = (offset, other) if axis == 0 else (other, offset)
    return COO(row=torch.cat(rows), col=torch.cat(cols), data=torch.cat(vals),
               shape=shape)


def delete_edges_flat(coo: COO, edge_positions: torch.Tensor) -> COO:
    """Apply a delete-action list and emit the flat [1, n²] matrix:
    positions index the (sorted) nonzero list, deleted entries get value 0
    (the pattern stays), positions outside [0, nnz) are ignored."""
    pos = edge_positions.long()
    idx = torch.where((pos >= 0) & (pos < coo.nnz), pos, coo.nnz)
    keep = torch.ones(coo.nnz + 1, dtype=torch.bool, device=pos.device)
    keep[idx] = False
    return flatten_coo(coo.with_data(coo.data * keep[:coo.nnz].to(coo.data.dtype)))
