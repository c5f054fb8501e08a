"""LinOp: a linear operator as an ``(fn, data)`` pair (counterpart of
``gflownet_spai_tpu/solvers/linop.py``).

In JAX the pair exists so that an operator's arrays travel through jit
boundaries as arguments; PyTorch runs eagerly, so here it is a small
callable that keeps the split (``fn(data, x)``) and a dictionary ``info``
of what its constructor chose (the fused k, tile, sweeps or degree of a
polynomial preconditioner).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..ops.dia import DIA, spmv_dia
from ..sparse.ops import spmv


@dataclasses.dataclass(frozen=True, eq=False)
class LinOp:
    data: Any
    fn: Callable
    info: dict = dataclasses.field(default_factory=dict)

    def __call__(self, x):
        return self.fn(self.data, x)


def as_linop(obj) -> "LinOp | Callable":
    """Sparse container (COO of tensors, or DIA: K8) → LinOp; callables
    (LinOps included) pass through."""
    if callable(obj):
        return obj
    return LinOp(data=obj, fn=spmv_dia if isinstance(obj, DIA) else spmv)
