"""Carry parameters and matrices over from the JAX package.

``params_from_jax(tree)`` turns a JAX ``GFlowNetParams`` tree whose leaves
are numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) into the
port's ``GFlowNetParams``; ``gatv2_params_from_jax`` does the same for one
``GATv2Params`` (any edge_dim), and ``bell_from_jax`` for a block-ELL
matrix.  They read fields by name and import nothing of JAX, so the
layouts stay one-to-one.  ``sharded_params_from_jax`` gives one ``rows``
rank's parameters of the sharded sampler: the head padded to a multiple of
the rank count, then the rank's column slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .gfn.gflownet import GFlowNetParams
from .models import policies as pol
from .models.gat import GATv2Params
from .ops.bsr import BELL


def _tensor(x, device):
    return None if x is None else torch.tensor(np.asarray(x), device=device)


def _fields(cls, node, device, **given):
    """``cls`` built from the same-named fields of ``node`` (or ``given``)."""
    return cls(**{name: given[name] if name in given
                  else _tensor(getattr(node, name, None), device)
                  for name in cls._fields})


def gatv2_params_from_jax(node, device=None) -> GATv2Params:
    """One GATv2 layer's parameters (numpy leaves) on ``device``."""
    return _fields(GATv2Params, node, resolve_device(device))


def bell_from_jax(bell) -> BELL:
    """A JAX ``BELL``'s ``data``, ``bcols``, ``shape`` and ``nnz`` as a
    host port ``BELL`` (``.to(device)`` moves it): numpy arrays, except
    bf16 ``data``, whose bits are carried through a 16-bit integer view
    into a CPU ``torch.bfloat16`` tensor (numpy itself has no bf16)."""
    data = np.asarray(bell.data)
    if data.dtype.name == "bfloat16":
        data = torch.from_numpy(data.view(np.int16).copy()).view(torch.bfloat16)
    return BELL(data=data, bcols=np.asarray(bell.bcols, np.int32),
                shape=tuple(bell.shape), nnz=int(bell.nnz))


def params_from_jax(tree, device=None) -> GFlowNetParams:
    device = resolve_device(device)
    fwd = tree.forward
    forward = _fields(pol.ForwardPolicyParams, fwd, device,
                      gat1=gatv2_params_from_jax(fwd.gat1, device),
                      gat2=gatv2_params_from_jax(fwd.gat2, device))
    backward = tree.backward
    if backward is not None:
        cls = (pol.LinearBackwardParams if hasattr(backward, "emb_g")
               else pol.BackwardPolicyParams)
        backward = _fields(cls, backward, device)
    flow = (None if tree.flow is None
            else _fields(pol.FlowHeadParams, tree.flow, device))
    return GFlowNetParams(forward=forward, backward=backward,
                          log_z=_tensor(tree.log_z, device), flow=flow)


def sharded_params_from_jax(tree, n_shards: int, index: int,
                            device=None) -> GFlowNetParams:
    """Rank ``index`` of ``n_shards``: ``params_from_jax`` with the forward
    head padded (``parallel.tp.pad_head``) and cut to the rank's columns."""
    from .parallel.tp import head_slice

    p = params_from_jax(tree, device)
    return p._replace(forward=head_slice(p.forward, n_shards, index))
