"""Carry parameters over from the JAX package.

``params_from_jax(tree)`` turns a JAX ``GFlowNetParams`` tree whose leaves
are numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) into the
port's ``GFlowNetParams``.  It reads fields by name and imports nothing of
JAX, so the parameter layouts stay one-to-one.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .gfn.gflownet import GFlowNetParams
from .models import policies as pol
from .models.gat import GATv2Params


def _tensor(x, device):
    return None if x is None else torch.tensor(np.asarray(x), device=device)


def _fields(cls, node, device, **given):
    """``cls`` built from the same-named fields of ``node`` (or ``given``)."""
    return cls(**{name: given[name] if name in given
                  else _tensor(getattr(node, name, None), device)
                  for name in cls._fields})


def params_from_jax(tree, device=None) -> GFlowNetParams:
    device = resolve_device(device)
    fwd = tree.forward
    forward = _fields(pol.ForwardPolicyParams, fwd, device,
                      gat1=_fields(GATv2Params, fwd.gat1, device),
                      gat2=_fields(GATv2Params, fwd.gat2, device))
    backward = tree.backward
    if backward is not None:
        cls = (pol.LinearBackwardParams if hasattr(backward, "emb_g")
               else pol.BackwardPolicyParams)
        backward = _fields(cls, backward, device)
    flow = (None if tree.flow is None
            else _fields(pol.FlowHeadParams, tree.flow, device))
    return GFlowNetParams(forward=forward, backward=backward,
                          log_z=_tensor(tree.log_z, device), flow=flow)
