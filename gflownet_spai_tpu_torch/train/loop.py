"""Host-side setup of the sampling path (counterpart of
``gflownet_spai_tpu/train/loop.py:65-160``): matrix → seed pattern → env
format → env → policy graph → model config → parameters.  The optimizer,
the training state and the training loop come with the training slice.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..env import ilu, spai
from ..gfn import gflownet as gfn
from ..models import policies as pol
from ..ops.rcm import n_diagonals
from ..sparse import gallery, read_mtx
from ..sparse.types import COO
from .config import TrainConfig


def load_matrix(cfg: TrainConfig) -> COO:
    """A gallery name (fixed names and the parametric families) or a path
    to a ``.mtx`` file."""
    try:
        return gallery.get(cfg.matrix)
    except KeyError:
        pass
    if not Path(cfg.matrix).exists():
        raise FileNotFoundError(
            f"matrix {cfg.matrix!r}: not a gallery name "
            f"({', '.join(sorted(gallery.GALLERY))}, poisson<k>, convdiff<n>) "
            f"and no such .mtx file")
    return read_mtx(cfg.matrix)


def device_of(cfg: TrainConfig) -> torch.device:
    """``platform=None`` → CUDA (raises without a card); ``"cpu"`` → CPU."""
    if cfg.platform in (None, "cuda", "gpu"):
        return resolve_device(None)
    if cfg.platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {cfg.platform!r}")


def _dia_phantom_slots(coo: COO) -> int:
    """In-range slots of the pattern's diagonals that hold no nonzero: the
    JAX package's ``env.spai_dia.has_phantom_slots(coo_to_dia(seed))`` for
    a canonical (deduplicated) pattern."""
    h = coo.numpy()
    offs = np.unique(h.col.astype(np.int64) - h.row.astype(np.int64))
    positions = int(np.sum(coo.shape[0] - np.abs(offs)))
    return positions - int(np.count_nonzero(h.data))


def resolve_env_format(cfg: TrainConfig, a: COO, seed: COO) -> str:
    """``auto`` as the JAX package resolves it: banded patterns with fully
    dense diagonals → ``dia``; otherwise seeds of ``rowblock_min_nnz``
    nonzeros or more → ``rowblock``; else ``coo``."""
    fmt = cfg.env_format
    if fmt != "auto":
        return fmt
    fmt = "coo"
    if (not cfg.reference_baseline
            and n_diagonals(seed) <= cfg.dia_max_diags
            and n_diagonals(a) <= cfg.dia_max_diags
            and _dia_phantom_slots(seed) == 0):
        fmt = "dia"
    if fmt == "coo" and seed.nnz >= cfg.rowblock_min_nnz:
        fmt = "rowblock"
    return fmt


def setup(cfg: TrainConfig):
    """Host-side setup.  Returns ``(a, seed, env, graph, mcfg, params)``:
    ``a`` and ``seed`` as host (numpy) COO matrices, the env, graph and
    parameters on the device ``cfg.platform`` selects."""
    device = device_of(cfg)
    dtype = np.dtype(cfg.dtype)
    a = load_matrix(cfg)
    a = COO(row=a.row, col=a.col, data=a.data.astype(dtype), shape=a.shape)
    seed = ilu.seed_pattern(a, method=cfg.seed_method, dtype=dtype,
                            **({"k": cfg.seed_k}
                               if cfg.seed_method == "spai" else {}))
    fmt = resolve_env_format(cfg, a, seed)
    if fmt in ("dia", "rowblock"):
        raise NotImplementedError(
            f"env_format={fmt!r} (from {cfg.env_format!r}) comes with the "
            "rowblock/DIA slice of the port; pass env_format='coo'")
    if fmt != "coo":
        raise ValueError(f"unknown env_format {cfg.env_format!r}")
    if cfg.sampler != "dense":
        raise NotImplementedError(
            f"sampler={cfg.sampler!r} comes with the multi-device slice")
    env = spai.make_env(seed, original=None if cfg.reference_baseline else a,
                        reward_path="pair", baseline=cfg.reward_baseline,
                        device=device)
    if seed.nnz >= cfg.gat_tiled_min_edges:
        graph = pol.tiled_graph_from_seed(
            seed, bucket_step=cfg.gat_bucket_step or None, device=device)
    else:
        graph = pol.graph_from_seed(seed, device=device)
    mcfg = gfn.GFlowNetConfig(
        hidden_dim=cfg.hidden_dim, heads=cfg.heads,
        num_actions=env.num_actions, loss=cfg.loss,
        temperature=cfg.temperature, alpha_fixed=cfg.alpha_fixed,
        subtb_lambda=cfg.subtb_lambda, backward=cfg.backward,
        reward_beta=cfg.reward_beta, terminal_bias=cfg.terminal_bias,
        edge_feats=cfg.edge_feats,
        t_cap=min(max(cfg.t_cap, 0), env.num_actions),
    )
    params = gfn.init_params(torch.Generator().manual_seed(cfg.prng_seed), mcfg,
                             dtype=getattr(torch, cfg.dtype), device=device)
    return a, seed, env, graph, mcfg, params
