"""Edge-enumeration versioning for checkpoints (counterpart of
``gflownet_spai_tpu/train/enums.py``).

Action ``j`` deletes edge ``j`` of the enumeration the env was built with,
so a checkpoint is only meaningful under the same enumeration.  Two env
backends define their own order: a window-order row-block plan permutes
the seed so each reward bucket's windows are contiguous slices
(``sparse.rowblock``), and the DIA env enumerates edges diagonal-major
(``env.spai_dia.edge_coo``); every other env keeps the sorted seed.  Every
checkpoint stamps it (``checkpoint/enum.json`` + the canonical
permutation as ``enum_perm.npy``, the same files, byte for byte, as the
JAX package writes); a restore verifies it, remaps the id-indexed
parameters across orders (exact for the ``linear`` / ``uniform`` backward
policies), or refuses (the ``lstm`` backward reads raw ids as inputs).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..sparse.types import to_numpy

ENUM_VERSION = 1


def _hash_edges(row: np.ndarray, col: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(row, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(col, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def _canonical_perm(row: np.ndarray, col: np.ndarray) -> np.ndarray:
    """perm such that (row, col)[perm] is row-major sorted."""
    return np.lexsort((col, row))


def enumeration_meta(env) -> dict:
    """Enumeration descriptor of a live env (``SpaiEnv`` or ``SpaiDiaEnv``):
    ``enum_hash`` fingerprints the order-sensitive enumeration,
    ``canonical_hash`` the edge set; ``to_canonical`` is the permutation p
    with ``edges[p]`` canonical."""
    from ..env import spai_dia

    if isinstance(env, spai_dia.SpaiDiaEnv):
        edges, order = spai_dia.edge_coo(env), "dia"
    else:
        edges = env.seed
        order = ("window" if env.rb is not None and env.rb.edge_perm is not None
                 else "sorted")
    row, col = to_numpy(edges.row), to_numpy(edges.col)
    p = _canonical_perm(row, col)
    return {
        "enum_version": ENUM_VERSION,
        "order": order,
        "num_edges": int(row.shape[0]),
        "enum_hash": _hash_edges(row, col),
        "canonical_hash": _hash_edges(row[p], col[p]),
        "to_canonical": p,
    }


def save_enum_meta(out_dir: str, env) -> None:
    base = Path(out_dir).absolute() / "checkpoint"
    base.mkdir(parents=True, exist_ok=True)
    meta = enumeration_meta(env)
    np.save(base / "enum_perm.npy", meta.pop("to_canonical"))
    (base / "enum.json").write_text(json.dumps(meta, indent=2))


def load_enum_meta(run_dir: str) -> Optional[dict]:
    base = Path(run_dir).absolute() / "checkpoint"
    f = base / "enum.json"
    if not f.exists():
        return None
    meta = json.loads(f.read_text())
    perm = base / "enum_perm.npy"
    meta["to_canonical"] = np.load(perm) if perm.exists() else None
    return meta


def _permute_head(arr: torch.Tensor, o_idx: np.ndarray, axis: int) -> torch.Tensor:
    """Permute the first ``len(o_idx)`` slots of an id-indexed axis (the
    terminal slot and any padding stay): ``new[j] = old[o_idx[j]]``."""
    idx = np.arange(arr.shape[axis])
    idx[:o_idx.shape[0]] = o_idx
    return torch.index_select(arr, axis, torch.as_tensor(idx, device=arr.device))


def remap_params(params, o_idx: np.ndarray, backward: str):
    """params with every action-id-indexed slice permuted so that new
    action ``j`` reads old action ``o_idx[j]``'s weights.  Exact for
    ``linear`` and ``uniform``; raises for ``lstm``."""
    if backward == "lstm":
        raise ValueError(
            "cannot remap an LSTM-backward checkpoint across edge "
            "enumerations: the reference-parity LSTM consumes raw action "
            "ids as numeric inputs (models/policies.py "
            "backward_policy_batch).  Re-validate with the enumeration "
            "the run was trained with.")
    fwd = params.forward._replace(
        fc_w=_permute_head(params.forward.fc_w, o_idx, axis=1),
        fc_b=_permute_head(params.forward.fc_b, o_idx, axis=0))
    bwd = params.backward
    if backward == "linear" and bwd is not None:
        bwd = bwd._replace(emb_g=_permute_head(bwd.emb_g, o_idx, axis=0),
                           emb_v=_permute_head(bwd.emb_v, o_idx, axis=0))
    flow = params.flow
    if flow is not None:
        flow = flow._replace(edge_d=_permute_head(flow.edge_d, o_idx, axis=0))
    return params._replace(forward=fwd, backward=bwd, flow=flow)


def remap_actions(actions: torch.Tensor, o_idx: np.ndarray,
                  num_edges: int) -> torch.Tensor:
    """Remap a −1-padded action tensor (terminal id = num_edges) from the
    old enumeration to the new one: ``new_id = inv(o_idx)[old_id]``."""
    lut = np.empty(num_edges + 1, np.int64)
    lut[o_idx] = np.arange(num_edges)
    lut[num_edges] = num_edges
    lut = torch.as_tensor(lut, device=actions.device)
    valid = actions >= 0
    return torch.where(valid, lut[torch.where(valid, actions, 0).long()]
                       .to(actions.dtype), actions)


def reconcile(run_dir: str, env, state, backward: str, opt=None,
              strict_missing: bool = False):
    """Verify (or repair) a restored TrainState against the current env's
    enumeration; returns (state, remapped).  Same enumeration → no-op;
    same edge set in another order → permute the id-indexed params and the
    replay actions (and re-initialise the optimizer state when ``opt`` is
    given); another edge set, or an ``lstm`` backward → SystemExit; no
    stamp → warn unless ``strict_missing``."""
    cur = enumeration_meta(env)
    saved = load_enum_meta(run_dir)
    if saved is None:
        import warnings

        msg = (f"checkpoint {run_dir} has no enumeration stamp "
               "(pre-versioning run): ensure the env format matches the "
               "training run")
        if strict_missing:
            raise SystemExit(msg)
        warnings.warn(msg, stacklevel=2)
        return state, False
    if saved["enum_hash"] == cur["enum_hash"]:
        return state, False
    if saved["canonical_hash"] != cur["canonical_hash"]:
        raise SystemExit(
            f"checkpoint {run_dir} was trained on a DIFFERENT edge set "
            f"(saved canonical {saved['canonical_hash']}, current "
            f"{cur['canonical_hash']}): matrix / seed-method / "
            "build params do not match the training run.")
    if saved.get("to_canonical") is None:
        raise SystemExit(
            f"checkpoint {run_dir}: enumeration order differs "
            f"({saved['order']} → {cur['order']}) and enum_perm.npy is "
            "missing — cannot remap.")
    # canonical edge k == old edge saved_p[k] == new edge cur_p[k]
    saved_p = np.asarray(saved["to_canonical"])
    cur_p = np.asarray(cur["to_canonical"])
    o_idx = np.empty_like(saved_p)
    o_idx[cur_p] = saved_p
    new_params = remap_params(state.params, o_idx, backward)
    new_replay = state.replay
    if new_replay is not None:
        new_replay = new_replay._replace(actions=remap_actions(
            new_replay.actions, o_idx, cur["num_edges"]))
    opt_state = state.opt_state
    if opt is not None:
        from .loop import tree_leaves

        opt_state = opt.init(x for _, x in tree_leaves(new_params))
    print(f"enumeration remap: checkpoint order {saved['order']!r} → "
          f"current {cur['order']!r} ({cur['num_edges']} actions); "
          "optimizer state re-initialized")
    return state._replace(params=new_params, replay=new_replay,
                          opt_state=opt_state), True
