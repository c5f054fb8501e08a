"""Fused GATv2 tile forward K1: score → segment softmax → weighted segment
sum in one launch, one block per node tile (counterpart of
``gflownet_spai_tpu/ops/gat_fused.py``: ``gat_tile_fused_jnp`` :70 and the
Pallas ``_fwd_kernel`` :167 / ``_run_fwd`` :269 / ``gat_tile_fused`` :438).

Per tile::

    e       = attr ⊗ w_e                        (edge_dim = 1)
    msg     = xs_slot + xd[local_dst] + e
    act     = leaky_relu(msg)
    scores  = act @ blockdiag(att)              ([S, H])
    α       = segment softmax with a per-segment max shift (padding → 0)
    out     = Σ_{slots of v} xs_slot ⊙ α        ([TN, H·D])

CUDA tensors launch ``csrc/gat_fused.cu``; CPU tensors take
``gat_tile_fused_ref``.  Forward only: the backward kernel K2 comes with
the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .segment import SegTiles


def _blockdiag_att(att: torch.Tensor) -> torch.Tensor:
    """[H, D] attention vectors → [H·D, H] block-diagonal score matrix."""
    H, D = att.shape
    eye = torch.eye(H, dtype=att.dtype, device=att.device)
    return (att[:, :, None] * eye[:, None, :]).reshape(H * D, H)


def _expand_mat(heads: int, out_dim: int, dtype, device) -> torch.Tensor:
    """[H, H·D] 0/1 matrix broadcasting per-head α to its channels."""
    eye = torch.eye(heads, dtype=dtype, device=device)
    return torch.repeat_interleave(eye, out_dim, dim=1)


def gat_tile_fused_ref(tiles: SegTiles, attr: torch.Tensor, xs_slot: torch.Tensor,
                       xd: torch.Tensor, w_e: torch.Tensor, att: torch.Tensor,
                       negative_slope: float = 0.2) -> torch.Tensor:
    """Plain version of K1 ([T·S]-flat slot inputs → [n_pad, H·D]).
    ``xs_slot``: [T·S, HD] or [1, HD] (uniform); ``xd``: [n_pad, HD] or
    [1, HD]; ``attr``: [T·S]; ``w_e``: [HD]; ``att``: [H, D]."""
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    H, D = att.shape
    HD = H * D
    dev = attr.device
    oh = (torch.arange(TN, device=dev)[None, :, None]
          == tiles.local_dst.long()[:, None, :])            # [T, TN, S]
    ohf = oh.to(attr.dtype)
    e = attr[:, None] * w_e[None, :]                        # [T·S, HD]
    if xd.shape[0] == 1:
        xd_slot = xd.expand(T * S, HD)
    else:
        xd_slot = torch.einsum("tvs,tvc->tsc", ohf,
                               xd.reshape(T, TN, HD)).reshape(T * S, HD)
    msg = xs_slot + xd_slot + e
    act = torch.nn.functional.leaky_relu(msg, negative_slope)
    sc_t = (act @ _blockdiag_att(att)).reshape(T, S, H)
    # per-segment stability shift; padding slots shift by their own score
    masked = torch.where(oh[..., None], sc_t[:, None, :, :],
                         torch.tensor(-1e30, dtype=sc_t.dtype, device=dev))
    segmax = masked.amax(dim=2)                             # [T, TN, H]
    colsum = ohf.sum(dim=1)                                 # [T, S]
    shift = (torch.einsum("tvs,tvh->tsh", ohf, segmax)
             + (1.0 - colsum)[..., None] * sc_t)
    ex = torch.exp(sc_t - shift)
    den = torch.einsum("tvs,tsh->tvh", ohf, ex)
    den_s = torch.einsum("tvs,tvh->tsh", ohf, den)
    alpha = torch.where(den_s > 0, ex / torch.where(den_s > 0, den_s, 1.0), 0.0)
    al_hd = alpha.reshape(T * S, H) @ _expand_mat(H, D, attr.dtype, dev)
    wgt = (xs_slot * al_hd).reshape(T, S, HD)
    return torch.einsum("tvs,tsc->tvc", ohf, wgt).reshape(T * TN, HD)


_FWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_void_p])
_MAX_HEADS = 8          # kMaxHeads in csrc/gat_fused.cu
_MAX_SMEM = 48 * 1024   # static launch limit without the opt-in attribute


def _fwd_lib():
    fn = _build.load("gat_fused").gat_tile_fused_fwd
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    return fn


def gat_tile_fused(tiles: SegTiles, attr: torch.Tensor, xs_slot: torch.Tensor,
                   xd: torch.Tensor, w_e: torch.Tensor, att: torch.Tensor,
                   negative_slope: float = 0.2) -> torch.Tensor:
    """One-launch-per-tile fused GATv2 step (see the module docstring).

    ``attr``: [T·S] edge scalars in slot order; ``xs_slot``: [T·S, H·D]
    source slot features or [1, H·D] uniform; ``xd``: [n_pad, H·D] target
    node features or [1, H·D] uniform; ``w_e``: [H·D]; ``att``: [H, D].
    Returns [n_pad, H·D] aggregated node features (no bias)."""
    args = (attr, xs_slot, xd, w_e, att)
    if all(a.device.type == "cpu" for a in args):
        return gat_tile_fused_ref(tiles, attr, xs_slot, xd, w_e, att,
                                  negative_slope)
    dev = attr.device
    if dev.type != "cuda" or any(a.device != dev for a in args) \
            or tiles.local_dst.device != dev:
        raise ValueError("gat_tile_fused: all tensors must be on one CUDA device")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        raise NotImplementedError(
            "gat_tile_fused on CUDA is forward only: K2 (the fused backward "
            "kernel) lands with the training slice")
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    H, D = att.shape
    HD = H * D
    shapes_ok = (
        tiles.local_dst.shape == (T, S) and tiles.local_dst.dtype == torch.int32
        and attr.shape == (T * S,)
        and xs_slot.shape in ((1, HD), (T * S, HD))
        and xd.shape in ((1, HD), (T * TN, HD))
        and w_e.shape == (HD,))
    if not shapes_ok:
        raise ValueError(
            f"gat_tile_fused: shapes do not match the tile layout (T={T}, "
            f"S={S}, TN={TN}, H={H}, D={D}): local_dst "
            f"{tuple(tiles.local_dst.shape)} {tiles.local_dst.dtype}, attr "
            f"{tuple(attr.shape)}, xs {tuple(xs_slot.shape)}, xd "
            f"{tuple(xd.shape)}, w_e {tuple(w_e.shape)}")
    if any(a.dtype != torch.float32 or not a.is_contiguous() for a in args) \
            or not tiles.local_dst.is_contiguous():
        raise ValueError("gat_tile_fused: inputs must be contiguous float32")
    smem = 4 * (2 * TN * H + TN * HD + 2 * HD)
    if H > _MAX_HEADS or smem > _MAX_SMEM or T * S * HD >= 2**31:
        raise ValueError(f"gat_tile_fused: H={H}, TN·H·D={TN * HD} exceed the "
                         "kernel's limits (H ≤ 8, 48 KB of shared memory)")
    out = torch.empty((T * TN, HD), dtype=attr.dtype, device=dev)
    fn = _fwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(fn(tiles.local_dst.data_ptr(), attr.data_ptr(),
                    xs_slot.data_ptr(), xd.data_ptr(), w_e.data_ptr(),
                    att.data_ptr(), out.data_ptr(), T, S, TN, H, D,
                    int(xs_slot.shape[0] == 1), int(xd.shape[0] == 1),
                    float(negative_slope), stream),
                 "gat_tile_fused")
    gat_tile_fused.launches += 1
    return out


gat_tile_fused.launches = 0
