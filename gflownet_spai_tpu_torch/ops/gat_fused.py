"""Fused GATv2 tile forward K1 and backward K2: score → segment softmax →
weighted segment sum in one launch per bucket (counterpart of
``gflownet_spai_tpu/ops/gat_fused.py``: ``gat_tile_fused_jnp`` :70, the
Pallas ``_fwd_kernel`` :167 / ``_run_fwd`` :269, its custom VJP :396-418
and ``gat_tile_fused`` :438).

Per tile::

    e       = attr ⊗ w_e                        (edge_dim = 1)
    msg     = xs_slot + xd[local_dst] + e
    act     = leaky_relu(msg)
    scores  = act @ blockdiag(att)              ([S, H])
    α       = segment softmax with a per-segment max shift (padding → 0)
    out     = Σ_{slots of v} xs_slot ⊙ α        ([TN, H·D])

The backward K2 (``_bwd_kernel`` :211 / ``_run_bwd`` :315 in JAX) recomputes
this per node and emits ∂xs, ∂xd, ∂att and ∂w_e.  CUDA tensors launch
``csrc/gat_fused.cu`` for both directions; CPU tensors take
``gat_tile_fused_ref`` and ``gat_tile_fused_bwd_ref``.

The kernels work node by node over each node's run of slots: the wrapper
derives once per layout where each run starts and, where a node's slots
are not adjacent, the slot order that makes them runs (``layout_runs``).
A node gets P channel lanes per head times Q slot lanes (``_lane_plan``);
``layout_runs`` lives in ``ops.segment``, whose K5 and K6 share it.
K2 sums its per-tile terms
in a fixed order inside the launch, so both kernels give the same bits on
every launch.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .segment import _RUNS, SegTiles, _mean_run, _pow2, layout_runs  # noqa: F401


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


def gat_tile_fused_bwd_ref(tiles: SegTiles, attr: torch.Tensor,
                           xs_slot: torch.Tensor, xd: torch.Tensor,
                           w_e: torch.Tensor, att: torch.Tensor,
                           g: torch.Tensor, negative_slope: float = 0.2):
    """Plain version of K2: the VJP of ``gat_tile_fused_ref`` at cotangent
    ``g`` [n_pad, H·D], by autograd.  Returns ``(dxs, dxd, dw_e, datt)``
    shaped as ``(xs_slot, xd, w_e, att)``; uniform rows get their sums."""
    with torch.enable_grad():
        ins = [x.detach().requires_grad_(True) for x in (xs_slot, xd, w_e, att)]
        out = gat_tile_fused_ref(tiles, attr.detach(), *ins, negative_slope)
        return torch.autograd.grad(out, ins, g)


_FWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10
                 + [ctypes.c_float, ctypes.c_void_p])
_MAX_HEADS = 8          # kMaxHeads in csrc/gat_fused.cu
_MAX_CHANNELS = 8       # kMaxC: channels of one head per lane
_THREADS = 128          # kThreads: lanes per block


def _lib_fn(name: str, argtypes):
    fn = getattr(_build.load("gat_fused"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _lane_plan(H: int, D: int, mean_run: float = 1.0,
               max_lanes: float | None = None) -> tuple[int, int, int]:
    """Channel lanes per head P (the fewest, a power of two, that hold D
    channels at ≤ 8 a lane), slot lanes Q (a power of two at or above the
    mean run / 2.4, so a lane walks two or three slots; the constant is
    from the card's timings of each plan, ``chip_smoke.py``'s
    ``[K1-plans]`` / ``[K2-plans]``) and lanes per node G (H·P·Q rounded
    up to a power of two).  Q shrinks while G passes a warp or
    ``max_lanes`` (lanes per node that fit one wave of the card).  Raises
    where even Q = 1 passes a warp."""
    P = 1
    while -(-D // P) > _MAX_CHANNELS:
        P *= 2
    if H < 1 or H > _MAX_HEADS or D < 1 or _pow2(H * P) > 32:
        raise ValueError(f"gat_tile_fused: H={H}, D={D} exceed the kernel's limits "
                         f"(1 ≤ H ≤ 8, ⌈D/8⌉ rounded up to a power of two times "
                         f"H at most 32)")
    Q = _pow2(-(-mean_run // 2.4))
    while Q > 1 and (_pow2(H * P * Q) > 32
                     or max_lanes is not None and _pow2(H * P * Q) > max_lanes):
        Q //= 2
    return P, Q, _pow2(H * P * Q)


_SMS: dict = {}
_WAVE_WARPS = 16        # warps per SM a bucket's lanes may fill before Q shrinks


def _sms(dev) -> int:
    if dev not in _SMS:
        _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _SMS[dev]


def _check_cuda_args(what: str, tiles: SegTiles, attr, xs_slot, xd, w_e, att):
    """Device, shape, dtype and limit checks shared by K1 and K2; returns
    the lane plan (P, Q, G) for the layout."""
    args = (attr, xs_slot, xd, w_e, att)
    dev = attr.device
    if dev.type != "cuda" or any(a.device != dev for a in args) \
            or tiles.local_dst.device != dev:
        raise ValueError(f"{what}: all tensors must be on one CUDA device")
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
            f"{what}: shapes do not match the tile layout (T={T}, "
            f"S={S}, TN={TN}, H={H}, D={D}): local_dst "
            f"{tuple(tiles.local_dst.shape)} {tiles.local_dst.dtype}, attr "
            f"{tuple(attr.shape)}, xs {tuple(xs_slot.shape)}, xd "
            f"{tuple(xd.shape)}, w_e {tuple(w_e.shape)}")
    if any(a.dtype != torch.float32 or not a.is_contiguous() for a in args) \
            or not tiles.local_dst.is_contiguous():
        raise ValueError(f"{what}: inputs must be contiguous float32")
    return _lane_plan(H, D, _mean_run(tiles),
                      _sms(dev) * _WAVE_WARPS * 32 / max(T * TN, 1))


def _vec(D: int, P: int, *tensors) -> int:
    """16-byte loads and stores: a lane's channels come in fours and every
    row starts on 16 bytes."""
    return int(D % 4 == 0 and -(-D // P) % 4 == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _fwd(tiles: SegTiles, attr, xs_slot, xd, w_e, att, negative_slope):
    """K1 on CUDA tensors, its plain version on CPU tensors."""
    if all(a.device.type == "cpu" for a in (attr, xs_slot, xd, w_e, att)):
        return gat_tile_fused_ref(tiles, attr, xs_slot, xd, w_e, att,
                                  negative_slope)
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    H, D = att.shape
    HD = H * D
    P, Q, G = _check_cuda_args("gat_tile_fused", tiles, attr, xs_slot, xd, w_e, att)
    starts, order = layout_runs(tiles)
    out = torch.empty((T * TN, HD), dtype=attr.dtype, device=attr.device)
    stream = torch.cuda.current_stream(attr.device).cuda_stream
    _build.check(_lib_fn("gat_tile_fused_fwd", _FWD_ARGTYPES)(
        starts.data_ptr(), None if order is None else order.data_ptr(),
        attr.data_ptr(), xs_slot.data_ptr(), xd.data_ptr(), w_e.data_ptr(),
        att.data_ptr(), out.data_ptr(), T, S, TN, H, D, P, Q,
        int(xs_slot.shape[0] == 1), int(xd.shape[0] == 1),
        _vec(D, P, xs_slot, xd, w_e, att, out),
        float(negative_slope), stream), "gat_tile_fused")
    gat_tile_fused.launches += 1
    return out


def gat_tile_fused_bwd(tiles: SegTiles, attr: torch.Tensor,
                       xs_slot: torch.Tensor, xd: torch.Tensor,
                       w_e: torch.Tensor, att: torch.Tensor, g: torch.Tensor,
                       negative_slope: float = 0.2):
    """K2: the VJP of ``gat_tile_fused`` at cotangent ``g`` [n_pad, H·D],
    recomputing the forward.  Returns ``(dxs, dxd, dw_e, datt)`` shaped as
    ``(xs_slot, xd, w_e, att)``.  CUDA tensors launch ``csrc/gat_fused.cu``
    (the per-tile sums, which ``_run_bwd`` sums outside its kernel in JAX,
    are summed in a fixed order by a second kernel launched with it);
    CPU tensors take ``gat_tile_fused_bwd_ref``."""
    if all(a.device.type == "cpu" for a in (attr, xs_slot, xd, w_e, att, g)):
        return gat_tile_fused_bwd_ref(tiles, attr, xs_slot, xd, w_e, att, g,
                                      negative_slope)
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    H, D = att.shape
    HD = H * D
    xs_uni, xd_uni = xs_slot.shape[0] == 1, xd.shape[0] == 1
    P, Q, G = _check_cuda_args("gat_tile_fused_bwd", tiles, attr, xs_slot, xd, w_e, att)
    if g.shape != (T * TN, HD) or g.dtype != torch.float32 \
            or g.device != attr.device or not g.is_contiguous():
        raise ValueError(f"gat_tile_fused_bwd: g must be a contiguous float32 "
                         f"[{T * TN}, {HD}] tensor on {attr.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    starts, order = layout_runs(tiles)
    new = lambda *shape: torch.empty(shape, dtype=g.dtype, device=g.device)
    dxs = new(1, HD) if xs_uni else new(T * S, HD)
    dxd = new(1, HD) if xd_uni else new(T * TN, HD)
    datt, dwe = new(HD), new(HD)
    if T * TN == 0:
        return (dxs.zero_(), dxd.zero_(), dwe.zero_(), datt.zero_().reshape(H, D))
    sums = 2 + xs_uni + xd_uni        # datt, dwe, and the uniform rows' dxs, dxd
    part = new(T * -(-TN // (_THREADS // G)), -(-sums * HD // 4) * 4)   # a row a block
    stream = torch.cuda.current_stream(g.device).cuda_stream
    _build.check(_lib_fn("gat_tile_fused_bwd", _BWD_ARGTYPES)(
        starts.data_ptr(), None if order is None else order.data_ptr(),
        attr.data_ptr(), xs_slot.data_ptr(), xd.data_ptr(), w_e.data_ptr(),
        att.data_ptr(), g.data_ptr(), dxs.data_ptr(), dxd.data_ptr(),
        datt.data_ptr(), dwe.data_ptr(), part.data_ptr(), T, S, TN, H, D, P, Q,
        int(xs_uni), int(xd_uni), _vec(D, P, xs_slot, xd, w_e, att, g, dxs, dxd),
        float(negative_slope), stream), "gat_tile_fused_bwd")
    gat_tile_fused_bwd.launches += 1
    return dxs, dxd, dwe, datt.reshape(H, D)


class _GatTileFused(torch.autograd.Function):
    """K1 forward, K2 backward (``_gat_fused_p`` and its custom VJP in
    JAX).  ``attr`` is static graph data and gets no gradient."""

    @staticmethod
    def forward(ctx, tiles, negative_slope, attr, xs_slot, xd, w_e, att):
        ctx.tiles, ctx.slope = tiles, negative_slope
        ctx.save_for_backward(attr, xs_slot, xd, w_e, att)
        return _fwd(tiles, attr, xs_slot, xd, w_e, att, negative_slope)

    @staticmethod
    def backward(ctx, g):
        dxs, dxd, dwe, datt = gat_tile_fused_bwd(
            ctx.tiles, *ctx.saved_tensors, g.contiguous(), ctx.slope)
        return None, None, None, dxs, dxd, dwe, datt


def gat_tile_fused(tiles: SegTiles, attr: torch.Tensor, xs_slot: torch.Tensor,
                   xd: torch.Tensor, w_e: torch.Tensor, att: torch.Tensor,
                   negative_slope: float = 0.2) -> torch.Tensor:
    """One-launch fused GATv2 step over a tile layout (see the module
    docstring).

    ``attr``: [T·S] edge scalars in slot order; ``xs_slot``: [T·S, H·D]
    source slot features or [1, H·D] uniform; ``xd``: [n_pad, H·D] target
    node features or [1, H·D] uniform; ``w_e``: [H·D]; ``att``: [H, D].
    Returns [n_pad, H·D] aggregated node features (no bias).
    Differentiable in (xs_slot, xd, w_e, att): K1 forward and K2 backward
    on CUDA tensors, their plain versions on CPU tensors."""
    return _GatTileFused.apply(tiles, float(negative_slope), attr, xs_slot,
                               xd, w_e, att)


gat_tile_fused.launches = 0
gat_tile_fused_bwd.launches = 0
