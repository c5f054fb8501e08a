"""Row-partitioned DIA SpMV with neighbour halo exchange (counterpart of
``gflownet_spai_tpu/parallel/halo_spmv.py``).

A is row-partitioned over the ``rows`` axis in DIA form: every rank passes
the whole (``partition_dia``-padded) matrix and its own x shard
[n_pad / R], and gets its own y shard.  A banded matrix needs only the
``halo`` boundary entries of each neighbour's x shard, so the exchange is
one ``batch_isend_irecv`` with the two neighbours (``mesh.neighbour_exchange``);
then K8 (``ops.dia.spmv_dia_padded``) runs on the halo-extended shard.
Edge ranks receive zeros, the out-of-range semantics the DIA kernel
already assumes.  ``halo_spmv_power`` exchanges k·halo entries of x and of
the diagonal rows once and runs K12's k passes on the extended shard
(communication-avoiding temporal blocking).

Each rank's row block is a DIA of its own, made once per (matrix, mesh
position) and kept with the matrix: its K8 path and K12 mode are picked
from the global matrix's segment share and the common shard size, so
every rank takes the same path (lockstep).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.dia import (DIA, _ALIGN, _round_up, dia_pad_pp, dia_pp_tile,
                       spmv_dia_padded, spmv_dia_power)
from .mesh import Mesh, all_gather, neighbour_exchange

_LOCAL = WeakIdKeyDictionary()   # d.data → {key: local DIA}


def partition_dia(d: DIA, n_shards: int) -> DIA:
    """Re-pad a DIA matrix so its rows split evenly over ``n_shards``
    (host-side): ``data``'s second dim becomes ``n_shards · n_local``,
    n_local a multiple of 1,024."""
    n_local = _round_up(-(-d.n_pad // n_shards), _ALIGN)
    total = n_local * n_shards
    if total != d.n_pad:
        d = dataclasses.replace(d, data=torch.nn.functional.pad(
            d.data, (0, total - d.n_pad)))
    return d


def _halo(d: DIA) -> int:
    return _round_up(max(max((abs(o) for o in d.offsets), default=1), 1), _ALIGN)


def _cached(d: DIA, key, make):
    per = _LOCAL.setdefault(d.data, {})
    if key not in per:
        per[key] = make()
    return per[key]


def _block(d: DIA, data: torch.Tensor, n: int, shards: int) -> DIA:
    return DIA(data=data.contiguous(), offsets=d.offsets, shape=(n, n),
               nnz=d.nnz // shards, seg_share=d.seg_share)


def _local_dia(mesh: Mesh, d: DIA, axis: str = "rows") -> DIA:
    """This rank's row block of the partitioned ``d`` as an [n_local,
    n_local] DIA (cached with ``d``)."""
    R, i = mesh.size(axis), mesh.index(axis)
    n_local = d.n_pad // R
    return _cached(d, ("block", R, i), lambda: _block(
        d, d.data[:, i * n_local:(i + 1) * n_local], n_local, R))


def halo_spmv(mesh: Mesh, d: DIA, x: torch.Tensor, axis: str = "rows") -> torch.Tensor:
    """This rank's shard of y = A·x, A row-partitioned over ``mesh[axis]``.
    ``d`` must be pre-partitioned (``partition_dia``); ``x``: the rank's
    [n_pad / R] shard."""
    n_local = d.n_pad // mesh.size(axis)
    halo = _halo(d)
    if halo > n_local:
        raise ValueError(f"halo {halo} exceeds shard size {n_local}")
    from_left, from_right = neighbour_exchange(mesh, x[n_local - halo:], x[:halo], axis)
    xp = torch.cat([from_left, x, from_right])
    return spmv_dia_padded(_local_dia(mesh, d, axis), xp)


def _extended(mesh: Mesh, d: DIA, kh: int, axis: str) -> DIA:
    """The rank's row block widened by kh neighbour rows of the diagonals
    on each side (zeros past the matrix edges), exchanged once per (matrix,
    k·halo) and kept with the matrix."""
    R, i = mesh.size(axis), mesh.index(axis)

    def make():
        n_local = d.n_pad // R
        dl = d.data[:, i * n_local:(i + 1) * n_local].contiguous()
        left, right = neighbour_exchange(mesh, dl[:, n_local - kh:].contiguous(),
                                         dl[:, :kh].contiguous(), axis)
        return _block(d, torch.cat([left, dl, right], dim=1), n_local + 2 * kh, R)

    return _cached(d, ("ext", R, i, kh), make)


def extended_power(mesh: Mesh, d: DIA, x: torch.Tensor, k: int, kh: int,
                   scale: float = 1.0, add_ext: torch.Tensor | None = None,
                   axis: str = "rows") -> torch.Tensor:
    """K12 on the k·halo-extended shard: one exchange of x's kh boundary
    entries, k fused passes (``add_ext``: the affine term over the extended
    rows, [n_local + 2·kh]), the centre rows kept."""
    n_local = d.n_pad // mesh.size(axis)
    d_ext = _extended(mesh, d, kh, axis)
    from_left, from_right = neighbour_exchange(mesh, x[n_local - kh:], x[:kh], axis)
    tr = dia_pp_tile(d_ext) or d_ext.halo
    xq = dia_pad_pp(d_ext, torch.cat([from_left, x, from_right]), tr=tr)
    add_q = None if add_ext is None else dia_pad_pp(d_ext, add_ext, tr=tr)
    zq = spmv_dia_power(d_ext, None, xq, torch.zeros_like(xq), scale=scale, k=k,
                        add=add_q)
    # the centre rows only: the extension's edge rows lack their halo context
    return zq[tr + kh:tr + kh + n_local]


def halo_spmv_power(mesh: Mesh, d: DIA, x: torch.Tensor, k: int = 4,
                    scale: float = 1.0, axis: str = "rows") -> torch.Tensor:
    """This rank's shard of z = (scale·A)ᵏ·x, A row-partitioned: ONE
    exchange of k·halo boundary entries (x, and the diagonal rows once per
    matrix) per k dependent applies, then K12's k fused passes on the
    extended shard."""
    n_local = d.n_pad // mesh.size(axis)
    kh = k * _halo(d)
    if kh > n_local:
        raise ValueError(f"k·halo {kh} exceeds shard size {n_local}")
    return extended_power(mesh, d, x, k, kh, scale=scale, axis=axis)


def spmv_allgather(mesh: Mesh, d: DIA, x: torch.Tensor, axis: str = "rows") -> torch.Tensor:
    """Baseline distributed SpMV: all-gather x, then the rank's rows —
    correct for any bandwidth, O(n) traffic.  The oracle for ``halo_spmv``
    and the operator for matrices whose band exceeds a shard."""
    R, i = mesh.size(axis), mesh.index(axis)
    n_local = d.n_pad // R
    h = _halo(d)
    xg = torch.nn.functional.pad(all_gather(mesh, x, axis, tiled=True), (h, h))
    window = xg[i * n_local:i * n_local + n_local + 2 * h]
    return spmv_dia_padded(_local_dia(mesh, d, axis), window)
