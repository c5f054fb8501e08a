"""Distributed Krylov and Jacobi solvers over a row-partitioned DIA matrix
(counterpart of ``gflownet_spai_tpu/parallel/solvers.py``).

The operator is the halo-exchange SpMV (``halo_spmv``, neighbour exchange
only) or, where the band exceeds a shard, the all-gather SpMV; the port's
single-device ``solvers.gmres`` / ``solvers.cg`` run unchanged on each
rank's shard with an inner product summed over ``rows`` (JAX gets the same
from GSPMD's propagation).  Every scalar a stopping test or a Givens
rotation reads is all-reduced, so every rank takes the same decisions.
Every rank passes the whole matrix and right-hand side; the solution comes
back whole ([n]) on every rank.
"""

from __future__ import annotations

from functools import partial

import torch

from ..ops.dia import DIA
from ..solvers.cg import CGResult, cg
from ..solvers.gmres import GMRESResult, gmres
from .halo_spmv import (_halo, extended_power, halo_spmv, partition_dia,
                        spmv_allgather)
from .mesh import Mesh, all_gather, neighbour_exchange, psum


def _shard(mesh: Mesh, v: torch.Tensor, n_pad: int, axis: str) -> torch.Tensor:
    """This rank's block of ``v`` zero-padded to [n_pad]."""
    R, i = mesh.size(axis), mesh.index(axis)
    n_local = n_pad // R
    vp = torch.nn.functional.pad(v, (0, n_pad - v.shape[0]))
    return vp[i * n_local:(i + 1) * n_local].contiguous()


def _dot(mesh: Mesh, axis: str):
    """The inner product over every rank's shard (None on one rank: the
    solvers' local default, so a one-rank mesh gives the single-device
    numbers)."""
    if mesh.size(axis) == 1:
        return None
    return lambda a, b: psum(mesh, torch.matmul(a, b), axis)


def _prepare(mesh: Mesh, d: DIA, b: torch.Tensor, axis: str):
    d = partition_dia(d, mesh.size(axis))
    bp = _shard(mesh, b.to(d.data.dtype), d.n_pad, axis)
    # the neighbour exchange needs halo ≤ shard; small / wide-band matrices
    # take the all-gather operator (correct for any bandwidth)
    op = halo_spmv if _halo(d) <= d.n_pad // mesh.size(axis) else spmv_allgather
    return d, bp, partial(op, mesh, d, axis=axis)


def _whole(mesh: Mesh, x: torch.Tensor, n: int, axis: str) -> torch.Tensor:
    return all_gather(mesh, x, axis, tiled=True)[:n]


def distributed_gmres(mesh: Mesh, d: DIA, b: torch.Tensor, axis: str = "rows",
                      restart: int = 30, maxiter: int = 1000,
                      rtol: float = 1e-5) -> GMRESResult:
    """Solve A x = b with A row-partitioned over ``mesh[axis]``.  ``b``:
    unpadded [n]; the returned ``x`` is [n] on every rank."""
    n = b.shape[0]
    d, bp, op = _prepare(mesh, d, b, axis)
    res = gmres(op, bp, restart=restart, maxiter=maxiter, rtol=rtol,
                dot=_dot(mesh, axis))
    return res._replace(x=_whole(mesh, res.x, n, axis))


def distributed_cg(mesh: Mesh, d: DIA, b: torch.Tensor, axis: str = "rows",
                   maxiter: int = 1000, rtol: float = 1e-5) -> CGResult:
    n = b.shape[0]
    d, bp, op = _prepare(mesh, d, b, axis)
    res = cg(op, bp, maxiter=maxiter, rtol=rtol, dot=_dot(mesh, axis))
    return res._replace(x=_whole(mesh, res.x, n, axis))


def distributed_jacobi(mesh: Mesh, d: DIA, b: torch.Tensor, axis: str = "rows",
                       omega: float = 2.0 / 3.0, iters: int = 100, k: int = 4):
    """Communication-avoiding weighted Jacobi over a row-partitioned DIA
    matrix: ONE k·halo neighbour exchange of x per k sweeps (the diagonal
    rows' and the constant's exchanges happen once), the k sweeps fused
    on K12 with ``add`` = the constant on each rank's extended shard.  k
    halves until k·halo fits a shard.  ``iters`` rounds up to a multiple
    of k.  Returns (x [n] on every rank, ‖b − A·x‖₂ by the halo SpMV)."""
    from ..solvers.stationary import jacobi_constant, jacobi_iteration_matrix

    n = b.shape[0]
    R, i = mesh.size(axis), mesh.index(axis)
    m = partition_dia(jacobi_iteration_matrix(d, omega), R)
    d_part = partition_dia(d, R)
    c_loc = _shard(mesh, jacobi_constant(d, b, omega), m.n_pad, axis)
    b_loc = _shard(mesh, b.to(m.data.dtype), m.n_pad, axis)
    n_local = m.n_pad // R
    h = _halo(m)
    while k > 1 and k * h > n_local:
        k //= 2
    kh = k * h
    if kh > n_local:
        raise ValueError(
            f"halo {h} exceeds shard size {n_local} even at k=1 — use fewer "
            "shards or the allgather operator (spmv_allgather)")
    rounds = max(1, -(-iters // k))
    left, right = neighbour_exchange(mesh, c_loc[n_local - kh:], c_loc[:kh], axis)
    c_ext = torch.cat([left, c_loc, right])
    x = torch.zeros_like(c_loc)
    for _ in range(rounds):
        x = extended_power(mesh, m, x, k, kh, add_ext=c_ext, axis=axis)
    r = b_loc - halo_spmv(mesh, d_part, x, axis=axis)
    rows = i * n_local + torch.arange(n_local, device=r.device)
    r = torch.where(rows < n, r, 0.0)
    rnorm = torch.sqrt(psum(mesh, torch.dot(r, r), axis))
    return _whole(mesh, x, n, axis), rnorm
