"""The (dp, rows) device mesh and its collectives (counterpart of
``gflownet_spai_tpu/parallel/mesh.py``).

The framework's two mesh axes:

* ``dp``   — data parallel: trajectory batch split, policy replicated,
             gradients averaged;
* ``rows`` — the sequence-parallel analogue for sparse linear algebra:
             matrix rows, SpGEMM pair sets, action-head columns and graph
             tiles partitioned, halo exchange between neighbours,
             reductions by all-reduce.

JAX drives every device from one controller; the port runs one process per
device, and every function of ``parallel/`` runs on each rank over that
rank's shard, with collectives on the mesh's sub-groups.  Rank
``d·rows + r`` holds mesh coordinate (d, r).  A 1×1 mesh needs no process
group: every collective on an axis of size 1 is the identity.  CUDA
tensors travel through NCCL only: a mesh on the card needs a NCCL process
group (``multihost.initialize_from_env``).

Gradients through the collectives follow one convention.  The
differentiable ``psum`` and ``all_gather`` have the transposes of the
distributed program whose output is the SUM of every rank's loss: the
backward of ``psum`` all-reduces the cotangents, that of ``all_gather``
sums the cotangents over ranks and keeps the rank's own block.  Where every
``rows`` rank computes the same loss (the sharded sampler, the tile-sharded
GAT), each rank back-propagates ``loss / rows`` and then all-reduces the
gradients of replicated parameters over ``rows`` (``reduce_grads``); a
parameter that is itself sharded (the head's column slice) keeps its local
gradient.  Gradients are then averaged over ``dp``.  That gives JAX's
gradients (the gradient of the replicated loss) exactly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .._device import resolve_device

AXES = ("dp", "rows")


class Mesh:
    """A (dp, rows) mesh: per axis its ``size``, this rank's ``index`` and
    the process ``group`` (None on an axis of size 1, or with no process
    group).  ``device`` is where the rank's tensors live."""

    def __init__(self, dp: int, rows: int, device, groups=None, index=(0, 0)):
        self.shape = {"dp": int(dp), "rows": int(rows)}
        self.device = torch.device(device)
        self.groups = dict(groups or {"dp": None, "rows": None})
        self.coords = dict(zip(AXES, index))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, rows={self.shape['rows']}, "
                f"at {tuple(self.coords.values())}, {self.device})")


def make_mesh(dp: int = 1, rows: int = 1, device=None) -> Mesh:
    """The (dp, rows) mesh over the process group's ranks (one device
    each; ``device`` defaults to the current CUDA device and raises
    without one, as every entry point of the port does).
    Without a process group only the 1×1 mesh exists.  Raises when the
    world does not hold exactly ``dp·rows`` ranks, and when a CUDA mesh
    would run on another backend than NCCL."""
    need = dp * rows
    device = resolve_device(device)
    if not dist.is_available() or not dist.is_initialized():
        if need != 1:
            raise ValueError(f"need {need} ranks for mesh (dp={dp}, rows={rows}), "
                             "have 1 (no process group: initialize_from_env or "
                             "torchrun start one)")
        return Mesh(1, 1, device)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} ranks for mesh (dp={dp}, rows={rows}), "
                         f"have {world}")
    backend = dist.get_backend()
    if device.type == "cuda" and backend != "nccl":
        raise ValueError(f"a mesh on {device} needs the NCCL backend, the process "
                         f"group runs {backend}")
    if device.type == "cpu" and backend == "nccl":
        raise ValueError("a CPU mesh needs the gloo backend, the process group "
                         "runs nccl")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device.type, (dp, rows), mesh_dim_names=AXES)
    rank = dist.get_rank()
    groups = {ax: (dm.get_group(ax) if n > 1 else None)
              for ax, n in (("dp", dp), ("rows", rows))}
    return Mesh(dp, rows, device, groups, (rank // rows, rank % rows))


def single_device_mesh(device=None) -> Mesh:
    return make_mesh(1, 1, device)


# ---------------------------------------------------------------------------
# Collectives on one axis
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.stack(parts)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.group, ctx.index = group, index
        return _gather(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group)[ctx.index], None, None, None


def psum(mesh: Mesh, x: torch.Tensor, axis: str = "rows") -> torch.Tensor:
    """Σ of ``x`` over the ranks of ``axis``; differentiable (the backward
    all-reduces the cotangents)."""
    g = mesh.group(axis)
    return x if g is None else _PSum.apply(x, g)


def pmean(mesh: Mesh, x: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    n = mesh.size(axis)
    return x if n == 1 else psum(mesh, x, axis) / n


def pmax(mesh: Mesh, x: torch.Tensor, axis: str = "rows") -> torch.Tensor:
    """Elementwise max over ``axis`` of a value that carries no gradient."""
    g = mesh.group(axis)
    return x.detach() if g is None else _all_reduce(x, g, dist.ReduceOp.MAX)


def all_gather(mesh: Mesh, x: torch.Tensor, axis: str = "rows",
               tiled: bool = False) -> torch.Tensor:
    """The ranks' ``x`` stacked along a new leading axis ([size, ...]), or
    concatenated along axis 0 with ``tiled``; differentiable (the backward
    sums the cotangents over ranks and keeps this rank's block)."""
    g = mesh.group(axis)
    out = x[None] if g is None else _AllGather.apply(x, g, mesh.size(axis),
                                                      mesh.index(axis))
    return out.reshape((-1,) + tuple(x.shape[1:])) if tiled else out


def neighbour_exchange(mesh: Mesh, to_right: torch.Tensor, to_left: torch.Tensor,
                       axis: str = "rows"):
    """One exchange with the neighbours along ``axis`` (JAX's two
    ``ppermute`` shifts): ``to_right`` goes to index + 1, ``to_left`` to
    index − 1.  Returns ``(from_left, from_right)``, what index − 1 sent
    right and what index + 1 sent left; an edge rank receives zeros.  Every
    send and receive is one ``batch_isend_irecv``, so neighbours cannot
    deadlock.  Not differentiable."""
    from_left = torch.zeros_like(to_right)
    from_right = torch.zeros_like(to_left)
    g = mesh.group(axis)
    if g is None:
        return from_left, from_right
    i, n = mesh.index(axis), mesh.size(axis)
    ops = []
    if i + 1 < n:
        peer = dist.get_global_rank(g, i + 1)
        ops += [dist.P2POp(dist.isend, to_right.contiguous(), peer, g),
                dist.P2POp(dist.irecv, from_right, peer, g)]
    if i > 0:
        peer = dist.get_global_rank(g, i - 1)
        ops += [dist.P2POp(dist.isend, to_left.contiguous(), peer, g),
                dist.P2POp(dist.irecv, from_left, peer, g)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return from_left, from_right


def reduce_grads(mesh: Mesh, grads, sharded=(), rows_sum: bool = True):
    """Gradients of the rank's loss share → the gradient of the global loss
    (the module docstring's convention): Σ over ``rows`` for every gradient
    whose position is not in ``sharded`` (when ``rows_sum``), then the mean
    over ``dp``.  All reductions of one axis go out as one flat buffer."""
    grads = list(grads)

    def reduce(idx, axis, scale):
        if mesh.group(axis) is None or not idx:
            return
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = _all_reduce(flat, mesh.group(axis))
        if scale != 1:
            flat = flat / scale
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].reshape(grads[i].shape)
            off += n

    if rows_sum:
        reduce([i for i in range(len(grads)) if i not in sharded], "rows", 1)
    reduce(list(range(len(grads))), "dp", mesh.size("dp"))
    return grads
