"""Weak-scaling harness: the halo-exchange SpMV across mesh sizes
(counterpart of ``gflownet_spai_tpu/bench_scaling.py``).

    torchrun --nproc-per-node N -m gflownet_spai_tpu_torch.bench_scaling --multihost
    python -m gflownet_spai_tpu_torch.bench_scaling            # one card

keeps the rows per rank constant (the 5-point stencil of a square grid)
and prints, from rank 0, one JSON line per mesh size: ``devices``,
``rows``, ``nnz``, ``time_s`` (per call of ``reps`` calls made back to
back after a barrier, CUDA events on the card; the slowest rank's),
``nnz_per_s`` and ``efficiency`` (the one-rank time over this size's:
weak scaling keeps the ideal time constant).  A size p below
the world size runs on ranks [0, p) while the others wait.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist


def _stencil(n: int, device) -> "DIA":
    from .ops.dia import DIA

    k = max(1, int(np.sqrt(n)))          # the grid's row stride
    data = np.zeros((5, n), np.float32)
    data[2, :] = 4.0
    data[0, k:] = -1.0
    data[1, 1:] = -1.0
    data[3, :-1] = -1.0
    data[4, :-k] = -1.0
    return DIA(data=torch.as_tensor(data, device=device), offsets=(-k, -1, 0, 1, k),
               shape=(n, n), nnz=int((data != 0).sum()))


def _mesh(p: int, device):
    """The rows-only mesh of ranks [0, p), or None on a rank outside it."""
    from .parallel.mesh import Mesh, make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if p == world:
        return make_mesh(1, p, device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    group = dist.new_group(list(range(p))) if p > 1 else None
    if rank >= p:
        return None
    return Mesh(1, p, device, {"dp": None, "rows": group}, (0, rank))


def _time(fn, reps: int, mesh) -> float:
    """Seconds per call of ``reps`` calls made back to back after a barrier
    of the mesh's ranks (CUDA events on the card).  A call timed alone
    would also time its wait for the neighbours' host work."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    if mesh.group("rows") is not None:
        dist.barrier(group=mesh.group("rows"))
    t0 = time.perf_counter()
    if cuda:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(reps):
        fn()
    if not cuda:
        return (time.perf_counter() - t0) / reps
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def run(device_counts, rows_per_device: int = 262144, reps: int = 50, device=None):
    """One record per mesh size (on rank 0; other ranks get [])."""
    from ._device import resolve_device
    from .parallel import halo_spmv, partition_dia

    device = resolve_device(device)
    results = []
    for p in device_counts:
        mesh = _mesh(p, device)
        if mesh is not None:
            d = partition_dia(_stencil(rows_per_device * p, device), p)
            n_local = d.n_pad // p
            rng = np.random.default_rng(mesh.index("rows"))
            x = torch.as_tensor(rng.standard_normal(n_local), dtype=torch.float32,
                                device=device)
            halo_spmv(mesh, d, x)           # builds the block and the P2P pairs
            t = _time(lambda: halo_spmv(mesh, d, x), reps, mesh)
            if mesh.group("rows") is not None:
                tt = torch.tensor([t], device=device)
                dist.all_reduce(tt, op=dist.ReduceOp.MAX, group=mesh.group("rows"))
                t = float(tt)
            results.append({"devices": p, "rows": d.shape[0], "nnz": d.nnz,
                            "time_s": t, "nnz_per_s": d.nnz / t})
        if dist.is_initialized():
            dist.barrier()
    if dist.is_initialized() and dist.get_rank() != 0:
        return []
    base = results[0]["time_s"]
    for r in results:
        r["efficiency"] = base / r["time_s"]
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gflownet_spai_tpu_torch.bench_scaling")
    ap.add_argument("--devices", default=None,
                    help="mesh sizes, e.g. 1,2,4 (default: powers of two up to "
                         "the world size)")
    ap.add_argument("--rows-per-device", type=int, default=262144)
    ap.add_argument("--platform", default=None, help="cpu runs on the CPU (gloo)")
    ap.add_argument("--multihost", action="store_true",
                    help="start the process group from the environment "
                         "(parallel.multihost)")
    args = ap.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    if args.multihost:
        from .parallel.multihost import initialize_from_env, process_summary

        initialize_from_env(device=device)
        print(json.dumps(process_summary()), flush=True)
    world = dist.get_world_size() if dist.is_initialized() else 1
    counts = ([int(x) for x in args.devices.split(",")] if args.devices else
              [1 << i for i in range(world.bit_length()) if 1 << i <= world])
    if max(counts) > world:
        raise SystemExit(f"need {max(counts)} ranks, have {world} (start them with "
                         "torchrun --nproc-per-node N ... --multihost)")
    if device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available; pass --platform cpu")
    for r in run(counts, args.rows_per_device, device=device):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
