"""A check of the multi-device layer on every rank of a process group: the
halo-exchange SpMV (K8) on the 2-D Poisson matrix split over the ranks
against each rank's whole-matrix ``spmv_dia``, and one dp train step
(LF10_like) on the (world, 1) mesh.

    torchrun --standalone --nproc-per-node N -m gflownet_spai_tpu_torch.parallel.check

Each rank starts the process group from the environment
(``multihost.initialize_from_env``: NCCL on its card, gloo with
``--platform cpu``), prints one JSON line (``rank``, ``world``, the SpMV's
relative error, its K8 launches and ms per apply, the dp step's loss)
and exits non-zero when the SpMV disagrees, when a kernel of the
path did not launch on the card or when the loss is not finite.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

SPMV_RTOL = 1e-6            # max |y − y_ref| / max |y_ref|, float32


def _ms_per_call(fn, reps: int, device) -> float:
    """Median ms of ``reps`` calls (CUDA events on the card)."""
    fn()
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts))


def run(poisson: int = 1024, device=None, reps: int = 20) -> dict:
    """This rank's record (the process group, if any, is already up)."""
    from ..ops import dia
    from ..sparse import gallery
    from ..train.loop import TrainConfig, setup
    from .dp import make_dp_train_step
    from .halo_spmv import halo_spmv, partition_dia
    from .mesh import make_mesh

    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = make_mesh(1, world, device)
    d = partition_dia(dia.coo_to_dia(gallery.poisson2d(poisson, dtype=np.float32),
                                     device=device), world)
    x = torch.randn(d.n_pad, generator=torch.Generator(device=device).manual_seed(1),
                    device=device)
    x[d.n:] = 0
    n_loc = d.n_pad // world
    mine = slice(rank * n_loc, (rank + 1) * n_loc)
    x_loc = x[mine]
    before = dia.spmv_dia.launches
    y = halo_spmv(mesh, d, x_loc)
    k8 = dia.spmv_dia.launches - before
    full = dia.spmv_dia(d, x)
    want = torch.nn.functional.pad(full, (0, d.n_pad - full.shape[0]))[mine]
    err = float((y - want).abs().max()) / max(float(want.abs().max()), 1e-30)
    ms = _ms_per_call(lambda: halo_spmv(mesh, d, x_loc), reps, device)

    cfg = TrainConfig(matrix="LF10_like", dp_devices=world, batch_size=2 * world,
                      platform="cpu" if device.type == "cpu" else None)
    _, _, env, graph, mcfg, opt, state = setup(cfg)
    step, _ = make_dp_train_step(make_mesh(world, 1, device), env, graph, mcfg, opt,
                                 2 * world)
    loss = float(step(state.params, state.opt_state, 0)[2])
    return {"rank": rank, "world": world, "device": str(device), "poisson": poisson,
            "spmv_rel_err": err, "k8_launches": k8, "halo_spmv_ms": ms,
            "dp_loss": loss}


def main(argv=None) -> int:
    from .multihost import initialize_from_env

    ap = argparse.ArgumentParser(prog="gflownet_spai_tpu_torch.parallel.check")
    ap.add_argument("--poisson", type=int, default=1024, help="grid side of the matrix")
    ap.add_argument("--platform", default=None, help="cpu runs on the CPU (gloo)")
    args = ap.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else None
    started = not dist.is_initialized() and initialize_from_env(device=device)
    try:
        rec = run(args.poisson, device)
    finally:
        if started:
            dist.destroy_process_group()
    # one write, so the ranks' lines stay whole in a pipe they share
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), (json.dumps(rec) + "\n").encode())
    bad = []
    if not rec["spmv_rel_err"] <= SPMV_RTOL:
        bad.append(f"halo_spmv max rel err {rec['spmv_rel_err']:.3e} > {SPMV_RTOL}")
    if rec["device"].startswith("cuda") and rec["k8_launches"] == 0:
        bad.append("halo_spmv launched no K8")
    if not np.isfinite(rec["dp_loss"]):
        bad.append(f"the dp step's loss {rec['dp_loss']}")
    if bad:
        print(f"rank {rec['rank']}: " + "; ".join(bad), file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
