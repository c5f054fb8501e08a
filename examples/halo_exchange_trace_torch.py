"""Where the time of one ``halo_spmv`` goes across ranks: the neighbour
exchange, the K8 SpMV on the halo-extended shard, and the whole call, each
timed alone, beside a one-float ``all_reduce``; then a ``torch.profiler``
trace of the whole call (device time by kernel, host time by op).

    torchrun --standalone --nproc-per-node 4 examples/halo_exchange_trace_torch.py
    torchrun --standalone --nproc-per-node 2 examples/halo_exchange_trace_torch.py \\
        --platform cpu --rows-per-rank 4096

The matrix is ``bench_scaling``'s 5-point stencil, ``--rows-per-rank``
rows a rank (default 262,144).  Each piece runs ``--reps`` times back to
back after a barrier: ``dev_ms`` is CUDA events around the loop over reps
(on the CPU, the host clock), ``host_ms`` the host clock around the loop
and one synchronize, both per call.  Each rank prints one JSON line; the
profiler's tables go to ``--out`` (one file a rank).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gflownet_spai_tpu_torch import bench_scaling  # noqa: E402
from gflownet_spai_tpu_torch.ops.dia import spmv_dia_padded  # noqa: E402
from gflownet_spai_tpu_torch.parallel import halo_spmv, make_mesh, partition_dia  # noqa: E402
from gflownet_spai_tpu_torch.parallel.halo_spmv import _halo, _local_dia  # noqa: E402
from gflownet_spai_tpu_torch.parallel.mesh import neighbour_exchange  # noqa: E402
from gflownet_spai_tpu_torch.parallel.multihost import initialize_from_env  # noqa: E402


def _per_call(fn, reps: int, device) -> dict:
    """ms per call of ``fn``, ``reps`` calls back to back after a barrier."""
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    dist.barrier()
    t0 = time.perf_counter()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(reps):
        fn()
    if device.type == "cuda":
        end.record()
    sync()
    host = 1e3 * (time.perf_counter() - t0) / reps
    dev = start.elapsed_time(end) / reps if device.type == "cuda" else host
    return {"dev_ms": dev, "host_ms": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows-per-rank", type=int, default=262144)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--platform", default=None, help="cpu runs on the CPU (gloo)")
    ap.add_argument("--out", default="runs/halo_trace")
    args = ap.parse_args(argv)
    cpu = args.platform == "cpu"
    if not initialize_from_env(device="cpu" if cpu else None):
        raise SystemExit("start the ranks with torchrun (no process group configured)")
    world, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device("cpu") if cpu else torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(1, world, device)
    d = partition_dia(bench_scaling._stencil(args.rows_per_rank * world, device), world)
    n_local = d.n_pad // world
    halo = _halo(d)
    x = torch.randn(n_local, generator=torch.Generator(device=device).manual_seed(rank),
                    device=device)
    xp = torch.cat([torch.zeros(halo, device=device), x, torch.zeros(halo, device=device)])
    block = _local_dia(mesh, d)
    one = torch.ones(1, device=device)
    for _ in range(5):
        halo_spmv(mesh, d, x)
    rec = {"rank": rank, "world": world, "device": str(device), "n_local": n_local,
           "halo": halo, "halo_bytes": 4 * halo, "reps": args.reps,
           "exchange": _per_call(lambda: neighbour_exchange(mesh, x[n_local - halo:],
                                                            x[:halo]), args.reps, device),
           "spmv_padded": _per_call(lambda: spmv_dia_padded(block, xp), args.reps, device),
           "halo_spmv": _per_call(lambda: halo_spmv(mesh, d, x), args.reps, device),
           "all_reduce_1": _per_call(lambda: dist.all_reduce(one), args.reps, device)}

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([] if cpu else [ProfilerActivity.CUDA])
    with profile(activities=acts) as prof:
        if not cpu:
            torch.cuda.synchronize()
        dist.barrier()          # inside the window: the profilers' start-up differs by rank
        for _ in range(20):
            halo_spmv(mesh, d, x)
        if not cpu:
            torch.cuda.synchronize()
    ka = prof.key_averages()
    dev_key = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") \
        else "self_cuda_time_total"
    rows = sorted(((e.key, e.count, getattr(e, dev_key, 0.0) / 1e3, e.self_cpu_time_total / 1e3)
                   for e in ka), key=lambda r: -(r[2] + r[3]))
    rec["profile_20_calls"] = [{"name": k, "count": c, "self_device_ms": dv,
                                "self_host_ms": h} for k, c, dv, h in rows[:12]]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"rank{rank}.txt").write_text(ka.table(sort_by=dev_key if not cpu else
                                                  "self_cpu_time_total", row_limit=40))
    print(json.dumps(rec), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
