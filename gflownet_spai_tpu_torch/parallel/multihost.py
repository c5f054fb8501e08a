"""Multi-process bootstrap: the process group from environment variables
and the process-spanning mesh (counterpart of
``gflownet_spai_tpu/parallel/multihost.py``).

One process per device.  Set ``GFNSPAI_COORDINATOR`` (``host:port``, or a
``file://`` rendezvous path), ``GFNSPAI_NUM_PROCS`` and ``GFNSPAI_PROC_ID``
(JAX's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` are honoured too), or start the processes with
``torchrun``, whose ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
``RANK`` are read when the others are absent.  ``initialize_from_env``
then starts the process group: NCCL on CUDA, gloo only where the caller
asks for the CPU.  Rank order is host-major, so ``global_mesh``'s
consecutive ``rows`` coordinates share a host wherever they can and only
the host boundaries' halo exchanges cross the network.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def multihost_env(environ=None) -> Optional[dict]:
    """Parse the bootstrap variables; None when none is set.  All three of
    a family must be set, and the id must lie in [0, count)."""
    env = os.environ if environ is None else environ
    coord = env.get("GFNSPAI_COORDINATOR") or env.get("JAX_COORDINATOR_ADDRESS")
    nproc = env.get("GFNSPAI_NUM_PROCS") or env.get("JAX_NUM_PROCESSES")
    pid = env.get("GFNSPAI_PROC_ID") or env.get("JAX_PROCESS_ID")
    if coord is None and nproc is None and pid is None and "MASTER_ADDR" in env:
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        nproc, pid = env.get("WORLD_SIZE"), env.get("RANK")
    if coord is None and nproc is None and pid is None:
        return None
    if coord is None or nproc is None or pid is None:
        raise ValueError(
            "multi-host bootstrap needs all three of GFNSPAI_COORDINATOR, "
            f"GFNSPAI_NUM_PROCS, GFNSPAI_PROC_ID (got coord={coord!r}, "
            f"num={nproc!r}, id={pid!r})")
    nproc_i, pid_i = int(nproc), int(pid)
    if not 0 <= pid_i < nproc_i:
        raise ValueError(f"process id {pid_i} outside [0, {nproc_i})")
    return {"coordinator_address": coord, "num_processes": nproc_i,
            "process_id": pid_i}


def initialize_from_env(environ=None, device=None) -> bool:
    """Start the process group from the environment (``multihost_env``).
    Returns True when a process group was started, False when nothing is
    configured (one process, the 1×1 mesh).  ``device=None`` means the CUDA
    card ``LOCAL_RANK`` names (set current) with NCCL; ``device="cpu"``
    runs gloo.  ``GFNSPAI_TIMEOUT_S`` (default 600) bounds the rendezvous
    and every collective."""
    env = os.environ if environ is None else environ
    cfg = multihost_env(env)
    if cfg is None:
        return False
    if dist.is_initialized():
        return True
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "(--platform cpu) for a gloo process group")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
    coord = cfg["coordinator_address"]
    init = coord if "://" in coord else f"tcp://{coord}"
    timeout = datetime.timedelta(seconds=float(env.get("GFNSPAI_TIMEOUT_S", 600)))
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init,
                            world_size=cfg["num_processes"], rank=cfg["process_id"],
                            timeout=timeout)
    return True


def global_mesh(dp: int = 1, rows: int = 1, device=None) -> Mesh:
    """The (dp, rows) mesh over every process of the group (rank d·rows + r
    at (d, r): hosts stay contiguous along ``rows``)."""
    return make_mesh(dp, rows, device)


def process_summary() -> dict:
    """One-line observability record for run logs."""
    up = dist.is_available() and dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": torch.cuda.device_count() if torch.cuda.is_available() else 1,
        "global_devices": dist.get_world_size() if up else 1,
        "backend": dist.get_backend() if up else "none",
    }
