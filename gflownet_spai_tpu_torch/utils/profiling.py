"""Tracing and profiling helpers (counterpart of
``gflownet_spai_tpu/utils/profiling.py``): the reference's memory
instrumentation (``log_memory_usage``, ``malloc_usage``; reference
gflownet/utils.py:280-293), a ``torch.profiler`` trace context, per-call
timing and the roofline counters of a sparse kernel (nnz/s, effective
GB/s)."""

from __future__ import annotations

import contextlib
import os
import resource
import time
from pathlib import Path
from typing import Callable, Dict

import torch

#: H100 SXM HBM3 bandwidth, the bound ``chip_smoke.py`` uses
H100_HBM_GBPS = 3350.0


def _host_memory_mb() -> Dict[str, float]:
    """Resident and virtual size of this process in MiB, from
    ``/proc/self/statm`` where the system has it, else the peak resident
    size from ``resource`` (no ``psutil``)."""
    try:
        vms, rss = (int(x) for x in Path("/proc/self/statm").read_text().split()[:2])
        page = os.sysconf("SC_PAGE_SIZE")
        return {"rss_mb": rss * page / 2**20, "vms_mb": vms * page / 2**20}
    except (OSError, ValueError):
        peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return {"rss_mb": peak_kb / 2**10, "vms_mb": float("nan")}


def log_memory_usage(stage: str) -> Dict[str, float]:
    """Host RSS and VMS, plus ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated`` of every card; printed on one line and
    returned (MiB)."""
    out = _host_memory_mb()
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            out[f"cuda{i}_allocated_mb"] = torch.cuda.memory_allocated(i) / 2**20
            out[f"cuda{i}_max_allocated_mb"] = torch.cuda.max_memory_allocated(i) / 2**20
    print(f"[{stage}] " + " ".join(f"{k}={v:.1f}" for k, v in out.items()), flush=True)
    return out


def malloc_usage(description: str, top: int = 10) -> None:
    """tracemalloc line statistics; needs ``tracemalloc.start()`` first."""
    import tracemalloc

    snapshot = tracemalloc.take_snapshot()
    print(f"\nMemory usage at {description}:")
    for stat in snapshot.statistics("lineno")[:top]:
        print(stat)


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """``torch.profiler`` over the block, CPU and (where a card is present)
    CUDA activities; writes a Chrome trace (``trace.json``, open it in
    Perfetto or chrome://tracing) into ``log_dir`` and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def timed(fn: Callable, *args, reps: int = 20, warmup: int = 2) -> float:
    """Seconds per call of ``fn(*args)``.  Where an argument is a CUDA
    tensor the calls are captured into one CUDA graph, whose replays are
    timed with CUDA events (device time, no host dispatch); otherwise
    ``time.perf_counter`` times ``reps`` calls."""
    on_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    for _ in range(warmup):
        fn(*args)
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / (5 * reps)


def roofline_report(nnz: int, seconds_per_op: float, bytes_per_nnz: float = 5.6,
                    hbm_gbps: float = H100_HBM_GBPS) -> Dict[str, float]:
    """nnz/s and the share of the HBM roofline of a sparse kernel that
    moves ``bytes_per_nnz`` bytes per nonzero."""
    nnz_per_s = nnz / seconds_per_op
    roofline = hbm_gbps * 1e9 / bytes_per_nnz
    return {
        "nnz_per_s": nnz_per_s,
        "gnnz_per_s": nnz_per_s / 1e9,
        "effective_gbps": nnz_per_s * bytes_per_nnz / 1e9,
        "roofline_fraction": nnz_per_s / roofline,
    }
