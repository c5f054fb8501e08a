"""Compare the DIA SpMV (K8) of several checkouts of the port on one card:
device time and output bits on `chip_smoke.py`'s `[dia]` K8 cases, and the
ms per iteration of its `[validate]` rows whose preconditioner runs K8.

    python examples/k8_compare_torch.py TREE [TREE ...]

Each TREE is the root of a checkout (for another commit: `git archive`
into a directory that `.gitignore` lists).  The trees run one at a time,
each in a process of its own, in the order given and then in reverse (A,
B, B, A for two), so that every tree is timed on either side of the
others.  Cases: poisson1024 (5 diagonals) and orsirr_like150 (230
diagonals) as float32, in the three instances (float32; bf16 diagonals
with float32 vectors; bf16 with bf16), through `spmv_dia` and
`spmv_dia_padded`, and orsirr_like150 with inf and NaN in x.  A line per
tree and case gives the graph-replay time over cold copies of the inputs
(as `chip_smoke.py`'s `_timed`), the host time of an eager call (the mean
over 200 calls, right after the timing), and a hash of the output, which are
equal between trees whose kernels give the same bits; then GMRES(20) on
orsirr_like150 (b = ones, rtol 1e-5) with the Jacobi-16 and Chebyshev-16
preconditioners: iterations, K8 launches, the host clock's ms per iteration
over six solves, and the device time per iteration of a seventh solve
under `torch.profiler` (all kernels, and K8's).  Needs a CUDA card and
`nvcc`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import itertools
import subprocess
import sys
import time
from pathlib import Path

POISSON, MATRIX = 1024, "orsirr_like150"
COLD_BYTES = 150_000_000      # input copies cycled through per timing (3x L2)
REPS = 20
HOST_CALLS = 200              # eager calls timed on the host clock per case
SOLVES = 6                    # GMRES solves per validate row (the first one cold)


def _graph_ms(fn, reps: int = REPS, replays: int = 5) -> float:
    """Mean device ms of one call of ``fn`` (``reps`` calls captured in one
    CUDA graph, its replays timed with CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _bits(y):
    import torch

    return y.view(torch.int16 if y.element_size() == 2 else torch.int32)


def _digest(y) -> str:
    return hashlib.sha256(_bits(y).cpu().numpy().tobytes()).hexdigest()[:16]


def run_tree(tree: str) -> None:
    """Build one tree's DIA kernels and time its K8 on every case."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from gflownet_spai_tpu_torch import _build
    from gflownet_spai_tpu_torch.ops import dia
    from gflownet_spai_tpu_torch.solvers import (chebyshev_op, estimate_lmax,
                                                 jacobi_sweeps_op, solve_with_gmres)
    from gflownet_spai_tpu_torch.sparse import gallery

    _build.SOURCES = ("dia",)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _build.build_all(verbose=True)
    lines = log.getvalue().splitlines()
    for i, line in enumerate(lines):
        kern = next((k for k in ("dia_spmv_kernel", "dia_spmv_skip_kernel",
                                 "dia_x_nonfinite_kernel") if k in line), None)
        if "Compiling entry" in line and kern:
            inst = line.split(kern)[1][:12]
            print(f"[compare] {tree} ptxas {kern}{inst}: {lines[i + 2].strip()}; "
                  f"{lines[i + 3].strip()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2024)
    bf16 = torch.bfloat16
    for name, coo in ((f"poisson{POISSON}", gallery.poisson2d(POISSON, dtype=np.float32)),
                      (MATRIX, gallery.get(MATRIX))):
        coo = coo.with_data(coo.data.astype(np.float32))
        d32 = dia.coo_to_dia(coo, device=dev)
        x32 = torch.randn(d32.n, generator=gen, device=dev)
        cases = [("float32", d32, x32), ("bf16 diagonals, float32 x", dia.dia_astype(d32, bf16),
                                         x32),
                 ("bf16", dia.dia_astype(d32, bf16), x32.to(bf16))]
        if name == MATRIX:
            bad = x32.clone()
            idx = torch.randperm(d32.n, generator=torch.Generator().manual_seed(7))[:6]
            bad[idx[:3]] = float("nan")
            bad[idx[3:]] = float("inf")
            cases.append(("float32, inf and NaN in x", d32, bad))
        for inst, d, x in cases:
            xp = torch.nn.functional.pad(x, (d.halo, d.n_pad - d.n + d.halo))
            for entry, fn, arg in (("spmv_dia", dia.spmv_dia, x),
                                   ("spmv_dia_padded", dia.spmv_dia_padded, xp)):
                y = fn(d, arg)
                same = torch.equal(_bits(fn(d, arg)), _bits(y))
                nbytes = d.data.numel() * d.data.element_size() + 2 * arg.numel() \
                    * arg.element_size()
                n_copies = min(16, max(2, -(-COLD_BYTES // nbytes)))
                copies = [(d, arg)] + [(dataclasses.replace(d, data=d.data.clone()),
                                        arg.clone()) for _ in range(1, n_copies)]
                it = itertools.cycle([lambda c=c: fn(*c) for c in copies])
                ms = _graph_ms(lambda: next(it)())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(HOST_CALLS):
                    fn(d, arg)
                host_us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
                torch.cuda.synchronize()
                print(f"[compare] {tree} {name} {inst} {entry}: K8 {ms:.5f} ms (graph replay "
                      f"over {n_copies} copies), host {host_us:.1f} us an eager call, "
                      f"output sha256 {_digest(y)}, NaN rows "
                      f"{int(y.isnan().sum())}, a second launch "
                      f"{'the same bits' if same else 'OTHER BITS'}", flush=True)
    coo = gallery.get(MATRIX)
    coo = coo.with_data(coo.data.astype(np.float32))
    a = coo.to(dev)
    b = torch.ones((coo.shape[0],), dtype=torch.float32, device=dev)

    def cheby():
        dd = dia.coo_to_dia(coo, device=dev)
        lmax = 1.05 * float(estimate_lmax(dd, iters=30))
        return chebyshev_op(dd, lmax=lmax, lmin=lmax / 30, degree=16)

    for row, make in (("jacobi_poly", lambda: jacobi_sweeps_op(
            dia.coo_to_dia(coo, device=dev), sweeps=16)), ("chebyshev", cheby)):
        before = dia.spmv_dia.launches
        op = make()
        walls = []
        for _ in range(SOLVES):
            _, _, iters, secs = solve_with_gmres(a, b, op, maxiter=10260, restart=20,
                                                 rtol=1e-5)
            walls.append(1e3 * secs / iters)
        launches = (dia.spmv_dia.launches - before) // SOLVES
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            solve_with_gmres(a, b, op, maxiter=10260, restart=20, rtol=1e-5)
        kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(us for _, us in kernels) / 1e3 / iters
        k8_ms = sum(us for name, us in kernels if "dia_spmv_kernel" in name
                    or "dia_spmv_skip" in name or "dia_x_nonfinite" in name) / 1e3 / iters
        print(f"[compare] {tree} validate {row}: {iters} iterations, K8 launches {launches} a "
              f"solve; host clock ms/iteration over {SOLVES} solves (the first cold) "
              f"{' '.join(f'{w:.4f}' for w in walls)}, median of the rest "
              f"{sorted(walls[1:])[len(walls[1:]) // 2]:.4f}; device (profiler) "
              f"{device_ms:.4f} ms/iteration, K8's kernels {k8_ms:.4f}", flush=True)


def main(trees: list[str]) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    for tree in trees + trees[::-1]:
        rc = subprocess.run([sys.executable, __file__, "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_tree(sys.argv[2])
    elif len(sys.argv) >= 2:
        sys.exit(main(sys.argv[1:]))
    else:
        sys.exit(__doc__)
