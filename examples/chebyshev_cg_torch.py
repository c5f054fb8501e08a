"""Chebyshev-preconditioned CG on Poisson-1M on the PyTorch port
(counterpart of ``examples/chebyshev_cg.py``): the solver stack on the
DIA kernels of the CUDA card.

* A applies through the DIA SpMV (K8);
* ``chebyshev_op``: a degree-d Chebyshev polynomial preconditioner whose
  applies run k steps per read of the diagonals (K13);
* the V-cycles (``vcycle_op``): Jacobi smoothing on the fused k-step SpMV
  (K12), Chebyshev smoothing on K13, and the W-cycle;
* ``estimate_lmax``: the power-iteration spectral bound.

Each row solves twice (the first builds and warms up) and prints the
second solve's iterations, wall time and the kernel wrappers' launch
counters (zero on the CPU, where the wrappers take their plain versions),
then one JSON line with every row.

    python examples/chebyshev_cg_torch.py [grid_k=1000] [degree=64] [levels=6]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gflownet_spai_tpu_torch import resolve_device  # noqa: E402
from gflownet_spai_tpu_torch.ops import dia  # noqa: E402
from gflownet_spai_tpu_torch.solvers import cg, chebyshev_op, estimate_lmax  # noqa: E402
from gflownet_spai_tpu_torch.solvers.multigrid import vcycle_op  # noqa: E402

COUNTERS = {"K8": dia.spmv_dia, "K12": dia.spmv_dia_power, "K13": dia.spmv_dia_cheby}
MAXITER, RTOL = 4000, 1e-5


def poisson_dia(k: int, device, dtype=np.float32) -> dia.DIA:
    """The 5-point Laplacian of a k × k grid in DIA on ``device``, padded to
    a power of two as the JAX launcher pads it (a length whose tiles the
    fused kernels' selection admits: at k = 1000 ``coo_to_dia``'s padding to
    a multiple of 1024, 1,000,448, is not one)."""
    n = k * k
    n_pad = 1 << (n - 1).bit_length()
    i = np.arange(n)
    r, c = i // k, i % k
    data = np.zeros((5, n_pad), dtype)
    data[2, :n] = 4.0
    data[0, i[r > 0]] = -1.0
    data[1, i[c > 0]] = -1.0
    data[3, i[c < k - 1]] = -1.0
    data[4, i[r < k - 1]] = -1.0
    return dia.DIA(data=torch.as_tensor(data, device=device), offsets=(-k, -1, 0, 1, k),
                   shape=(n, n), nnz=int((data != 0).sum()))


def lmin_exact(k: int) -> float:
    """λmin of the k × k 5-point Laplacian (exact for this stencil)."""
    return 8.0 * np.sin(np.pi / (2 * (k + 1))) ** 2


def rows(d: dia.DIA, k: int, degree: int, levels: int, lmax: float):
    """The preconditioner rows: (tag, operator or None)."""
    return (("none", None),
            (f"chebyshev(deg={degree})",
             chebyshev_op(d, lmax=lmax, lmin=lmin_exact(k), degree=degree)),
            (f"vcycle(levels={levels})",
             vcycle_op(d, pre=2, post=2, levels=levels, coarse_sweeps=16)),
            (f"vcycle-cheb(levels={min(levels, 3)})",
             vcycle_op(d, levels=min(levels, 3), smoother="chebyshev")),
            (f"wcycle-cheb(levels={min(levels, 3)})",
             vcycle_op(d, levels=min(levels, 3), smoother="chebyshev", gamma=2)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("k", nargs="?", type=int, default=1000)
    p.add_argument("degree", nargs="?", type=int, default=64)
    p.add_argument("levels", nargs="?", type=int, default=6)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    k = args.k
    d = poisson_dia(k, device)
    b = torch.ones((d.n,), dtype=torch.float32, device=device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Poisson {k}x{k}: n={d.n}, nnz={d.nnz} on {where}")
    lmax = 1.05 * float(estimate_lmax(d, iters=30))
    print(f"spectral interval: [{lmin_exact(k):.3e}, {lmax:.3f}]")

    out = []
    for tag, m_op in rows(d, k, args.degree, args.levels, lmax):
        cg(d, b, m_op=m_op, maxiter=MAXITER, rtol=RTOL)     # build + warm-up
        for fn in COUNTERS.values():
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        res = cg(d, b, m_op=m_op, maxiter=MAXITER, rtol=RTOL)
        sync()
        wall = time.perf_counter() - t0
        launches = {key: fn.launches for key, fn in COUNTERS.items()}
        out.append({"row": tag, "iterations": int(res.iterations),
                    "converged": bool(res.converged), "wall_s": wall,
                    "launches": launches})
        print(f"  {tag:22s}: {int(res.iterations):5d} iters, converged="
              f"{bool(res.converged)}, wall {wall:.3f}s, launches " +
              ", ".join(f"{key} {n}" for key, n in launches.items()), flush=True)
    print(json.dumps({"grid": k, "device": where, "rows": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
