"""BASELINE config 2 on the PyTorch port (counterpart of
``examples/config2_poisson_spai.py``): 2-D 5-point Poisson, sampled SPAI
against static power-pattern SPAI, CG iteration parity.

* ``--part classic`` (default grid 1000, the 1M-row config-2 problem):
  classic power-pattern SPAI (the pattern of A, batched-QR least squares)
  as a CG preconditioner on the CUDA card, against none and Jacobi.  A
  applies through the DIA SpMV (K8); M through the symmetrized SPAI
  operator on its DIA (CG needs a symmetric preconditioner).

* ``--part sampled`` (default grid 64): the GFlowNet thins the classic-SPAI
  seed (``--seed-method spai``) and the port's validation harness
  (``python -m gflownet_spai_tpu_torch.validate``, the JAX recipe's flags)
  compares CG iteration counts of the sampled pattern against classic
  SPAI, ILU and none.

    python examples/config2_poisson_spai_torch.py --part classic --grid 1000
    python examples/config2_poisson_spai_torch.py --part sampled --grid 64

Runs on the CUDA card unless ``--device cpu``; the sampled part writes
``runs/torch_config2_sampled_<grid>``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def run_classic(grid: int, device) -> dict:
    import numpy as np
    import torch

    from gflownet_spai_tpu_torch import _build, resolve_device
    from gflownet_spai_tpu_torch.ops.dia import coo_to_dia
    from gflownet_spai_tpu_torch.solvers.cg import cg
    from gflownet_spai_tpu_torch.solvers.linop import as_linop
    from gflownet_spai_tpu_torch.solvers.precond import jacobi_op, spai_op_sym
    from gflownet_spai_tpu_torch.solvers.spai_classic import spai_classic
    from gflownet_spai_tpu_torch.sparse.gallery import poisson2d

    device = resolve_device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        print(f"card: {torch.cuda.get_device_name(device)}; kernels built in "
              f"{_build.build_all():.1f}s", flush=True)
    a = poisson2d(grid, dtype=np.float32)
    n = a.shape[0]
    print(f"A: poisson {grid}x{grid} grid, n={n}, nnz={a.nnz}", flush=True)

    t0 = time.time()
    m = spai_classic(a, k=1, device=device)     # power-pattern(A^1) least squares
    sync()
    t_spai = time.time() - t0
    print(f"classic SPAI built in {t_spai:.1f}s, nnz(M)={m.nnz}", flush=True)

    a_lin = as_linop(coo_to_dia(a, device=device))     # K8
    b = torch.ones((n,), dtype=torch.float32, device=device)
    # M shares A's banded pattern: apply it through the DIA SpMV too
    m_dia = coo_to_dia(m, device=device)

    out = {"n": n, "nnz_A": a.nnz, "nnz_M": m.nnz, "spai_build_s": t_spai}
    for tag, m_op in (("none", None), ("jacobi", jacobi_op(a.to(device))),
                      ("classic_spai", spai_op_sym(m_dia))):
        sync()
        t0 = time.time()
        res = cg(a_lin, b, m_op=m_op, maxiter=2000, rtol=1e-5)
        sync()
        elapsed = time.time() - t0
        iters = int(res.iterations)
        out[tag] = {"iters": iters, "converged": bool(res.converged),
                    "wall_s": round(elapsed, 4)}
        print(f"CG[{tag}]: {iters} iters, converged={bool(res.converged)}, "
              f"{elapsed:.4f}s", flush=True)
    return out


def run_sampled(grid: int, epochs: int, device) -> dict:
    out_dir = f"runs/torch_config2_sampled_{grid}"
    cmd = [sys.executable, "-m", "gflownet_spai_tpu_torch.validate",
           "--matrix", f"poisson{grid}", "--epochs", str(epochs),
           "--batch-size", "8", "--seed-method", "spai", "--method", "cg",
           "--alpha-fixed", "0.98", "--out-dir", out_dir,
           # ~20k-step trajectories: subTB keeps the loss scale sane, replay
           # retains the rare high-reward thinnings
           "--loss", "subtb", "--replay-size", "16",
           *(["--platform", "cpu"] if device == "cpu" else [])]
    print("+", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)
    with open(f"{out_dir}/validation.json") as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--part", choices=["classic", "sampled"], default="classic")
    p.add_argument("--grid", type=int, default=None)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    if args.part == "classic":
        result = run_classic(args.grid or 1000, args.device)
    else:
        result = run_sampled(args.grid or 64, args.epochs, args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
