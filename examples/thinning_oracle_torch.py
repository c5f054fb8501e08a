"""Magnitude-thinning oracle on the PyTorch port (counterpart of
``examples/thinning_oracle.py``): the reward / iteration landscape a
thinning run has to climb, computed before any training.

For each fraction f it zeroes the f·nnz smallest-|value| entries of the
classic-SPAI seed M₀ (the demonstrations ``--replay-seed-thinning``
injects) and reports

* the env's exact reward through the single-sample reward API
  (``env.spai.reward`` on a float64 pair env with the identity baseline:
  res_ratio = ‖M_f·A − I‖_F / √n, flops ratio = nnz(M_f) / nnz(A)), per
  requested α, and
* (``--gmres`` or ``--cg``, not both) scipy iteration counts of the
  thinned preconditioner, the reference's acceptance metric.  GMRES runs
  with scipy's restart (``GMRES_RESTART``) and counts inner iterations
  (``callback_type="pr_norm"``); each row says so in ``solver``.

    python examples/thinning_oracle_torch.py --matrix orsirr_like150 --seed-k 2 \\
        --alphas 0.95,0.98 --fracs 0,0.1,0.2,0.3,0.4,0.5,0.6 [--gmres] [--device cpu]

The env lives on the CUDA card unless ``--device cpu``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

GMRES_RESTART = 20   # scipy's default restart (the JAX launcher passes None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--matrix", default="orsirr_like150")
    p.add_argument("--seed-k", type=int, default=2, dest="seed_k")
    p.add_argument("--alphas", default="0.95,0.98")
    p.add_argument("--fracs", default="0,0.1,0.2,0.3,0.4,0.5,0.6")
    solver = p.add_mutually_exclusive_group()
    solver.add_argument("--gmres", action="store_true",
                        help=f"also run scipy GMRES({GMRES_RESTART}) per fraction, "
                             "counting inner iterations (slow)")
    solver.add_argument("--cg", action="store_true",
                        help="also run scipy CG per fraction (SPD matrices)")
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from gflownet_spai_tpu_torch import resolve_device
    from gflownet_spai_tpu_torch.env import ilu, spai
    from gflownet_spai_tpu_torch.sparse import gallery
    from gflownet_spai_tpu_torch.sparse.types import COO

    device = resolve_device(args.device)
    a = gallery.get(args.matrix)
    t0 = time.time()
    seed = ilu.seed_pattern(a, method="spai", k=args.seed_k)
    print(f"seed: classic SPAI k={args.seed_k}, nnz {seed.nnz} "
          f"({seed.nnz / a.nnz:.2f}x nnz(A)={a.nnz}) "
          f"built in {time.time() - t0:.1f}s", flush=True)

    a64 = COO(row=a.row, col=a.col, data=a.data.astype(np.float64), shape=a.shape)
    m_row, m_col = seed.row, seed.col
    m_val = seed.data.astype(np.float64)
    env = spai.make_env(COO(row=m_row, col=m_col, data=m_val, shape=seed.shape),
                        original=a64, baseline="identity", device=device)
    n = a.shape[0]
    A = sp.csr_matrix((a64.data, (a64.row, a64.col)), shape=a.shape)
    order = np.argsort(np.abs(m_val))  # smallest first = demo deletion order
    alphas = [float(x) for x in args.alphas.split(",") if x]
    fracs = [float(x) for x in args.fracs.split(",") if x]
    b = A @ np.ones(n)

    def iters_of(M):
        it = {"n": 0}

        def cb(_):
            it["n"] += 1

        solver = spla.gmres if args.gmres else spla.cg
        kw = (dict(restart=GMRES_RESTART, callback_type="pr_norm") if args.gmres else {})
        x, _ = solver(A, b, rtol=args.rtol, maxiter=10260, M=M, callback=cb, **kw)
        return it["n"], np.linalg.norm(b - A @ x) / np.linalg.norm(b)

    rows = []
    for f in fracs:
        kdel = int(f * len(m_val))
        keep = np.ones(len(m_val), bool)
        keep[order[:kdel]] = False
        keep_t = torch.as_tensor(keep, device=device)
        res = float(spai.residual_norm(env, keep_t))
        row = {"frac": f, "nnz": int(keep.sum()), "residual": res,
               "res_ratio": res / float(env.baseline_residual),
               "comp_ratio": float(spai.matrix_flops(env, keep_t)) / env.baseline_flops}
        for al in alphas:
            row[f"reward_a{al}"] = float(spai.reward(env, keep_t, al))
        if args.gmres or args.cg:
            M = sp.csr_matrix((m_val[keep], (m_row[keep], m_col[keep])), shape=a.shape)
            linop = spla.LinearOperator(A.shape, matvec=lambda v, M=M: M @ v)
            row["iters"], row["true_res"] = iters_of(linop)
            row["solver"] = (f"gmres(restart {GMRES_RESTART}), inner iterations"
                             if args.gmres else "cg")
        rows.append(row)
        print(json.dumps(row), flush=True)

    # where does each alpha put the optimum?
    for al in alphas:
        best = max(rows, key=lambda r: r[f"reward_a{al}"])
        print(f"alpha={al}: reward optimum at frac={best['frac']} "
              f"(reward {best[f'reward_a{al}']:.1f})", flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
