"""End-to-end SPAI pipeline on the PyTorch port (counterpart of
``examples/spai_pipeline.py``): load or generate a matrix, build the ILU
seed pattern, train the GFlowNet, draw 512 preconditioners with the
trained policy, take the best, and compare GMRES with none, ILU(0) and the
sampled SPAI — the reference workflow (GFlowNet100.py) in library calls.

    python examples/spai_pipeline_torch.py [--matrix olm500_like] [--epochs 150]
        [--device cpu]

Trains on the CUDA card unless ``--device cpu``; writes ``runs/torch_example``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gflownet_spai_tpu_torch import resolve_device  # noqa: E402
from gflownet_spai_tpu_torch.env import ilu0  # noqa: E402
from gflownet_spai_tpu_torch.gfn import gflownet as gfn  # noqa: E402
from gflownet_spai_tpu_torch.solvers import ilu_solve_op, solve_with_gmres, spai_op  # noqa: E402
from gflownet_spai_tpu_torch.solvers.validate import best_sampled_matrix  # noqa: E402
from gflownet_spai_tpu_torch.train import TrainConfig, setup, train  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default="olm500_like")
    ap.add_argument("--epochs", type=int, default=150)
    ap.add_argument("--out-dir", default="runs/torch_example")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = TrainConfig(matrix=args.matrix, num_epochs=args.epochs, batch_size=16,
                      lr=5e-3, out_dir=args.out_dir,
                      platform="cpu" if device.type == "cpu" else None)
    state, _ = train(cfg, progress=True)

    # re-create the env and draw a big sample with the trained policy
    a, _, env, graph, mcfg, _, _ = setup(cfg)
    gen = torch.Generator(device=device).manual_seed(99)
    with torch.no_grad():
        out = gfn.sample(state.params, env, graph, mcfg, gen, batch_size=512)
    m = best_sampled_matrix(env, out.rollout.actions, out.rewards)
    print(f"best sampled reward: {float(out.rewards.max()):.1f}")

    ad = a.to(device)
    b = torch.ones((a.shape[0],), dtype=ad.data.dtype, device=device)
    for name, op in [("none", None),
                     ("ilu0", ilu_solve_op(*ilu0(a), device=device)),
                     ("sampled SPAI", spai_op(m.to(device)))]:
        _, _, iters, t = solve_with_gmres(ad, b, op, maxiter=3000)
        print(f"{name:14s} GMRES iters = {iters:5d}  ({t:.2f}s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
