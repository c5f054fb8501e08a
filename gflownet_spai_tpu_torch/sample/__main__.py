"""Sampling CLI: ``python -m gflownet_spai_tpu_torch.sample`` (counterpart of
``gflownet_spai_tpu/sample/__main__.py``, with the same flags).

Restores a trained checkpoint from ``--run-dir``, draws N trajectories,
reports the reward distribution (printed and written to
``<run-dir>/sample_summary.json``), and optionally writes the best sampled
preconditioner as a ``.mtx``.  Runs on the CUDA card unless
``--platform cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gflownet_spai_tpu_torch.sample")
    p.add_argument("--run-dir", required=True,
                   help="training out-dir containing checkpoint/")
    p.add_argument("--matrix", default="LF10_like")
    p.add_argument("--seed-method", default="ilu0")
    p.add_argument("--seed-k", type=int, default=1, dest="seed_k")
    p.add_argument("--env-format", default="auto")
    p.add_argument("--hidden-dim", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    # flags that change the checkpoint's parameters or action ids: they
    # must match the training run
    p.add_argument("--loss", default="tb", choices=["tb", "vargrad", "subtb"])
    p.add_argument("--backward", default="lstm",
                   choices=["lstm", "linear", "uniform"])
    p.add_argument("--edge-feats", action="store_true", dest="edge_feats")
    p.add_argument("--t-cap", type=int, default=0, dest="t_cap")
    p.add_argument("--rowblock-order", default="window",
                   choices=["sorted", "window"])
    p.add_argument("--reward-baseline", default="auto",
                   choices=["auto", "matrix", "identity"])
    p.add_argument("--replay-size", type=int, default=0,
                   help="must match the training run (the replay buffer is "
                        "part of the checkpointed state)")
    p.add_argument("--alpha-fixed", type=float, default=-1.0,
                   help="pin the reward mix (match the training run; "
                        "<0 = learned alpha)")
    p.add_argument("--plateau-patience", type=int, default=10,
                   help="must match the training run (0 disables the "
                        "plateau LR rule, which changes the optimizer state)")
    p.add_argument("--num-samples", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--prng-seed", type=int, default=0)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU; default: the CUDA card")
    p.add_argument("--export-mtx", default=None,
                   help="write the best sampled M to this .mtx path")
    args = p.parse_args(argv)

    import torch

    from ..gfn import gflownet as gfn
    from ..solvers.validate import best_sampled_matrix
    from ..sparse import write_mtx
    from ..sparse.types import to_numpy
    from ..train import TrainConfig, restore_checkpoint, setup
    from ..train.enums import reconcile

    cfg = TrainConfig(
        matrix=args.matrix, seed_method=args.seed_method, seed_k=args.seed_k,
        env_format=args.env_format, hidden_dim=args.hidden_dim,
        heads=args.heads, out_dir=args.run_dir, prng_seed=args.prng_seed,
        loss=args.loss, backward=args.backward, edge_feats=args.edge_feats,
        t_cap=args.t_cap, rowblock_order=args.rowblock_order,
        reward_baseline=args.reward_baseline, replay_size=args.replay_size,
        plateau_patience=args.plateau_patience, alpha_fixed=args.alpha_fixed,
        platform=args.platform,
    )
    a, seed, env, graph, mcfg, opt, state = setup(cfg)
    restored = restore_checkpoint(args.run_dir, state)
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.run_dir}/checkpoint")
    state, _ = reconcile(args.run_dir, env, restored, backward=cfg.backward)
    print(f"restored epoch {int(state.epoch)}; sampling {args.num_samples} "
          f"trajectories on {env.num_actions - 1} edges")

    gen = torch.Generator(device=state.generator.device).manual_seed(
        args.prng_seed + 7)
    best_r = -np.inf
    best_actions = None
    all_r, all_len = [], []
    remaining = args.num_samples
    with torch.no_grad():
        while remaining > 0:
            b = min(args.batch_size, remaining)   # only the first b count
            out = gfn.sample(state.params, env, graph, mcfg, gen, args.batch_size)
            r = to_numpy(out.rewards)[:b]
            all_r.append(r)
            all_len.append(to_numpy(out.rollout.lengths)[:b])
            i = int(np.argmax(r))
            if r[i] > best_r:
                best_r = float(r[i])
                best_actions = out.rollout.actions[i]
            remaining -= b
    r = np.concatenate(all_r)
    lens = np.concatenate(all_len)
    summary = {
        "samples": int(len(r)),
        "reward_mean": float(r.mean()),
        "reward_p50": float(np.median(r)),
        "reward_p95": float(np.percentile(r, 95)),
        "reward_max": float(r.max()),
        "mean_len": float(lens.mean()),
        "alpha": (float(args.alpha_fixed) if args.alpha_fixed >= 0 else
                  float(torch.sigmoid(state.params.forward.alpha))),
    }
    print(json.dumps(summary, indent=2))
    (Path(args.run_dir) / "sample_summary.json").write_text(json.dumps(summary))

    if args.export_mtx:
        m = best_sampled_matrix(env, best_actions[None, :],
                                torch.tensor([best_r]))
        write_mtx(args.export_mtx, m, comment=" best GFlowNet-sampled SPAI")
        print(f"wrote best M (reward {best_r:.1f}) to {args.export_mtx}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
