"""Acceptance-harness CLI: ``python -m gflownet_spai_tpu_torch.validate``
(counterpart of ``gflownet_spai_tpu/validate/__main__.py``, with the same
flags, ``validation.json``, table and exit-code rule).

  load matrix → train the GFlowNet (or restore a checkpoint) → the best of
  a final sampling round → GMRES (or CG) with none / ILU / sampled SPAI /
  classic SPAI [/ polynomial Jacobi / Chebyshev / aggregation V-cycle] →
  iteration counts, residuals and timings.

Runs on the CUDA card unless ``--platform cpu``.  The ILU(0) factors keep
float64 on either device.  Exit code 0 iff the
sampled preconditioner needs no more iterations than none and solves the
system (true residual ≤ 100·rtol).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gflownet_spai_tpu_torch.validate")
    p.add_argument("--matrix", default="LF10_like")
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--plateau-patience", type=int, default=10,
                   help="ReduceLROnPlateau patience; 0 disables (must match "
                        "the training run when restoring a checkpoint)")
    p.add_argument("--rowblock-order", default="window",
                   choices=["sorted", "window"],
                   help="edge enumeration of the rowblock reward plan "
                        "(must match the training run when restoring)")
    p.add_argument("--seed-method", default="spai",
                   choices=["ilu0", "spilu", "pattern", "spai"])
    p.add_argument("--gat-bucket-step", type=float, default=1.5,
                   help="bucketed fused-GAT slot-width ladder step "
                        "(0 disables bucketing)")
    p.add_argument("--seed-k", type=int, default=1,
                   help="power-pattern order for --seed-method spai")
    p.add_argument("--method", default="gmres", choices=["gmres", "cg"],
                   help="cg for SPD systems")
    p.add_argument("--maxiter", type=int, default=10260)
    p.add_argument("--restart", type=int, default=20)  # scipy default
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU; default: the CUDA card")
    p.add_argument("--out-dir", default="runs/validate")
    p.add_argument("--alpha-fixed", type=float, default=-1.0)
    p.add_argument("--reward-baseline", default="auto",
                   choices=["auto", "matrix", "identity"])
    p.add_argument("--loss", default="subtb", choices=["tb", "vargrad", "subtb"])
    p.add_argument("--subtb-lambda", type=float, default=0.9)
    p.add_argument("--backward", default="linear",
                   choices=["lstm", "linear", "uniform"])
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--edge-feats", action="store_true", dest="edge_feats")
    p.add_argument("--terminal-bias", type=float, default=0.0, dest="terminal_bias")
    p.add_argument("--reward-beta", type=float, default=1.0, dest="reward_beta")
    p.add_argument("--replay-size", type=int, default=16)
    p.add_argument("--replay-samples", type=int, default=2)
    p.add_argument("--replay-prioritized", type=float, default=1.0)
    p.add_argument("--replay-seed-thinning", default="", dest="replay_seed_fracs",
                   metavar="F1,F2,...")
    p.add_argument("--warmstart-epochs", type=int, default=0, dest="warmstart_epochs")
    p.add_argument("--warmstart-lr", type=float, default=5e-3, dest="warmstart_lr")
    p.add_argument("--t-cap", type=int, default=0, dest="t_cap")
    p.add_argument("--from-checkpoint", default=None, metavar="RUN_DIR",
                   help="restore a trained policy from RUN_DIR/checkpoint and "
                        "skip training")
    p.add_argument("--final-samples", type=int, default=256,
                   help="terminal sampling-round batch for picking the best M")
    p.add_argument("--classic-k", type=int, default=1,
                   help="power-pattern order for the classic-SPAI row")
    p.add_argument("--jacobi-poly", type=int, default=0, metavar="SWEEPS",
                   help="add a polynomial-Jacobi preconditioner row")
    p.add_argument("--chebyshev", type=int, default=0, metavar="DEGREE",
                   help="add a Chebyshev polynomial preconditioner row "
                        "(λmax by power iteration; λmin = λmax/--cheby-lmin-ratio)")
    p.add_argument("--cheby-lmin-ratio", type=float, default=30.0)
    p.add_argument("--vcycle", type=int, default=0, metavar="LEVELS",
                   help="add an aggregation V-cycle preconditioner row with that "
                        "many grid levels (>= 2; solvers.multigrid)")
    p.add_argument("--wall-repeats", type=int, default=1,
                   help="time each solve this many times and report the last "
                        "wall as time_steady_s beside the cold time_s")
    p.add_argument("--vcycle-smoother", default="jacobi",
                   choices=["jacobi", "chebyshev"])
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from ..env import ilu as ilu_mod
    from ..gfn import gflownet as gfn
    from ..ops.dia import coo_to_dia
    from ..solvers import (best_sampled_matrix, chebyshev_op, estimate_lmax,
                           ilu_solve_op, jacobi_sweeps_op, solve_with_cg,
                           solve_with_gmres, spai_classic, spai_op, spai_op_sym)
    from ..solvers.multigrid import vcycle_op
    from ..solvers.validate import true_residual
    from ..train import TrainConfig, make_train_step, restore_checkpoint, setup
    from ..train.loop import device_of

    cfg = TrainConfig(
        matrix=args.matrix, seed_method=args.seed_method, seed_k=args.seed_k,
        batch_size=args.batch_size, num_epochs=args.epochs, lr=args.lr,
        plateau_patience=args.plateau_patience, rowblock_order=args.rowblock_order,
        out_dir=args.out_dir, alpha_fixed=args.alpha_fixed,
        reward_baseline=args.reward_baseline, loss=args.loss,
        subtb_lambda=args.subtb_lambda, backward=args.backward,
        temperature=args.temperature, reward_beta=args.reward_beta,
        terminal_bias=args.terminal_bias, edge_feats=args.edge_feats,
        replay_size=args.replay_size, replay_samples=args.replay_samples,
        replay_prioritized=args.replay_prioritized,
        replay_seed_fracs=args.replay_seed_fracs,
        warmstart_epochs=args.warmstart_epochs, warmstart_lr=args.warmstart_lr,
        t_cap=args.t_cap, gat_bucket_step=args.gat_bucket_step,
        platform=args.platform,
    )
    dev = device_of(cfg)
    a, seed, env, graph, mcfg, opt, state = setup(cfg)
    print(f"matrix {args.matrix}: n={env.n}, seed nnz={env.num_edges}, device {dev}")

    if args.from_checkpoint:
        restored = restore_checkpoint(args.from_checkpoint, state)
        if restored is None:
            raise SystemExit(f"no checkpoint under {args.from_checkpoint}/checkpoint")
        from ..train.enums import reconcile

        state, _ = reconcile(args.from_checkpoint, env, restored,
                             backward=args.backward)
        print(f"restored trained policy at epoch {int(state.epoch)}, "
              "skipping training")
    else:
        if cfg.replay_seed_fracs:
            from ..train.loop import (seed_replay_with_magnitude_thinning,
                                      warmstart_on_demonstrations)

            state = seed_replay_with_magnitude_thinning(
                env, state, cfg,
                alpha=cfg.alpha_fixed if cfg.alpha_fixed >= 0 else 0.5)
            if cfg.warmstart_epochs > 0:
                state = warmstart_on_demonstrations(env, graph, mcfg, state, cfg, opt)
        step = make_train_step(cfg, env, graph, mcfg, opt)
        for epoch in range(args.epochs):
            state, metrics = step(state)
            if epoch % max(1, args.epochs // 5) == 0:
                print(f"  train epoch {epoch}: loss {float(metrics['loss']):.2f} "
                      f"reward {float(metrics['reward_mean']):.1f}")

    # a large final sampling round → the best preconditioner (the reference
    # does a 10^4-sample terminal rollout, GFlowNet100.py:530-532)
    with torch.no_grad():
        out = gfn.sample(state.params, env, graph, mcfg,
                         torch.Generator(device=dev).manual_seed(123),
                         args.final_samples)
    m_best = best_sampled_matrix(env, out.rollout.actions, out.rewards)
    kept = int((m_best.data.abs() > 0).sum())
    print(f"best sampled M: kept {kept}/{env.num_edges} entries, "
          f"reward {float(out.rewards.max()):.1f}")

    ad = a.to(dev)
    b = torch.ones((env.n,), dtype=ad.data.dtype, device=dev)
    if args.method == "cg":
        kw = dict(maxiter=args.maxiter, rtol=args.rtol)
        solve = solve_with_cg
    else:
        kw = dict(maxiter=args.maxiter, restart=args.restart, rtol=args.rtol)
        solve = solve_with_gmres

    def timed_solve(op):
        """(x, res, iters, cold_wall, steady_wall), re-solving
        ``--wall-repeats``−1 extra times."""
        x, res, iters, t = solve(ad, b, op, **kw)
        steady = t
        for _ in range(args.wall_repeats - 1):
            x, res, iters, steady = solve(ad, b, op, **kw)
        return x, res, iters, t, steady

    def wall_fields(t, steady):
        return {"time_s": t, **({"time_steady_s": steady}
                                if args.wall_repeats > 1 else {})}

    def row_of(x, res, iters, t, steady):
        return {"iterations": iters, **wall_fields(t, steady),
                "final_residual": float(res[-1]) if len(res) else None}

    report = {}
    x, *rest = timed_solve(None)
    report["none"] = row_of(x, *rest) | {"true_residual": true_residual(ad, b, x)}

    # the baseline factors always come from ilu0 (spilu drops SuperLU's row
    # permutation: its L·U is a pattern source, not a solve operator)
    L, U = ilu_mod.ilu0(a)
    x, *rest = timed_solve(ilu_solve_op(L, U, device=dev))
    report["ilu"] = row_of(x, *rest) | {"true_residual": true_residual(ad, b, x)}

    # CG needs an SPD preconditioner → symmetrise the SPAI applies; if CG
    # still breaks down (NaN), the row falls back to GMRES and says so
    as_op = spai_op_sym if args.method == "cg" else spai_op

    def solve_row(op):
        x, *rest = timed_solve(op)
        row = row_of(x, *rest) | {"method": args.method}
        fr = row["final_residual"]
        if args.method == "cg" and (fr is None or not np.isfinite(fr)):
            x, res, iters, t = solve_with_gmres(
                ad, b, op, maxiter=args.maxiter, restart=args.restart, rtol=args.rtol)
            row = {"iterations": iters, "time_s": t,
                   "final_residual": float(res[-1]) if len(res) else None,
                   "method": "gmres (CG broke down: indefinite preconditioner)"}
        row["true_residual"] = true_residual(ad, b, x)
        return row

    report["sampled_spai"] = solve_row(as_op(m_best)) | {
        "kept_nnz": kept, "seed_nnz": env.num_edges}

    mc = spai_classic(a, k=args.classic_k, dtype=a.data.dtype, device=dev)
    report["classic_spai"] = solve_row(as_op(mc.to(dev))) | {"nnz": mc.nnz}

    if args.jacobi_poly > 0:
        op = jacobi_sweeps_op(coo_to_dia(a, device=dev), sweeps=args.jacobi_poly)
        report["jacobi_poly"] = solve_row(op) | {"sweeps": args.jacobi_poly}

    if args.chebyshev > 0:
        dd = coo_to_dia(a, device=dev)
        lmax = 1.05 * float(estimate_lmax(dd, iters=30))
        op = chebyshev_op(dd, lmax=lmax, lmin=lmax / args.cheby_lmin_ratio,
                          degree=args.chebyshev)
        report["chebyshev"] = solve_row(op) | {"degree": args.chebyshev,
                                               "lmax_est": lmax}

    if args.vcycle >= 2:
        op = vcycle_op(coo_to_dia(a, device=dev), levels=args.vcycle,
                       smoother=args.vcycle_smoother)
        report["vcycle"] = solve_row(op) | {"levels": args.vcycle,
                                            "smoother": args.vcycle_smoother}

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "validation.json").write_text(json.dumps(report, indent=2))

    print(f"\n{'preconditioner':15s} {'iters':>7s} {'time(s)':>8s} "
          f"{'precond res':>12s} {'true res':>10s}")
    for k, v in report.items():
        fr = v["final_residual"]
        print(f"{k:15s} {v['iterations']:7d} {v['time_s']:8.2f} "
              f"{'-' if fr is None else format(fr, '12.3e')} "
              f"{v['true_residual']:10.3e}")

    # acceptance: no more iterations than unpreconditioned AND a solved
    # system (true residual within 100× the target)
    ok = (report["sampled_spai"]["iterations"] <= report["none"]["iterations"]
          and report["sampled_spai"]["true_residual"] <= 100 * args.rtol)
    print("\nsampled SPAI", "PASS (iters and true residual)"
          if ok else "FAIL (worse than unpreconditioned or unsolved system)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
