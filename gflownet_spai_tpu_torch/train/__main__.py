"""Training CLI: ``python -m gflownet_spai_tpu_torch.train`` (counterpart of
``gflownet_spai_tpu/train/__main__.py``, with the same flags).

Runs on the CUDA card unless ``--platform cpu``.  The flags of the
multi-device slice (``--multihost``, ``--dp-devices``/``--rows-devices``
> 1, ``--sampler sharded``) are accepted and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses

from .config import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gflownet_spai_tpu_torch.train",
        description="Train a GFlowNet to sample SPAI preconditioner patterns.",
    )
    d = TrainConfig()
    p.add_argument("--matrix", default=d.matrix,
                   help="gallery name (LF10_like|bcsstk03_like|olm500_like|poisson32) or .mtx path")
    p.add_argument("--seed-method", default=d.seed_method,
                   choices=["ilu0", "spilu", "pattern", "spai"])
    p.add_argument("--seed-k", type=int, default=d.seed_k, dest="seed_k",
                   help="power-pattern order for --seed-method spai "
                        "(k=2 = A^2 pattern: denser seed, real thinning "
                        "headroom for the policy)")
    p.add_argument("--env-format", default=d.env_format,
                   choices=["auto", "coo", "dia", "rowblock"],
                   help="reward path: coo pair-plan, gather-free dia band, "
                        "or rowblock dense-bucket plan (unstructured)")
    p.add_argument("--rowblock-bf16", action="store_true",
                   dest="rowblock_bf16",
                   help="bf16 G-block storage for the rowblock reward "
                        "(rounded bf16 operands, float32 products and "
                        "sums, ~1e-3 residual noise)")
    p.add_argument("--rowblock-layout", default=d.rowblock_layout,
                   choices=["cm", "mc"], dest="rowblock_layout",
                   help="rowblock G-block layout: cm = [R, cp, mp] "
                        "blocks, mc = [R, mp, cp] (batch as the rows of "
                        "each product)")
    p.add_argument("--rowblock-class-step", type=float,
                   default=d.rowblock_class_step, dest="rowblock_class_step",
                   help="rowblock bucket ladder spacing (1.25 = finer)")
    p.add_argument("--rowblock-compress", default=d.rowblock_compress,
                   choices=["none", "gram"], dest="rowblock_compress",
                   help="gram = quadratic-form residual (4-5x fewer "
                        "FLOPs/bytes, ~1e-3-class precision)")
    p.add_argument("--rowblock-order", default=d.rowblock_order,
                   choices=["sorted", "window"], dest="rowblock_order",
                   help="window = gather-free batched reward (the plan "
                        "defines the edge enumeration; windows become "
                        "static contiguous slices)")
    p.add_argument("--gat-bucket-step", type=float,
                   default=d.gat_bucket_step, dest="gat_bucket_step",
                   help="bucketed fused-GAT slot-width ladder step "
                        "(0 disables bucketing: uniform-S tile layout)")
    p.add_argument("--reference-baseline", action="store_true",
                   help="score against the seed matrix like the reference "
                        "training script (GFlowNet100.py:173) instead of "
                        "the true A")
    p.add_argument("--hidden-dim", type=int, default=d.hidden_dim)
    p.add_argument("--heads", type=int, default=d.heads)
    p.add_argument("--loss", default=d.loss, choices=["tb", "vargrad", "subtb"])
    p.add_argument("--subtb-lambda", type=float, default=d.subtb_lambda,
                   help="λ for --loss subtb (sub-trajectory weight decay)")
    p.add_argument("--backward", default=d.backward,
                   choices=["lstm", "linear", "uniform"],
                   help="backward policy: lstm = reference parity (O(T) "
                        "serial scan), linear = learned gated linear "
                        "recurrence (O(log T) associative scan), uniform = "
                        "closed-form uniform-parent")
    p.add_argument("--replay-size", type=int, default=d.replay_size,
                   help="top-k reward replay buffer capacity (0 = off)")
    p.add_argument("--replay-samples", type=int, default=d.replay_samples,
                   help="replayed trajectories mixed into each epoch's loss")
    p.add_argument("--replay-prioritized", type=float,
                   default=d.replay_prioritized,
                   help="rank-based replay priority exponent α "
                        "(P ∝ (1+rank)^−α; 0 = uniform)")
    p.add_argument("--replay-seed-thinning", default=d.replay_seed_fracs,
                   dest="replay_seed_fracs", metavar="F1,F2,...",
                   help="demonstration-seed the replay buffer with "
                        "magnitude-ordered thinnings at these fractions "
                        "(e.g. 0.1,0.25,0.5) — off-policy-valid anchor "
                        "for deep thinning optima")
    p.add_argument("--warmstart-epochs", type=int,
                   default=d.warmstart_epochs, dest="warmstart_epochs",
                   help="supervised warm-start: this many cross-entropy "
                        "steps on the --replay-seed-thinning demonstration "
                        "trajectories before GFlowNet training")
    p.add_argument("--warmstart-lr", type=float, default=d.warmstart_lr,
                   dest="warmstart_lr",
                   help="Adam lr of the warm-start phase")
    p.add_argument("--temperature", type=float, default=d.temperature,
                   help="rollout sampling temperature (>1 explores)")
    p.add_argument("--edge-feats", action="store_true", dest="edge_feats",
                   help="value-aware action-head channel (one learned "
                        "weight on the log edge magnitude) — makes "
                        "magnitude-ordered thinning directly learnable")
    p.add_argument("--terminal-bias", type=float, default=d.terminal_bias,
                   dest="terminal_bias",
                   help="initial terminal-logit offset: start-short "
                        "curriculum for huge action spaces (~8 at 1M "
                        "actions puts initial trajectory depth ~A*e^-b)")
    p.add_argument("--reward-beta", type=float, default=d.reward_beta,
                   dest="reward_beta",
                   help="reward exponent β: sample P ∝ R^β (>1 sharpens "
                        "toward the reward optimum)")
    p.add_argument("--sampler", default=d.sampler,
                   choices=["dense", "sharded"],
                   help="sharded = rollout's action head, Gumbel top-k and "
                        "per-step log-probs sharded over the rows axis — "
                        "no device materializes [B, A] (parallel.sampler; "
                        "set --rows-devices >= 2)")
    p.add_argument("--t-cap", type=int, default=d.t_cap, dest="t_cap",
                   help="trajectory prefix cap, dense AND sharded "
                        "samplers (0 = num_actions: exact — but the whole "
                        "step then runs on [B, A]-padded trajectories).  "
                        "With --loss subtb, "
                        "truncated rollouts train as PARTIAL trajectories "
                        "(sub-trajectory balance against the learned flow "
                        "at the truncation point) — no zero-weighted "
                        "batches at any cap; tb/vargrad weight-0 them")
    p.add_argument("--t-cap-auto", action="store_true", dest="t_cap_auto",
                   help="adaptive cap ladder: shrink the cap (one "
                        "recompile per level, cached) to next_pow2("
                        "margin*P95(len)) once >=95%% of rollouts "
                        "terminate inside it for a full window")
    p.add_argument("--t-cap-min", type=int, default=d.t_cap_min,
                   dest="t_cap_min")
    p.add_argument("--t-cap-margin", type=float, default=d.t_cap_margin,
                   dest="t_cap_margin")
    p.add_argument("--t-cap-window", type=int, default=d.t_cap_window,
                   dest="t_cap_window")
    p.add_argument("--reward-baseline", default=d.reward_baseline,
                   choices=["auto", "matrix", "identity"],
                   help="residual normalizer: auto = matrix unless "
                        "degenerate for this seed (then identity, with a "
                        "warning), matrix = ||A·A−I||_F (reference "
                        "formula; saturates on unscaled matrices), "
                        "identity = sqrt(n) (the empty-preconditioner "
                        "residual — discriminating for --seed-method spai)")
    p.add_argument("--alpha-fixed", type=float, default=d.alpha_fixed,
                   help=">=0 pins the reward mixing α (0=pure flops, "
                        "1=pure residual); negative = learned (reference)")
    p.add_argument("--batch-size", type=int, default=d.batch_size)
    p.add_argument("--epochs", type=int, default=d.num_epochs, dest="num_epochs")
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--plateau-patience", type=int, default=d.plateau_patience,
                   help="ReduceLROnPlateau patience (reference "
                        "GFlowNet100.py:267); 0 DISABLES the schedule — "
                        "on noisy TB/SubTB objectives the plateau decay "
                        "reaches its 5%% floor within ~100 epochs and "
                        "freezes training (measured on orsirr_like150)")
    p.add_argument("--plateau-factor", type=float, default=d.plateau_factor)
    p.add_argument("--prng-seed", type=int, default=d.prng_seed)
    p.add_argument("--dtype", default=d.dtype)
    p.add_argument("--platform", default=None,
                   help="cpu runs on the CPU; default: the CUDA card")
    p.add_argument("--dp-devices", type=int, default=d.dp_devices,
                   help="data-parallel device count (mesh dp axis)")
    p.add_argument("--rows-devices", type=int, default=d.rows_devices,
                   help="rows-axis device count (shards the reward residual)")
    p.add_argument("--out-dir", default=d.out_dir)
    p.add_argument("--log-every", type=int, default=d.log_every)
    p.add_argument("--checkpoint-every", type=int, default=d.checkpoint_every)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--legacy", action="store_true",
                   help="reference train.py hyperparams (batch 32, lr 1e-3, hidden 32)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process mesh (the multi-device slice; "
                        "raises here)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.multihost:
        raise NotImplementedError(
            "--multihost comes with the multi-device slice of the port")
    base = TrainConfig.legacy() if args.legacy else TrainConfig()
    overrides = {
        k: v for k, v in vars(args).items()
        if k not in ("legacy", "multihost")
        and v != getattr(TrainConfig(), k, None)
    }
    if args.legacy:
        for k in ("batch_size", "lr", "hidden_dim"):
            if vars(args)[k] == getattr(TrainConfig(), k):
                overrides.pop(k, None)
    cfg = dataclasses.replace(base, **overrides)
    if cfg.sampler == "sharded" or cfg.dp_devices > 1 or cfg.rows_devices > 1:
        raise NotImplementedError(
            "--sampler sharded and --dp-devices/--rows-devices > 1 come with "
            "the multi-device slice of the port")
    from .loop import device_of, train

    print(f"config: {cfg}")
    print(f"device: {device_of(cfg)}")
    _, history = train(cfg)
    print(f"final loss: {history[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
