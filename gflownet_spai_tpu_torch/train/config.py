"""Training configuration (counterpart of
``gflownet_spai_tpu/train/config.py``: the same fields and defaults).

The reference has no config system; this dataclass collects its knobs with
the reference training script's defaults (batch 2, 1000 epochs, lr 5e-4,
Adam + ReduceLROnPlateau(0.2, 10), reward scale 1000, GMRES maxiter 10260).
Fields of the multi-device path (the sharded sampler, ``dp_devices`` /
``rows_devices`` > 1, the adaptive ``t_cap`` ladder) keep their names and
defaults; the port raises where it would need them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # data
    matrix: str = "LF10_like"       # gallery name or path to a .mtx file
    seed_method: str = "ilu0"       # ilu0 | spilu | pattern | spai
    seed_k: int = 1                 # power-pattern order for seed_method=spai
    reference_baseline: bool = False  # True → original_matrix = seed
    env_format: str = "auto"        # auto | coo | dia | rowblock
    dia_max_diags: int = 64         # "auto" considers dia up to this band count
    rowblock_min_nnz: int = 10000   # "auto" picks rowblock above this seed nnz
                                    # when dia does not apply
    rowblock_bf16: bool = False     # bf16 G-block storage (rowblock only)
    rowblock_layout: str = "cm"     # G-block axis order: cm | mc
    rowblock_class_step: float = 1.5  # rowblock bucket ladder spacing
    rowblock_compress: str = "none" # none | gram
    rowblock_order: str = "window"  # window | sorted (rowblock edge order)
    gat_tiled_min_edges: int = 100000  # the policy graph takes the node-tile
                                    # layout (kernels K1, K3) at or above
                                    # this edge count
    gat_bucket_step: float = 1.5    # slot-width ladder step of the bucketed
                                    # tile layout; 0 disables bucketing

    # model (reference GFlowNet100.py:180, policy.py:19)
    hidden_dim: int = 4
    heads: int = 4
    loss: str = "tb"                # tb | vargrad | subtb
    subtb_lambda: float = 0.9       # λ for loss="subtb"
    backward: str = "lstm"          # lstm (parity) | linear | uniform
    reward_beta: float = 1.0        # reward exponent β: sample P ∝ R^β
    edge_feats: bool = False        # value-aware action-head channel
    terminal_bias: float = 0.0      # initial terminal-logit offset
    temperature: float = 1.0        # rollout sampling temperature
    alpha_fixed: float = -1.0       # >=0 pins reward-mix α (else learned)
    reward_baseline: str = "auto"   # auto | matrix | identity
                                    # (env.spai.resolve_baseline)
    replay_size: int = 0            # top-k reward replay buffer (0 = off)
    replay_samples: int = 2         # buffer trajectories mixed per epoch
    replay_prioritized: float = 0.0 # rank-based replay priority exponent
    replay_seed_fracs: str = ""     # magnitude-thinning demonstrations
    warmstart_epochs: int = 0       # supervised warm-start steps
    warmstart_lr: float = 5e-3      # Adam lr of the warm-start phase
    sampler: str = "dense"          # dense | sharded
    t_cap: int = 0                  # trajectory prefix cap (0 = num_actions)
    t_cap_auto: bool = False        # adaptive cap ladder
    t_cap_min: int = 256            # adaptive-cap floor
    t_cap_margin: float = 4.0       # headroom factor over P95(len)
    t_cap_window: int = 20          # epochs of history per ladder decision

    # optimization (reference GFlowNet100.py:32-34, 266-267)
    batch_size: int = 2
    num_epochs: int = 1000
    lr: float = 5e-4
    plateau_factor: float = 0.2
    plateau_patience: int = 10

    # runtime
    prng_seed: int = 0
    dtype: str = "float32"
    platform: Optional[str] = None   # None → CUDA (raises without a card);
                                     # "cpu" runs on the CPU
    dp_devices: int = 1              # data-parallel mesh size
    rows_devices: int = 1            # rows-axis mesh size

    # outputs (CSV schema parity with GFlowNet100.py:226-255)
    out_dir: str = "runs/default"
    log_every: int = 10
    checkpoint_every: int = 0        # 0 = only at the end
    resume: bool = False

    # validation
    gmres_maxiter: int = 10260       # reference GFlowNet100.py:81
    gmres_restart: int = 20          # scipy default (reference passes none)

    @classmethod
    def legacy(cls, **kw) -> "TrainConfig":
        """The reference train.py variant (train.py:18,54-56)."""
        return cls(batch_size=32, lr=1e-3, hidden_dim=32, **kw)
