"""Training: config, host-side setup, the train step, metrics,
checkpointing and the CLI (``python -m gflownet_spai_tpu_torch.train``)."""

from .config import TrainConfig
from .loop import (MetricsWriter, TrainState, load_matrix, make_optimizer,
                   make_train_step, restore_checkpoint, save_checkpoint, setup,
                   train)

__all__ = [
    "TrainConfig", "MetricsWriter", "TrainState", "load_matrix",
    "make_optimizer", "make_train_step", "restore_checkpoint",
    "save_checkpoint", "setup", "train",
]
