"""Configuration and host-side setup of the sampling path."""

from .config import TrainConfig
from .loop import load_matrix, setup

__all__ = ["TrainConfig", "load_matrix", "setup"]
