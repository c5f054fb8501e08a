"""Validation CLI: ``python -m gflownet_spai_tpu_torch.validate``."""
