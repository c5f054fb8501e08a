"""PyTorch/CUDA port of ``gflownet_spai_tpu``.

The module layout and function names follow the JAX package, so each
counterpart is easy to find.  Host-side setup (matrices, seed patterns,
tile layouts, pair plans) runs in numpy/scipy; the hot path runs in
PyTorch on a CUDA device, with the TPU's Pallas kernels replaced by
hand-written CUDA kernels (``csrc/``, built by ``_build``).

Every entry point runs on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` or ``TrainConfig(platform="cpu")``); with no card and no
such request it raises.  On CPU tensors each kernel wrapper computes its
plain PyTorch version.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
