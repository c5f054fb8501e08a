"""Config 4 on the PyTorch/CUDA port: the nonsymmetric-unstructured
quality recipe of ``examples/config4_orsirr.py`` with its flags unchanged,
through ``python -m gflownet_spai_tpu_torch.train`` and ``.validate`` on
the CUDA card.

``orsirr_like150``'s SPAI seed (112,125 edges) resolves to the rowblock
reward env with the window edge order, and the policy graph to the tiled
layout (the kernels K1-K4).  The target is the JAX run's acceptance table
(``runs/c4id2_orsirr150_val/validation.json``): a sampled SPAI that
converges in as many GMRES iterations as classic SPAI.

Usage:

    python examples/config4_orsirr_torch.py [k=150] [epochs=4000]

Writes ``runs/torch_config4_orsirr<k>`` (metrics, checkpoints) and
``runs/torch_config4_orsirr<k>_val/validation.json``.
"""

import subprocess
import sys


def main():
    k = sys.argv[1] if len(sys.argv) > 1 else "150"
    epochs = sys.argv[2] if len(sys.argv) > 2 else "4000"
    run = f"runs/torch_config4_orsirr{k}"
    common = [
        "--matrix", f"orsirr_like{k}",
        "--seed-method", "spai", "--reward-baseline", "identity",
        "--loss", "subtb", "--backward", "linear",
        "--replay-size", "32", "--replay-samples", "4",
        "--replay-prioritized", "1.0",
        "--alpha-fixed", "0.98", "--lr", "2e-3", "--plateau-patience", "0",
        "--rowblock-order", "window",
    ]
    train = [sys.executable, "-m", "gflownet_spai_tpu_torch.train", *common,
             "--epochs", epochs, "--batch-size", "16",
             "--checkpoint-every", "1000", "--log-every", "100",
             "--out-dir", run]
    validate = [sys.executable, "-m", "gflownet_spai_tpu_torch.validate", *common,
                "--from-checkpoint", run, "--final-samples", "256",
                "--out-dir", run + "_val"]
    print("+", " ".join(train), flush=True)
    subprocess.run(train, check=True)
    print("+", " ".join(validate), flush=True)
    raise SystemExit(subprocess.run(validate).returncode)


if __name__ == "__main__":
    main()
