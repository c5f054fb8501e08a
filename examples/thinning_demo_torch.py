"""The thinning demonstration on the PyTorch/CUDA port: the recipe of
``examples/thinning_demo.py`` with its flags unchanged, through
``python -m gflownet_spai_tpu_torch.train`` and ``.validate`` on the CUDA
card.

``bcsstk03_like`` with a k = 2 SPAI seed (3,562 edges) runs on the pair
(``coo``) reward env.  The recipe's claim (and the JAX run's acceptance
table, ``runs/thin_bcsstk03_l1_val/validation.json``): a sampled SPAI with
at least 10% fewer nonzeros than classic SPAI at no more CG iterations.
The port draws from torch's PRNG, so the claim is the target, not the JAX
run's exact counts.

Usage:

    python examples/thinning_demo_torch.py [epochs=4000]

Writes ``runs/torch_thinning_demo`` (metrics, checkpoints) and
``runs/torch_thinning_demo_val/validation.json``.
"""

import subprocess
import sys


def main():
    epochs = sys.argv[1] if len(sys.argv) > 1 else "4000"
    run = "runs/torch_thinning_demo"
    common = [
        "--matrix", "bcsstk03_like", "--seed-method", "spai", "--seed-k", "2",
        "--reward-baseline", "identity",
        "--loss", "subtb", "--subtb-lambda", "1.0", "--backward", "linear",
        "--replay-size", "32", "--replay-samples", "4",
        "--replay-prioritized", "1.0",
        "--alpha-fixed", "0.98", "--lr", "1e-3", "--plateau-patience", "0",
        "--reward-beta", "50", "--edge-feats",
        "--replay-seed-thinning", "0.4,0.5,0.6",
    ]
    train = [sys.executable, "-m", "gflownet_spai_tpu_torch.train", *common,
             "--warmstart-epochs", "6000",
             "--epochs", epochs, "--batch-size", "16",
             "--checkpoint-every", "1000", "--log-every", "100",
             "--out-dir", run]
    validate = [sys.executable, "-m", "gflownet_spai_tpu_torch.validate", *common,
                "--method", "cg", "--classic-k", "2",
                "--from-checkpoint", run, "--final-samples", "256",
                "--out-dir", run + "_val"]
    print("+", " ".join(train), flush=True)
    subprocess.run(train, check=True)
    print("+", " ".join(validate), flush=True)
    subprocess.run(validate, check=True)


if __name__ == "__main__":
    main()
