"""Thinning at scale on the PyTorch port: the deep-thinning recipe of
``examples/thinning_orsirr.py`` with its flags unchanged, through
``python -m gflownet_spai_tpu_torch.train`` and ``.validate`` on the CUDA
card.

orsirr_like150's k = 2 SPAI seed (291,513 entries, 2.60 × nnz(A)) with the
identity baseline, α 0.95, SubTB(1.0), edge features, magnitude-thinning
demonstrations (30-50%) and a 6,000-epoch warm start, t_cap 163,840.  The
target is the JAX run's acceptance table (``VERDICT.md``): sampled SPAI at
no more GMRES iterations than classic k = 2 SPAI with fewer entries.

    python examples/thinning_orsirr_torch.py [k=150] [epochs=3000] [--device cpu]

Writes ``runs/torch_thin_orsirr<k>`` (metrics, checkpoints) and
``runs/torch_thin_orsirr<k>_val/validation.json``.
"""

import argparse
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("k", nargs="?", default="150")
    p.add_argument("epochs", nargs="?", default="3000")
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    run = f"runs/torch_thin_orsirr{args.k}"
    common = [
        "--matrix", f"orsirr_like{args.k}",
        "--seed-method", "spai", "--seed-k", "2",
        "--reward-baseline", "identity",
        "--loss", "subtb", "--subtb-lambda", "1.0", "--backward", "linear",
        "--replay-size", "32", "--replay-samples", "4",
        "--replay-prioritized", "1.0",
        "--alpha-fixed", "0.95", "--lr", "1e-3", "--plateau-patience", "0",
        "--reward-beta", "50", "--edge-feats",
        "--replay-seed-thinning", "0.3,0.4,0.5",
        "--t-cap", "163840",
    ]
    platform = ["--platform", "cpu"] if args.device == "cpu" else []
    train = [sys.executable, "-m", "gflownet_spai_tpu_torch.train", *common,
             "--warmstart-epochs", "6000",
             "--epochs", args.epochs, "--batch-size", "16",
             "--checkpoint-every", "500", "--log-every", "50",
             "--out-dir", run, *platform]
    validate = [sys.executable, "-m", "gflownet_spai_tpu_torch.validate", *common,
                "--classic-k", "2", "--wall-repeats", "3",
                "--from-checkpoint", run, "--final-samples", "128",
                "--out-dir", run + "_val", *platform]
    print("+", " ".join(train), flush=True)
    subprocess.run(train, check=True)
    print("+", " ".join(validate), flush=True)
    subprocess.run(validate, check=True)


if __name__ == "__main__":
    main()
