"""Multi-card runs of the port's multi-device layer on one host, one process
per card (NCCL):

1. the port's rank check (``gflownet_spai_tpu_torch.parallel.check``):
   ``halo_spmv`` on poisson1024 split over the cards against each rank's
   whole-matrix K8, and one dp step;
2. the weak-scaling harness (``gflownet_spai_tpu_torch.bench_scaling``,
   262,144 rows a card) on 1, 2, 4, ... cards;
3. ``train`` at ``chip_smoke.py``'s ``[train]`` configuration (orsirr_like150,
   SubTB, linear backward, t_cap 4096, batch 16 + 4 replayed) through the
   sharded sampler on every (dp, rows) factorisation of the cards, and
   through the dp step (dense sampler) on (cards, 1): ms per step from
   rank 0's ``metrics.jsonl`` (the first step includes warm-up).

    python examples/multi_card_torch.py [--cards N] [--epochs 12]

The last line is one JSON object with every reading.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
TRAIN = ["--matrix", "orsirr_like150", "--env-format", "coo", "--loss", "subtb",
         "--backward", "linear", "--t-cap", "4096", "--terminal-bias", "8",
         "--batch-size", "16", "--lr", "2e-3", "--plateau-patience", "0",
         "--replay-size", "32", "--replay-samples", "4", "--replay-prioritized", "1.0",
         "--alpha-fixed", "0.98", "--reward-baseline", "identity", "--log-every", "1"]


def _torchrun(cards: int, module: str, args) -> str:
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node", str(cards), "-m", module, *args],
                          capture_output=True, text=True, cwd=str(REPO), timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{module} {' '.join(args)} exited {proc.returncode}:\n"
                         f"{(proc.stdout + proc.stderr)[-3000:]}")
    return proc.stdout


def _train(cards: int, mesh_args, epochs: int, out: Path) -> dict:
    _torchrun(cards, "gflownet_spai_tpu_torch.train",
              ["--multihost", *mesh_args, *TRAIN, "--epochs", str(epochs),
               "--out-dir", str(out)])
    recs = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    wall = [r["wall_s"] * 1e3 for r in recs]
    return {"ms_per_step": wall, "steady_ms": sum(wall[1:]) / max(len(wall) - 1, 1),
            "losses": [r["loss"] for r in recs],
            "valid_frac": [r.get("valid_frac", 1.0) for r in recs]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--cards", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=12)
    args = ap.parse_args(argv)
    cards = args.cards or torch.cuda.device_count()
    if cards < 2:
        raise SystemExit(f"{cards} card(s): a multi-card run needs two or more")
    report = {"cards": cards}
    out = _torchrun(cards, "gflownet_spai_tpu_torch.parallel.check", [])
    report["check"] = [json.loads(x) for x in out.splitlines() if x.startswith('{"rank"')]
    for r in report["check"]:
        print(json.dumps(r), flush=True)
    out = _torchrun(cards, "gflownet_spai_tpu_torch.bench_scaling", ["--multihost"])
    report["bench_scaling"] = [json.loads(x) for x in out.splitlines()
                               if x.startswith("{") and '"devices"' in x]
    for r in report["bench_scaling"]:
        print(json.dumps(r), flush=True)
    meshes = [(d, cards // d) for d in range(1, cards + 1) if cards % d == 0]
    runs = {}
    with tempfile.TemporaryDirectory(prefix="multi_card_") as tmp:
        for dp, rows in meshes:
            key = f"sharded dp {dp} rows {rows}"
            runs[key] = _train(cards, ["--sampler", "sharded", "--dp-devices", str(dp),
                                       "--rows-devices", str(rows)], args.epochs,
                               Path(tmp) / f"sh_{dp}_{rows}")
        runs[f"dp step dp {cards}"] = _train(cards, ["--dp-devices", str(cards)],
                                             args.epochs, Path(tmp) / "dp")
    for key, r in runs.items():
        print(f"[multi-card] {key}: steady ms/step {r['steady_ms']:.3f} (steps "
              f"{', '.join(f'{w:.3f}' for w in r['ms_per_step'])}); losses "
              f"{', '.join(f'{v:.4f}' for v in r['losses'])}", flush=True)
    report["train"] = runs
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
