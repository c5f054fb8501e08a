"""Toy grid-world GFlowNet on the PyTorch port: the sanity check of
``examples/grid_gfn.py`` (reference grid.py) on the CUDA card.

Trains a small MLP policy with the generic per-step sampler
(``gfn.rollout.scan_rollout``) and the uniform backward policy by
trajectory balance (``torch.optim.Adam``), prints the loss every 100 steps,
then the share of samples that land in the high-reward rings (about 6% at
random) and the milliseconds per step.

    python examples/grid_gfn_torch.py [--device cpu] [--epochs 400]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gflownet_spai_tpu_torch import resolve_device  # noqa: E402
from gflownet_spai_tpu_torch.env import grid as G  # noqa: E402
from gflownet_spai_tpu_torch.gfn.loss import trajectory_balance_loss  # noqa: E402
from gflownet_spai_tpu_torch.gfn.rollout import scan_rollout  # noqa: E402


def init_params(g: G.GridEnv, hidden: int, gen: torch.Generator, device) -> dict:
    """The MLP's weights, drawn on the CPU from ``gen`` (the same on every
    device), as leaf tensors on ``device``."""
    params = {"w1": torch.randn(g.state_dim, hidden, generator=gen) * 0.1,
              "b1": torch.zeros(hidden),
              "w2": torch.randn(hidden, G.NUM_ACTIONS, generator=gen) * 0.1,
              "b2": torch.zeros(G.NUM_ACTIONS),
              "log_z": torch.zeros(())}
    return {k: v.to(device).requires_grad_() for k, v in params.items()}


def policy_logits(g: G.GridEnv, params: dict, idx: torch.Tensor) -> torch.Tensor:
    """[B] cells → [B, 3] logits, illegal actions at -inf."""
    x = torch.nn.functional.one_hot(idx, g.state_dim).to(params["w1"].dtype)
    h = torch.relu(x @ params["w1"] + params["b1"])
    return torch.where(G.mask(g, idx), h @ params["w2"] + params["b2"], float("-inf"))


def rollout(g: G.GridEnv, params: dict, n: int, gen: torch.Generator, max_steps: int):
    """(final cells [n], Rollout) of ``n`` trajectories from cell 0."""
    init = torch.zeros(n, dtype=torch.int64, device=params["w1"].device)
    return scan_rollout(lambda s, t: policy_logits(g, params, s),
                        lambda s, a: G.update(g, s, a), init, gen, G.TERMINATE,
                        max_steps)


def tb_loss(g: G.GridEnv, params: dict, finals: torch.Tensor, rolls) -> torch.Tensor:
    """Trajectory balance with the uniform backward policy: a cell (r, c)
    has binom(r + c, r) paths from the origin, each of probability
    1 / binom under P_B."""
    r, c = (finals // g.size).float(), (finals % g.size).float()
    logbinom = torch.lgamma(r + c + 1) - torch.lgamma(r + 1) - torch.lgamma(c + 1)
    return trajectory_balance_loss(params["log_z"], torch.log(G.reward(g, finals)),
                                   rolls.fwd_logprobs.sum(-1), -logbinom)


def train(size: int = 8, hidden: int = 32, steps: int = 400, batch: int = 64,
          max_steps: int | None = None, lr: float = 5e-3, device=None, seed: int = 0,
          log_every: int = 0):
    """Train the grid GFlowNet: returns (params, losses, wall seconds of the
    steps, synchronised)."""
    device = resolve_device(device)
    g = G.GridEnv(size=size)
    max_steps = max_steps or 2 * size
    params = init_params(g, hidden, torch.Generator().manual_seed(seed), device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    opt = torch.optim.Adam(params.values(), lr=lr)
    losses = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        finals, rolls = rollout(g, params, batch, gen, max_steps)
        loss = tb_loss(g, params, finals, rolls)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
        if log_every and step % log_every == 0:
            print(f"epoch {step}: loss {float(loss):.3f}", flush=True)
    losses = torch.stack(losses).tolist()      # synchronises
    return params, losses, time.perf_counter() - t0


@torch.no_grad()
def band_share(size: int, params: dict, n: int, seed: int = 2,
               max_steps: int | None = None) -> float:
    """Share of ``n`` sampled trajectories that end in a high-reward ring."""
    g = G.GridEnv(size=size)
    gen = torch.Generator(device=params["w1"].device).manual_seed(seed)
    finals, _ = rollout(g, params, n, gen, max_steps or 2 * size)
    return float((G.reward(g, finals) > 0.5).float().mean())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", type=int, default=8)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--device", default=None, help="default: the CUDA card")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    params, _, secs = train(args.size, args.hidden, args.epochs, args.batch,
                            device=device, log_every=100)
    hit = band_share(args.size, params, args.samples)
    print(f"samples in high-reward rings: {hit:.1%} of {args.samples}; "
          f"{1e3 * secs / args.epochs:.3f} ms per step on {device}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
