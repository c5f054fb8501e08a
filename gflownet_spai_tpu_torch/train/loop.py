"""Host-side setup and the training loop (counterpart of
``gflownet_spai_tpu/train/loop.py``).

``setup`` builds matrix → seed pattern → env → policy graph → model config
→ parameters, optimizer and training state, and returns JAX's 7-tuple
``(a, seed, env, graph, mcfg, opt, state)``.  ``make_train_step`` is one
epoch: replay draw → rollout → reward → loss → gradients → NaN/Inf guard →
Adam (+ plateau decay).  PyTorch runs eagerly, so the step is a plain
function over the state.  Metrics land in the reference's CSV schema plus
a JSONL stream; checkpoints are ``torch.save`` dicts of tensors.

The optimizer reproduces optax's ``adam`` chained with
``contrib.reduce_on_plateau`` (optax 0.2.6): a functional Adam over the
parameter leaves whose state is tensors, so every leaf gets a gradient
(zeros where the loss does not use it, as optax gives) and the state
checkpoints as plain tensors.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..env import ilu, spai, spai_dia
from ..gfn import gflownet as gfn
from ..gfn.gflownet import tree_leaves, tree_replace
from ..gfn.replay import (ReplayBuffer, replay_init, replay_resize,
                          replay_sample, replay_update)
from ..models import policies as pol
from ..ops.dia import coo_to_dia
from ..ops.rcm import n_diagonals
from ..sparse import gallery, read_mtx
from ..sparse.types import COO, to_numpy
from .config import TrainConfig

# ---------------------------------------------------------------------------
# Optimizer: optax.adam, optionally chained with reduce_on_plateau
# ---------------------------------------------------------------------------

class AdamState(NamedTuple):
    count: torch.Tensor   # int32 scalar
    mu: tuple             # first moments, one per leaf
    nu: tuple             # second moments


class PlateauState(NamedTuple):
    scale: torch.Tensor           # params dtype
    best_value: torch.Tensor      # float64
    plateau_count: torch.Tensor   # int32
    cooldown_count: torch.Tensor  # int32
    count: torch.Tensor           # int32, values accumulated so far
    avg_value: torch.Tensor       # float64


class OptState(NamedTuple):
    adam: AdamState
    plateau: Optional[PlateauState] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8), chained with
    ``optax.contrib.reduce_on_plateau(**plateau)`` when ``plateau`` is
    given.  Works on flat lists of leaf tensors (``tree_leaves`` order);
    all arithmetic stays on the leaves' device, with no host sync."""

    lr: float
    plateau: Optional[dict] = None
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, leaves) -> OptState:
        leaves = list(leaves)
        dev = leaves[0].device
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        adam = AdamState(count=i32(0),
                         mu=tuple(torch.zeros_like(x) for x in leaves),
                         nu=tuple(torch.zeros_like(x) for x in leaves))
        plateau = None
        if self.plateau is not None:
            f64 = lambda v: torch.tensor(v, dtype=torch.float64, device=dev)
            plateau = PlateauState(
                scale=torch.tensor(1.0, dtype=leaves[0].dtype, device=dev),
                best_value=f64(float("inf")), plateau_count=i32(0),
                cooldown_count=i32(0), count=i32(0), avg_value=f64(0.0))
        return OptState(adam=adam, plateau=plateau)

    def update(self, grads, state: OptState, value=None):
        """(updates, new state) for gradient leaves ``grads``; ``value`` is
        the loss fed to the plateau rule."""
        b1, b2 = self.b1, self.b2
        st = state.adam
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, st.mu))
        nu = tuple((1 - b2) * g ** 2 + b2 * v for g, v in zip(grads, st.nu))
        count = st.count + 1
        c = count.to(torch.float64)
        bc1 = (1 - b1 ** c).to(grads[0].dtype)
        bc2 = (1 - b2 ** c).to(grads[0].dtype)
        updates = [(-self.lr) * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
                   for m, v in zip(mu, nu)]
        plateau = state.plateau
        if plateau is not None:
            plateau = self._plateau_update(plateau, value)
            updates = [plateau.scale * u for u in updates]
        return updates, OptState(adam=AdamState(count, mu, nu), plateau=plateau)

    def _plateau_update(self, st: PlateauState, value) -> PlateauState:
        """``reduce_on_plateau``'s update, both ``lax.cond`` branches as
        ``torch.where``: average ``accumulation_size`` values, then compare
        the average with ``(1 − rtol)·best − atol``."""
        p = self.plateau
        rtol, atol = p.get("rtol", 1e-4), p.get("atol", 0.0)
        patience, cooldown = p["patience"], p["cooldown"]
        count = st.count + 1
        value = torch.as_tensor(value, device=st.avg_value.device)
        avg = (st.count.to(torch.float64) * st.avg_value
               + value.to(torch.float64)) / count.to(torch.float64)
        improved = avg < (1 - rtol) * st.best_value - atol
        best = torch.where(improved, avg, st.best_value)
        cur = torch.where(improved, torch.zeros_like(st.plateau_count),
                          st.plateau_count + 1)
        in_cooldown = st.cooldown_count > 0
        hit = cur == patience
        zero = torch.zeros_like(cur)
        plateau_count = torch.where(in_cooldown | hit, zero, cur)
        scale = torch.where(
            in_cooldown, st.scale,
            torch.clamp_min(torch.where(hit, st.scale * p["factor"], st.scale),
                            p["min_scale"]))
        cooldown_count = torch.where(
            in_cooldown, st.cooldown_count - 1,
            torch.where(hit, torch.full_like(cur, cooldown), zero))
        due = count == p["accumulation_size"]
        keep = lambda new, old: torch.where(due, new, old)
        return PlateauState(
            scale=keep(scale, st.scale), best_value=keep(best, st.best_value),
            plateau_count=keep(plateau_count, st.plateau_count),
            cooldown_count=keep(cooldown_count, st.cooldown_count),
            count=keep(zero, count),
            avg_value=keep(torch.zeros_like(avg), avg))


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    """Adam + plateau LR decay (reference GFlowNet100.py:266-267), as the
    JAX package configures it: the plateau rule averages ``patience``
    epochs before comparing, cools down as long, and floors the decay at
    5% of the base LR.  ``plateau_patience=0`` disables the schedule."""
    if cfg.plateau_patience <= 0:
        return Optimizer(lr=cfg.lr)
    return Optimizer(lr=cfg.lr, plateau=dict(
        factor=cfg.plateau_factor, patience=cfg.plateau_patience,
        cooldown=cfg.plateau_patience,
        accumulation_size=max(1, cfg.plateau_patience), min_scale=0.05))


def apply_updates(params, updates):
    """``params`` tree plus the flat ``updates`` list."""
    leaves = [p + u for (_, p), u in zip(tree_leaves(params), updates)]
    return tree_replace(params, iter(leaves))


# ---------------------------------------------------------------------------
# Setup
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: gfn.GFlowNetParams
    opt_state: OptState
    generator: torch.Generator   # on the run's device: replay draws, noise
    epoch: int
    replay: Optional[ReplayBuffer] = None   # top-k buffer (replay_size > 0)


def load_matrix(cfg: TrainConfig) -> COO:
    """A gallery name (fixed names and the parametric families) or a path
    to a ``.mtx`` file."""
    try:
        return gallery.get(cfg.matrix)
    except KeyError:
        pass
    if not Path(cfg.matrix).exists():
        raise FileNotFoundError(
            f"matrix {cfg.matrix!r}: not a gallery name "
            f"({', '.join(sorted(gallery.GALLERY))}, poisson<k>, convdiff<n>) "
            f"and no such .mtx file")
    return read_mtx(cfg.matrix)


def device_of(cfg: TrainConfig) -> torch.device:
    """``platform=None`` → CUDA (raises without a card); ``"cpu"`` → CPU."""
    if cfg.platform in (None, "cuda", "gpu"):
        return resolve_device(None)
    if cfg.platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {cfg.platform!r}")


def resolve_env_format(cfg: TrainConfig, a: COO, seed: COO) -> str:
    """``auto`` as the JAX package resolves it: banded patterns with fully
    dense diagonals → ``dia``; otherwise seeds of ``rowblock_min_nnz``
    nonzeros or more → ``rowblock``; else ``coo``."""
    fmt = cfg.env_format
    if fmt != "auto":
        return fmt
    fmt = "coo"
    if (not cfg.reference_baseline
            and n_diagonals(seed) <= cfg.dia_max_diags
            and n_diagonals(a) <= cfg.dia_max_diags
            and spai_dia.has_phantom_slots(coo_to_dia(seed, device="cpu")) == 0):
        fmt = "dia"
    if fmt == "coo" and seed.nnz >= cfg.rowblock_min_nnz:
        fmt = "rowblock"
    return fmt


def setup(cfg: TrainConfig):
    """Host-side setup.  Returns ``(a, seed, env, graph, mcfg, opt,
    state)``: ``a`` and ``seed`` as host (numpy) COO matrices; the env,
    graph, parameters and training state on the device ``cfg.platform``
    selects."""
    device = device_of(cfg)
    dtype = np.dtype(cfg.dtype)
    a = load_matrix(cfg)
    a = COO(row=a.row, col=a.col, data=a.data.astype(dtype), shape=a.shape)
    seed = ilu.seed_pattern(a, method=cfg.seed_method, dtype=dtype,
                            **({"k": cfg.seed_k}
                               if cfg.seed_method == "spai" else {}))
    fmt = resolve_env_format(cfg, a, seed)
    if fmt not in ("coo", "dia", "rowblock"):
        raise ValueError(f"unknown env_format {cfg.env_format!r}")
    if cfg.sampler not in ("dense", "sharded"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")

    def _graph(edges):
        # the node-tile layout (kernels K1-K4) at scale; the GAT ignores
        # edge ids, only the action head maps to them
        if edges.nnz >= cfg.gat_tiled_min_edges:
            bstep = cfg.gat_bucket_step or None
            if bstep and cfg.sampler == "sharded":
                # the tile-sharded forward takes the uniform layout only
                print("gat buckets: disabled under the sharded sampler "
                      "(uniform tile layout)", flush=True)
                bstep = None
            return pol.tiled_graph_from_seed(edges, bucket_step=bstep, device=device)
        return pol.graph_from_seed(edges, device=device)

    if fmt == "dia":
        env = spai_dia.make_dia_env(seed, a, baseline=cfg.reward_baseline,
                                    device=device)
        # edge / action ids follow the DIA enumeration, so the graph does
        graph = _graph(spai_dia.edge_coo(env))
    else:
        env = spai.make_env(
            seed, original=None if cfg.reference_baseline else a,
            reward_path="rowblock" if fmt == "rowblock" else "pair",
            baseline=cfg.reward_baseline, device=device,
            rowblock_dtype=torch.bfloat16 if cfg.rowblock_bf16 else None,
            rowblock_layout=cfg.rowblock_layout,
            rowblock_class_step=cfg.rowblock_class_step,
            rowblock_compress=cfg.rowblock_compress,
            rowblock_order=cfg.rowblock_order)
        # a window-order plan defines the edge enumeration: the returned
        # seed and the graph follow the env's
        if env.rb is not None and env.rb.edge_perm is not None:
            seed = env.seed.numpy()
        graph = _graph(seed)
    mcfg = gfn.GFlowNetConfig(
        hidden_dim=cfg.hidden_dim, heads=cfg.heads,
        num_actions=env.num_actions, loss=cfg.loss,
        temperature=cfg.temperature, alpha_fixed=cfg.alpha_fixed,
        subtb_lambda=cfg.subtb_lambda, backward=cfg.backward,
        reward_beta=cfg.reward_beta, terminal_bias=cfg.terminal_bias,
        edge_feats=cfg.edge_feats,
        # the dense sampler's cap; the sharded sampler takes its own
        t_cap=min(cfg.t_cap if cfg.sampler == "dense" and cfg.t_cap > 0 else 0,
                  env.num_actions),
    )
    tdtype = getattr(torch, cfg.dtype)
    params = gfn.init_params(torch.Generator().manual_seed(cfg.prng_seed), mcfg,
                             dtype=tdtype, device=device)
    opt = make_optimizer(cfg)
    # the replay width follows t_cap (the rollouts' width), as in JAX
    traj_w = (min(cfg.t_cap, env.num_actions) if cfg.t_cap > 0 else 0) \
        or env.num_actions
    state = TrainState(
        params=params,
        opt_state=opt.init(x for _, x in tree_leaves(params)),
        generator=torch.Generator(device=device).manual_seed(cfg.prng_seed + 1),
        epoch=0,
        replay=(replay_init(cfg.replay_size, traj_w, tdtype, device=device)
                if cfg.replay_size > 0 else None),
    )
    return a, seed, env, graph, mcfg, opt, state


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: TrainConfig, env, graph, mcfg, opt: Optimizer):
    """One epoch: ``step(state) -> (new_state, metrics)``.  A non-finite
    loss gives zero gradients (Adam still decays its moments and counts
    the step) and feeds ``inf`` to the plateau rule, as the JAX step does
    (the reference skips the epoch, GFlowNet100.py:307-309).  Metrics stay
    on the device; the caller reads them."""
    use_replay = cfg.replay_size > 0

    def step(state: TrainState):
        gen = state.generator
        replay_arg = None
        if use_replay:
            r_actions, _, r_valid = replay_sample(
                state.replay, gen, cfg.replay_samples,
                prioritized=cfg.replay_prioritized)
            replay_arg = (r_actions, r_valid)
        leaves = [x.detach().requires_grad_(True)
                  for _, x in tree_leaves(state.params)]
        params = tree_replace(state.params, iter(leaves))
        loss, aux = gfn.loss_fn(params, env, graph, mcfg, gen, cfg.batch_size,
                                replay=replay_arg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            loss = loss.detach()
            good = torch.isfinite(loss)
            grads = [torch.zeros_like(p) if g is None
                     else torch.where(good, g, torch.zeros_like(g))
                     for p, g in zip(leaves, grads)]
            updates, opt_state = opt.update(
                grads, state.opt_state,
                value=torch.where(good, loss, torch.full_like(loss, float("inf"))))
            new_params = apply_updates(
                tree_replace(state.params, (x.detach() for x in leaves)), updates)
            rewards = aux["rewards"].detach()
            new_replay = state.replay
            if use_replay:
                new_replay = replay_update(state.replay, aux["actions"], rewards)
            metrics = {
                "loss": loss,
                "reward_mean": rewards.mean(),
                "reward_max": rewards.max(),
                "alpha": aux["alpha"].detach(),
                "log_z": new_params.log_z,
                "mean_len": aux["lengths"].to(torch.float32).mean(),
                "lengths": aux["lengths"],
                "rewards": rewards,
                "skipped": ~good,
            }
        return TrainState(params=new_params, opt_state=opt_state, generator=gen,
                          epoch=state.epoch + 1, replay=new_replay), metrics

    return step


def _step_seed(state: TrainState) -> int:
    """One seed per step from the run's generator (the same on every rank:
    the state is replicated), from which the steps seed their shards'
    generators."""
    gen = state.generator
    return int(torch.randint(0, 2**62, (1,), generator=gen, device=gen.device))


def _metrics(mcfg, params, loss, rewards, lengths, **extra) -> dict:
    """The adapters' metrics; ``alpha`` is the reward mix the reward used
    (a fixed α never reads the learned logit)."""
    alpha = (torch.tensor(mcfg.alpha_fixed, dtype=torch.float32)
             if mcfg.alpha_fixed >= 0 else torch.sigmoid(params.forward.alpha))
    return {"loss": loss, "reward_mean": rewards.mean(), "reward_max": rewards.max(),
            "alpha": alpha, "log_z": params.log_z,
            "mean_len": lengths.to(torch.float32).mean(), "lengths": lengths,
            "rewards": rewards, "skipped": ~torch.isfinite(loss), **extra}


def _mesh(cfg: TrainConfig):
    from ..parallel import make_mesh

    return make_mesh(dp=cfg.dp_devices, rows=cfg.rows_devices, device=device_of(cfg))


def _make_dp_step_adapter(cfg: TrainConfig, env, graph, mcfg, opt, mesh=None):
    """The mesh-parallel step (``parallel.dp``) in the single-device step's
    interface.  Every rank holds the same state; the step's outputs are
    gathered over ``dp``."""
    from ..parallel import make_dp_train_step

    use_replay = cfg.replay_size > 0
    dp_step, _ = make_dp_train_step(
        mesh or _mesh(cfg), env, graph, mcfg, opt, batch_size=cfg.batch_size,
        replay_samples=cfg.replay_samples if use_replay else 0)

    def step(state: TrainState):
        if use_replay and state.replay.actions.shape[1] != mcfg.num_actions:
            # the dp step rolls out whole trajectories ([b, num_actions]),
            # whatever t_cap sized the buffer (JAX's adapter fails there)
            state = state._replace(replay=replay_resize(state.replay, mcfg.num_actions))
        replay_arg = ()
        if use_replay:
            r_actions, _, r_valid = replay_sample(
                state.replay, state.generator, cfg.replay_samples,
                prioritized=cfg.replay_prioritized)
            replay_arg = (r_actions, r_valid)
        params, opt_state, loss, rewards, actions = dp_step(
            state.params, state.opt_state, _step_seed(state), *replay_arg)
        new_replay = state.replay
        if use_replay:
            new_replay = replay_update(state.replay, actions, rewards)
        # the dp step reports no lengths (as JAX's adapter): zeros
        metrics = _metrics(mcfg, params, loss, rewards,
                           torch.zeros_like(rewards, dtype=torch.int64))
        return TrainState(params=params, opt_state=opt_state, generator=state.generator,
                          epoch=state.epoch + 1, replay=new_replay), metrics

    return step


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


class CapLadder:
    """Adaptive ``t_cap`` schedule of the sharded sampler (decisions only;
    the adapter rebuilds the step).  ``observe(lengths, valid)`` returns
    the new cap when it changes, else None:

    * SHRINK once ≥95% of rollouts terminated inside the cap for ``window``
      straight epochs and ``next_pow2(margin · max-window-P95)`` lies
      strictly below it;
    * GROW back ×2 (never past the starting cap) when the window-mean
      termination rate falls below 50% at a shrunken cap.

    History resets after any change.  The sharded step gathers ``lengths``
    and ``valid`` over ``dp``, so every rank observes the same statistics
    and changes the cap at the same epoch."""

    def __init__(self, cap: int, cap_min: int, margin: float, window: int):
        self.cap = cap
        self.cap0 = cap
        self.cap_min = cap_min
        self.margin = margin
        self.window = window
        self._p95: list = []
        self._term: list = []

    def observe(self, lengths, valid):
        self._p95.append(float(np.percentile(to_numpy(lengths), 95)))
        self._term.append(float(np.mean(to_numpy(valid))))
        if len(self._p95) < self.window:
            return None
        self._p95 = self._p95[-self.window:]
        self._term = self._term[-self.window:]
        term_mean = float(np.mean(self._term))
        if term_mean < 0.5 and self.cap < self.cap0:
            self.cap = min(self.cap0, 2 * self.cap)
            self._p95, self._term = [], []
            return self.cap
        if min(self._term) < 0.95:
            return None
        want = max(self.cap_min, _next_pow2(int(self.margin * max(self._p95))))
        if want >= self.cap:
            return None
        self.cap = want
        self._p95, self._term = [], []
        return want


def _make_sharded_sampler_adapter(cfg: TrainConfig, env, graph, mcfg, opt, mesh=None):
    """The sharded-sampler step (``parallel.sampler``) in the single-device
    step's interface; returns ``(step, transform)``.  ``transform(state)``
    cuts the forward head to the rank's column slice and re-initialises the
    optimizer state on the sharded parameters (a resumed checkpoint keeps
    its parameters, not its Adam moments); with replay it keeps the buffer,
    resized to the sampler's ``t_cap`` width, and adopts a narrower stored
    width as the ladder's cap.  ``cfg.t_cap_auto`` arms the cap ladder
    (``CapLadder``), which rebuilds the step at each new cap."""
    from ..parallel import shard_head
    from ..parallel.sampler import make_sharded_sampler_train_step

    mesh = mesh or _mesh(cfg)
    t_cap0 = cfg.t_cap or mcfg.num_actions
    use_replay = cfg.replay_size > 0

    def build(cap: int):
        return make_sharded_sampler_train_step(
            mesh, env, graph, mcfg, opt, batch_size=cfg.batch_size, t_cap=cap,
            replay_samples=cfg.replay_samples if use_replay else 0)[0]

    ladder = CapLadder(t_cap0, cfg.t_cap_min, cfg.t_cap_margin, cfg.t_cap_window)
    current = {"step": build(t_cap0)}

    def transform(state: TrainState) -> TrainState:
        params = state.params._replace(forward=shard_head(mesh, state.params.forward))
        replay = state.replay
        if use_replay and replay is not None:
            stored_w = replay.actions.shape[1]
            if cfg.t_cap_auto and ladder.cap_min <= stored_w < ladder.cap:
                print(f"t_cap ladder resume: adopting stored cap {stored_w}", flush=True)
                ladder.cap = stored_w
                current["step"] = build(stored_w)
            if stored_w != ladder.cap:
                replay = replay_resize(replay, ladder.cap)
        elif use_replay:
            replay = replay_init(cfg.replay_size, ladder.cap, getattr(torch, cfg.dtype),
                                 device=state.generator.device)
        return state._replace(params=params,
                              opt_state=opt.init(x for _, x in tree_leaves(params)),
                              replay=replay)

    def _maybe_shrink(state, lengths, valid):
        old = ladder.cap
        want = ladder.observe(lengths, valid)
        if want is None:
            return state
        print(f"t_cap ladder: {old} -> {want}; rebuilding step", flush=True)
        current["step"] = build(want)
        if state.replay is not None:
            state = state._replace(replay=replay_resize(state.replay, want))
        return state

    def step(state: TrainState):
        replay_arg = ()
        if use_replay:
            r_actions, _, r_valid = replay_sample(
                state.replay, state.generator, cfg.replay_samples,
                prioritized=cfg.replay_prioritized)
            replay_arg = (r_actions, r_valid)
        out = current["step"](state.params, state.opt_state, _step_seed(state),
                              *replay_arg)
        params, opt_state, loss, rewards, valid, lengths = out[:6]
        new_replay = state.replay
        if use_replay:
            # a rollout whose terminal missed the prefix scored a truncated
            # pattern: it never enters the buffer
            new_replay = replay_update(state.replay, out[6],
                                       torch.where(valid, rewards, float("-inf")))
        new_state = TrainState(params=params, opt_state=opt_state,
                               generator=state.generator, epoch=state.epoch + 1,
                               replay=new_replay)
        metrics = _metrics(mcfg, params, loss, rewards, lengths,
                           valid_frac=valid.to(torch.float32).mean(), t_cap=ladder.cap)
        if cfg.t_cap_auto:
            new_state = _maybe_shrink(new_state, lengths, valid)
        return new_state, metrics

    return step, transform


def _stored_state(mesh, state: TrainState) -> TrainState:
    """A sharded run's state as it is stored: the column-padded head and
    its Adam moments gathered from every ``rows`` rank (the JAX package
    stores the padded head too; ``transform`` cuts it again)."""
    from ..parallel.mesh import all_gather

    if mesh.size("rows") == 1:
        return state
    whole = lambda t: torch.cat(list(all_gather(mesh, t.detach(), "rows")), dim=-1)
    paths = [p for p, _ in tree_leaves(state.params)]
    head = {i for i, p in enumerate(paths) if p in ("/forward/fc_w", "/forward/fc_b")}
    params = tree_replace(state.params, (whole(x) if i in head else x
                                         for i, (_, x) in enumerate(tree_leaves(state.params))))
    adam = state.opt_state.adam
    moments = lambda ms: tuple(whole(m) if i in head else m for i, m in enumerate(ms))
    opt_state = state.opt_state._replace(adam=adam._replace(mu=moments(adam.mu),
                                                            nu=moments(adam.nu)))
    return state._replace(params=params, opt_state=opt_state)


# ---------------------------------------------------------------------------
# Metrics and checkpoints
# ---------------------------------------------------------------------------

class MetricsWriter:
    """CSV schema parity with the reference (GFlowNet100.py:226-255:
    ``training_log.csv`` = epoch,num_actions,loss,reward and
    ``detailed_training_log.csv`` adds per-sample rows) + a JSONL stream."""

    def __init__(self, out_dir: str, resume: bool = False):
        self.dir = Path(out_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        # append on resume so prior-epoch metrics survive a restart
        fresh = not (resume and (self.dir / "training_log.csv").exists())
        mode = "w" if fresh else "a"
        self.summary = open(self.dir / "training_log.csv", mode)
        self.detail = open(self.dir / "detailed_training_log.csv", mode)
        self.jsonl = open(self.dir / "metrics.jsonl", mode)
        if fresh:
            self.summary.write("epoch,num_actions,loss,reward\n")
            self.detail.write("epoch,sample_number,num_actions,loss,reward\n")

    def write(self, epoch: int, m: dict):
        loss = float(m["loss"])
        rewards = to_numpy(m["rewards"])
        lengths = to_numpy(m["lengths"])
        self.summary.write(
            f"{epoch},{int(lengths.max())},{loss},{rewards.mean()}\n")
        for i, (r, l) in enumerate(zip(rewards, lengths)):
            self.detail.write(f"{epoch},{i + 1},{int(l)},{loss},{float(r)}\n")
        rec = {
            "epoch": epoch,
            "loss": loss,
            "reward_mean": float(m["reward_mean"]),
            "reward_max": float(m["reward_max"]),
            "alpha": float(m["alpha"]),
            "log_z": float(m["log_z"]),
            "mean_len": float(m["mean_len"]),
            "skipped": bool(m["skipped"]),
            "valid_frac": float(m.get("valid_frac", 1.0)),
            "wall_s": float(m.get("wall_s", 0.0)),
            "time": time.time(),
        }
        if "t_cap" in m:
            rec["t_cap"] = int(m["t_cap"])
        self.jsonl.write(json.dumps(rec) + "\n")

    def flush(self):
        for f in (self.summary, self.detail, self.jsonl):
            f.flush()

    def close(self):
        for f in (self.summary, self.detail, self.jsonl):
            f.close()


def _opt_dict(st: OptState) -> dict:
    out = {"adam/count": st.adam.count}
    for i, (m, v) in enumerate(zip(st.adam.mu, st.adam.nu)):
        out[f"adam/mu/{i}"], out[f"adam/nu/{i}"] = m, v
    if st.plateau is not None:
        out.update({f"plateau/{f}": getattr(st.plateau, f)
                    for f in PlateauState._fields})
    return out


def _opt_from_dict(d: dict, template: OptState, device) -> OptState:
    t = lambda k: d[k].to(device)
    n = len(template.adam.mu)
    adam = AdamState(count=t("adam/count"),
                     mu=tuple(t(f"adam/mu/{i}") for i in range(n)),
                     nu=tuple(t(f"adam/nu/{i}") for i in range(n)))
    plateau = None
    if template.plateau is not None and "plateau/scale" in d:
        plateau = PlateauState(*(t(f"plateau/{f}") for f in PlateauState._fields))
    elif template.plateau is not None:
        plateau = template.plateau
    return OptState(adam=adam, plateau=plateau)


def save_checkpoint(out_dir: str, state: TrainState, env=None):
    """``out_dir/checkpoint/epoch_<n>.pt``: plain dicts of CPU tensors (the
    params by tree path, the optimizer state, the replay buffer), the
    generator state and the epoch — loadable with ``weights_only=True``.
    With ``env``, also stamps the edge enumeration (``train.enums``)."""
    path = Path(out_dir).absolute() / "checkpoint"
    path.mkdir(parents=True, exist_ok=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    blob = {
        "epoch": int(state.epoch),
        "params": cpu(dict(tree_leaves(state.params))),
        "opt_state": cpu(_opt_dict(state.opt_state)),
        "generator": state.generator.get_state(),
        "replay": (None if state.replay is None else
                   cpu(state.replay._asdict())),
    }
    torch.save(blob, path / f"epoch_{int(state.epoch)}.pt")
    if env is not None:
        from .enums import save_enum_meta

        save_enum_meta(out_dir, env)


def restore_checkpoint(out_dir: str, template: TrainState) -> Optional[TrainState]:
    """Restore the latest checkpoint into the structure of ``template``
    (its device and generator).  Stored shapes win over the template's,
    as the JAX package's ``_conform_to_stored`` makes them: a replay
    buffer keeps its stored width, which the caller re-conforms to the
    live run (``replay_resize``)."""
    base = Path(out_dir).absolute() / "checkpoint"
    steps = sorted(base.glob("epoch_*.pt"),
                   key=lambda p: int(p.stem.split("_")[1])) if base.exists() else []
    if not steps:
        return None
    blob = torch.load(steps[-1], map_location="cpu", weights_only=True)
    dev = template.generator.device
    stored = blob["params"]
    paths = [p for p, _ in tree_leaves(template.params)]
    missing = [p for p in paths if p not in stored]
    if missing:
        raise SystemExit(f"checkpoint {steps[-1]} lacks parameters {missing}: "
                         "the run's flags (loss, backward, edge-feats) differ "
                         "from the training run's")
    params = tree_replace(template.params, (stored[p].to(dev) for p in paths))
    replay = template.replay
    if replay is not None and blob["replay"] is not None:
        replay = ReplayBuffer(**{k: v.to(dev) for k, v in blob["replay"].items()})
    template.generator.set_state(blob["generator"])
    return TrainState(
        params=params,
        opt_state=_opt_from_dict(blob["opt_state"], template.opt_state, dev),
        generator=template.generator, epoch=int(blob["epoch"]), replay=replay)


# ---------------------------------------------------------------------------
# Demonstrations
# ---------------------------------------------------------------------------

def _magnitude_demos(env, fracs, T: int) -> np.ndarray:
    """[N, T] −1-padded demonstration trajectories: for each fraction f,
    delete the f·nnz smallest-|value| seed entries in magnitude order,
    then terminate.  The ids are the env's action ids: for a DIA env the
    (diagonal, row) order of ``spai_dia.edge_coo``, not the band storage."""
    if isinstance(env, spai_dia.SpaiDiaEnv):
        vals = to_numpy(spai_dia.edge_coo(env).data)
    else:
        vals = to_numpy(env.seed.data)
    order = np.argsort(np.abs(vals))
    terminal = env.num_edges
    acts = np.full((len(fracs), T), -1, np.int64)
    for i, f in enumerate(fracs):
        k = min(int(f * env.num_edges), T - 1)
        acts[i, :k] = order[:k]
        acts[i, k] = terminal
    return acts


def _fracs(cfg) -> list:
    return [float(x) for x in str(cfg.replay_seed_fracs).split(",") if x]


def warmstart_on_demonstrations(env, graph, mcfg, state: TrainState, cfg,
                                opt: Optimizer) -> TrainState:
    """Supervised warm-start (``cfg.warmstart_epochs`` > 0): maximise the
    forward policy's log P_F of the magnitude-thinning demonstrations
    (``cfg.replay_seed_fracs``), the terminal step weighted by the mean
    deletion depth so both signals carry equal gradient mass; then
    re-initialise the optimizer state (JAX loop.py:611-677)."""
    from ..gfn.rollout import trajectory_logprobs

    fracs = _fracs(cfg)
    if not fracs or cfg.warmstart_epochs <= 0:
        return state
    kmax = max(min(int(f * env.num_edges), env.num_actions - 1) for f in fracs)
    demos_np = _magnitude_demos(env, fracs, kmax + 1)
    dev = state.generator.device
    demos = torch.as_tensor(demos_np, device=dev)
    lengths = (demos_np >= 0).sum(-1)
    w_term = float(np.mean(lengths - 1))
    is_term = (torch.arange(demos.shape[1], device=dev)[None, :]
               == torch.as_tensor(lengths - 1, device=dev)[:, None])
    wopt = Optimizer(lr=cfg.warmstart_lr)
    params = state.params
    wstate = wopt.init(x for _, x in tree_leaves(params))
    t0 = time.perf_counter()
    for i in range(cfg.warmstart_epochs):
        leaves = [x.detach().requires_grad_(True) for _, x in tree_leaves(params)]
        p = tree_replace(params, iter(leaves))
        logits = pol.forward_policy_logits(p.forward, graph, mcfg.num_actions,
                                           mcfg.hidden_dim, mcfg.heads)
        lps = trajectory_logprobs(logits, demos)
        dn = -torch.mean(torch.sum(torch.where(is_term, 0.0, lps), -1))
        tn = -torch.mean(torch.sum(torch.where(is_term, lps, 0.0), -1))
        loss = dn + w_term * tn
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        with torch.no_grad():
            updates, wstate = wopt.update(grads, wstate)
            params = apply_updates(tree_replace(params, (x.detach() for x in leaves)),
                                   updates)
        loss, dn, tn = loss.detach(), dn.detach(), tn.detach()
        if i % max(1, cfg.warmstart_epochs // 10) == 0:
            print(f"warmstart {i}: NLL {float(loss):.2f} "
                  f"(delete {float(dn):.2f}, stop {float(tn):.3f})", flush=True)
    print(f"warmstart done: NLL {float(loss):.2f} "
          f"(delete {float(dn):.2f}, stop {float(tn):.3f}); {cfg.warmstart_epochs} "
          f"steps in {time.perf_counter() - t0:.1f} s", flush=True)
    return state._replace(params=params,
                          opt_state=opt.init(x for _, x in tree_leaves(params)))


def seed_replay_with_magnitude_thinning(env, state: TrainState, cfg,
                                        alpha: float) -> TrainState:
    """Demonstration-seed the replay buffer (``cfg.replay_seed_fracs``):
    for each fraction f, the trajectory that deletes the f·nnz
    smallest-|value| seed entries then terminates, with its true reward."""
    fracs = _fracs(cfg)
    if not fracs or state.replay is None:
        return state
    T = state.replay.actions.shape[1]
    demos = _magnitude_demos(env, fracs, T)
    replay = state.replay
    dev = replay.actions.device
    for f, acts in zip(fracs, demos):
        acts_t = torch.as_tensor(acts[None, :], device=dev)
        r = gfn._batched_rewards(env, acts_t, torch.tensor(
            alpha, dtype=replay.rewards.dtype, device=dev))
        replay = replay_update(replay, acts_t, r)
        print(f"replay seed: magnitude-thin {f:.0%} "
              f"({int((acts >= 0).sum()) - 1} deletions) "
              f"reward {float(r[0]):.1f}", flush=True)
    return state._replace(replay=replay)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def _checkpoint(cfg: TrainConfig, state: TrainState, env, lead: bool):
    """Rank 0 writes the checkpoint; with a process group every rank waits
    for it, so none reads a half-written file."""
    import torch.distributed as dist

    if lead:
        save_checkpoint(cfg.out_dir, state, env=env)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def train(cfg: TrainConfig, progress: bool = True):
    """Full training run; returns (final TrainState, history of losses).

    ``cfg.sampler == "sharded"`` runs the sharded sampler, ``dp_devices`` /
    ``rows_devices`` > 1 the mesh-parallel step (``parallel/``), on the
    process group's ranks (one per device; a 1×1 mesh needs none), each
    holding the same state.  Only rank 0 writes metrics and checkpoints; a
    sharded run stores its column-padded head whole."""
    import torch.distributed as dist

    a, seed, env, graph, mcfg, opt, state = setup(cfg)
    lead = not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    restored = restore_checkpoint(cfg.out_dir, state) if cfg.resume else None
    if restored is None and cfg.replay_seed_fracs:
        # a resumed run restores the seeded buffer and the warmed-up
        # policy, so neither is made again (the JAX loop repeats the warm
        # start, then overwrites it with the checkpoint)
        state = seed_replay_with_magnitude_thinning(
            env, state, cfg,
            alpha=cfg.alpha_fixed if cfg.alpha_fixed >= 0 else 0.5)
        if cfg.warmstart_epochs > 0:
            state = warmstart_on_demonstrations(env, graph, mcfg, state, cfg, opt)
            if cfg.checkpoint_every:
                _checkpoint(cfg, state, env, lead)
    if restored is not None:
        from .enums import reconcile

        tmpl_w = (state.replay.actions.shape[1]
                  if state.replay is not None else None)
        state, _ = reconcile(cfg.out_dir, env, restored,
                             backward=cfg.backward, opt=opt)
        # the stored replay width wins on restore; conform it back to
        # this run's cap (the sharded adapter owns its own width)
        if (cfg.sampler != "sharded" and state.replay is not None
                and tmpl_w is not None
                and state.replay.actions.shape[1] != tmpl_w):
            state = state._replace(replay=replay_resize(state.replay, tmpl_w))
    mesh = None
    stored = lambda st: st
    if cfg.sampler == "sharded":
        mesh = _mesh(cfg)
        step, transform = _make_sharded_sampler_adapter(cfg, env, graph, mcfg, opt, mesh)
        state = transform(state)
        stored = lambda st: _stored_state(mesh, st)
    elif cfg.dp_devices > 1 or cfg.rows_devices > 1:
        mesh = _mesh(cfg)
        step = _make_dp_step_adapter(cfg, env, graph, mcfg, opt, mesh)
    else:
        step = make_train_step(cfg, env, graph, mcfg, opt)
    writer = MetricsWriter(cfg.out_dir, resume=cfg.resume) if lead else None
    history = []
    for epoch in range(int(state.epoch), cfg.num_epochs):
        t0 = time.time()
        state, metrics = step(state)
        metrics = {k: to_numpy(v) if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics["wall_s"] = time.time() - t0
        if lead:
            writer.write(epoch, metrics)
        if lead and progress and epoch % cfg.log_every == 0:
            writer.flush()
            print(f"epoch {epoch} loss {float(metrics['loss']):.4f} "
                  f"reward {float(metrics['reward_mean']):.2f} "
                  f"alpha {float(metrics['alpha']):.3f} "
                  f"len {float(metrics['mean_len']):.1f}", flush=True)
        history.append(float(metrics["loss"]))
        if cfg.checkpoint_every and (epoch + 1) % cfg.checkpoint_every == 0:
            _checkpoint(cfg, stored(state), env, lead)
    _checkpoint(cfg, stored(state), env, lead)
    if not lead:
        return state, history
    writer.close()
    try:
        from ..utils.reporting import render_training_report

        render_training_report(cfg.out_dir)
    except Exception as e:  # reporting must never fail a run
        print(f"report generation skipped: {e}")
    return state, history
