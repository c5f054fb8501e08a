"""Entry points of the PyTorch port: the single-card forward step and
a multi-device dry run (counterpart of ``__graft_entry__.py``)."""

import torch


def _lf10_setup(device=None, dtype=torch.float32):
    from gflownet_spai_tpu_torch.env import make_env, seed_pattern
    from gflownet_spai_tpu_torch.gfn import GFlowNetConfig, init_params
    from gflownet_spai_tpu_torch.models import graph_from_seed
    from gflownet_spai_tpu_torch.sparse import gallery
    from gflownet_spai_tpu_torch.sparse.types import COO

    a = gallery.get("LF10_like")
    a = COO(row=a.row, col=a.col, data=a.data.astype("float32"), shape=a.shape)
    seed = seed_pattern(a, method="ilu0", dtype="float32")
    env = make_env(seed, original=a, device=device)
    graph = graph_from_seed(seed, device=device)
    cfg = GFlowNetConfig(hidden_dim=4, heads=4, num_actions=env.num_actions)
    params = init_params(torch.Generator().manual_seed(0), cfg, dtype=dtype,
                         device=device)
    return env, graph, cfg, params


def entry(device=None):
    """(fn, example_args): the flagship model's forward step — GATv2 policy
    forward, Gumbel-top-k rollout, fixed-pattern reward, backward LSTM and
    TB loss on the LF10 SPAI env — on the card (``device=None``)."""
    from gflownet_spai_tpu_torch.gfn.gflownet import loss_fn

    env, graph, cfg, params = _lf10_setup(device)
    dev = params.log_z.device

    def fn(params, seed):
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        loss, aux = loss_fn(params, env, graph, cfg, gen, batch_size=4)
        return loss, aux["rewards"]

    return fn, (params, 1)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One training step over the squarest (dp × rows) factorisation of
    ``n_devices`` (the process group's world size; 1 needs no group): the
    dp step (policy replicated, batch over dp, reward pairs over rows), the
    column-sharded head against the replicated logits, distributed CG, and
    with rows ≥ 2 the sharded-sampler step."""
    from gflownet_spai_tpu_torch.gfn.gflownet import tree_leaves
    from gflownet_spai_tpu_torch.models.policies import forward_policy_logits
    from gflownet_spai_tpu_torch.ops import coo_to_dia
    from gflownet_spai_tpu_torch.parallel import (distributed_cg, make_dp_train_step,
                                                  make_mesh, shard_head,
                                                  sharded_policy_logits)
    from gflownet_spai_tpu_torch.parallel.sampler import make_sharded_sampler_train_step
    from gflownet_spai_tpu_torch.sparse import gallery
    from gflownet_spai_tpu_torch.train.loop import Optimizer

    dp = next(c for c in range(int(n_devices ** 0.5), 0, -1) if n_devices % c == 0)
    rows = n_devices // dp
    mesh = make_mesh(dp=dp, rows=rows, device=device)
    env, graph, cfg, params = _lf10_setup(mesh.device)
    opt = Optimizer(lr=1e-3)
    init = lambda p: opt.init(x for _, x in tree_leaves(p))
    step, _ = make_dp_train_step(mesh, env, graph, cfg, opt, batch_size=2 * dp)
    params, _, loss, rewards, _ = step(params, init(params), 2)
    assert torch.isfinite(loss), loss
    assert rewards.shape == (2 * dp,)

    want = forward_policy_logits(params.forward, graph, cfg.num_actions, 4)
    got = sharded_policy_logits(mesh, shard_head(mesh, params.forward), graph,
                                cfg.num_actions, 4)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)

    coo = gallery.get("poisson32")
    res = distributed_cg(mesh, coo_to_dia(coo, device=mesh.device),
                         torch.ones(coo.shape[0], device=mesh.device),
                         maxiter=200, rtol=1e-3)
    assert bool(torch.isfinite(res.x).all())

    if rows >= 2:
        cfg_lin = cfg._replace(backward="linear")
        from gflownet_spai_tpu_torch.gfn import init_params

        p_lin = init_params(torch.Generator().manual_seed(5), cfg_lin, device=mesh.device)
        sh_step, shard_fwd, _ = make_sharded_sampler_train_step(
            mesh, env, graph, cfg_lin, opt, batch_size=dp, t_cap=env.num_actions)
        p_sh = shard_fwd(p_lin)
        out = sh_step(p_sh, init(p_sh), 6)
        assert torch.isfinite(out[2]) and bool(out[4].all())
    print(f"dryrun_multichip: mesh(dp={dp}, rows={rows}) one train step + "
          f"distributed CG OK, loss={float(loss):.4f}", flush=True)
