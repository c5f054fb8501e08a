"""PyTorch port vs the JAX package: parameters carried over, the dense and
the bucketed tiled GATv2 layers, and the forward-policy logits.

Tolerance rtol 2e-4, atol 2e-5 (the repo's own bound for the tiled GAT vs
the dense path, tests/test_segment.py): sums run in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.gfn import gflownet as j_gfn
from gflownet_spai_tpu.models import gat as j_gat
from gflownet_spai_tpu.models import policies as j_pol
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu_torch.convert import params_from_jax
from gflownet_spai_tpu_torch.models import gat as t_gat
from gflownet_spai_tpu_torch.models import policies as t_pol
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse.types import COO as TCOO
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 2e-4, 2e-5
HIDDEN, HEADS = 4, 4


@pytest.fixture(scope="module")
def case():
    j = j_gallery.random_spd(80, density=0.05, seed=12)
    j = JCOO(row=j.row, col=j.col, data=j.data.astype(jnp.float32), shape=j.shape)
    t = t_gallery.random_spd(80, density=0.05, seed=12)
    t = TCOO(row=t.row, col=t.col, data=t.data.astype(np.float32), shape=t.shape)
    cfg = j_gfn.GFlowNetConfig(hidden_dim=HIDDEN, heads=HEADS,
                               num_actions=j.nnz + 1, edge_feats=True)
    jparams = j_gfn.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    # a nonzero feature weight, so the value-aware channel is exercised
    jparams = jparams._replace(forward=jparams.forward._replace(
        feat_w=jnp.asarray([0.3], jnp.float32)))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return dict(j=j, t=t, cfg=cfg, jparams=jparams, tparams=tparams,
                jg=j_pol.tiled_graph_from_seed(j, tile_nodes=32),
                tg=t_pol.tiled_graph_from_seed(t, tile_nodes=32, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_params_from_jax_carries_every_leaf(case):
    jl = jax.tree_util.tree_leaves(case["jparams"])
    tl = [x for x in _leaves(case["tparams"]) if x is not None]
    assert len(jl) == len(tl) > 10
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [y for x in tree for y in _leaves(x)]
    return [tree]


def _layers(jp, tp):
    return ((jp.forward.gat1, tp.forward.gat1, HEADS),
            (jp.forward.gat2, tp.forward.gat2, 1))


def test_gatv2_apply_dense_matches(case):
    j, t = case["j"], case["t"]
    n2 = 2 * j.shape[0]
    rng = np.random.default_rng(0)
    for jl, tl, heads in _layers(case["jparams"], case["tparams"]):
        x = rng.standard_normal((n2, jl.w_src.shape[0])).astype(np.float32)
        want = j_gat.gatv2_apply(jl, jnp.asarray(x), j.row, j.col,
                                 j.data[:, None], n2, heads, HIDDEN)
        got = t_gat.gatv2_apply(tl, torch.as_tensor(x), torch.as_tensor(t.row),
                                torch.as_tensor(t.col),
                                torch.as_tensor(t.data)[:, None], n2, heads,
                                HIDDEN)
        _close(got, want)


def test_gatv2_apply_tiled_buckets_match(case):
    jg, tg = case["jg"], case["tg"]
    n2 = jg.tiles.num_nodes
    assert len(tg.gat_buckets) >= 2
    rng = np.random.default_rng(1)
    for jl, tl, heads in _layers(case["jparams"], case["tparams"]):
        x = (np.ones((1, 1), np.float32) if heads == HEADS else
             rng.standard_normal((n2, jl.w_src.shape[0])).astype(np.float32))
        want = j_gat.gatv2_apply_tiled(
            jl, jnp.asarray(x), jg.tiles, jg.src_t, jg.dst_t, jg.attr_t, n2,
            heads, HIDDEN, interpret=True, srcwin=jg.srcwin,
            buckets=jg.gat_buckets)
        got = t_gat.gatv2_apply_tiled(
            tl, torch.as_tensor(x), tg.tiles, tg.src_t, tg.dst_t, tg.attr_t, n2,
            heads, HIDDEN, srcwin=tg.srcwin, buckets=tg.gat_buckets)
        _close(got, want)
        # the unbucketed tile layout gives the same layer
        got1 = t_gat.gatv2_apply_tiled(
            tl, torch.as_tensor(x), tg.tiles, tg.src_t, tg.dst_t, tg.attr_t, n2,
            heads, HIDDEN, srcwin=tg.srcwin)
        _close(got1, want)


@pytest.mark.parametrize("tiled", [True, False])
def test_forward_policy_logits_match(case, tiled):
    j, t, cfg = case["j"], case["t"], case["cfg"]
    jg = case["jg"] if tiled else j_pol.graph_from_seed(j)
    tg = case["tg"] if tiled else t_pol.graph_from_seed(t, device="cpu")
    want = j_pol.forward_policy_logits(case["jparams"].forward, jg,
                                       cfg.num_actions, HIDDEN, HEADS)
    got = t_pol.forward_policy_logits(case["tparams"].forward, tg,
                                      cfg.num_actions, HIDDEN, HEADS)
    assert got.shape == (cfg.num_actions,)
    _close(got, want)
    np.testing.assert_allclose(
        float(t_pol.forward_policy_alpha(case["tparams"].forward)),
        float(j_pol.forward_policy_alpha(case["jparams"].forward)))


@pytest.mark.parametrize("bucketed", [True, False])
def test_non_uniform_layer_without_window_plan_raises(case, bucketed):
    tg = case["tg"]
    n2 = tg.tiles.num_nodes
    p = case["tparams"].forward.gat2
    h = torch.ones((n2, p.w_src.shape[0]))
    buckets = (tuple(b._replace(srcwin=None) for b in tg.gat_buckets)
               if bucketed else None)
    with pytest.raises(ValueError, match="window plan"):
        t_gat.gatv2_apply_tiled(p, h, tg.tiles, tg.src_t, tg.dst_t, tg.attr_t,
                                n2, 1, HIDDEN, srcwin=None, buckets=buckets)


def test_edge_dim_other_than_one_raises(case):
    """An edge_dim 2 layer takes the generic tile chain (K5-K7): it raises
    on the graph's one-column edge features and on a non-uniform input
    without the window plan, and runs on [T·S, 2] features."""
    gen = torch.Generator().manual_seed(0)
    p = t_gat.gatv2_init(gen, 1, HIDDEN, HEADS, edge_dim=2)
    tg = case["tg"]
    n2 = tg.tiles.num_nodes
    with pytest.raises(RuntimeError):
        t_gat.gatv2_apply_tiled(p, tg.x, tg.tiles, tg.src_t, tg.dst_t,
                                tg.attr_t, n2, HEADS, HIDDEN)
    attr2 = torch.cat([tg.attr_t, tg.attr_t.abs()], dim=1)
    with pytest.raises(ValueError, match="window plan"):
        t_gat.gatv2_apply_tiled(p, torch.ones((n2, 1)), tg.tiles, tg.src_t, tg.dst_t,
                                attr2, n2, HEADS, HIDDEN, buckets=tg.gat_buckets)
    out = t_gat.gatv2_apply_tiled(p, tg.x, tg.tiles, tg.src_t, tg.dst_t, attr2,
                                  n2, HEADS, HIDDEN, buckets=tg.gat_buckets)
    assert out.shape == (n2, HEADS * HIDDEN) and torch.isfinite(out).all()


def test_gatv2_apply_tiled_buckets_grads_match(case):
    """Gradients through the bucketed branch (the ``xd_r[idx]`` gather and
    the ``out_r[idx]`` write, K2 and K4 on the card, their plain versions
    here) against ``jax.grad`` through the JAX layer with the interpret-mode
    kernels, for the layer's parameters and its input features.  Tolerance
    rtol 5e-4 and atol 5e-5 times the largest gradient of the layer (the
    repo's bound for these gradients, tests/test_segment.py; w_dst's and
    att's gradients are float32 sums that cancel)."""
    jg, tg = case["jg"], case["tg"]
    n2 = jg.tiles.num_nodes
    rng = np.random.default_rng(4)
    jl, tl = case["jparams"].forward.gat2, case["tparams"].forward.gat2
    x = rng.standard_normal((n2, jl.w_src.shape[0])).astype(np.float32)
    tgt = rng.standard_normal((n2, HIDDEN)).astype(np.float32)

    def jloss(p, x):
        out = j_gat.gatv2_apply_tiled(p, x, jg.tiles, jg.src_t, jg.dst_t,
                                      jg.attr_t, n2, 1, HIDDEN, interpret=True,
                                      srcwin=jg.srcwin, buckets=jg.gat_buckets)
        return jnp.sum(out * tgt)

    jp_g, jx_g = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jl, jnp.asarray(x))
    leaves = [t.clone().requires_grad_(True) for t in tl]
    tx = torch.as_tensor(x).requires_grad_(True)
    out = t_gat.gatv2_apply_tiled(
        t_gat.GATv2Params(*leaves), tx, tg.tiles, tg.src_t, tg.dst_t, tg.attr_t,
        n2, 1, HIDDEN, srcwin=tg.srcwin, buckets=tg.gat_buckets)
    got = torch.autograd.grad((out * torch.as_tensor(tgt)).sum(), leaves + [tx])
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jp_g)] + [np.asarray(jx_g)]
    scale = max(float(np.abs(w).max()) for w in want[:-1])
    for g, w in zip(got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), w, rtol=5e-4, atol=5e-5 * scale)
    np.testing.assert_allclose(got[-1].numpy(), want[-1], rtol=5e-4,
                               atol=5e-5 * float(np.abs(want[-1]).max()))
