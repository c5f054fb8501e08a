"""PyTorch port vs the JAX package: the tile segment ops (the plain versions
of K5 softmax, K6 sum and K7 broadcast, with their custom VJPs) against the
interpret-mode Pallas kernels and the jnp oracles, and the generic GATv2
tile layer (edge_dim 2 and 3) against JAX's generic branch and the per-edge
path.

Tolerances: the segment ops rtol 1e-5, atol 1e-6 (tests/test_segment.py);
the GAT stack's values rtol 2e-4, atol 2e-5 and its gradients rtol 5e-3,
atol 5e-4 (tests/test_segment.py:106-121: sums run in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.models import gat as j_gat
from gflownet_spai_tpu.models import policies as j_pol
from gflownet_spai_tpu.ops import segment as j_seg
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu_torch.convert import gatv2_params_from_jax
from gflownet_spai_tpu_torch.models import gat as t_gat
from gflownet_spai_tpu_torch.models import policies as t_pol
from gflownet_spai_tpu_torch.ops import segment as t_seg
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse.types import COO as TCOO
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(rtol=1e-5, atol=1e-6)
VAL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=5e-4)
HIDDEN, HEADS = 4, 4


def _layouts(seed, n=300, e=2500, tile_nodes=64):
    """The same layout from both packages; a hub node owns a long run."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, n, e), np.full(150, 7)])
    return (rng, j_seg.build_seg_tiles(ids, n, tile_nodes=tile_nodes),
            t_seg.build_seg_tiles(ids, n, tile_nodes=tile_nodes, device="cpu"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("heads", [4, 1])
def test_segment_softmax_matches_jax(heads):
    rng, jt, tt = _layouts(6)
    T, S = tt.tiles, tt.slots
    scores = rng.standard_normal((T, heads, S)).astype(np.float32)
    tgt = rng.standard_normal((T, heads, S)).astype(np.float32)
    want = j_seg.segment_softmax_tiles_mh(jt, jnp.asarray(scores), interpret=True)
    for h in range(heads):
        _close(t_seg.segment_softmax_tiles_ref(tt, torch.as_tensor(scores[:, h])),
               j_seg.segment_softmax_tiles_jnp(jt, jnp.asarray(scores[:, h])))
    x = torch.as_tensor(scores).requires_grad_(True)
    got = t_seg.segment_softmax_tiles_mh(tt, x)
    _close(got, want)
    pad = (tt.local_dst.numpy() == tt.tile_nodes)
    assert pad.any() and not got.detach().numpy().transpose(0, 2, 1)[pad].any()
    g_want = jax.jit(jax.grad(lambda s: jnp.sum(
        j_seg.segment_softmax_tiles_mh(jt, s, interpret=True) * tgt)))(jnp.asarray(scores))
    (g,) = torch.autograd.grad((got * torch.as_tensor(tgt)).sum(), x)
    _close(g, g_want)
    if heads == 1:   # the single-head entry
        _close(t_seg.segment_softmax_tiles(tt, torch.as_tensor(scores[:, 0])),
               j_seg.segment_softmax_tiles(jt, jnp.asarray(scores[:, 0]), interpret=True))


@pytest.mark.parametrize("D", [16, 4, 1])
def test_segment_sum_and_broadcast_match_jax(D):
    """K6 and K7's plain versions and their VJPs (each the other) against
    the interpret-mode kernels; padding slots carry values and are
    ignored by the sum."""
    rng, jt, tt = _layouts(4)
    T, S, TN = tt.tiles, tt.slots, tt.tile_nodes
    vals = rng.standard_normal((T, S, D)).astype(np.float32)
    nodes = rng.standard_normal((T, TN, D)).astype(np.float32)
    tgt_n = rng.standard_normal((T * TN, D)).astype(np.float32)
    tgt_s = rng.standard_normal((T, S, D)).astype(np.float32)

    v = torch.as_tensor(vals).requires_grad_(True)
    got = t_seg.segment_sum_tiles(tt, v)
    _close(got, j_seg.segment_sum_tiles(jt, jnp.asarray(vals), interpret=True))
    _close(t_seg.segment_sum_tiles_ref(tt, torch.as_tensor(vals)),
           j_seg.segment_sum_tiles_jnp(jt, jnp.asarray(vals)))
    g_want = jax.jit(jax.grad(lambda x: jnp.sum(
        j_seg.segment_sum_tiles(jt, x, interpret=True) * tgt_n)))(jnp.asarray(vals))
    _close(torch.autograd.grad((got * torch.as_tensor(tgt_n)).sum(), v)[0], g_want)

    nv = torch.as_tensor(nodes).requires_grad_(True)
    got = t_seg.segment_broadcast_tiles(tt, nv)
    _close(got, j_seg.segment_broadcast_tiles(jt, jnp.asarray(nodes), interpret=True))
    _close(t_seg.segment_broadcast_tiles_ref(tt, torch.as_tensor(nodes)),
           j_seg.segment_broadcast_tiles_jnp(jt, jnp.asarray(nodes)))
    g_want = jax.jit(jax.grad(lambda x: jnp.sum(
        j_seg.segment_broadcast_tiles(jt, x, interpret=True) * tgt_s)))(jnp.asarray(nodes))
    _close(torch.autograd.grad((got * torch.as_tensor(tgt_s)).sum(), nv)[0], g_want)


def test_segment_max_and_from_tiles_match_jax():
    rng, jt, tt = _layouts(8)
    T, S = tt.tiles, tt.slots
    vals = rng.standard_normal((T, S)).astype(np.float32)
    got = t_seg.segment_max_tiles_ref(tt, torch.as_tensor(vals)).numpy()
    want = np.asarray(j_seg.segment_max_tiles_jnp(jt, jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)          # −inf where a node is empty
    assert np.isinf(got).any()
    per_slot = rng.standard_normal((T * S, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        t_seg.from_tiles(tt, torch.as_tensor(per_slot)).numpy(),
        np.asarray(j_seg.from_tiles(jt, jnp.asarray(per_slot))))


def _edge_features(data, n2, edge_dim):
    """[v, |v|, v²][:edge_dim] per seed edge, self-loop rows filled with
    the column means of the real edges (GATv2Conv's fill_value='mean')."""
    v = np.asarray(data, np.float32)
    feats = np.stack([v, np.abs(v), v * v], axis=1)[:, :edge_dim]
    return np.concatenate([feats, np.broadcast_to(feats.mean(0), (n2, edge_dim))])


@pytest.fixture(scope="module")
def graph():
    j = j_gallery.random_spd(80, density=0.05, seed=11)
    j = JCOO(row=j.row, col=j.col, data=j.data.astype(jnp.float32), shape=j.shape)
    t = t_gallery.random_spd(80, density=0.05, seed=11)
    t = TCOO(row=t.row, col=t.col, data=t.data.astype(np.float32), shape=t.shape)
    return (j, j_pol.tiled_graph_from_seed(j, tile_nodes=32, bucket_step=None),
            t, t_pol.tiled_graph_from_seed(t, tile_nodes=32, bucket_step=None,
                                           device="cpu"))


@pytest.mark.parametrize("edge_dim", [2, 3])
def test_generic_gat_stack_matches_jax(graph, edge_dim):
    """Two generic layers (heads 4 on the uniform x, ReLU, heads 1 through
    the window plan) against JAX's generic branch (interpret-mode kernels)
    and both against the per-edge path; gradients of sum(c · out) with
    respect to both layers' parameters."""
    j, jg, t, tg = graph
    n2 = jg.tiles.num_nodes
    E = j.nnz
    attr = _edge_features(t.data, n2, edge_dim)
    j_attr_t = j_seg.to_tiles(jg.tiles, jnp.asarray(attr))
    t_attr_t = t_seg.to_tiles(tg.tiles, torch.as_tensor(attr))
    keys = jax.random.split(jax.random.PRNGKey(edge_dim), 2)
    jp = (j_gat.gatv2_init(keys[0], 1, HIDDEN, HEADS, edge_dim=edge_dim),
          j_gat.gatv2_init(keys[1], HEADS * HIDDEN, HIDDEN, 1, edge_dim=edge_dim))
    # nonzero biases, so every parameter is exercised
    rng = np.random.default_rng(edge_dim)
    jp = tuple(p._replace(b_src=jnp.asarray(rng.standard_normal(p.b_src.shape), jnp.float32),
                          bias=jnp.asarray(rng.standard_normal(p.bias.shape), jnp.float32))
               for p in jp)
    tp = [gatv2_params_from_jax(jax.tree_util.tree_map(np.asarray, p), device="cpu")
          for p in jp]
    c = rng.standard_normal((n2, HIDDEN)).astype(np.float32)

    def j_tiled(ps):
        h = jax.nn.relu(j_gat.gatv2_apply_tiled(
            ps[0], jg.x, jg.tiles, jg.src_t, jg.dst_t, j_attr_t, n2, HEADS, HIDDEN,
            interpret=True, srcwin=jg.srcwin))
        return j_gat.gatv2_apply_tiled(ps[1], h, jg.tiles, jg.src_t, jg.dst_t, j_attr_t,
                                       n2, 1, HIDDEN, interpret=True, srcwin=jg.srcwin)

    def j_edges(ps):
        x, ea = jnp.ones((n2, 1), jnp.float32), jnp.asarray(attr[:E])
        h = jax.nn.relu(j_gat.gatv2_apply(ps[0], x, j.row, j.col, ea, n2, HEADS, HIDDEN))
        return j_gat.gatv2_apply(ps[1], h, j.row, j.col, ea, n2, 1, HIDDEN)

    def t_tiled(ps):
        h = torch.relu(t_gat.gatv2_apply_tiled(
            ps[0], tg.x, tg.tiles, tg.src_t, tg.dst_t, t_attr_t, n2, HEADS, HIDDEN,
            srcwin=tg.srcwin))
        return t_gat.gatv2_apply_tiled(ps[1], h, tg.tiles, tg.src_t, tg.dst_t, t_attr_t,
                                       n2, 1, HIDDEN, srcwin=tg.srcwin)

    want = np.asarray(jax.jit(j_tiled)(jp))
    np.testing.assert_allclose(np.asarray(jax.jit(j_edges)(jp)), want, **VAL_TOL)
    leaves = [[x.clone().requires_grad_(True) for x in p] for p in tp]
    got = t_tiled([t_gat.GATv2Params(*lv) for lv in leaves])
    _close(got, want, VAL_TOL)
    edges = t.to("cpu")
    x = torch.ones((n2, 1))
    ea = torch.as_tensor(attr[:E])
    h = torch.relu(t_gat.gatv2_apply(tp[0], x, edges.row, edges.col, ea, n2, HEADS,
                                     HIDDEN))
    _close(t_gat.gatv2_apply(tp[1], h, edges.row, edges.col, ea, n2, 1, HIDDEN),
           want, VAL_TOL)

    loss = lambda f: (lambda ps: jnp.sum(f(ps) * c))
    g_tiled = jax.jit(jax.grad(loss(j_tiled)))(jp)
    g_edges = jax.jit(jax.grad(loss(j_edges)))(jp)
    flat = [x for lv in leaves for x in lv]
    got_g = torch.autograd.grad((got * torch.as_tensor(c)).sum(), flat)
    for a, b, w in zip(got_g, jax.tree_util.tree_leaves(g_edges),
                       jax.tree_util.tree_leaves(g_tiled)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(w), **GRAD_TOL)
        _close(a, w, GRAD_TOL)
