"""PyTorch port vs the JAX package: the plain tile segment ops on every
layout the reference takes.  JAX's tile kernels compare each slot's id with
every node of its tile (a onehot), so a slot whose id lies outside
[0, TN) is padding, wherever it stands and whatever its id.  The plain K5
(softmax) forward and its VJP (``segment_softmax_tiles_bwd_ref``), K6
(sum), K7 (broadcast) and the per-node max are held against JAX's
interpret-mode kernels and ``segment_max_tiles_jnp`` on the builder's
sorted layout, a shuffled one (each tile's slots permuted, part of the
padding marked -1 and part TN + 5), -1 padding in tile 0, and TN + 5
padding in tile 0 and in the last tile.  The schedule of the K5 kernels
(lane l of L takes a run's positions l, l + L, ...; the lane sums merge
by an xor butterfly) is emulated in float64 against float64 softmax sums
to 1e-12, through the layout's run starts and slot order.

Tolerances (``tests/test_torch_segment_generic.py``): values rtol 2e-4,
atol 2e-5; gradients rtol 5e-3, atol 5e-4; K7 and the max move values:
exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import segment as j_seg
from gflownet_spai_tpu_torch.ops import segment as t_seg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

VAL_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=5e-3, atol=5e-4)
LAYOUTS = ["sorted", "shuffled", "neg_first", "over_first", "over_last"]


def _layouts(kind, seed=6, n=300, e=2500, tile_nodes=64):
    """The same layout in both packages (T 5, S 768; node 7 owns a
    150-slot run), its local_dst rewritten per ``kind``."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(0, n, e), np.full(150, 7)])
    jt = j_seg.build_seg_tiles(ids, n, tile_nodes=tile_nodes)
    tt = t_seg.build_seg_tiles(ids, n, tile_nodes=tile_nodes, device="cpu")
    lid = tt.local_dst.numpy().copy()
    tn, pad = tile_nodes, lid == tile_nodes
    if kind == "shuffled":
        for t in range(tt.tiles):
            lid[t] = lid[t][rng.permutation(tt.slots)]
            where = np.flatnonzero(lid[t] == tn)
            lid[t, where[::3]] = -1
            lid[t, where[1::3]] = tn + 5
    elif kind == "neg_first":
        lid[0][pad[0]] = -1
    elif kind == "over_first":
        lid[0][pad[0]] = tn + 5
    elif kind == "over_last":
        lid[-1][pad[-1]] = tn + 5
    assert kind == "sorted" or (lid != tt.local_dst.numpy()).any()
    return (rng, dataclasses.replace(jt, local_dst=jnp.asarray(lid)),
            dataclasses.replace(tt, local_dst=torch.as_tensor(lid)))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want), **tol)


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("heads", [4, 1])
def test_plain_softmax_and_vjp_match_pallas(kind, heads):
    rng, jt, tt = _layouts(kind)
    T, S = tt.tiles, tt.slots
    scores = (rng.standard_normal((T, heads, S)) * 3).astype(np.float32)
    g = rng.standard_normal((T, heads, S)).astype(np.float32)
    want = j_seg.segment_softmax_tiles_mh(jt, jnp.asarray(scores), interpret=True)
    _close(t_seg.segment_softmax_tiles_ref(tt, torch.as_tensor(scores)), want, VAL_TOL)
    x = torch.as_tensor(scores).requires_grad_(True)
    y = t_seg.segment_softmax_tiles_mh(tt, x)
    _close(y, want, VAL_TOL)
    pad = ~t_seg._real(tt)[:, None].expand_as(y)
    assert bool(pad.any()) and not y.detach()[pad].any()
    g_want = jax.jit(jax.grad(lambda s: jnp.sum(
        j_seg.segment_softmax_tiles_mh(jt, s, interpret=True) * g)))(jnp.asarray(scores))
    _close(t_seg.segment_softmax_tiles_bwd_ref(tt, y.detach(), torch.as_tensor(g)),
           g_want, GRAD_TOL)
    (dx,) = torch.autograd.grad((y * torch.as_tensor(g)).sum(), x)
    _close(dx, g_want, GRAD_TOL)


@pytest.mark.parametrize("kind", LAYOUTS)
@pytest.mark.parametrize("D", [16, 4, 1])
def test_plain_sum_and_broadcast_match_pallas(kind, D):
    rng, jt, tt = _layouts(kind, seed=4)
    T, S, TN = tt.tiles, tt.slots, tt.tile_nodes
    vals = rng.standard_normal((T, S, D)).astype(np.float32)
    nodes = rng.standard_normal((T, TN, D)).astype(np.float32)
    want = j_seg.segment_sum_tiles(jt, jnp.asarray(vals), interpret=True)
    for got in (t_seg.segment_sum_tiles_ref(tt, torch.as_tensor(vals)),
                t_seg.segment_sum_tiles(tt, torch.as_tensor(vals))):
        _close(got, want, VAL_TOL)
    want = np.asarray(j_seg.segment_broadcast_tiles(jt, jnp.asarray(nodes), interpret=True))
    for got in (t_seg.segment_broadcast_tiles_ref(tt, torch.as_tensor(nodes)),
                t_seg.segment_broadcast_tiles(tt, torch.as_tensor(nodes))):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_plain_max_matches_jnp(kind):
    rng, jt, tt = _layouts(kind, seed=8)
    vals = rng.standard_normal((tt.tiles, tt.slots)).astype(np.float32)
    got = t_seg.segment_max_tiles_ref(tt, torch.as_tensor(vals)).numpy()
    want = np.asarray(j_seg.segment_max_tiles_jnp(jt, jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)          # −inf where a node is empty
    assert np.isinf(got).any()


def _butterfly(lanes):
    """Every lane adds lane r ^ m's value for m = 1, 2, ..., L / 2; lane 0."""
    m = 1
    while m < len(lanes):
        lanes = [lanes[r] + lanes[r ^ m] for r in range(len(lanes))]
        m *= 2
    return lanes[0]


def _k5_schedule(starts, order, y_or_x, L, g=None):
    """The K5 kernels' order in the dtype of the [T, H, S] inputs: lane r of
    a (node, head) takes the run's positions start + r, start + r + L, ...
    (through ``order`` where it is not None) and adds its terms in
    ascending order from 0 (exp(s − max) forward, y·g backward); the lanes
    merge by ``_butterfly``; padding gets 0.  Forward when ``g`` is None."""
    x = np.moveaxis(y_or_x, 1, 2)                     # [T, S, H]
    T, S, H = x.shape
    beg, end = starts[:, :-1], starts[:, 1:]
    slot = np.broadcast_to(np.arange(S), (T, S)) if order is None else order
    tile = np.arange(T)[:, None]
    longest = int((end - beg).max())
    lanes = [[(beg + p < end, slot[tile, np.minimum(beg + p, S - 1)])
              for p in range(r, longest, L)] for r in range(L)]
    terms = [(ok, s) for lane in lanes for ok, s in lane]
    if g is None:
        m = np.full(beg.shape + (H,), -np.inf)
        for ok, s in terms:
            m = np.where(ok[..., None], np.maximum(m, x[tile, s]), m)
        term = lambda s: np.exp(x[tile, s] - m)
    else:
        gs = np.moveaxis(g, 1, 2)
        term = lambda s: x[tile, s] * gs[tile, s]
    sums = []
    for lane in lanes:
        acc = np.zeros(beg.shape + (H,))
        for ok, s in lane:
            acc = np.where(ok[..., None], acc + term(s), acc)
        sums.append(acc)
    total = _butterfly(sums)
    out = np.zeros((T, S, H))
    for ok, s in terms:
        val = term(s) / np.maximum(total, 1e-30) if g is None \
            else x[tile, s] * (gs[tile, s] - total)
        t_ok, n_ok = np.nonzero(ok)
        out[t_ok, s[t_ok, n_ok]] = val[t_ok, n_ok]
    return np.moveaxis(out, 2, 1)


@pytest.mark.parametrize("kind", LAYOUTS)
def test_k5_schedule_matches_float64(kind):
    """The schedule at the rule's L and at every L it can pick, forward and
    backward, in float64, equals the float64 plain versions to 1e-12;
    padding positions hold scores the kernels must not read."""
    rng, _, tt = _layouts(kind)
    T, S, H = tt.tiles, tt.slots, 3
    starts, order = t_seg.layout_runs(tt)
    assert (order is None) == (kind != "shuffled")
    starts = starts.numpy().astype(np.int64)
    order = None if order is None else order.numpy().astype(np.int64)
    x = rng.standard_normal((T, H, S)) * 3
    g = rng.standard_normal((T, H, S))
    y = t_seg.segment_softmax_tiles_ref(tt, torch.as_tensor(x)).numpy()
    dx = t_seg.segment_softmax_tiles_bwd_ref(tt, torch.as_tensor(y), torch.as_tensor(g)).numpy()
    rule = t_seg._slot_lanes(t_seg._mean_run(tt))
    for L in sorted({rule, 1, 2, 4, 8}):
        np.testing.assert_allclose(_k5_schedule(starts, order, x, L), y, rtol=1e-12,
                                   atol=1e-12, err_msg=f"forward, L {L}")
        np.testing.assert_allclose(_k5_schedule(starts, order, y, L, g), dx, rtol=1e-12,
                                   atol=1e-12, err_msg=f"backward, L {L}")
