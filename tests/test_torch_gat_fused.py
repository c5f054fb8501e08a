"""PyTorch port vs the JAX package: the plain version of the fused GATv2
tile forward (K1) against ``gat_tile_fused(..., interpret=True)``.

Tolerance rtol 2e-4, atol 2e-5: the JAX side's interpret-mode kernel sums
through hi/lo-split matmuls in another order than the port's einsums (the
repo's own bound for this kernel, tests/test_segment.py).

The CUDA kernels' host-side parts are held here too: the per-layout run
starts and slot order (``layout_runs``) against numpy, the lane plan, and
the kernels' per-node schedule emulated in float64 against the plain
versions to 1e-12."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import gat_fused as j_gf
from gflownet_spai_tpu.ops import segment as j_seg
from gflownet_spai_tpu_torch.ops import gat_fused as t_gf
from gflownet_spai_tpu_torch.ops import segment as t_seg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 2e-4, 2e-5


def _case(uniform, H, D, seed=7, n=220, e=1800, tn=64):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, e)
    jt = j_seg.build_seg_tiles(ids, n, tile_nodes=tn)
    tt = t_seg.build_seg_tiles(ids, n, tile_nodes=tn, device="cpu")
    T, S, HD = jt.tiles, jt.slots, H * D
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    arrays = dict(attr=f32(T * S), xs=f32(1 if uniform else T * S, HD),
                  xd=f32(1 if uniform else jt.n_pad, HD), w_e=f32(HD),
                  att=f32(H, D))
    return jt, tt, arrays


def _both(jt, tt, arrays):
    order = ("attr", "xs", "xd", "w_e", "att")
    want = np.asarray(j_gf.gat_tile_fused(
        jt, *(jnp.asarray(arrays[k]) for k in order), interpret=True))
    targs = [torch.as_tensor(arrays[k]) for k in order]
    return want, t_gf.gat_tile_fused_ref(tt, *targs), targs


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("H,D", [(4, 4), (1, 4)])
def test_gat_tile_fused_ref_matches_interpret(uniform, H, D):
    jt, tt, arrays = _case(uniform, H, D)
    want, got, targs = _both(jt, tt, arrays)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the wrapper takes the plain version on CPU tensors, and launches nothing
    before = t_gf.gat_tile_fused.launches
    np.testing.assert_array_equal(t_gf.gat_tile_fused(tt, *targs).numpy(),
                                  got.numpy())
    assert t_gf.gat_tile_fused.launches == before
    # nodes with no slots (here the padded tail of the last tile) are zero rows
    lid = tt.local_dst.numpy()
    has_slot = np.zeros(tt.n_pad, bool)
    for t in range(tt.tiles):
        real = lid[t][lid[t] < tt.tile_nodes]
        has_slot[t * tt.tile_nodes + real] = True
    assert (~has_slot).any()
    assert not got.numpy()[~has_slot].any()


def test_gat_tile_fused_ref_wide_score_spread():
    """Two segments of one tile scoring ~+600 and ~−120: the per-segment
    shift keeps both softmaxes valid (out rows ≡ 1 for xs ≡ 1)."""
    ids = np.array([0, 0, 1, 1])
    jt = j_seg.build_seg_tiles(ids, 2, tile_nodes=8)
    tt = t_seg.build_seg_tiles(ids, 2, tile_nodes=8, device="cpu")
    HD = 8
    attr = np.zeros(jt.tiles * jt.slots, np.float32)
    attr[:2], attr[2:4] = 600.0, -600.0
    w_e = np.zeros(HD, np.float32); w_e[0] = 1.0
    att = np.zeros((1, HD), np.float32); att[0, 0] = 1.0
    arrays = dict(attr=attr, xs=np.ones((1, HD), np.float32),
                  xd=np.zeros((1, HD), np.float32), w_e=w_e, att=att)
    want, got, _ = _both(jt, tt, arrays)
    np.testing.assert_allclose(got.numpy()[:2], np.ones((2, HD)), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert not got.numpy()[2:].any()   # nodes without slots stay zero


# Gradients: K2's plain path (autograd through the plain forward, reached
# through the port's autograd.Function) against ``jax.grad`` through
# ``gat_tile_fused(..., interpret=True)``, which runs ``_bwd_kernel``.
# Tolerance rtol 5e-4, atol 5e-5: the repo's own bound for these gradients
# (tests/test_segment.py), for the same reason as the forward's.
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _grads_both(jt, tt, arrays, seed=3):
    import jax

    order = ("xs", "xd", "w_e", "att")
    rng = np.random.default_rng(seed)
    tgt = rng.standard_normal((jt.n_pad, arrays["w_e"].shape[0])).astype(np.float32)
    attr = arrays["attr"]

    def jloss(xs, xd, w_e, att):
        out = j_gf.gat_tile_fused(jt, jnp.asarray(attr), xs, xd, w_e, att,
                                  interpret=True)
        return jnp.sum(out * jnp.asarray(tgt))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(arrays[k]) for k in order))
    leaves = [torch.as_tensor(arrays[k]).requires_grad_(True) for k in order]
    out = t_gf.gat_tile_fused(tt, torch.as_tensor(attr), *leaves)
    got = torch.autograd.grad((out * torch.as_tensor(tgt)).sum(), leaves)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("H,D", [(4, 4), (1, 4)])
def test_gat_tile_fused_grads_match_interpret(uniform, H, D):
    jt, tt, arrays = _case(uniform, H, D)
    want, got = _grads_both(jt, tt, arrays)
    for name, w, g in zip(("xs", "xd", "w_e", "att"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
    # the plain backward launches nothing on CPU tensors
    before = t_gf.gat_tile_fused_bwd.launches
    t_gf.gat_tile_fused_bwd(tt, *(torch.as_tensor(arrays[k]) for k in
                                  ("attr", "xs", "xd", "w_e", "att")),
                            torch.ones((tt.n_pad, H * D)))
    assert t_gf.gat_tile_fused_bwd.launches == before


def test_gat_tile_fused_grads_wide_score_spread():
    """The wide-spread case of tests/test_segment.py: gradients stay finite
    and match through both segments' shifts."""
    ids = np.array([0, 0, 1, 1])
    jt = j_seg.build_seg_tiles(ids, 2, tile_nodes=8)
    tt = t_seg.build_seg_tiles(ids, 2, tile_nodes=8, device="cpu")
    HD = 8
    attr = np.zeros(jt.tiles * jt.slots, np.float32)
    attr[:2], attr[2:4] = 600.0, -600.0
    w_e = np.zeros(HD, np.float32); w_e[0] = 1.0
    att = np.zeros((1, HD), np.float32); att[0, 0] = 1.0
    rng = np.random.default_rng(5)
    arrays = dict(attr=attr, xs=rng.standard_normal((1, HD)).astype(np.float32),
                  xd=np.zeros((1, HD), np.float32), w_e=w_e, att=att)
    want, got = _grads_both(jt, tt, arrays)
    for w, g in zip(want, got):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL)


# The CUDA kernels' per-layout precompute and their per-node schedule, on
# the host.  ``layout_runs`` against a numpy construction; the schedule (each
# node walks its run once with an online softmax in K1; K2's two passes, its
# per-run sums and its per-block partials summed in block order) emulated in
# float64 torch, against the plain versions to 1e-12.

def _layout(kind, seed=11, n=300, e=2500, tn=64):
    """``sorted``: the builder's layout, plus an all-padding tile (no node
    id falls in tile 2) and empty nodes; ``shuffled``: the same with each
    tile's slots permuted and part of the padding marked −1 or TN + 5, so
    no node's slots form a run."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, e)
    ids = ids[ids // tn != 2]
    ids = np.concatenate([ids, np.full(70, 17)])       # a run longer than 64
    tt = t_seg.build_seg_tiles(ids, n, tile_nodes=tn, device="cpu")
    if kind == "shuffled":
        lid = tt.local_dst.numpy().copy()
        for t in range(tt.tiles):
            lid[t] = lid[t][rng.permutation(tt.slots)]
            pad = np.flatnonzero(lid[t] == tn)
            lid[t, pad[::3]] = -1
            lid[t, pad[1::3]] = tn + 5
        tt = dataclasses.replace(tt, local_dst=torch.as_tensor(lid))
    return rng, tt


@pytest.mark.parametrize("kind", ["sorted", "shuffled"])
def test_layout_runs_match_numpy(kind):
    _, tt = _layout(kind)
    T, S, TN = tt.tiles, tt.slots, tt.tile_nodes
    starts, order = t_gf.layout_runs(tt)
    lid = tt.local_dst.numpy()
    key = np.where((lid >= 0) & (lid < TN), lid, TN)
    want = np.stack([np.searchsorted(np.sort(k), np.arange(TN + 1)) for k in key])
    assert starts.dtype == torch.int32 and starts.shape == (T, TN + 1)
    np.testing.assert_array_equal(starts.numpy(), want)
    assert (want[:, TN] == (key < TN).sum(1)).all()
    assert (want[2] == 0).all()                        # the all-padding tile
    if kind == "sorted":
        assert order is None
    else:
        assert order.dtype == torch.int32 and order.shape == (T, S)
        np.testing.assert_array_equal(order.numpy(),
                                      np.argsort(key, axis=1, kind="stable"))
        assert (np.diff(np.take_along_axis(key, order.numpy(), 1), axis=1) >= 0).all()
    again = t_gf.layout_runs(tt)                        # cached per layout
    assert again[0] is starts and again[1] is order


@pytest.mark.parametrize("H,D,run,cap,plan", [
    (4, 4, 1.0, None, (1, 1, 4)), (1, 4, 1.0, None, (1, 1, 1)),
    (4, 4, 8.0, None, (1, 4, 16)), (1, 4, 8.0, None, (1, 4, 4)),
    (1, 4, 4.9, None, (1, 4, 4)), (4, 4, 3.0, None, (1, 2, 8)),
    (3, 5, 1.0, None, (1, 1, 4)), (8, 16, 8.0, None, (2, 2, 32)),
    (1, 256, 1.0, None, (32, 1, 32)), (2, 9, 40.0, None, (2, 8, 32)),
    (1, 4, 300.0, None, (1, 32, 32)),
    # the main path's buckets on 132 SMs (max_lanes 132·16·32 / (T·TN))
    (4, 4, 7.95, 5.6, (1, 1, 4)), (1, 4, 7.95, 5.6, (1, 4, 4)),
    (4, 4, 4.91, 528.0, (1, 4, 16)), (4, 4, 1.0, 3.0, (1, 1, 4))])
def test_lane_plan(H, D, run, cap, plan):
    """(channel lanes P, slot lanes Q, lanes per node G) by heads, width,
    mean run and the lanes per node that fit one wave."""
    assert t_gf._lane_plan(H, D, run, cap) == plan


@pytest.mark.parametrize("H,D", [(8, 40), (9, 4), (4, 65)])
def test_lane_plan_refuses(H, D):
    with pytest.raises(ValueError, match="limits"):
        t_gf._lane_plan(H, D)


def _node_rows(tt, attr, xs, xd, w_e, att, j, slope):
    """Every node's j-th slot of its run: (valid [T, TN], slot [T, TN],
    msg and xs rows [T, TN, H, D], scores [T, TN, H], attr [T, TN])."""
    starts, order = t_gf.layout_runs(tt)
    T, S, TN = tt.tiles, tt.slots, tt.tile_nodes
    H, D = att.shape
    st = starts.long()
    beg, runlen = st[:, :TN], st[:, 1:] - st[:, :TN]
    valid = j < runlen
    pos = (beg + j).clamp(max=S - 1)
    within = pos if order is None else order.long().gather(1, pos)
    slot = torch.arange(T)[:, None] * S + within
    xr = (xs.expand(T * S, H * D) if xs.shape[0] == 1 else xs)[slot]
    xd_n = (xd.expand(T * TN, H * D) if xd.shape[0] == 1 else xd).reshape(T, TN, H * D)
    e = attr[slot]
    msg = (xr + xd_n) + e[..., None] * w_e
    act = torch.where(msg > 0, msg, slope * msg)
    sc = (act.reshape(T, TN, H, D) * att).sum(-1)
    return valid, slot, msg.reshape(T, TN, H, D), xr.reshape(T, TN, H, D), sc, e


def _online(tt, run, H, Q):
    """Pass 1 of either kernel: each of Q slot lanes walks the run's slots
    q, q + Q, ... keeping a running max, a rescaled normaliser and rescaled
    sums of ``run(j)``'s per-slot terms; the lanes' states are then merged
    in the kernels' xor butterfly."""
    T, TN = tt.tiles, tt.tile_nodes
    starts, _ = t_gf.layout_runs(tt)
    longest = int((starts[:, 1:] - starts[:, :-1]).max())
    lanes = []
    for q in range(Q):
        m = torch.full((T, TN, H), -1e30, dtype=torch.float64)
        den = torch.zeros((T, TN, H), dtype=torch.float64)
        acc = 0.0
        for j in range(q, longest, Q):
            valid, sc, term = run(j)
            v = valid[..., None]
            new = v & (sc > m)
            r = torch.where(new, torch.exp(m - sc), torch.ones_like(sc))
            p = torch.where(v, torch.where(new, torch.ones_like(sc), torch.exp(sc - m)),
                            torch.zeros_like(sc))
            m = torch.where(new, sc, m)
            den = den * r + p
            rr, pp = (r, p) if term.dim() == 3 else (r[..., None], p[..., None])
            acc = acc * rr + term * pp
        lanes.append((m, den, acc))
    off = 1
    while off < Q:
        merged = []
        for q in range(Q):
            (m, den, acc), (mo, deno, acco) = lanes[q], lanes[q ^ off]
            mn = torch.maximum(m, mo)
            r, ro = torch.exp(m - mn), torch.exp(mo - mn)
            rr, rro = (r, ro) if torch.is_tensor(acc) and acc.dim() == 3 else \
                (r[..., None], ro[..., None])
            merged.append((mn, den * r + deno * ro, acc * rr + acco * rro))
        lanes, off = merged, 2 * off
    return (*lanes[0], longest)


def _emulate_fwd(tt, attr, xs, xd, w_e, att, slope=0.2):
    H, D = att.shape
    run = lambda j: (lambda v, s, msg, xr, sc, e: (v, sc, xr))(
        *_node_rows(tt, attr, xs, xd, w_e, att, j, slope))
    m, den, acc, _ = _online(tt, run, H, t_gf._lane_plan(H, D, t_gf._mean_run(tt))[1])
    out = torch.where(den[..., None] > 0, acc / torch.where(den > 0, den, 1.0)[..., None],
                      torch.zeros_like(acc))
    return out.reshape(tt.n_pad, H * D)


def _emulate_bwd(tt, attr, xs, xd, w_e, att, g, slope=0.2):
    T, S, TN = tt.tiles, tt.slots, tt.tile_nodes
    H, D = att.shape
    npb = 128 // t_gf._lane_plan(H, D, t_gf._mean_run(tt))[2]   # nodes a block
    HD = H * D
    gv = g.reshape(T, TN, H, D)

    al0 = _node_rows(tt, attr, xs, xd, w_e, att, 0, slope)[3]
    al0 = (gv * al0).sum(-1)                           # al_bar of each run's first slot

    def run(j):
        v, _, _, xr, sc, _ = _node_rows(tt, attr, xs, xd, w_e, att, j, slope)
        return v, sc, (gv * xr).sum(-1) - al0

    m, den, num, longest = _online(tt, run, H, t_gf._lane_plan(H, D, t_gf._mean_run(tt))[1])
    safe = torch.where(den > 0, den, 1.0)
    seg = torch.where(den > 0, num / safe, 0.0)        # seg - al0
    dxs = torch.zeros((T * S, HD), dtype=torch.float64)
    ndxd = torch.zeros((T, TN, H, D), dtype=torch.float64)
    node_datt, node_dwe, node_dxs = (torch.zeros((T, TN, H, D), dtype=torch.float64)
                                     for _ in range(3))
    for j in range(longest):
        valid, slot, msg, xr, sc, e = _node_rows(tt, attr, xs, xd, w_e, att, j, slope)
        alpha = torch.where(den > 0, torch.exp(sc - m) / safe, 0.0)
        sb = (alpha * (((gv * xr).sum(-1) - al0) - seg))[..., None]
        act = torch.where(msg > 0, msg, slope * msg)
        mb = torch.where(msg > 0, sb * att, slope * sb * att)
        dx = gv * alpha[..., None] + mb
        vm = valid[..., None, None]
        dx, mb = torch.where(vm, dx, 0.0), torch.where(vm, mb, 0.0)
        ndxd += mb
        node_datt += torch.where(vm, act * sb, 0.0)
        node_dwe += e[..., None, None] * mb
        node_dxs += dx
        rows = slot[valid]
        dxs[rows] = dx[valid].reshape(-1, HD)
    chunks = -(-TN // npb)

    def block_order_sum(per_node):
        # per-block rows; each 32 rows summed in block order, then the
        # group sums in group order
        part = torch.nn.functional.pad(per_node.reshape(T, TN, HD),
                                       (0, 0, 0, chunks * npb - TN))
        rows = part.reshape(T * chunks, npb, HD).sum(1)
        total = torch.zeros(HD, dtype=torch.float64)
        for group in rows.split(32):
            acc = torch.zeros(HD, dtype=torch.float64)
            for r in group:
                acc = acc + r
            total = total + acc
        return total

    dxs = block_order_sum(node_dxs)[None] if xs.shape[0] == 1 else dxs
    dxd = block_order_sum(ndxd)[None] if xd.shape[0] == 1 else ndxd.reshape(T * TN, HD)
    return dxs, dxd, block_order_sum(node_dwe), block_order_sum(node_datt).reshape(H, D)


@pytest.mark.parametrize("kind", ["sorted", "shuffled"])
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("H,D", [(4, 4), (1, 4), (3, 5)])
def test_host_schedule_matches_plain(kind, uniform, H, D):
    rng, tt = _layout(kind)
    T, S, HD = tt.tiles, tt.slots, H * D
    f = lambda *shape: torch.as_tensor(rng.standard_normal(shape))
    args = (f(T * S), f(1 if uniform else T * S, HD), f(1 if uniform else tt.n_pad, HD),
            f(HD), f(H, D))
    g = f(tt.n_pad, HD)
    want = t_gf.gat_tile_fused_ref(tt, *args)
    got = _emulate_fwd(tt, *args)
    tol = lambda w: dict(rtol=1e-12, atol=1e-12 * max(float(w.abs().max()), 1.0))
    torch.testing.assert_close(got, want, **tol(want))
    assert float(want.abs().max()) > 0.5
    for name, a, b in zip(("xs", "xd", "w_e", "att"), _emulate_bwd(tt, *args, g),
                          t_gf.gat_tile_fused_bwd_ref(tt, *args, g)):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, **tol(b), msg=name)
