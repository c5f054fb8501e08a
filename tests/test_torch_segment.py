"""PyTorch port vs the JAX package: node-tile layouts, bucket ladder, source
windows and the plain version of the windowed row gather (K3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.models import policies as j_pol
from gflownet_spai_tpu.ops import segment as j_seg
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu_torch.models import policies as t_pol
from gflownet_spai_tpu_torch.ops import segment as t_seg
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse.types import COO as TCOO

CPU = "cpu"


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor)
                                  else np.asarray(t), np.asarray(j))


def _assert_tiles_equal(tt, jt):
    for f in ("num_nodes", "num_edges", "tiles", "tile_nodes", "slots"):
        assert getattr(tt, f) == getattr(jt, f), f
    _eq(tt.perm, jt.perm)
    _eq(tt.local_dst, jt.local_dst)


def _assert_sorted_by_local_dst(tiles):
    lid = tiles.local_dst.numpy()
    assert (np.diff(lid, axis=1) >= 0).all(), "slots not sorted by local dst"
    assert lid.min() >= 0 and lid.max() <= tiles.tile_nodes


def _skewed_ids(seed=11, n=512, tn=64):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, n, 2000), rng.integers(0, tn, 3000)])


@pytest.mark.parametrize("tile_nodes", [32, 64])
def test_build_seg_tiles_equal_and_sorted(tile_nodes):
    ids = _skewed_ids()
    tt = t_seg.build_seg_tiles(ids, 512, tile_nodes=tile_nodes, device=CPU)
    _assert_tiles_equal(tt, j_seg.build_seg_tiles(ids, 512, tile_nodes=tile_nodes))
    _assert_sorted_by_local_dst(tt)


def test_build_seg_buckets_equal_and_sorted():
    ids = _skewed_ids()
    tb = t_seg.build_seg_buckets(ids, 512, tile_nodes=64, device=CPU)
    jb = j_seg.build_seg_buckets(ids, 512, tile_nodes=64)
    assert len(tb.tiles) == len(jb.tiles) >= 2
    assert tb.slot_total == jb.slot_total
    for tt, jt, ti, ji in zip(tb.tiles, jb.tiles, tb.tile_idx, jb.tile_idx):
        _assert_tiles_equal(tt, jt)
        _assert_sorted_by_local_dst(tt)
        _eq(ti, ji)


def _window_case(seed=3, n=700, e=6000, spread=60, jumps=40):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-spread, spread, e), 0, n - 1)
    src[:jumps] = rng.integers(0, n, jumps)          # long-range outliers
    return n, dst, src


@pytest.mark.parametrize("win", [None, 128])
def test_build_src_windows_equal(win):
    n, dst, src = _window_case()
    tt = t_seg.build_seg_tiles(dst, n, tile_nodes=64, device=CPU)
    jt = j_seg.build_seg_tiles(dst, n, tile_nodes=64)
    t_src = t_seg.to_tiles(tt, torch.as_tensor(src))
    j_src = np.asarray(j_seg.to_tiles(jt, jnp.asarray(src, jnp.int32)))
    _eq(t_src, j_src)
    tp = t_seg.build_src_windows(tt, t_src, n, win=win, device=CPU)
    jp = j_seg.build_src_windows(jt, j_src, n, win=win)
    assert (tp.win, tp.rows_pad) == (jp.win, jp.rows_pad)
    for f in ("lsrc", "blk", "out_slot", "out_src"):
        _eq(getattr(tp, f), getattr(jp, f))


@pytest.mark.parametrize("D", [4, 16])
def test_gather_rows_windows_ref_matches_interpret(D):
    n, dst, src = _window_case()
    jt = j_seg.build_seg_tiles(dst, n, tile_nodes=64)
    j_src = j_seg.to_tiles(jt, jnp.asarray(src, jnp.int32))
    jp = j_seg.build_src_windows(jt, np.asarray(j_src), n, win=128)
    assert int((np.asarray(jp.out_slot) < jt.tiles * jt.slots).sum()) > 0
    tt = t_seg.build_seg_tiles(dst, n, tile_nodes=64, device=CPU)
    tp = t_seg.build_src_windows(tt, np.asarray(j_src), n, win=128, device=CPU)
    vals = np.random.default_rng(D).standard_normal((n, D)).astype(np.float32)
    want = np.asarray(j_seg.gather_rows_windows(
        jp, jt, j_src, jnp.asarray(vals), interpret=True))
    got = t_seg.gather_rows_windows_ref(tp, tt, torch.as_tensor(vals))
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper takes the plain version on CPU tensors, and launches nothing
    before = t_seg.gather_rows_windows.launches
    np.testing.assert_array_equal(
        t_seg.gather_rows_windows(tp, tt, None, torch.as_tensor(vals)).numpy(),
        want)
    assert t_seg.gather_rows_windows.launches == before


def test_tiled_graph_from_seed_equal():
    j = j_gallery.random_spd(80, density=0.05, seed=12)
    j = JCOO(row=j.row, col=j.col, data=j.data.astype(jnp.float32), shape=j.shape)
    t = t_gallery.random_spd(80, density=0.05, seed=12)
    t = TCOO(row=t.row, col=t.col, data=t.data.astype(np.float32), shape=t.shape)
    jg = j_pol.tiled_graph_from_seed(j, tile_nodes=32)
    tg = t_pol.tiled_graph_from_seed(t, tile_nodes=32, device=CPU)
    _eq(tg.x, jg.x)
    _eq(tg.src_t, jg.src_t)
    _eq(tg.dst_t, jg.dst_t)
    np.testing.assert_allclose(tg.attr_t.numpy(), np.asarray(jg.attr_t), rtol=1e-6)
    _assert_tiles_equal(tg.tiles, jg.tiles)
    for f in ("lsrc", "blk", "out_slot", "out_src", "win", "rows_pad"):
        _eq(getattr(tg.srcwin, f), getattr(jg.srcwin, f))
    np.testing.assert_allclose(tg.action_feats.numpy(),
                               np.asarray(jg.action_feats), rtol=1e-5, atol=1e-6)
    assert len(tg.gat_buckets) == len(jg.gat_buckets) >= 2
    for tb, jb in zip(tg.gat_buckets, jg.gat_buckets):
        _assert_tiles_equal(tb.tiles, jb.tiles)
        _assert_sorted_by_local_dst(tb.tiles)
        _eq(tb.tile_idx, jb.tile_idx)
        _eq(tb.src_t, jb.src_t)
        np.testing.assert_allclose(tb.attr_t.numpy(), np.asarray(jb.attr_t),
                                   rtol=1e-6)
        for f in ("lsrc", "blk", "out_slot", "out_src", "win", "rows_pad"):
            _eq(getattr(tb.srcwin, f), getattr(jb.srcwin, f))


def _grad_case(seed=3):
    n, dst, src = _window_case(seed=seed)
    jt = j_seg.build_seg_tiles(dst, n, tile_nodes=64)
    j_src = j_seg.to_tiles(jt, jnp.asarray(src, jnp.int32))
    jp = j_seg.build_src_windows(jt, np.asarray(j_src), n, win=128)
    tt = t_seg.build_seg_tiles(dst, n, tile_nodes=64, device=CPU)
    tp = t_seg.build_src_windows(tt, np.asarray(j_src), n, win=128, device=CPU)
    return n, jt, j_src, jp, tt, tp


@pytest.mark.parametrize("D", [4, 16])
def test_gather_rows_windows_grad_matches_interpret(D):
    """The port's gradient of the K3 gather (K4's plain version with the
    outlier fixup) against ``jax.grad`` through
    ``gather_rows_windows(..., interpret=True)``, which runs K4 in interpret
    mode, on a plan with outliers and padding slots.  Tolerance rtol 5e-4,
    atol 5e-5 (the repo's own for these gradients: the interpret-mode
    kernel sums hi/lo-split products in another order)."""
    import jax

    n, jt, j_src, jp, tt, tp = _grad_case()
    n_slots = jt.tiles * jt.slots
    assert int((np.asarray(jp.out_slot) < n_slots).sum()) > 0        # outliers
    assert int((np.asarray(jt.local_dst) >= jt.tile_nodes).sum()) > 0  # padding
    rng = np.random.default_rng(D)
    vals = rng.standard_normal((n, D)).astype(np.float32)
    tgt = rng.standard_normal((n_slots, D)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(j_seg.gather_rows_windows(
        jp, jt, j_src, v, interpret=True) * jnp.asarray(tgt)))(jnp.asarray(vals))
    v = torch.as_tensor(vals).requires_grad_(True)
    (got,) = torch.autograd.grad(
        (t_seg.gather_rows_windows(tp, tt, None, v) * torch.as_tensor(tgt)).sum(), v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    before = t_seg.scatter_rows_windows.launches
    t_seg.scatter_rows_windows(tp, torch.as_tensor(tgt), n)
    assert t_seg.scatter_rows_windows.launches == before


def test_scatter_rows_windows_ref_is_index_add():
    """The plain K4 equals ``index_add_`` of the slot cotangents onto the
    rows that the gather reads (the plain ``vals[src_t]`` gradient, with
    padding slots dropped)."""
    n, jt, j_src, jp, tt, tp = _grad_case(seed=4)
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (jt.tiles * jt.slots, 4)).astype(np.float32))
    src = torch.as_tensor(np.array(j_src)).long()
    real = (tt.local_dst.reshape(-1) < tt.tile_nodes)
    rows = torch.where(real, src, n)
    want = torch.zeros((n + 1, 4)).index_add_(0, rows, g)[:n]
    got = t_seg.scatter_rows_windows_ref(tp, g, n)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(t_seg.effective_rows(tp, n), rows)
