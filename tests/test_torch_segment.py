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
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


# ---------------------------------------------------------------------------
# K3 / K4 over every bucket of a layer: the row plan, the bucketed plain
# versions, and K4's schedule
# ---------------------------------------------------------------------------

EPS32 = float(np.finfo(np.float32).eps)


def _bucket_case(seed=7, n=900, tn=64):
    """Edges for a four-bucket layout (one narrow tile and one wide tile
    among them): sources near their destination, 40 long-range
    outliers, a hub row (450) that 300 slots read, and row 0 read by the
    slots clipped at the low end."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([rng.integers(0, n, 3000), rng.integers(3 * tn, 4 * tn, 700),
                          rng.integers(7 * tn, 9 * tn, 250)])
    dst = np.concatenate([dst[(dst // tn != 13) | (rng.random(dst.size) < 0.3)],
                          rng.integers(0, n, 300)])
    src = np.clip(dst + rng.integers(-60, 60, dst.size), 0, n - 1)
    src[-300:] = 450
    src[:40] = rng.integers(0, n, 40)
    return n, dst, src


@pytest.fixture(scope="module")
def buckets():
    """The case's buckets built by both packages (window 128): JAX's
    (plans, tiles, slot sources) and the port's plans."""
    n, dst, src = _bucket_case()
    jb = j_seg.build_seg_buckets(dst, n, tile_nodes=64)
    tb = t_seg.build_seg_buckets(dst, n, tile_nodes=64, device=CPU)
    assert [(t.tiles, t.slots) for t in tb.tiles] == [(2, 128), (9, 256), (3, 384),
                                                      (1, 1024)]
    jps, jsrc, tps = [], [], []
    for jt, tt in zip(jb.tiles, tb.tiles):
        js = j_seg.to_tiles(jt, jnp.asarray(src, jnp.int32))
        jps.append(j_seg.build_src_windows(jt, np.asarray(js), n, win=128))
        jsrc.append(js)
        tps.append(t_seg.build_src_windows(tt, np.asarray(js), n, win=128, device=CPU))
    return dict(n=n, jps=jps, jtiles=jb.tiles, jsrc=jsrc, tps=tps)


def _np_rows(jp, n):
    """Each slot's effective source row from JAX's plan, in numpy: the
    window row where lsrc is in the window and the row is below n, the
    outlier's source (n where it is not below n), else n."""
    lsrc, blk = np.asarray(jp.lsrc).astype(np.int64), np.asarray(jp.blk).astype(np.int64)
    row = blk[:, None] * jp.win + lsrc
    ok = (lsrc >= 0) & (lsrc < 2 * jp.win) & (row < n)
    row = np.where(ok, row, n).reshape(-1)
    o_slot, o_src = np.asarray(jp.out_slot), np.asarray(jp.out_src)
    fix = o_slot < row.size
    row[o_slot[fix]] = np.where(o_src[fix] < n, o_src[fix], n)
    return row


@pytest.mark.parametrize("cut", [0, 300])
def test_row_plan_matches_numpy(buckets, cut):
    """The all-bucket plan (slot offsets, effective rows, row_ptr, each row's
    slots in ascending order, the hub rows) against a numpy derivation from
    JAX's per-bucket plans; ``cut`` rows fewer than the plans were built for
    make in-window rows and outlier sources >= n."""
    n = buckets["n"] - cut
    rp = t_seg.row_plan(buckets["tps"], n)
    assert t_seg.row_plan(buckets["tps"], n) is rp            # cached per layout and n
    sizes = [p.lsrc.size for p in buckets["jps"]]
    assert rp.offsets == tuple(np.cumsum([0] + sizes))
    rows = np.concatenate([_np_rows(p, n) for p in buckets["jps"]])
    counts = np.bincount(rows, minlength=n + 1)[:n]
    row_ptr = np.concatenate([[0], np.cumsum(counts)])
    for got, want in ((rp.rows, rows), (rp.row_ptr, row_ptr),
                      (rp.slots, np.argsort(rows, kind="stable")[:row_ptr[-1]]),
                      (rp.hubs, np.flatnonzero(counts > 32))):
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), want)
    assert (rows == n).any() and (rows[rows < n] >= 0).all()
    if cut == 0:
        assert rp.hubs.tolist() == [0, 450] and counts.max() >= 300
        assert all(int((np.asarray(p.out_slot) < p.lsrc.size).sum()) > 0
                   for p in buckets["jps"])


@pytest.mark.parametrize("D", [3, 4, 16])
def test_gather_rows_buckets_ref_matches_interpret(buckets, D):
    """The bucketed plain gather equals JAX's ``gather_rows_windows(...,
    interpret=True)`` of each bucket exactly; so does the wrapper on CPU
    tensors, which launches nothing."""
    vals = np.random.default_rng(D).standard_normal((buckets["n"], D)).astype(np.float32)
    want = [np.asarray(j_seg.gather_rows_windows(p, t, s, jnp.asarray(vals), interpret=True))
            for p, t, s in zip(buckets["jps"], buckets["jtiles"], buckets["jsrc"])]
    before = t_seg.gather_rows_windows.launches
    for fn in (t_seg.gather_rows_buckets_ref, t_seg.gather_rows_buckets):
        got = fn(buckets["tps"], torch.as_tensor(vals))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert t_seg.gather_rows_windows.launches == before


@pytest.mark.parametrize("D", [3, 4, 16])
def test_gather_rows_buckets_grad_matches_interpret(buckets, D):
    """The gradient of the bucketed gather (one plain K4 over every bucket;
    bucket 1's output unused, so its cotangent is None) against ``jax.grad``
    of the same sum through JAX's per-bucket interpret-mode K3 / K4:
    rtol 1e-6 and, per element, 4·eps32·Σ|g| over the row's slots (JAX
    sums hi/lo-split onehot products per window, the port in slot order:
    two float32 orders of one sum)."""
    import jax

    n = buckets["n"]
    rng = np.random.default_rng(10 + D)
    vals = rng.standard_normal((n, D)).astype(np.float32)
    tgt = [rng.standard_normal((p.lsrc.size, D)).astype(np.float32) * (b != 1)
           for b, p in enumerate(buckets["jps"])]

    def jloss(v):
        return sum(jnp.sum(j_seg.gather_rows_windows(p, t, s, v, interpret=True) * g)
                   for p, t, s, g in zip(buckets["jps"], buckets["jtiles"],
                                         buckets["jsrc"], tgt))

    want = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(vals)))
    v = torch.as_tensor(vals).requires_grad_(True)
    outs = t_seg.gather_rows_buckets(buckets["tps"], v)
    before = t_seg.scatter_rows_windows.launches
    (got,) = torch.autograd.grad(sum((o * torch.as_tensor(g)).sum()
                                     for b, (o, g) in enumerate(zip(outs, tgt)) if b != 1), v)
    assert t_seg.scatter_rows_windows.launches == before
    sums = t_seg.scatter_rows_buckets_ref(buckets["tps"],
                                          [torch.as_tensor(np.abs(g)) for g in tgt], n)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 1e-6 * np.abs(want) + 4 * EPS32 * sums.numpy() + 1e-30)


def _k4_schedule(rp, g, hub_slots=32, lanes=32):
    """K4's schedule on the host, in ``g``'s dtype: every row with at most
    ``hub_slots`` slots sums them in ascending slot order from 0; a hub's
    lane l sums its slots l, l + 32, ... in order, then the lane sums merge
    by an xor butterfly over distances 16, 8, 4, 2, 1 (lane 0's result)."""
    row_ptr, slots = rp.row_ptr.numpy(), rp.slots.numpy()
    dv = np.zeros((rp.n, g.shape[1]), g.dtype)
    hubs = []
    for r in range(rp.n):
        own = slots[row_ptr[r]:row_ptr[r + 1]]
        if own.size > hub_slots:
            hubs.append(r)
            acc = np.zeros((lanes, g.shape[1]), g.dtype)
            for lane in range(lanes):
                for s in own[lane::lanes]:
                    acc[lane] = acc[lane] + g[s]
            m = lanes // 2
            while m:
                acc = acc + acc[np.arange(lanes) ^ m]
                m //= 2
            dv[r] = acc[0]
        else:
            for s in own:
                dv[r] = dv[r] + g[s]
    assert hub_slots != 32 or hubs == rp.hubs.tolist()
    return dv


@pytest.mark.parametrize("D", [3, 4, 16])
def test_k4_schedule_matches_index_add(buckets, D):
    """K4's schedule (the plan's rows, slot order and hub split) emulated in
    float64 agrees with float64 ``index_add_`` over the effective rows to
    1e-12; and float32 CPU ``index_add_`` (the plain K4) sums each row in
    slot order: it equals the float32 schedule bit for bit on every row that
    a thread owns, and a sequential slot-order sum on every row."""
    n = buckets["n"]
    rp = t_seg.row_plan(buckets["tps"], n)
    rng = np.random.default_rng(D)
    g = [rng.standard_normal((p.lsrc.size, D)) * np.exp(rng.standard_normal((p.lsrc.size, 1)))
         for p in buckets["jps"]]
    g64 = np.concatenate(g)
    want64 = t_seg.scatter_rows_buckets_ref(buckets["tps"], [torch.as_tensor(x) for x in g], n)
    np.testing.assert_allclose(_k4_schedule(rp, g64), want64.numpy(), rtol=1e-12, atol=1e-12)
    got32 = t_seg.scatter_rows_buckets_ref(
        buckets["tps"], [torch.as_tensor(x.astype(np.float32)) for x in g], n).numpy()
    sched32 = _k4_schedule(rp, g64.astype(np.float32))
    light = np.ones(n, bool)
    light[rp.hubs.numpy()] = False
    np.testing.assert_array_equal(got32[light], sched32[light])
    seq32 = _k4_schedule(rp, g64.astype(np.float32), hub_slots=10**9)
    np.testing.assert_array_equal(got32, seq32)
    before = t_seg.scatter_rows_windows.launches
    dv = t_seg.scatter_rows_buckets(buckets["tps"], [torch.as_tensor(x.astype(np.float32))
                                                     for x in g], n)
    np.testing.assert_array_equal(dv.numpy(), got32)
    assert t_seg.scatter_rows_windows.launches == before
