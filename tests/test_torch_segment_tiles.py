"""PyTorch port: the host side of the tile segment sum (K6) and broadcast
(K7).  ``layout_runs`` (each tile's run starts, shared by K1, K2 and K6)
against numpy; K6's lane plan; K6's per-node schedule (R slot lanes each
adding every R-th slot of a run in ascending order, then an xor butterfly
over the slot lanes) emulated in float64 against float64 sums to 1e-12;
and the plain K6 and K7 against JAX's ``_sum_pallas`` and
``_broadcast_pallas`` in interpret mode.

The layouts are the card tests' (``tests/test_torch_gpu.py``): ``empty``
has two tiles without a slot and a 300-slot hub; ``padded`` a 1,000-slot
hub, so most of every other tile is padding.  Tolerance against JAX: K7
moves values, exactly; K6 sums in another order than the onehot matmul,
rtol 1e-5 plus, per element, 4·eps32 times the sum of its terms'
magnitudes (the bound ``chip_smoke.py`` holds the kernel to)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import segment as j_seg
from gflownet_spai_tpu_torch.ops import gat_fused as t_gf
from gflownet_spai_tpu_torch.ops import segment as t_seg

EPS32 = float(np.finfo(np.float32).eps)


def _ids(kind):
    rng = np.random.default_rng(3)
    n, tn = 1500, 128
    if kind == "empty":
        ids = rng.integers(0, n, 12000)
        ids = ids[(ids // tn != 2) & (ids // tn != 5)]
        ids = np.concatenate([ids, np.full(300, 900)])
    else:
        ids = np.concatenate([rng.integers(0, n, 3000), np.full(1000, 40)])
    return rng, ids, n, tn


def _layout(kind):
    rng, ids, n, tn = _ids(kind)
    return rng, t_seg.build_seg_tiles(ids, n, tile_nodes=tn, device="cpu")


@pytest.mark.parametrize("kind", ["empty", "padded"])
def test_layout_runs_match_numpy(kind):
    _, tt = _layout(kind)
    T, TN = tt.tiles, tt.tile_nodes
    starts, order = t_seg.layout_runs(tt)
    lid = tt.local_dst.numpy()
    want = np.stack([np.searchsorted(row, np.arange(TN + 1)) for row in lid])
    assert starts.dtype == torch.int32 and starts.shape == (T, TN + 1)
    np.testing.assert_array_equal(starts.numpy(), want)
    assert order is None                               # build_seg_tiles writes runs
    runs = np.diff(want, axis=1)
    assert int(runs.max()) >= (300 if kind == "empty" else 1000)   # the hub
    if kind == "empty":
        assert (want[[2, 5]] == 0).all()               # the tiles without a slot
    nodes = int((runs > 0).sum())
    assert t_seg._mean_run(tt) == pytest.approx(int(want[:, TN].sum()) / nodes)
    again = t_seg.layout_runs(tt)                      # cached per layout
    assert again[0] is starts and again[1] is None
    assert t_gf.layout_runs is t_seg.layout_runs and t_gf._mean_run is t_seg._mean_run


@pytest.mark.parametrize("q,run,plan", [
    (4, 4.0, (4, 2)), (1, 4.0, (1, 2)), (16, 4.0, (16, 2)), (1, 1.0, (1, 1)),
    (4, 300.0, (4, 8)), (16, 300.0, (4, 8)), (3, 8.0, (4, 4)), (128, 1.0, (32, 1))])
def test_sum_lanes(q, run, plan):
    """(chunk lanes P, slot lanes R) by the row's chunks and the mean run;
    R does not depend on the row's width."""
    assert t_seg._sum_lanes(q, run) == plan
    assert t_seg._sum_lanes(1, run)[1] == plan[1]


def _k6_schedule(starts, vals, R):
    """K6's per-node order in the dtype of ``vals`` [T, S, D]: slot lane r
    adds the run's rows start + r, start + r + R, ... in ascending order
    from 0; then, for m = 1, 2, ..., R / 2, every lane adds lane r ^ m's
    sum to its own (lane distance m·P in the kernel); lane 0 is written."""
    T, S, D = vals.shape
    beg, end = starts[:, :-1], starts[:, 1:]
    longest = int((end - beg).max())
    tile = np.arange(T)[:, None]
    lanes = []
    for r in range(R):
        acc = np.zeros(beg.shape + (D,), vals.dtype)
        for s in range(r, longest, R):
            pos = beg + s
            ok = pos < end
            acc = np.where(ok[..., None], acc + vals[tile, np.minimum(pos, S - 1)], acc)
        lanes.append(acc)
    m = 1
    while m < R:
        lanes = [lanes[r] + lanes[r ^ m] for r in range(R)]
        m *= 2
    return lanes[0].reshape(-1, D)


@pytest.mark.parametrize("kind", ["empty", "padded"])
@pytest.mark.parametrize("D", [16, 4, 3, 1])
def test_k6_schedule_matches_sums(kind, D):
    """The schedule at the plan's R (and at every R the plan can pick), in
    float64, equals the float64 plain sums to 1e-12; padding slots hold
    values the sums must not read."""
    rng, tt = _layout(kind)
    T, S = tt.tiles, tt.slots
    vals = rng.standard_normal((T, S, D)) * np.exp(rng.standard_normal((T, S, 1)))
    starts = t_seg.layout_runs(tt)[0].numpy().astype(np.int64)
    want = t_seg.segment_sum_tiles_ref(tt, torch.as_tensor(vals)).numpy()
    q = D // 4 if D % 4 == 0 else D
    R = t_seg._sum_lanes(q, t_seg._mean_run(tt))[1]
    for r in sorted({R, 1, 2, 4, 8}):
        np.testing.assert_allclose(_k6_schedule(starts, vals, r), want, rtol=1e-12,
                                   atol=1e-12, err_msg=f"R {r}")


@pytest.mark.parametrize("D", [16, 4, 1])
def test_plain_k6_k7_match_pallas(D):
    """The plain K6 and K7 (and the public wrappers, which take them on CPU
    tensors) against the interpret-mode Pallas kernels on the hub layout."""
    rng, ids, n, tn = _ids("padded")
    tt = t_seg.build_seg_tiles(ids, n, tile_nodes=tn, device="cpu")
    jt = j_seg.build_seg_tiles(ids, n, tile_nodes=tn)
    np.testing.assert_array_equal(tt.local_dst.numpy(), np.asarray(jt.local_dst))
    T, S, TN = tt.tiles, tt.slots, tt.tile_nodes
    vals = rng.standard_normal((T, S, D)).astype(np.float32)
    nodes = rng.standard_normal((T, TN, D)).astype(np.float32)

    want = np.asarray(j_seg._sum_pallas(TN, True, jt.local_dst, jnp.asarray(vals)))
    mags = t_seg.segment_sum_tiles_ref(tt, torch.as_tensor(np.abs(vals))).numpy()
    bound = 1e-5 * np.abs(want.reshape(-1, D)) + 4 * EPS32 * mags
    for got in (t_seg.segment_sum_tiles_ref(tt, torch.as_tensor(vals)),
                t_seg.segment_sum_tiles(tt, torch.as_tensor(vals))):
        err = np.abs(got.numpy() - want.reshape(-1, D))
        assert (err <= bound).all(), f"max err {err.max():.3e}"

    want = np.asarray(j_seg._broadcast_pallas(TN, True, jt.local_dst, jnp.asarray(nodes)))
    for got in (t_seg.segment_broadcast_tiles_ref(tt, torch.as_tensor(nodes)),
                t_seg.segment_broadcast_tiles(tt, torch.as_tensor(nodes))):
        np.testing.assert_array_equal(got.numpy(), want)
