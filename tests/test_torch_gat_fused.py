"""PyTorch port vs the JAX package: the plain version of the fused GATv2
tile forward (K1) against ``gat_tile_fused(..., interpret=True)``.

Tolerance rtol 2e-4, atol 2e-5: the JAX side's interpret-mode kernel sums
through hi/lo-split matmuls in another order than the port's einsums (the
repo's own bound for this kernel, tests/test_segment.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import gat_fused as j_gf
from gflownet_spai_tpu.ops import segment as j_seg
from gflownet_spai_tpu_torch.ops import gat_fused as t_gf
from gflownet_spai_tpu_torch.ops import segment as t_seg

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
