"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: run with ``python -m pytest tests/ -m gpu -q`` on a machine
with an NVIDIA GPU; without one every test skips (decided in a fixture).

K1 tolerance rtol 1e-5, atol 1e-5: its normaliser and output sums are
shared-memory float atomics, whose order changes from run to run.  K3 only
moves values, so it must match exactly."""

import numpy as np
import pytest
import torch

from gflownet_spai_tpu_torch.models import policies as pol
from gflownet_spai_tpu_torch.ops import gat_fused as gf
from gflownet_spai_tpu_torch.ops import segment as seg
from gflownet_spai_tpu_torch.sparse import gallery

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph_case(dev, seed=0, n=3000, e=24000, tn=128):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n, e)
    src = np.clip(dst + rng.integers(-200, 200, e), 0, n - 1)
    src[:100] = rng.integers(0, n, 100)
    tiles = seg.build_seg_tiles(dst, n, tile_nodes=tn, device=dev)
    src_t = seg.to_tiles(tiles.to("cpu"), torch.as_tensor(src))
    plan = seg.build_src_windows(tiles.to("cpu"), src_t, n, win=256, device=dev)
    return rng, n, tiles, src_t.to(dev), plan


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("H,D", [(4, 4), (1, 4)])
def test_k1_matches_plain(cuda, uniform, H, D):
    rng, n, tiles, _, _ = _graph_case(cuda)
    T, S, HD = tiles.tiles, tiles.slots, H * D
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                   device=cuda)
    args = (f(T * S), f(1 if uniform else T * S, HD),
            f(1 if uniform else tiles.n_pad, HD), f(HD), f(H, D))
    before = gf.gat_tile_fused.launches
    got = gf.gat_tile_fused(tiles, *args)
    torch.cuda.synchronize()
    assert gf.gat_tile_fused.launches == before + 1
    want = gf.gat_tile_fused_ref(tiles, *args)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_k1_refuses_gradients(cuda):
    _, _, tiles, _, _ = _graph_case(cuda)
    T, S = tiles.tiles, tiles.slots
    xs = torch.ones((1, 4), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K2"):
        gf.gat_tile_fused(tiles, torch.zeros(T * S, device=cuda), xs,
                          torch.zeros((1, 4), device=cuda),
                          torch.zeros(4, device=cuda),
                          torch.zeros((1, 4), device=cuda))


@pytest.mark.parametrize("D", [4, 16])
def test_k3_matches_plain(cuda, D):
    rng, n, tiles, src_t, plan = _graph_case(cuda)
    assert int((plan.out_slot < tiles.tiles * tiles.slots).sum()) > 0
    vals = torch.as_tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                           device=cuda)
    before = seg.gather_rows_windows.launches
    got = seg.gather_rows_windows(plan, tiles, src_t, vals)
    torch.cuda.synchronize()
    assert seg.gather_rows_windows.launches == before + 1
    torch.testing.assert_close(got, seg.gather_rows_windows_ref(plan, tiles, vals),
                               rtol=0, atol=0)


def test_tiled_policy_logits_match_dense_path(cuda):
    """The kernel path (K1 + K3 over buckets) against the per-edge scatter
    path, both on the card."""
    from gflownet_spai_tpu_torch.gfn.gflownet import GFlowNetConfig, init_params

    seed = gallery.orsirr_like(24)
    seed = seed.with_data(seed.data.astype(np.float32))
    cfg = GFlowNetConfig(num_actions=seed.nnz + 1)
    params = init_params(torch.Generator().manual_seed(0), cfg, device=cuda)
    tg = pol.tiled_graph_from_seed(seed, tile_nodes=128, device=cuda)
    dg = pol.graph_from_seed(seed, device=cuda)
    k1, k3 = gf.gat_tile_fused.launches, seg.gather_rows_windows.launches
    got = pol.forward_policy_logits(params.forward, tg, cfg.num_actions, 4, 4)
    torch.cuda.synchronize()
    assert gf.gat_tile_fused.launches - k1 == 2 * len(tg.gat_buckets)
    assert seg.gather_rows_windows.launches - k3 == len(tg.gat_buckets)
    want = pol.forward_policy_logits(params.forward, dg, cfg.num_actions, 4, 4)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
