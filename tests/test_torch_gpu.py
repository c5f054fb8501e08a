"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: run with ``python -m pytest tests/ -m gpu -q`` on a machine
with an NVIDIA GPU; without one every test skips (decided in a fixture).

K1 tolerance rtol 1e-5, atol 1e-5: its normaliser and output sums are
shared-memory float atomics, whose order changes from run to run.  K3 only
moves values, so it must match exactly.  K2 sums its segment and per-tile
terms with atomics too (and reduces the per-tile weight gradients over up
to 1152 slots per tile): rtol 1e-4, and atol 1e-4 times the largest
magnitude of the gradient (at least 1), because the uniform rows' gradients
are float32 sums of ~24,000 slot terms of mixed sign, which two summation
orders round apart by ~1e-5 absolute (measured on the card).  K4 adds each
row's slots with float atomics in run-dependent order: rtol 1e-5, atol
1e-6."""

import numpy as np
import pytest
import torch

from gflownet_spai_tpu_torch.models import policies as pol
from gflownet_spai_tpu_torch.ops import gat_fused as gf
from gflownet_spai_tpu_torch.ops import segment as seg
from gflownet_spai_tpu_torch.sparse import gallery

pytestmark = pytest.mark.gpu
K2_RTOL, K2_ATOL = 1e-4, 1e-4
K4_RTOL, K4_ATOL = 1e-5, 1e-6


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


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("H,D", [(4, 4), (1, 4)])
def test_k2_matches_plain(cuda, uniform, H, D):
    """K2 (the fused backward) against autograd through the plain forward,
    through the autograd path that the training step takes."""
    rng, n, tiles, _, _ = _graph_case(cuda, seed=1)
    T, S, HD = tiles.tiles, tiles.slots, H * D
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                   device=cuda)
    attr = f(T * S)
    ins = [f(1 if uniform else T * S, HD), f(1 if uniform else tiles.n_pad, HD),
           f(HD), f(H, D)]
    g = f(tiles.n_pad, HD)
    before = gf.gat_tile_fused_bwd.launches
    leaves = [x.clone().requires_grad_(True) for x in ins]
    out = gf.gat_tile_fused(tiles, attr, *leaves)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert gf.gat_tile_fused_bwd.launches == before + 1
    want = gf.gat_tile_fused_bwd_ref(tiles, attr, *ins, g)
    for a, b in zip(got, want):
        scale = max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a, b, rtol=K2_RTOL, atol=K2_ATOL * scale)


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


@pytest.mark.parametrize("D", [4, 16])
def test_k4_matches_plain(cuda, D):
    """K4 (the windowed scatter-add) as the gradient of the K3 gather."""
    rng, n, tiles, src_t, plan = _graph_case(cuda)
    vals = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32,
                        device=cuda, requires_grad=True)
    g = torch.as_tensor(rng.standard_normal((tiles.tiles * tiles.slots, D)),
                        dtype=torch.float32, device=cuda)
    before = seg.scatter_rows_windows.launches
    (got,) = torch.autograd.grad(seg.gather_rows_windows(plan, tiles, src_t, vals),
                                 vals, g)
    torch.cuda.synchronize()
    assert seg.scatter_rows_windows.launches == before + 1
    torch.testing.assert_close(got, seg.scatter_rows_windows_ref(plan, g, n),
                               rtol=K4_RTOL, atol=K4_ATOL)


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


def test_train_two_steps_on_card(cuda, tmp_path):
    """Two train steps of the training slice's recipe on orsirr_like16
    (bucketed tile layout): every kernel of the path launches each step,
    the loss is finite and the checkpoint restores."""
    from gflownet_spai_tpu_torch.train import TrainConfig, restore_checkpoint, setup
    from gflownet_spai_tpu_torch.train.loop import train

    cfg = TrainConfig(matrix="orsirr_like16", env_format="coo",
                      gat_tiled_min_edges=0, loss="subtb", backward="linear",
                      t_cap=64, terminal_bias=8.0, batch_size=8, lr=2e-3,
                      plateau_patience=0, replay_size=8, replay_samples=2,
                      replay_prioritized=1.0, alpha_fixed=0.98,
                      reward_baseline="identity", num_epochs=2,
                      out_dir=str(tmp_path))
    counters = (gf.gat_tile_fused, gf.gat_tile_fused_bwd,
                seg.gather_rows_windows, seg.scatter_rows_windows)
    before = [fn.launches for fn in counters]
    state, history = train(cfg, progress=False)
    torch.cuda.synchronize()
    # 2 buckets: K1 and K2 once per bucket and layer, K3 and K4 once per bucket
    assert [fn.launches - b for fn, b in zip(counters, before)] == [8, 8, 4, 4]
    assert np.isfinite(history).all() and state.epoch == 2
    assert state.params.log_z.device.type == "cuda"
    *_, template = setup(cfg)
    restored = restore_checkpoint(str(tmp_path), template)
    assert restored.epoch == 2
    assert torch.equal(restored.params.forward.fc_w, state.params.forward.fc_w)
