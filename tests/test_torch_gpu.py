"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: run with ``python -m pytest tests/ -m gpu -q`` on a machine
with an NVIDIA GPU; without one every test skips (decided in a fixture).

K1 tolerance rtol 1e-5, atol 1e-5: its online softmax rescales running
sums and divides once per node, where the plain version divides per slot
and sums by matmuls (float32 rounding, over runs of up to 300 slots here).
K3 only moves values, so it must match exactly.  K2 sums its segment and
per-tile terms in a fixed order, another than the plain version's (the
per-tile weight gradients over up to 1152 slots per tile): rtol 1e-4, and
atol 1e-4 times the largest magnitude of the gradient (at least 1),
because the uniform rows' gradients are float32 sums of ~24,000 slot terms
of mixed sign, which two summation orders round apart by ~1e-5 absolute
(measured on the card).  K1 and K2 use no atomics, so two launches on the
same inputs must give the same bits (``torch.equal``).  K3 and K4 serve
every bucket of a layer in one launch each.  K4 uses no atomics either:
a thread sums each row of at most 32 slots in ascending slot order from
0, as ``index_add_`` on the CPU does (``tests/test_torch_segment.py``
checks that order), so those rows equal the plain version computed on
the CPU bit for bit; a warp sums each hub row (more than 32 slots: rows
0 and n − 1 of the graph case collect hundreds) in another fixed order,
held to float64 within K4_EPS_SUMS·eps32·Σ|g| over the row's slots (a
float32 sum in a tree of depth d is within d·eps32/2·Σ|g| of the exact
one; here d ≤ 18 and the bound allows d = 2, which random signs stay far
below).  Two launches give the same bits.

K8 rtol 1e-5, atol 1e-5 (the kernel's sums contract to FMAs and start
from zero in offset order like the plain version: float32 rounding only).
K12, K13 and K14 carry k dependent passes: atol 1e-5 times k times the
largest output magnitude, rtol 1e-5, in every mode (K12 and K13 fused or
streamed; a reach too wide for shared memory, or forced).  K12's and K13's two modes round every row alike, so they must
agree exactly (``torch.equal``).  K10,
K11, K15 and K16 as K8 (one pass, sums from zero in offset order), with
atol 1e-5 times the largest output magnitude.  Each kernel test also
replaces the plain version by one that fails, so a CUDA tensor that
reached it would show.

The bf16 instances (``dia_astype``): on bf16 vectors bit for bit with
their plain versions (a product of two bf16 values is exact in float32,
so a fused multiply-add rounds as a multiply and an add), on float32
vectors as the float32 kernels; fused against streamed, K14's k passes
against k one-pass calls, and a second launch, bit for bit.

K7 only moves values: exact.  K6 sums each node's run in slot order, the
plain version with index_add_: rtol 1e-5 and per element 4·eps32·Σ|v|
over the run's terms, as K4.  K5 divides by a sum of positive terms whose
rounding grows with the run: rtol 1e-5 + 4·eps32·(run length), atol 1e-6.
K5's backward y ⊙ (g − Σ_run y·g) sums the run in another order than the
plain K6: atol 1e-6, rtol 1e-5 and per element 4·eps32·|y|·Σ_run|y·g|
(K6's bound carried through the product with y).
K17 sums W·bn products per output in another order than the plain
version's batched matmul (and skips the all-zero chunks of A): rtol 1e-5
and per element 4·eps32·(|A|·|X|)."""

import dataclasses

import numpy as np
import pytest
import torch

from gflownet_spai_tpu_torch.models import gat
from gflownet_spai_tpu_torch.models import policies as pol
from gflownet_spai_tpu_torch.ops import bsr
from gflownet_spai_tpu_torch.ops import dia
from gflownet_spai_tpu_torch.ops import gat_fused as gf
from gflownet_spai_tpu_torch.ops import segment as seg
from gflownet_spai_tpu_torch.sparse import gallery

pytestmark = pytest.mark.gpu
K2_RTOL, K2_ATOL = 1e-4, 1e-4
K4_RTOL, K4_EPS_SUMS = 0.0, 1.0
EPS32 = float(torch.finfo(torch.float32).eps)


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


def _gat_layout(dev, kind, seed=2):
    """Tile layouts K1 and K2 must take beside the builder's sorted one:
    ``graph`` the [graph] case's; ``shuffled`` each tile's slots permuted
    and part of the padding marked -1 or TN + 5 (no node's slots form a
    run); ``long`` a node with 40 slots and one with 300 (longer than a
    warp and than a block); ``empty`` few edges (empty nodes) and no node id
    in tile 3 (an all-padding tile); ``T1`` one tile."""
    rng = np.random.default_rng(seed)
    n, tn = 1500, 128
    if kind == "graph":
        return _graph_case(dev, seed=seed)[2]
    if kind == "T1":
        ids = rng.integers(0, 100, 700)
    elif kind == "long":
        ids = np.concatenate([rng.integers(0, n, 6000), np.full(40, 70),
                              np.full(300, 900)])
    elif kind == "empty":
        ids = rng.integers(0, n, 900)
        ids = ids[ids // tn != 3]
    else:
        ids = rng.integers(0, n, 12000)
    tiles = seg.build_seg_tiles(ids, 100 if kind == "T1" else n, tile_nodes=tn,
                                device=dev)
    if kind == "shuffled":
        lid = tiles.local_dst.cpu().numpy().copy()
        for t in range(tiles.tiles):
            lid[t] = lid[t][rng.permutation(tiles.slots)]
            pad = np.flatnonzero(lid[t] == tn)
            lid[t, pad[::3]] = -1
            lid[t, pad[1::3]] = tn + 5
        tiles = dataclasses.replace(tiles, local_dst=torch.as_tensor(lid, device=dev))
        assert gf.layout_runs(tiles)[1] is not None
    return tiles


def _gat_inputs(tiles, uniform, H, D, dev, seed=5):
    rng = np.random.default_rng(seed)
    T, S, HD = tiles.tiles, tiles.slots, H * D
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                   device=dev)
    args = (f(T * S), f(1 if uniform else T * S, HD),
            f(1 if uniform else tiles.n_pad, HD), f(HD), f(H, D))
    return args, f(tiles.n_pad, HD)


GAT_LAYOUTS = [("shuffled", 4, 4), ("shuffled", 1, 4), ("long", 4, 4), ("long", 1, 4),
               ("empty", 4, 4), ("empty", 1, 4), ("T1", 4, 4), ("T1", 1, 4),
               ("graph", 8, 4), ("shuffled", 8, 16), ("long", 3, 5), ("graph", 2, 24)]


@pytest.mark.parametrize("kind,H,D", GAT_LAYOUTS)
@pytest.mark.parametrize("uniform", [True, False])
def test_k1_k2_match_plain_on_every_layout(cuda, kind, H, D, uniform):
    """K1 and K2 (called directly) against their plain versions on layouts
    whose slots are not in runs, long runs, empty nodes and tiles, one tile,
    8 heads and lane plans with idle lanes or 2 lanes per head."""
    tiles = _gat_layout(cuda, kind)
    args, g = _gat_inputs(tiles, uniform, H, D, cuda)
    k1, k2 = gf.gat_tile_fused.launches, gf.gat_tile_fused_bwd.launches
    got = gf.gat_tile_fused(tiles, *args)
    got_b = gf.gat_tile_fused_bwd(tiles, *args, g)
    torch.cuda.synchronize()
    assert (gf.gat_tile_fused.launches - k1, gf.gat_tile_fused_bwd.launches - k2) == (1, 1)
    torch.testing.assert_close(got, gf.gat_tile_fused_ref(tiles, *args), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(got_b, gf.gat_tile_fused_bwd_ref(tiles, *args, g)):
        scale = max(float(b.abs().max()), 1.0)
        torch.testing.assert_close(a, b, rtol=K2_RTOL, atol=K2_ATOL * scale)


@pytest.mark.parametrize("kind,H,D", [("graph", 4, 4), ("graph", 1, 4), ("shuffled", 4, 4),
                                      ("long", 1, 4), ("shuffled", 8, 16)])
@pytest.mark.parametrize("uniform", [True, False])
def test_k1_k2_deterministic(cuda, kind, H, D, uniform):
    """Two launches on the same inputs give the same bits: K1's output and
    each of K2's four outputs."""
    tiles = _gat_layout(cuda, kind)
    args, g = _gat_inputs(tiles, uniform, H, D, cuda, seed=6)
    assert torch.equal(gf.gat_tile_fused(tiles, *args), gf.gat_tile_fused(tiles, *args))
    first = gf.gat_tile_fused_bwd(tiles, *args, g)
    second = gf.gat_tile_fused_bwd(tiles, *args, g)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k1_k2_refuse_what_they_do_not_take(cuda):
    tiles = _gat_layout(cuda, "T1")
    for H, D in ((9, 4), (8, 40), (4, 65)):
        args, g = _gat_inputs(tiles, True, H, D, cuda)
        with pytest.raises(ValueError, match="limits"):
            gf.gat_tile_fused(tiles, *args)
        with pytest.raises(ValueError, match="limits"):
            gf.gat_tile_fused_bwd(tiles, *args, g)
    args, g = _gat_inputs(tiles, True, 4, 4, cuda)
    with pytest.raises(ValueError, match="shapes"):
        gf.gat_tile_fused(tiles, args[0][:-1], *args[1:])


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
    assert torch.equal(got, seg.gather_rows_windows_ref(plan, tiles, vals))


def _hold_k4(got, plans, gs, n):
    """K4's dv against the plain version on the CPU: the same bits on every
    row of at most 32 slots; hub rows within the float64 bound.  Returns
    the number of hub rows."""
    host = [p.to("cpu") for p in plans]
    cpu = lambda f: [None if g is None else f(g.cpu()) for g in gs]
    want = seg.scatter_rows_buckets_ref(host, cpu(lambda g: g), n)
    exact = seg.scatter_rows_buckets_ref(host, cpu(torch.Tensor.double), n)
    sums = seg.scatter_rows_buckets_ref(host, cpu(lambda g: g.double().abs()), n)
    hub = torch.zeros(n, dtype=torch.bool)
    hub[seg.row_plan(host, n).hubs.long()] = True
    got = got.cpu()
    assert got.shape == want.shape and torch.equal(got[~hub], want[~hub])
    err = (got[hub].double() - exact[hub]).abs()
    bound = K4_RTOL * exact[hub].abs() + K4_EPS_SUMS * EPS32 * sums[hub]
    assert bool((err <= bound).all()), \
        f"hub rows: max err {float(err.max()):.3e}, max err/bound {float((err / bound).max()):.3f}"
    return int(hub.sum())


@pytest.mark.parametrize("D", [4, 16])
def test_k4_matches_plain(cuda, D):
    """K4 (the windowed scatter-add) as the gradient of the K3 gather, on a
    layout with two hub rows; a second launch gives the same bits."""
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
    assert _hold_k4(got, [plan], [g], n) == 2
    assert torch.equal(seg.scatter_rows_windows(plan, g, n), got)


def _bucket_plans(dev, seed=7, n=900, tn=64):
    """Four buckets (one narrow tile and one wide tile among them) with 40
    long-range outliers, a hub row (450) that 300 slots read and row 0 read
    by the slots clipped at the low end: the window plans (win 128)."""
    rng = np.random.default_rng(seed)
    dst = np.concatenate([rng.integers(0, n, 3000), rng.integers(3 * tn, 4 * tn, 700),
                          rng.integers(7 * tn, 9 * tn, 250)])
    dst = np.concatenate([dst[(dst // tn != 13) | (rng.random(dst.size) < 0.3)],
                          rng.integers(0, n, 300)])
    src = np.clip(dst + rng.integers(-60, 60, dst.size), 0, n - 1)
    src[-300:] = 450
    src[:40] = rng.integers(0, n, 40)
    sb = seg.build_seg_buckets(dst, n, tile_nodes=tn, device="cpu")
    plans = [seg.build_src_windows(tb, seg.to_tiles(tb, torch.as_tensor(src)), n, win=128,
                                   device=dev) for tb in sb.tiles]
    assert len(plans) == 4
    return n, plans


@pytest.mark.parametrize("D,offset", [(3, 0), (4, 0), (16, 0), (4, 1), (16, 2)])
def test_k3_all_buckets_exact(cuda, D, offset):
    """One K3 launch serves every bucket, each output equal to its plain
    version bit for bit; ``offset`` floats into a buffer makes ``vals``
    unaligned (the one-float kernel instance)."""
    n, plans = _bucket_plans(cuda)
    rng = np.random.default_rng(D)
    buf = torch.as_tensor(rng.standard_normal(n * D + offset), dtype=torch.float32,
                          device=cuda)
    vals = buf[offset:].view(n, D)
    assert (vals.data_ptr() % 16 == 0) == (offset == 0)
    before = seg.gather_rows_windows.launches
    got = seg.gather_rows_buckets(plans, vals)
    torch.cuda.synchronize()
    assert seg.gather_rows_windows.launches == before + 1
    want = seg.gather_rows_buckets_ref(plans, vals)
    assert len(got) == 4 and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("D", [3, 4, 16])
def test_k4_all_buckets(cuda, D):
    """One K4 launch per backward over every bucket (bucket 1's output
    unused: its cotangent is None, read as zeros), held to the plain
    version on the CPU, hubs included; a second launch gives the same
    bits."""
    n, plans = _bucket_plans(cuda)
    rng = np.random.default_rng(20 + D)
    vals = torch.tensor(rng.standard_normal((n, D)), dtype=torch.float32, device=cuda,
                        requires_grad=True)
    gs = [None if b == 1 else torch.as_tensor(rng.standard_normal((p.lsrc.numel(), D)),
                                              dtype=torch.float32, device=cuda)
          for b, p in enumerate(plans)]
    k3, k4 = seg.gather_rows_windows.launches, seg.scatter_rows_windows.launches
    outs = seg.gather_rows_buckets(plans, vals)
    loss = sum((o * g).sum() for o, g in zip(outs, gs) if g is not None)
    (got,) = torch.autograd.grad(loss, vals)
    torch.cuda.synchronize()
    assert (seg.gather_rows_windows.launches - k3, seg.scatter_rows_windows.launches - k4) \
        == (1, 1)
    assert _hold_k4(got, plans, gs, n) == 2
    assert torch.equal(seg.scatter_rows_buckets(plans, gs, n), got)


def test_k3_k4_refuse_what_they_do_not_take(cuda):
    n, plans = _bucket_plans(cuda)
    vals = torch.zeros((n, 4), device=cuda)
    with pytest.raises(ValueError, match="buckets"):
        seg.gather_rows_buckets(plans * 3, vals)
    with pytest.raises(ValueError, match="contiguous"):
        seg.gather_rows_buckets(plans, torch.zeros((n, 8), device=cuda)[:, :4])
    with pytest.raises(ValueError, match="does not fit"):
        seg.scatter_rows_buckets(plans, [torch.zeros((p.lsrc.numel() + 1, 4), device=cuda)
                                         for p in plans], n)


def test_tiled_policy_logits_match_dense_path(cuda):
    """The kernel path (K1 per bucket, one K3 for every bucket) against the
    per-edge scatter path, both on the card."""
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
    assert seg.gather_rows_windows.launches - k3 == 1        # every bucket at once
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
    # 2 buckets: K1 and K2 once per bucket and layer, K3 and K4 once a step
    assert [fn.launches - b for fn, b in zip(counters, before)] == [8, 8, 2, 2]
    assert np.isfinite(history).all() and state.epoch == 2
    assert state.params.log_z.device.type == "cuda"
    *_, template = setup(cfg)
    restored = restore_checkpoint(str(tmp_path), template)
    assert restored.epoch == 2
    assert torch.equal(restored.params.forward.fc_w, state.params.forward.fc_w)


def _poisson_dia(dev, k=96):
    a = gallery.poisson2d(k, dtype=np.float32)
    return a, dia.coo_to_dia(a, device=dev)


def _close_k(got, want, k):
    scale = max(float(want.abs().max()), 1.0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * k * scale)


@pytest.mark.parametrize("name", ["poisson96", "orsirr_like24"])
def test_k8_matches_plain(cuda, name):
    """K8 on a banded and on a many-diagonal (wide-halo) matrix, through
    ``spmv_dia``, its gradient, and ``spmv_dia_padded``."""
    a = gallery.get(name)
    d = dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=cuda)
    x = torch.randn(d.n, device=cuda, requires_grad=True)
    before = dia.spmv_dia.launches
    y = dia.spmv_dia(d, x)
    g = torch.randn(d.n, device=cuda)
    (dx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    assert dia.spmv_dia.launches == before + 2      # forward, and Aᵀ·g
    with torch.no_grad():
        torch.testing.assert_close(y, dia.spmv_dia_ref(d, x),
                                   rtol=1e-5, atol=1e-5)
    dt = dia.dia_transpose(d)
    torch.testing.assert_close(dx, dia.spmv_dia_ref(dt, g), rtol=1e-5, atol=1e-5)
    xp = dia.dia_pad_x(d, x.detach())
    torch.testing.assert_close(dia.spmv_dia_padded(d, xp),
                               dia.spmv_dia_padded_ref(d, xp), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("affine", [False, True])
def test_k12_matches_plain(cuda, k, affine):
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix

    _, d = _poisson_dia(cuda)
    m = jacobi_iteration_matrix(d)
    tr = 4 * m.halo
    xq = dia.dia_pad_pp(m, torch.randn(m.n, device=cuda), tr=tr)
    cq = dia.dia_pad_pp(m, torch.randn(m.n, device=cuda), tr=tr) if affine else None
    before = dia.spmv_dia_power.launches
    got = dia.spmv_dia_power(m, None, xq, torch.zeros_like(xq), scale=0.9, k=k, add=cq)
    torch.cuda.synchronize()
    assert dia.spmv_dia_power.launches == before + 1
    want = dia.spmv_dia_power_ref(m, xq, torch.zeros_like(xq), scale=0.9, k=k, add=cq)
    _close_k(got, want, k)
    assert not got[:tr].any() and not got[tr + m.n_pad:].any()


@pytest.mark.parametrize("k", [2, 3])
def test_k13_matches_plain(cuda, k):
    from gflownet_spai_tpu_torch.solvers.stationary import chebyshev_coeffs

    _, d = _poisson_dia(cuda)
    q = lambda: dia.dia_pad_pp(d, torch.randn(d.n, device=cuda))
    zq, ddq, rq = q(), q(), q()
    coeffs = tuple(chebyshev_coeffs(0.3, 8.2, k))
    before = dia.spmv_dia_cheby.launches
    got = dia.spmv_dia_cheby(d, None, zq, ddq, rq, torch.zeros_like(zq),
                             torch.zeros_like(zq), coeffs, k)
    torch.cuda.synchronize()
    assert dia.spmv_dia_cheby.launches == before + 1
    want = dia.spmv_dia_cheby_ref(d, zq, ddq, rq, torch.zeros_like(zq),
                                  torch.zeros_like(zq), coeffs, k)
    for a, b in zip(got, want):
        _close_k(a, b, k)


def test_cg_with_polynomial_preconditioners_on_card(cuda):
    """CG on poisson64 with the fused Jacobi (K12, k = 4) and Chebyshev
    (K13, k = 4) preconditioners on the card: the same iteration counts
    as on the CPU (float32 both), and both kernels ran."""
    from gflownet_spai_tpu_torch.solvers import (cg, chebyshev_op, estimate_lmax,
                                                 jacobi_sweeps_op)

    a = gallery.poisson2d(64, dtype=np.float32)
    its = {}
    for dev in ("cpu", cuda):
        d = dia.coo_to_dia(a, device=dev)
        b = torch.ones(d.n, device=dev)
        v0 = torch.as_tensor(np.random.default_rng(0).standard_normal(d.n),
                             dtype=torch.float32, device=dev)
        lmax = 1.05 * float(estimate_lmax(d, iters=30, v0=v0))
        ops = (jacobi_sweeps_op(d, sweeps=16),
               chebyshev_op(d, lmax=lmax, lmin=lmax / 30, degree=16))
        assert [op.info["k"] for op in ops] == [4, 4]
        before = (dia.spmv_dia_power.launches, dia.spmv_dia_cheby.launches)
        its[str(dev)] = [cg(d, b, m_op=op, maxiter=500, rtol=1e-5).iterations
                         for op in ops]
        if dev != "cpu":
            torch.cuda.synchronize()
            assert dia.spmv_dia_power.launches > before[0]
            assert dia.spmv_dia_cheby.launches > before[1]
    assert all(abs(g - c) <= 1 for g, c in zip(its[str(cuda)], its["cpu"])), its


def _banded_dia(dev, n, reach, seed=0):
    """A random 5-diagonal DIA with offsets (−reach, −1, 0, 1, reach)."""
    n_pad = -(-n // 1024) * 1024
    data = np.random.default_rng(seed).standard_normal((5, n_pad)).astype(np.float32)
    data[:, n:] = 0.0
    return dia.DIA(data=torch.as_tensor(data, device=dev),
                   offsets=(-reach, -1, 0, 1, reach), shape=(n, n), nnz=5 * n)


def _pp(d, dev, seed):
    x = torch.randn(d.n, generator=torch.Generator(device=dev).manual_seed(seed),
                    device=dev)
    return dia.dia_pad_pp(d, x)


def _mode(d, kind, k, types=0):
    """The mode K12 / K13 take for ``d`` at k on this card (P and the
    buffers aligned, as ``dia_pad_pp`` makes them), for the instance of
    ``types`` (``ops/dia.py`` ``_TYPES``)."""
    plan = dia._fused_plan(kind, d.ndiags, k, d.reach, d.n_pad,
                           dia._card_active(kind, d.ndiags, d.data.device, types),
                           dia._SMEM_BYTES, dia._ELEMS[types])
    return "fused" if plan is not None else "streamed"


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("affine", [False, True])
def test_k12_streamed_matches_plain(cuda, k, affine):
    """Reach 10,000: the k-pass window needs more shared memory than a
    block has, so K12 streams its passes through global memory."""
    d = _banded_dia(cuda, 50_000, 10_000)
    assert _mode(d, dia._FUSED_AFFINE if affine else dia._FUSED_POWER, k) == "streamed"
    xq, cq = _pp(d, cuda, 1), (_pp(d, cuda, 2) if affine else None)
    before = dia.spmv_dia_power.launches
    got = dia.spmv_dia_power(d, None, xq, torch.zeros_like(xq), scale=0.3, k=k, add=cq)
    torch.cuda.synchronize()
    assert dia.spmv_dia_power.launches == before + 1
    want = dia.spmv_dia_power_ref(d, xq, torch.zeros_like(xq), scale=0.3, k=k, add=cq)
    _close_k(got, want, k)
    p = (xq.shape[0] - d.n_pad) // 2
    assert not got[:p].any() and not got[p + d.n_pad:].any()


@pytest.mark.parametrize("k", [2, 3])
def test_k13_streamed_matches_plain(cuda, k):
    from gflownet_spai_tpu_torch.solvers.stationary import chebyshev_coeffs

    d = _banded_dia(cuda, 50_000, 10_000, seed=3)
    assert _mode(d, dia._FUSED_CHEBY, k) == "streamed"
    zq, ddq, rq = (_pp(d, cuda, s) for s in (4, 5, 6))
    coeffs = tuple(chebyshev_coeffs(0.3, 8.2, k))
    before = dia.spmv_dia_cheby.launches
    got = dia.spmv_dia_cheby(d, None, zq, ddq, rq, torch.zeros_like(zq),
                             torch.zeros_like(zq), coeffs, k)
    torch.cuda.synchronize()
    assert dia.spmv_dia_cheby.launches == before + 1
    want = dia.spmv_dia_cheby_ref(d, zq, ddq, rq, torch.zeros_like(zq),
                                  torch.zeros_like(zq), coeffs, k)
    for a, b in zip(got, want):
        _close_k(a, b, k)


def _plan(cluster, rows, clusters=132):
    """A fused plan of the given shape (the rule's timings are not read)."""
    return dia.FusedPlan(cluster=cluster, rows=rows, clusters=clusters,
                         windows=0, smem=0, fused_us=0.0, streamed_us=0.0)


def _both_modes(monkeypatch, call, plan=None):
    """``call()`` in the fused mode (the rule's plan, or ``plan``) and in
    the streamed mode (shared memory taken away): the two results and the
    fused call's launches by mode."""
    with monkeypatch.context() as mp:
        if plan is not None:
            mp.setattr(dia, "_fused_for", lambda *a: plan)
        counts = (dict(dia.spmv_dia_power.mode_launches),
                  dict(dia.spmv_dia_cheby.mode_launches))
        fused = call()
        torch.cuda.synchronize()
        moved = [{m: after[m] - c[m] for m in c} for c, after in
                 zip(counts, (dia.spmv_dia_power.mode_launches,
                              dia.spmv_dia_cheby.mode_launches))]
    with monkeypatch.context() as mp:
        mp.setattr(dia, "_SMEM_BYTES", 0)
        streamed = call()
        torch.cuda.synchronize()
    return fused, streamed, moved


def _halo_noise(q, d, seed):
    """Nonzero values in a [P + n_pad + P] buffer's halo blocks: the first
    pass reads x on [-P, n_pad + P)."""
    p = (q.shape[0] - d.n_pad) // 2
    gen = torch.Generator(device=q.device).manual_seed(seed)
    q[:p] = torch.randn(p, generator=gen, device=q.device)
    q[p + d.n_pad:] = torch.randn(p, generator=gen, device=q.device)
    return q


# (matrix, k, plan): poisson-like 5-diagonal matrices at k 2, 3, 4, 8 through
# the rule's plan; an irregular banded DIA (4 diagonals); n a multiple of
# neither S nor the window; n smaller than one CTA's slice; plans as
# (C, S, clusters launched): fewer clusters than windows walk several
K12_FUSED_CASES = [
    ("poisson96", 2, (1, 2048)), ("poisson96", 3, None), ("poisson96", 4, None),
    ("poisson96", 8, None), ("poisson256", 8, None), ("banded 60000 r700", 4, (16, 1024)),
    ("irregular 20000", 3, (4, 1024)), ("banded 60000 r700", 3, (4, 1504, 2)),
    ("banded 60000 r700", 2, (16, 736)), ("banded 3000 r37", 4, (1, 4096)),
    ("irregular 20000", 2, (2, 2048, 3)), ("banded 60000 r700", 4, (4, 1504, 2)),
    ("irregular 20000", 8, (4, 2048, 2)),
]


def _fused_case_matrix(name, dev):
    if name.startswith("poisson"):
        return _poisson_dia(dev, int(name[len("poisson"):]))[1]
    if name.startswith("irregular"):
        d = _banded_dia(dev, int(name.split()[1]), 1, seed=5)
        return dia.DIA(data=d.data[:4].contiguous(), offsets=(-301, -7, 0, 129),
                       shape=d.shape, nnz=4 * d.n)
    n, r = name.split()[1:]
    return _banded_dia(dev, int(n), int(r[1:]), seed=int(n) % 97)


@pytest.mark.parametrize("name,k,plan", K12_FUSED_CASES)
@pytest.mark.parametrize("affine,scale", [(False, 1.0), (True, 0.9), (True, -0.35)])
def test_k12_fused_equals_streamed(cuda, no_plain, monkeypatch, name, k, plan, affine,
                                   scale):
    """K12's fused mode equals its streamed mode bit for bit and the plain
    version within ``_close_k``, with nonzero halo blocks in x and c."""
    ref = no_plain("spmv_dia_power_ref")["spmv_dia_power_ref"]
    d = _fused_case_matrix(name, cuda)
    if plan is None:
        assert _mode(d, dia._FUSED_AFFINE if affine else dia._FUSED_POWER, k) == "fused"
    xq = _halo_noise(_pp(d, cuda, 1), d, 11)
    cq = _halo_noise(_pp(d, cuda, 2), d, 12) if affine else None
    p = (xq.shape[0] - d.n_pad) // 2
    call = lambda: dia.spmv_dia_power(d, None, xq, torch.full_like(xq, 5.0), scale=scale,
                                      k=k, add=cq)
    fused, streamed, moved = _both_modes(monkeypatch, call,
                                         plan and _plan(*plan))
    assert moved[0] == {"fused": 1, "streamed": 0}
    assert torch.equal(fused, streamed)
    _close_k(fused, ref(d, xq, torch.full_like(xq, 5.0), scale=scale, k=k, add=cq), k)
    assert (fused[:p] == 5.0).all() and (fused[p + d.n_pad:] == 5.0).all()


K13_FUSED_CASES = [("poisson96", 2, (2, 1024)), ("poisson96", 4, None), ("poisson256", 8, None),
                   ("irregular 20000", 3, (8, 512)), ("banded 60000 r700", 2, (16, 736)),
                   ("banded 3000 r37", 4, (1, 4096)), ("irregular 20000", 8, (4, 2048, 3)),
                   ("banded 60000 r700", 3, (4, 1504, 2))]


@pytest.mark.parametrize("name,k,plan", K13_FUSED_CASES)
def test_k13_fused_equals_streamed(cuda, no_plain, monkeypatch, name, k, plan):
    """K13's fused mode equals its streamed mode bit for bit (z and dd)
    and the plain version within ``_close_k``."""
    from gflownet_spai_tpu_torch.solvers.stationary import chebyshev_coeffs

    ref = no_plain("spmv_dia_cheby_ref")["spmv_dia_cheby_ref"]
    d = _fused_case_matrix(name, cuda)
    if plan is None:
        assert _mode(d, dia._FUSED_CHEBY, k) == "fused"
    zq, ddq, rq = (_halo_noise(_pp(d, cuda, s), d, s + 20) for s in (4, 5, 6))
    coeffs = tuple(chebyshev_coeffs(0.3, 8.2, k))
    call = lambda: dia.spmv_dia_cheby(d, None, zq, ddq, rq, torch.zeros_like(zq),
                                      torch.zeros_like(zq), coeffs, k)
    fused, streamed, moved = _both_modes(monkeypatch, call, plan and _plan(*plan))
    assert moved[1] == {"fused": 1, "streamed": 0}
    want = ref(d, zq, ddq, rq, torch.zeros_like(zq), torch.zeros_like(zq), coeffs, k)
    for f, s_, w in zip(fused, streamed, want):
        assert torch.equal(f, s_)
        _close_k(f, w, k)


@pytest.mark.parametrize("n,k", [(1024, 2), (512, 4), (256, 8)])
def test_k13_fused_vcycle_coefficients(cuda, monkeypatch, n, k):
    """K13 at the Chebyshev V-cycle's k (2, 4, 8) on its levels' shapes
    (poisson1024, 512, 256) with the coefficients of a degree-16 apply:
    every call of the apply, fused against streamed, bit for bit."""
    from gflownet_spai_tpu_torch.solvers.stationary import chebyshev_coeffs

    _, d = _poisson_dia(cuda, n)
    assert _mode(d, dia._FUSED_CHEBY, k) == "fused"
    coeffs = chebyshev_coeffs(8.0 / 30, 8.0, 16)
    zq, ddq, rq = (_pp(d, cuda, s) for s in (7, 8, 9))
    for i in range(0, 16, k):
        cc = tuple(coeffs[i:i + k])
        call = lambda: dia.spmv_dia_cheby(d, None, zq, ddq, rq, torch.zeros_like(zq),
                                          torch.zeros_like(zq), cc, k)
        fused, streamed, moved = _both_modes(monkeypatch, call)
        assert moved[1]["fused"] == 1
        assert all(torch.equal(f, s_) for f, s_ in zip(fused, streamed))
        zq, ddq = fused


def test_fused_selection_on_both_sides(cuda):
    """The rule on this card at the shapes that decide it: poisson1024's
    Jacobi-16 (k 8) and Jacobi-4 (k 2) and Chebyshev (k 2) calls fuse, and
    poisson128's Jacobi-16 (k 8); poisson128's Jacobi-4 (k 2, two short
    launches) streams, as does a 5-diagonal band of reach 10,000 over a
    million rows at k 4 (no window fits), and any k of 1."""
    _, d = _poisson_dia(cuda, 1024)
    assert _mode(d, dia._FUSED_AFFINE, 8) == "fused"
    assert _mode(d, dia._FUSED_AFFINE, 2) == "fused"
    assert _mode(d, dia._FUSED_CHEBY, 2) == "fused"
    _, d128 = _poisson_dia(cuda, 128)
    assert _mode(d128, dia._FUSED_AFFINE, 8) == "fused"
    assert _mode(d128, dia._FUSED_AFFINE, 2) == "streamed"
    band = _banded_dia(cuda, 1 << 20, 10_000)
    assert _mode(band, dia._FUSED_AFFINE, 4) == "streamed"
    assert _mode(d, dia._FUSED_AFFINE, 1) == "streamed"


def test_k12_fused_refuses_what_it_cannot_take(cuda):
    """The fused entry point returns an error (and the wrapper raises) for
    a plan the kernel cannot take: S not a multiple of 4, or a window
    yielding no output row; nothing falls back."""
    _, d = _poisson_dia(cuda, 96)
    xq = _pp(d, cuda, 3)
    with pytest.raises(RuntimeError):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dia, "_fused_for", lambda *a: _plan(4, 130))
            dia.spmv_dia_power(d, None, xq, torch.zeros_like(xq), k=2)
    with pytest.raises(RuntimeError):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dia, "_fused_for", lambda *a: _plan(1, 96))
            dia.spmv_dia_power(d, None, xq, torch.zeros_like(xq), k=8)


def test_k12_poisson2048_jacobi16_streams(cuda, monkeypatch):
    """poisson2048's Jacobi 16 sweeps: the TPU selection picks k = 8 (its
    streamed kernel); K12 in its streamed mode (forced where the rule would
    fuse) matches the plain sweeps."""
    from gflownet_spai_tpu_torch.solvers.stationary import (
        _pick_power_config, jacobi_iteration_matrix, jacobi_sweeps_op)

    k, n = 2048, 2048 * 2048
    i = np.arange(n)
    r, c = i // k, i % k
    data = np.zeros((5, n), np.float32)
    data[2] = 4.0
    data[0, i[r > 0]] = data[1, i[c > 0]] = -1.0
    data[3, i[c < k - 1]] = data[4, i[r < k - 1]] = -1.0
    d = dia.DIA(data=torch.as_tensor(data, device=cuda), offsets=(-k, -1, 0, 1, k),
                shape=(n, n), nnz=int((data != 0).sum()))
    m = jacobi_iteration_matrix(d)
    fk, tile = _pick_power_config(m, 8, 16)
    assert (fk, tile) == (8, 65536)
    if _mode(m, dia._FUSED_AFFINE, fk) == "fused":
        monkeypatch.setattr(dia, "_SMEM_BYTES", 0)
    assert _mode(m, dia._FUSED_AFFINE, fk) == "streamed"
    op = jacobi_sweeps_op(d, sweeps=16)
    assert op.info["k"] == 8 and op.info["sweeps"] == 16
    rhs = torch.randn(n, generator=torch.Generator(device=cuda).manual_seed(7),
                      device=cuda)
    before = dia.spmv_dia_power.launches
    streamed = dia.spmv_dia_power.mode_launches["streamed"]
    got = op(rhs)
    torch.cuda.synchronize()
    assert dia.spmv_dia_power.launches == before + 2
    assert dia.spmv_dia_power.mode_launches["streamed"] == streamed + 2
    c = torch.where(d.data[2] != 0, (2.0 / 3.0) * rhs / d.data[2], 0.0)
    xq = dia.dia_pad_pp(m, torch.zeros(n, device=cuda), tr=tile)
    cq = dia.dia_pad_pp(m, c, tr=tile)
    zq = dia.spmv_dia_power_ref(m, xq, torch.zeros_like(xq), k=8, add=cq)
    want = dia.spmv_dia_power_ref(m, zq, torch.zeros_like(xq), k=8, add=cq)
    _close_k(got, want[tile:tile + n], 16)


def test_spmv_dia_captures_on_a_fresh_matrix(cuda):
    """A DIA built just before a CUDA-graph capture, never called before:
    ``spmv_dia`` on it and on the transpose its backward builds (made
    inside the capture) replay to the plain results."""
    dia.spmv_dia(_poisson_dia(cuda, 16)[1], torch.ones(256, device=cuda))  # loads the library
    d = _banded_dia(cuda, 5000, 131, seed=9)
    d = dia.DIA(data=d.data, offsets=(-131, -3, 0, 5, 77), shape=d.shape, nnz=d.nnz)
    x, g = torch.randn(d.n, device=cuda), torch.randn(d.n, device=cuda)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = dia.spmv_dia(d, x)
        yt = dia.spmv_dia(dia.dia_transpose(d), g)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(y, dia.spmv_dia_ref(d, x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yt, dia.spmv_dia_ref(dia.dia_transpose(d), g),
                               rtol=1e-5, atol=1e-5)


@pytest.fixture
def no_plain(monkeypatch):
    """Replace the named plain versions in ``ops.dia`` by ones that fail and
    return the originals: a wrapper given CUDA tensors must launch its
    kernel."""
    def patch(*names):
        saved = {nm: getattr(dia, nm) for nm in names}

        def fail(*_, **__):
            raise AssertionError("a CUDA tensor reached the plain version")

        for nm in names:
            monkeypatch.setattr(dia, nm, fail)
        return saved
    return patch


def _close1(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(float(want.abs().max()), 1.0))


# K10 and K11's (diagonal, vector) instances: float32; bf16 diagonals with
# float32 vectors; bf16
PP_INSTANCES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                (torch.bfloat16, torch.bfloat16)]


def _pp_dia(dev, name, dt):
    a = gallery.get(name)
    d = dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=dev)
    return d if dt == torch.float32 else dia.dia_astype(d, dt)


def _hold_pp(got, want):
    """K10 / K11 against their plain versions: on bf16 vectors bit for bit
    (a product of two bf16 values is exact in float32), on float32 vectors
    within ``_close1``."""
    assert got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        _close1(got, want)


def _k10_over_nan(d, xq, scale):
    """K10 into an allocator block filled with NaN before it was freed: the
    block a first call was handed, so a halo row the kernel skipped would
    show.  Returns the second call's output."""
    y = dia.spmv_dia_padded_io(d, xq, scale=scale)
    ptr = y.data_ptr()
    y.fill_(float("nan"))
    del y
    got = dia.spmv_dia_padded_io(d, xq, scale=scale)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr, "the allocator handed K10 another block"
    return got


@pytest.mark.parametrize("name", ["poisson96", "orsirr_like24"])
@pytest.mark.parametrize("dt,vt", PP_INSTANCES)
def test_k10_k11_match_plain(cuda, no_plain, name, dt, vt):
    """Chains of 3 calls at scale 0.2 in each instance: K10 returns a new
    buffer with zero halo blocks, K11 writes the other buffer's interior
    only; every launch counted on its instance."""
    d = _pp_dia(cuda, name, dt)
    inst = dia._TYPE_NAMES[dia._TYPES[(dt, vt)]]
    ref = no_plain("spmv_dia_padded_io_ref", "spmv_dia_pingpong_ref")
    x = torch.randn(d.n, device=cuda)
    xq = dia.dia_pad_io(d, x).to(vt)
    p = (xq.shape[0] - d.n_pad) // 2
    before = dia.spmv_dia_padded_io.launches, dia.spmv_dia_padded_io.type_launches[inst]
    for _ in range(3):
        want = ref["spmv_dia_padded_io_ref"](d, xq, 0.2)
        got = dia.spmv_dia_padded_io(d, xq, scale=0.2)
        torch.cuda.synchronize()
        _hold_pp(got, want)
        assert not got[:p].any() and not got[p + d.n_pad:].any()
        xq = got
    assert (dia.spmv_dia_padded_io.launches,
            dia.spmv_dia_padded_io.type_launches[inst]) == (before[0] + 3, before[1] + 3)
    xq = dia.dia_pad_pp(d, x).to(vt)
    p = (xq.shape[0] - d.n_pad) // 2
    yq = torch.full_like(xq, 3.0)
    yq[p:p + d.n_pad] = 0.0
    before = dia.spmv_dia_pingpong.launches, dia.spmv_dia_pingpong.type_launches[inst]
    for _ in range(3):
        halo = torch.cat([yq[:p], yq[p + d.n_pad:]])      # 3.0 or 0.0 after a swap
        want = ref["spmv_dia_pingpong_ref"](d, xq, yq.clone(), 0.2)
        got = dia.spmv_dia_pingpong(d, xq, yq, scale=0.2)
        torch.cuda.synchronize()
        assert got is yq
        _hold_pp(got[p:p + d.n_pad], want[p:p + d.n_pad])
        assert torch.equal(torch.cat([got[:p], got[p + d.n_pad:]]), halo)
        xq, yq = yq, xq
    assert (dia.spmv_dia_pingpong.launches,
            dia.spmv_dia_pingpong.type_launches[inst]) == (before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("dt,vt", PP_INSTANCES)
def test_k10_writes_its_halo_over_a_nan_block(cuda, no_plain, dt, vt):
    """K10's output comes from ``torch.empty_like``: over a block that held
    NaN its halo blocks are zero (written by the same launch) and its
    interior is the plain version's, on poisson96 and orsirr_like24."""
    ref = no_plain("spmv_dia_padded_io_ref")["spmv_dia_padded_io_ref"]
    for name in ("poisson96", "orsirr_like24"):
        d = _pp_dia(cuda, name, dt)
        xq = dia.dia_pad_io(d, torch.randn(d.n, device=cuda)).to(vt)
        p = (xq.shape[0] - d.n_pad) // 2
        got = _k10_over_nan(d, xq, 0.7)
        assert torch.equal(got[:p], torch.zeros_like(got[:p]))
        assert torch.equal(got[p + d.n_pad:], torch.zeros_like(got[:p]))
        _hold_pp(got, ref(d, xq, 0.7))


@pytest.mark.parametrize("dt,vt", PP_INSTANCES)
def test_k10_k11_unaligned_take_the_scalar_instance(cuda, no_plain, dt, vt):
    """The scalar instance of the row-tile kernel: x one element past a
    16-byte boundary, a pad width P = halo + 1 (no multiple of the 4 or 8
    rows a thread takes, so threads straddle the halo blocks' edges), and a
    DIA of n_pad 5,001 (a ragged tail).  Same bits as the aligned call on
    poisson96; K10's halo blocks zero over a NaN block; K11's halo blocks
    left as they were (NaN)."""
    ref = no_plain("spmv_dia_padded_io_ref", "spmv_dia_pingpong_ref")
    d = _pp_dia(cuda, "poisson96", dt)
    x = torch.randn(d.n, device=cuda).to(vt)

    def padded(dd, p):
        return torch.nn.functional.pad(x[:dd.n], (p, dd.n_pad - dd.n + p))

    def run(dd, xq):
        p = (xq.shape[0] - dd.n_pad) // 2
        y10 = _k10_over_nan(dd, xq, 0.3)
        assert not y10[:p].any() and not y10[p + dd.n_pad:].any()
        y11 = torch.full_like(xq, float("nan"))
        dia.spmv_dia_pingpong(dd, xq, y11, scale=0.3)
        torch.cuda.synchronize()
        assert torch.isnan(y11[:p]).all() and torch.isnan(y11[p + dd.n_pad:]).all()
        return y10[p:p + dd.n_pad], y11[p:p + dd.n_pad]

    base = run(d, padded(d, d.halo))
    _hold_pp(base[0], ref["spmv_dia_padded_io_ref"](d, padded(d, d.halo), 0.3)[
        d.halo:d.halo + d.n_pad])
    assert torch.equal(base[1], base[0])
    for xq in (_shifted(padded(d, d.halo)), padded(d, d.halo + 1)):
        assert all(torch.equal(a, b) for a, b in zip(run(d, xq), base))
    r = _ragged_dia(cuda, dt)
    xq = padded(r, r.halo + 1)
    y10, y11 = run(r, xq)
    _hold_pp(y10, ref["spmv_dia_padded_io_ref"](r, xq, 0.3)[r.halo + 1:r.halo + 1 + r.n_pad])
    assert torch.equal(y11, y10)


@pytest.mark.parametrize("vt", [torch.float32, torch.bfloat16])
def test_row_tile_kernel_takes_a_band_wider_than_its_staged_offsets(cuda, no_plain, vt):
    """12,300 bf16 diagonals (the row-tile kernel stages 12,288 offsets in
    shared memory and reads the rest from global memory) at n 6,200: K10
    and K11 (aligned, and x off its alignment), K14 (k 2, 2 right-hand
    sides) and K16 (3) against their plain versions."""
    ref = no_plain("spmv_dia_padded_io_ref", "spmv_dia_pingpong_ref",
                   "spmv_dia_power_rhs_ref", "spmm_dia_t_padded_ref")
    n, n_pad, offsets = 6200, 6208, tuple(range(-6150, 6150))
    assert len(offsets) > 12288
    gen = torch.Generator(device=cuda).manual_seed(12300)
    i = torch.arange(n_pad, device=cuda)[None]
    o = torch.tensor(offsets, device=cuda)[:, None]
    keep = (i < n) & (i + o >= 0) & (i + o < n)
    data = torch.where(keep, torch.randn((len(offsets), n_pad), generator=gen, device=cuda)
                       / 64, 0.0).to(BF16)
    d = dia.DIA(data=data, offsets=offsets, shape=(n, n), nnz=int(keep.sum()))
    x = torch.randn(n, generator=gen, device=cuda).to(vt)
    xq = torch.nn.functional.pad(x, (d.halo, n_pad - n + d.halo))
    p = d.halo
    y10 = dia.spmv_dia_padded_io(d, xq, scale=0.5)
    _hold_pp(y10, ref["spmv_dia_padded_io_ref"](d, xq, 0.5))
    assert not y10[:p].any() and not y10[p + n_pad:].any()
    assert torch.equal(dia.spmv_dia_padded_io(d, _shifted(xq), scale=0.5), y10)
    y11 = dia.spmv_dia_pingpong(d, xq, torch.zeros_like(xq), scale=0.5)
    assert torch.equal(y11, y10)
    X = torch.randn((2, n), generator=gen, device=cuda).to(vt)
    Xq = torch.nn.functional.pad(X, (p, n_pad - n + p))
    got = dia.spmv_dia_power_rhs(d, None, Xq, torch.zeros_like(Xq), scale=0.5, k=2)
    _held(got, ref["spmv_dia_power_rhs_ref"](d, Xq, torch.zeros_like(Xq), scale=0.5, k=2), 2)
    rows = torch.nn.functional.pad(X, (0, n_pad - n, 0, 1))
    got = dia.spmm_dia_t_rows(d, rows)
    _held(got, ref["spmm_dia_t_padded_ref"](d, torch.nn.functional.pad(rows, (p, p))))
    torch.cuda.synchronize()


def _k14_chained(m, xq, cq, scale, k):
    """K14's k passes as k one-pass calls, each into a buffer whose halo is
    zero (the rows the passes after the first read as zero)."""
    z = xq
    for _ in range(k):
        z = dia.spmv_dia_power_rhs(m, None, z, torch.zeros_like(xq), scale=scale, k=1, add=cq)
    return z


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("affine", [False, True])
def test_k14_matches_plain(cuda, no_plain, k, affine):
    """K14 on poisson96's Jacobi matrix with 12 right-hand sides (one full
    group of 8 and one of 4): k passes of the row-tile kernel in one call.
    A second launch gives the same bits, as do k one-pass calls chained."""
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix

    _, d = _poisson_dia(cuda)
    m = jacobi_iteration_matrix(d)
    ref = no_plain("spmv_dia_power_rhs_ref")["spmv_dia_power_rhs_ref"]
    tr = 2 * m.halo
    gen = torch.Generator(device=cuda).manual_seed(k)
    X = torch.randn((12, m.n), generator=gen, device=cuda)
    xq = dia.dia_pad_pp_rhs(m, X, tr=tr)
    cq = dia.dia_pad_pp_rhs(m, torch.randn((12, m.n), generator=gen, device=cuda),
                            tr=tr) if affine else None
    zq = torch.full_like(xq, 5.0)
    before = dia.spmv_dia_power_rhs.launches
    got = dia.spmv_dia_power_rhs(m, None, xq, zq, scale=0.9, k=k, add=cq)
    torch.cuda.synchronize()
    assert got is zq and dia.spmv_dia_power_rhs.launches == before + 1
    want = ref(m, xq, torch.full_like(xq, 5.0), scale=0.9, k=k, add=cq)
    _close_k(got, want, k)
    assert (got[:, :tr] == 5.0).all() and (got[:, tr + m.n_pad:] == 5.0).all()
    call = lambda: dia.spmv_dia_power_rhs(m, None, xq, torch.full_like(xq, 5.0), scale=0.9,
                                          k=k, add=cq)
    assert torch.equal(call(), got)
    z = _k14_chained(m, xq, cq, 0.9, k)
    assert torch.equal(z[:, tr:tr + m.n_pad], got[:, tr:tr + m.n_pad])


def _ragged_dia(dev, dtype=torch.float32, n=4990, n_pad=5001, offsets=(-70, -1, 0, 1, 70)):
    """A hand-made DIA whose n_pad is no multiple of the row-tile kernel's V
    rows (its scalar instance), entries where the band covers the matrix."""
    gen = torch.Generator(device=dev).manual_seed(n_pad)
    i = torch.arange(n_pad, device=dev)
    data = torch.stack([torch.where((i < n) & (i + o >= 0) & (i + o < n),
                                    torch.randn(n_pad, generator=gen, device=dev) / 4, 0.0)
                        for o in offsets])
    return dia.DIA(data=data.to(dtype), offsets=offsets, shape=(n, n),
                   nnz=int((data != 0).sum()))


def _shifted(t):
    """``t``'s values in contiguous storage one element past a 16-byte
    boundary (the row-tile kernel's scalar instance)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("vt", [torch.float32, torch.bfloat16])
def test_k14_ragged_and_unaligned(cuda, no_plain, k, vt):
    """K14 on a DIA of n_pad 5,001 (a ragged tail, the scalar instance) and
    on poisson96's Jacobi matrix with buffers one element off their
    alignment, 13 right-hand sides, affine: the plain version's values, and
    on poisson96 the aligned buffers' bits."""
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix

    ref = no_plain("spmv_dia_power_rhs_ref")["spmv_dia_power_rhs_ref"]
    m96 = jacobi_iteration_matrix(_poisson_dia(cuda)[1])
    dd = dia.dia_astype if vt == BF16 else (lambda d, _: d)
    gen = torch.Generator(device=cuda).manual_seed(13)
    for m, unaligned in ((dd(_ragged_dia(cuda), BF16), False), (dd(m96, BF16), True)):
        p = m.halo
        xq = dia.dia_pad_pp_rhs(m, torch.randn((13, m.n), generator=gen, device=cuda),
                                tr=p).to(vt)
        cq = dia.dia_pad_pp_rhs(m, torch.randn((13, m.n), generator=gen, device=cuda),
                                tr=p).to(vt)
        got = dia.spmv_dia_power_rhs(m, None, xq, torch.zeros_like(xq), scale=0.8, k=k,
                                     add=cq)
        _held(got, ref(m, xq, torch.zeros_like(xq), scale=0.8, k=k, add=cq), k)
        if unaligned:
            xs, cs, zs = _shifted(xq), _shifted(cq), _shifted(torch.zeros_like(xq))
            assert torch.equal(dia.spmv_dia_power_rhs(m, None, xs, zs, scale=0.8, k=k,
                                                      add=cs), got)


@pytest.mark.parametrize("K", [1, 7, 13])
@pytest.mark.parametrize("vt", [torch.float32, torch.bfloat16])
def test_k16_ragged_and_unaligned(cuda, no_plain, K, vt):
    """K16 on a DIA of n_pad 5,001 (a ragged tail) and on poisson96 with
    Xt one element off its alignment, K not a multiple of the kernel's
    group of right-hand sides, float32 and bf16 diagonals: the plain
    version's values, both entry points (the padded buffer and the
    unpadded rows) the same bits, on poisson96 the aligned buffer's."""
    ref = no_plain("spmm_dia_t_padded_ref")["spmm_dia_t_padded_ref"]
    gen = torch.Generator(device=cuda).manual_seed(K)
    for diag_t in (torch.float32, BF16):
        if vt == BF16 and diag_t == torch.float32:
            continue
        for d, unaligned in ((_ragged_dia(cuda, diag_t), False),
                             (dia.coo_to_dia(gallery.poisson2d(96, dtype=np.float32),
                                             device=cuda), True)):
            d = dia.dia_astype(d, diag_t) if d.data.dtype != diag_t else d
            h = d.halo
            rows = torch.randn((K, d.n_pad), generator=gen, device=cuda).to(vt)
            rows[:, d.n:] = 0
            xtp = torch.nn.functional.pad(rows, (h, h))
            got = dia.spmm_dia_t_padded(d, xtp)
            _held(got, ref(d, xtp))
            assert torch.equal(dia.spmm_dia_t_rows(d, rows), got)
            assert torch.equal(dia.spmm_dia_t_padded(d, xtp), got)
            if unaligned:
                assert torch.equal(dia.spmm_dia_t_padded(d, _shifted(xtp)), got)
                assert torch.equal(dia.spmm_dia_t_rows(d, _shifted(rows)), got)


@pytest.mark.parametrize("name,K", [("poisson96", 1), ("poisson96", 7), ("poisson96", 16),
                                    ("poisson96", 256), ("poisson96", 260),
                                    ("orsirr_like24", 7), ("orsirr_like24", 16)])
@pytest.mark.parametrize("offset", [0, 1])
def test_k15_matches_plain(cuda, no_plain, name, K, offset):
    """K15 on a banded and on a many-diagonal matrix; ``offset`` 1 puts X
    one float into its storage (not 16-byte aligned: the word-by-word
    path, as is any K % 4 != 0)."""
    a = gallery.get(name)
    d = dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=cuda)
    ref = no_plain("spmm_dia_ref")["spmm_dia_ref"]
    x = torch.randn(d.n * K + offset, device=cuda)[offset:].view(d.n, K)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = dia.spmm_dia.launches
    got = dia.spmm_dia(d, x)
    torch.cuda.synchronize()
    assert dia.spmm_dia.launches == before + 1 and got.shape == (d.n, K)
    _close1(got, ref(d, x))


@pytest.mark.parametrize("name,K", [("poisson96", 13), ("poisson96", 200),
                                    ("orsirr_like24", 16)])
def test_k16_matches_plain(cuda, no_plain, name, K):
    """K16 on the ``dia_pad_xt`` buffer (K padded to the model's kb), the
    [K, n] entry point, and the unpadded entry on the same rows (the same
    bits, as is a second launch)."""
    a = gallery.get(name)
    d = dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=cuda)
    ref = no_plain("spmm_dia_t_padded_ref", "spmm_dia_t_ref")
    xt = torch.randn((K, d.n), device=cuda)
    xtp = dia.dia_pad_xt(d, xt)
    before = dia.spmm_dia_t_padded.launches
    got = dia.spmm_dia_t_padded(d, xtp)
    got_t = dia.spmm_dia_t(d, xt)
    got_r = dia.spmm_dia_t_rows(d, xtp[:, d.halo:d.halo + d.n_pad].contiguous())
    torch.cuda.synchronize()
    assert dia.spmm_dia_t_padded.launches == before + 3
    want = ref["spmm_dia_t_padded_ref"](d, xtp)
    _close1(got, want)
    _close1(got_t, want[:K, :d.n])
    assert torch.equal(got_r, got) and torch.equal(dia.spmm_dia_t_padded(d, xtp), got)


def test_multirhs_solvers_on_card(cuda):
    """``cg_multi`` (K16) and ``jacobi_multirhs`` (K14, fused k = 4) on
    poisson64: the same iteration counts as on the CPU (float32 both)
    within one, and the same sweeps to float32 rounding."""
    from gflownet_spai_tpu_torch.solvers import cg_multi, jacobi_multirhs

    a = gallery.poisson2d(64, dtype=np.float32)
    B = np.random.default_rng(4).standard_normal((5, a.shape[0])).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        d = dia.coo_to_dia(a, device=dev)
        before = (dia.spmm_dia_t_padded.launches, dia.spmv_dia_power_rhs.launches)
        res = cg_multi(d, torch.as_tensor(B, device=dev), maxiter=1000, rtol=1e-5)
        jac = jacobi_multirhs(d, torch.as_tensor(B[:2], device=dev), iters=16)
        out[str(dev)] = (res.iterations.cpu().numpy(), jac.x.cpu())
        if dev != "cpu":
            torch.cuda.synchronize()
            assert dia.spmm_dia_t_padded.launches > before[0]
            assert dia.spmv_dia_power_rhs.launches == before[1] + 4   # 2 pairs
            assert bool(res.converged.all()) and jac.iterations == 16
    assert np.abs(out[str(cuda)][0] - out["cpu"][0]).max() <= 1, out
    _close_k(out[str(cuda)][1], out["cpu"][1], 16)


def test_vcycle_and_bicgstab_on_card(cuda):
    """The Jacobi- and Chebyshev-smoothed V-cycles (K12 / K13 / K8) as CG
    preconditioners on poisson64 (float32), and BiCGStab on convdiff2d24
    (float64: its float32 recurrences on a nonsymmetric system may part by
    more than one iteration between two summation orders): iteration
    counts within one of the CPU's."""
    from gflownet_spai_tpu_torch.solvers import bicgstab, cg, vcycle_op

    a = gallery.poisson2d(64, dtype=np.float32)
    c = gallery.get("convdiff2d24")
    its = {}
    for dev in ("cpu", cuda):
        d = dia.coo_to_dia(a, device=dev)
        b = torch.ones(d.n, device=dev)
        before = {k: f.launches for k, f in
                  (("K8", dia.spmv_dia), ("K12", dia.spmv_dia_power),
                   ("K13", dia.spmv_dia_cheby))}
        ops = (vcycle_op(d, levels=3, min_coarse_n=256),
               vcycle_op(d, levels=3, smoother="chebyshev", min_coarse_n=256))
        its[str(dev)] = [cg(d, b, m_op=op, maxiter=300, rtol=1e-5).iterations
                         for op in ops]
        its[str(dev)].append(bicgstab(c.to(dev), torch.ones(c.shape[0], dtype=torch.float64,
                                                            device=dev),
                                      maxiter=500, rtol=1e-5).iterations)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert dia.spmv_dia.launches > before["K8"]
            assert dia.spmv_dia_power.launches + dia.spmv_dia_cheby.launches \
                > before["K12"] + before["K13"]
    assert all(abs(g - w) <= 1 for g, w in zip(its[str(cuda)], its["cpu"])), its


# ---------------------------------------------------------------------------
# bf16 diagonals (dia_astype): the bf16 instances of K8, K10-K16
# ---------------------------------------------------------------------------

BF16 = torch.bfloat16
VEC_DTYPES = [torch.float32, BF16]


def _bf16_dia(dev, name):
    a = gallery.get(name)
    return dia.dia_astype(dia.coo_to_dia(a.with_data(a.data.astype(np.float32)),
                                         device=dev), BF16)


def _held(got, want, k=1):
    """A bf16 instance against its plain version on the same CUDA tensors:
    on bf16 vectors bit for bit (a product of two bf16 values is exact in
    float32, so the kernels' fused multiply-adds round as the plain
    version's multiply and add, and K14's affine step rounds explicitly);
    on float32 vectors (bf16 diagonals) within ``_close_k``, as the float32
    kernels."""
    assert got.dtype == want.dtype
    if got.dtype == BF16:
        assert torch.equal(got, want)
    else:
        _close_k(got, want, k)


def _types_moved(fn, before, name):
    """The launches of ``fn``'s instance ``name`` since ``before``."""
    return fn.type_launches[dia._TYPE_NAMES[name]] - before


@pytest.mark.parametrize("name", ["poisson96", "orsirr_like24"])
@pytest.mark.parametrize("vt", VEC_DTYPES)
def test_bf16_one_pass_kernels_match_plain(cuda, no_plain, name, vt):
    """K8 (``spmv_dia``, ``spmv_dia_padded``), K10, K11 (chains of 2 at
    scale 0.2), K15 (K 16, 7, and X one element into its storage: the
    word-by-word path) and K16 (``spmm_dia_t_padded``, ``spmm_dia_t``) on
    bf16 diagonals with float32 and bf16 vectors: their plain versions'
    dtypes and values, the same bits on a second launch, every launch
    counted on its instance."""
    d = _bf16_dia(cuda, name)
    code = 2 if vt == BF16 else 1
    ref = no_plain("spmv_dia_ref", "spmv_dia_padded_ref", "spmv_dia_padded_io_ref",
                   "spmv_dia_pingpong_ref", "spmm_dia_ref", "spmm_dia_t_padded_ref",
                   "spmm_dia_t_ref")
    gen = torch.Generator(device=cuda).manual_seed(code)
    x = torch.randn(d.n, generator=gen, device=cuda).to(vt)
    fns = (dia.spmv_dia, dia.spmv_dia_padded_io, dia.spmv_dia_pingpong, dia.spmm_dia,
           dia.spmm_dia_t_padded)
    before = [fn.type_launches[dia._TYPE_NAMES[code]] for fn in fns]
    y = dia.spmv_dia(d, x)
    _held(y, ref["spmv_dia_ref"](d, x))
    assert torch.equal(dia.spmv_dia(d, x), y)
    xp = torch.nn.functional.pad(x, (d.halo, d.n_pad - d.n + d.halo))
    _held(dia.spmv_dia_padded(d, xp), ref["spmv_dia_padded_ref"](d, xp))
    xq = dia.dia_pad_io(d, x).to(vt)
    p = (xq.shape[0] - d.n_pad) // 2
    for _ in range(2):
        got = dia.spmv_dia_padded_io(d, xq, scale=0.2)
        _held(got, ref["spmv_dia_padded_io_ref"](d, xq, 0.2))
        assert not got[:p].any() and not got[p + d.n_pad:].any()
        xq = got
    xq = dia.dia_pad_pp(d, x)
    yq = torch.full_like(xq, 3.0)
    want = ref["spmv_dia_pingpong_ref"](d, xq, yq.clone(), 0.2)
    got = dia.spmv_dia_pingpong(d, xq, yq, scale=0.2)
    assert got is yq
    _held(got, want)
    for K, offset in ((16, 0), (7, 0), (16, 1)):
        X = torch.randn(d.n * K + offset, generator=gen, device=cuda).to(vt)[offset:]
        X = X.view(d.n, K)
        y = dia.spmm_dia(d, X)
        _held(y, ref["spmm_dia_ref"](d, X))
        assert torch.equal(dia.spmm_dia(d, X), y)
    xt = torch.randn((13, d.n), generator=gen, device=cuda).to(vt)
    xtp = torch.nn.functional.pad(xt, (d.halo, d.n_pad - d.n + d.halo, 0, 3))
    y = dia.spmm_dia_t_padded(d, xtp)
    _held(y, ref["spmm_dia_t_padded_ref"](d, xtp))
    assert torch.equal(dia.spmm_dia_t_padded(d, xtp), y)
    _held(dia.spmm_dia_t(d, xt), ref["spmm_dia_t_ref"](d, xt))
    torch.cuda.synchronize()
    moved = [_types_moved(fn, b, code) for fn, b in zip(fns, before)]
    assert moved == [3, 2, 1, 6, 3], moved   # K8 counts spmv_dia_padded, K16 spmm_dia_t


@pytest.mark.parametrize("name,k,plan", [
    ("poisson96", 2, (1, 2048)), ("poisson96", 8, None),
    ("banded 60000 r700", 4, (16, 1024)), ("irregular 20000", 3, (4, 1024)),
    ("banded 60000 r700", 3, (4, 1504, 2)), ("banded 3000 r37", 4, (1, 4096)),
    ("irregular 20000", 8, (4, 2048, 2))])
@pytest.mark.parametrize("vt", VEC_DTYPES)
@pytest.mark.parametrize("affine,scale", [(False, 1.0), (True, -0.35)])
def test_bf16_k12_fused_equals_streamed(cuda, no_plain, monkeypatch, name, k, plan, vt,
                                        affine, scale):
    """K12 on bf16 diagonals, float32 or bf16 buffers (8-element staging,
    bf16 edge rows two to a word): fused equals streamed bit for bit, and
    the plain version (``_held``), with nonzero halo blocks."""
    ref = no_plain("spmv_dia_power_ref")["spmv_dia_power_ref"]
    d = dia.dia_astype(_fused_case_matrix(name, cuda), BF16)
    code = 2 if vt == BF16 else 1
    if plan is None:
        assert _mode(d, dia._FUSED_AFFINE if affine else dia._FUSED_POWER, k, code) == "fused"
    xq = _halo_noise(_pp(d, cuda, 1), d, 11).to(vt)
    cq = _halo_noise(_pp(d, cuda, 2), d, 12).to(vt) if affine else None
    before = dia.spmv_dia_power.type_launches[dia._TYPE_NAMES[code]]
    call = lambda: dia.spmv_dia_power(d, None, xq, torch.full_like(xq, 5.0), scale=scale,
                                      k=k, add=cq)
    fused, streamed, moved = _both_modes(monkeypatch, call, plan and _plan(*plan))
    assert moved[0] == {"fused": 1, "streamed": 0}
    assert _types_moved(dia.spmv_dia_power, before, code) == 2
    assert fused.dtype == vt and torch.equal(fused, streamed)
    _held(fused, ref(d, xq, torch.full_like(xq, 5.0), scale=scale, k=k, add=cq), k)


@pytest.mark.parametrize("name,k,plan", [
    ("poisson96", 2, (2, 1024)), ("poisson256", 8, None), ("irregular 20000", 3, (8, 512)),
    ("banded 60000 r700", 2, (16, 736)), ("irregular 20000", 8, (4, 2048, 3))])
@pytest.mark.parametrize("vt", VEC_DTYPES)
def test_bf16_k13_fused_equals_streamed(cuda, no_plain, monkeypatch, name, k, plan, vt):
    """K13 on bf16 diagonals, float32 or bf16 buffers (dd and z rounded at
    every pass): fused equals streamed bit for bit (z and dd), and the
    plain version (``_held``)."""
    from gflownet_spai_tpu_torch.solvers.stationary import chebyshev_coeffs

    ref = no_plain("spmv_dia_cheby_ref")["spmv_dia_cheby_ref"]
    d = dia.dia_astype(_fused_case_matrix(name, cuda), BF16)
    code = 2 if vt == BF16 else 1
    if plan is None:
        assert _mode(d, dia._FUSED_CHEBY, k, code) == "fused"
    zq, ddq, rq = (_halo_noise(_pp(d, cuda, s), d, s + 20).to(vt) for s in (4, 5, 6))
    coeffs = tuple(chebyshev_coeffs(0.3, 8.2, k))
    call = lambda: dia.spmv_dia_cheby(d, None, zq, ddq, rq, torch.zeros_like(zq),
                                      torch.zeros_like(zq), coeffs, k)
    fused, streamed, moved = _both_modes(monkeypatch, call, plan and _plan(*plan))
    assert moved[1] == {"fused": 1, "streamed": 0}
    want = ref(d, zq, ddq, rq, torch.zeros_like(zq), torch.zeros_like(zq), coeffs, k)
    for f, s_, w in zip(fused, streamed, want):
        assert torch.equal(f, s_)
        _held(f, w, k)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("vt", VEC_DTYPES)
def test_bf16_k14_tiled_equals_streamed(cuda, no_plain, k, vt):
    """K14 on poisson96's bf16 Jacobi matrix with 12 right-hand sides,
    affine: k passes in one call against k one-pass calls chained bit for
    bit, a second launch, and the plain version (``_held``)."""
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi_iteration_matrix

    m = jacobi_iteration_matrix(_bf16_dia(cuda, "poisson96"))
    assert m.data.dtype == BF16
    ref = no_plain("spmv_dia_power_rhs_ref")["spmv_dia_power_rhs_ref"]
    gen = torch.Generator(device=cuda).manual_seed(k)
    tr = 2 * m.halo
    xq = dia.dia_pad_pp_rhs(m, torch.randn((12, m.n), generator=gen, device=cuda), tr=tr)
    cq = dia.dia_pad_pp_rhs(m, torch.randn((12, m.n), generator=gen, device=cuda), tr=tr)
    xq, cq = xq.to(vt), cq.to(vt)
    call = lambda: dia.spmv_dia_power_rhs(m, None, xq, torch.full_like(xq, 5.0), scale=0.9,
                                          k=k, add=cq)
    got = call()
    chained = _k14_chained(m, xq, cq, 0.9, k)
    torch.cuda.synchronize()
    assert got.dtype == vt
    assert torch.equal(got[:, tr:tr + m.n_pad], chained[:, tr:tr + m.n_pad])
    assert torch.equal(call(), got)
    _held(got, ref(m, xq, torch.full_like(xq, 5.0), scale=0.9, k=k, add=cq), k)
    assert (got[:, :tr] == 5.0).all() and (got[:, tr + m.n_pad:] == 5.0).all()


def test_bf16_wrappers_refuse_other_dtypes(cuda):
    """float16 and float64 diagonals or vectors, mixed buffers, and bf16
    buffers written in place on float32 diagonals raise ``ValueError``
    before any launch; a bf16 vector on float32 diagonals is promoted."""
    d32 = _poisson_dia(cuda, 32)[1]
    db = dia.dia_astype(d32, BF16)
    counts = {fn: fn.launches for fn in (dia.spmv_dia, dia.spmv_dia_pingpong,
                                        dia.spmv_dia_power, dia.spmm_dia)}
    x = torch.randn(d32.n, device=cuda)
    for dd, xx in ((d32, x.half()), (d32, x.double()), (dia.dia_astype(d32, torch.float16), x),
                   (dia.dia_astype(d32, torch.float64), x.double()), (db, x.half())):
        with pytest.raises(ValueError, match="diagonals torch"):
            dia.spmv_dia(dd, xx)
    xq = dia.dia_pad_pp(db, x)
    with pytest.raises(ValueError, match="diagonals torch"):       # mixed buffers
        dia.spmv_dia_power(db, None, xq, torch.zeros_like(xq).to(BF16), k=2)
    with pytest.raises(ValueError, match="diagonals torch"):       # f32 diagonals, bf16 buffers
        dia.spmv_dia_pingpong(d32, xq.to(BF16), torch.zeros_like(xq).to(BF16))
    with pytest.raises(ValueError, match="diagonals torch"):
        dia.spmm_dia(db, torch.randn((d32.n, 4), device=cuda).half())
    assert {fn: fn.launches for fn in counts} == counts
    y = dia.spmv_dia(d32, x.to(BF16))
    assert y.dtype == torch.float32
    _close1(y, dia.spmv_dia_ref(d32, x.to(BF16).float()))


# --- K8's two paths (csrc/dia.cu): rows, and skip (stored-zero segments) -------

K8_INSTANCES = [(torch.float32, torch.float32), (BF16, torch.float32), (BF16, BF16)]
K8_PATHS = {"rows": (0, 0.0), "skip": (0, float("inf"))}   # _K8_SKIP_RULE forcing each path


def _k8_case(dev, name, dt, vt, seed=0):
    """A gallery matrix as a DIA with ``dt`` diagonals and an x of ``vt``."""
    a = gallery.poisson2d(1024, dtype=np.float32) if name == "poisson1024" \
        else gallery.get(name)
    d = dia.coo_to_dia(a.with_data(a.data.astype(np.float32)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return dia.dia_astype(d, dt), torch.randn(d.n, generator=gen, device=dev).to(vt)


def _bits(y):
    return y.view(torch.int16 if y.element_size() == 2 else torch.int32)


def _on_paths(monkeypatch, call):
    """``call()`` on K8's rows path and on its skip path: both results (the
    same bits, NaN included) and the launches each path counted."""
    out = {}
    for path, least in K8_PATHS.items():
        with monkeypatch.context() as mp:
            mp.setattr(dia, "_K8_SKIP_RULE", least)
            before = dict(dia.spmv_dia.path_launches)
            out[path] = call()
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in dia.spmv_dia.path_launches.items()}
            assert moved[path] > 0 and sum(moved.values()) == moved[path], moved
    for a, b in zip(out["rows"], out["skip"]):
        assert torch.equal(_bits(a), _bits(b))
    return out["skip"]


def _same_nonfinite(got, want):
    """NaN and inf in the same places; the finite values as ``_held``."""
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    fin = want.isfinite()
    _held(got[fin], want[fin])


@pytest.mark.parametrize("dt,vt", K8_INSTANCES)
@pytest.mark.parametrize("name", ["orsirr_like150", "poisson1024"])
def test_k8_paths_match_plain_at_full_size(cuda, no_plain, monkeypatch, name, dt, vt):
    """K8 at the shapes of the validation path (230 diagonals, most
    segments skipped; 5 full diagonals of 1,048,576 rows) in each instance,
    through ``spmv_dia`` and ``spmv_dia_padded``: the skip path gives the
    rows path's bits, both the plain version's values (bf16 vectors: its
    bits), a second launch the same bits."""
    d, x = _k8_case(cuda, name, dt, vt)
    ref = no_plain("spmv_dia_ref", "spmv_dia_padded_ref")
    xp = torch.nn.functional.pad(x, (d.halo, d.n_pad - d.n + d.halo))
    y, yp, again = _on_paths(monkeypatch, lambda: (dia.spmv_dia(d, x), dia.spmv_dia_padded(d, xp),
                                                   dia.spmv_dia(d, x)))
    _held(y, ref["spmv_dia_ref"](d, x))
    _held(yp, ref["spmv_dia_padded_ref"](d, xp))
    assert torch.equal(_bits(again), _bits(y))
    if name == "orsirr_like150":
        assert float(d.flags.float().mean()) < 0.05     # the skipped segments


@pytest.mark.parametrize("dt,vt", K8_INSTANCES)
def test_k8_nonfinite_x_gives_nan_where_the_plain_version_does(cuda, no_plain, monkeypatch,
                                                               dt, vt):
    """inf and NaN in x on orsirr_like150, where stored zeros of skipped
    segments reach them in most rows that read them: both paths give NaN
    (and inf) in the same rows as the plain version, the rest its values."""
    d, x = _k8_case(cuda, "orsirr_like150", dt, vt, seed=1)
    ref = no_plain("spmv_dia_ref")["spmv_dia_ref"]
    idx = torch.randperm(d.n, generator=torch.Generator().manual_seed(5))[:8].to(cuda)
    x[idx[:4]] = float("inf")
    x[idx[4:]] = float("nan")
    (y,) = _on_paths(monkeypatch, lambda: (dia.spmv_dia(d, x),))
    want = ref(d, x)
    assert int(want.isnan().sum()) > 8 * 5          # every diagonal that reaches them
    _same_nonfinite(y, want)


@pytest.mark.parametrize("inf_at", [None, 3010], ids=["finite x", "inf in x"])
@pytest.mark.parametrize("word", [0.0, -0.0], ids=["+0.0", "-0.0"])
def test_k8_skipped_terms_turn_a_negative_zero_sum_positive(cuda, monkeypatch, word, inf_at):
    """A row whose sum underflows to -0.0 (fma(-1e-30, 1e-30, +0.0)) and
    then meets a skipped segment of ``word`` (+0.0 or -0.0, neither
    flagged): fma(word, x, -0.0) is +0.0 where word·x is +0.0, so the skip
    path must walk that segment with its words.  With inf at x[3010] the
    segment is listed in the tiles whose window of x holds it (rows 960 to
    1087), and read with its words there too: NaN in row 1010 only, every
    other row the rows path's bits."""
    n = 4096
    data = torch.full((2, n), word, device=cuda)
    data[0] = -1e-30                                 # offset 0: every row, flagged
    d = dia.DIA(data=data, offsets=(0, 2000), shape=(n, n), nnz=n)   # offset 2000: +-0.0
    assert not dia._flags(d)[:, 1].any()
    x = torch.full((n,), 1e-30, device=cuda)
    x[2000:3000] = 2.0
    x[3000:] = -2.0
    if inf_at is not None:
        x[inf_at] = float("inf")
    (y,) = _on_paths(monkeypatch, lambda: (dia.spmv_dia(d, x),))
    bits = _bits(y).cpu()                            # rows < 2000 summed to -0.0 first
    nan = torch.zeros(n, dtype=torch.bool)
    if inf_at is not None:
        nan[inf_at - 2000] = True
    assert torch.equal(y.isnan().cpu(), nan)
    plus = np.copysign(1.0, word) > 0                # word·2 is +0.0 for word +0.0
    rows = torch.arange(n)
    pos = (rows < 1000) if plus else (rows >= 1000) & (rows < 2000)
    neg = (rows < 2000) & ~pos
    assert (bits[pos & ~nan] == 0).all() and (bits[neg & ~nan] == -2 ** 31).all()
    assert (y[2000:] != 0).all()


def test_spmv_dia_skip_path_captures_on_a_fresh_matrix(cuda, monkeypatch):
    """As ``test_spmv_dia_captures_on_a_fresh_matrix`` on the skip path:
    the backward's transpose, made inside the capture, builds its segment
    flags there (device ops only), and the scan and the SpMV replay."""
    monkeypatch.setattr(dia, "_K8_SKIP_RULE", K8_PATHS["skip"])
    dia.spmv_dia(_poisson_dia(cuda, 16)[1], torch.ones(256, device=cuda))
    d = _banded_dia(cuda, 5000, 131, seed=9)
    d = dia.DIA(data=d.data, offsets=(-131, -3, 0, 5, 77), shape=d.shape, nnz=d.nnz)
    x, g = torch.randn(d.n, device=cuda), torch.randn(d.n, device=cuda)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = dia.spmv_dia(d, x)
        yt = dia.spmv_dia(dia.dia_transpose(d), g)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(y, dia.spmv_dia_ref(d, x), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(yt, dia.spmv_dia_ref(dia.dia_transpose(d), g),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", [torch.float32, BF16])
def test_k8_reads_an_in_place_write(cuda, no_plain, monkeypatch, dt):
    """A write into a segment whose flag is clear: the next launch makes
    the flags again (the data's version moved) and reads the new word."""
    monkeypatch.setattr(dia, "_K8_SKIP_RULE", K8_PATHS["skip"])
    d, x = _k8_case(cuda, "orsirr_like150", dt, dt)
    ref = no_plain("spmv_dia_ref")["spmv_dia_ref"]
    y0 = dia.spmv_dia(d, x)
    flags = d.flags.cpu()
    tile, s = next((t, s) for t in range(30, flags.shape[0]) for s in range(d.ndiags)
                   if not flags[t, s] and 0 <= t * 64 + d.offsets[s] < d.n)
    row = tile * 64
    d.data[s, row] = 3.0
    y1 = dia.spmv_dia(d, x)
    torch.cuda.synchronize()
    assert d.flags[tile, s] == 1
    _held(y1, ref(d, x))
    assert not torch.equal(y1[row], y0[row])
    assert torch.equal(y1[:row], y0[:row]) and torch.equal(y1[row + 1:], y0[row + 1:])


@pytest.mark.parametrize("dt,vt", K8_INSTANCES)
@pytest.mark.parametrize("ndiags", [1, 40, 1100])
def test_k8_takes_any_shape_and_alignment(cuda, no_plain, monkeypatch, ndiags, dt, vt):
    """Random offsets (some beyond n), n_pad 5,001 (a ragged last tile and
    diagonal rows off 16-byte boundaries), x one element into its storage,
    about three segments in four zero: one diagonal, 40, and 1,100 (two
    chunks of the skip path's lists).  Both paths, the same bits; the
    plain version's values (bf16 vectors: its bits)."""
    n, n_pad = 4990, 5001
    rng = np.random.default_rng(ndiags)
    offsets = tuple(sorted(rng.choice(np.arange(-6000, 6000), ndiags, replace=False).tolist()))
    data = rng.standard_normal((ndiags, n_pad)).astype(np.float32)
    data[:, rng.random(n_pad) < 0.5] = 0.0
    data[rng.random((ndiags, n_pad // 64 + 1)).repeat(64, 1)[:, :n_pad] < 0.5] = 0.0
    d = dia.dia_astype(dia.DIA(data=torch.as_tensor(data, device=cuda), offsets=offsets,
                               shape=(n, n), nnz=int((data != 0).sum())), dt)
    ref = no_plain("spmv_dia_ref", "spmv_dia_padded_ref")
    buf = torch.randn(n + 1, generator=torch.Generator(device=cuda).manual_seed(3),
                      device=cuda).to(vt)
    x = buf[1:]
    xp = torch.nn.functional.pad(x, (d.halo + 1, d.n_pad - d.n + d.halo))[1:]
    y, yp = _on_paths(monkeypatch, lambda: (dia.spmv_dia(d, x), dia.spmv_dia_padded(d, xp)))
    _held(y, ref["spmv_dia_ref"](d, x))
    _held(yp, ref["spmv_dia_padded_ref"](d, xp))


def test_k8_refuses_flags_it_cannot_read(cuda, monkeypatch):
    """On the skip path, flags of another shape raise ``ValueError`` before
    any launch; flags made for another tile height pass the wrapper's check
    and the C entry refuses them."""
    monkeypatch.setattr(dia, "_K8_SKIP_RULE", K8_PATHS["skip"])
    _, d = _poisson_dia(cuda, 32)
    x = torch.randn(d.n, device=cuda)
    before = dia.spmv_dia.launches
    object.__setattr__(d, "flags", d.flags[:-1])
    object.__setattr__(d, "flags_version", d.data._version)
    with pytest.raises(ValueError, match="segment flags"):
        dia.spmv_dia(d, x)
    monkeypatch.setattr(dia, "_FLAG_ROWS", 32)
    _, d32 = _poisson_dia(cuda, 32)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dia.spmv_dia(d32, x)
    assert dia.spmv_dia.launches == before


def test_bf16_solvers_on_card(cuda):
    """``jacobi_sweeps_op`` (K12 on bf16 buffers, k 4), ``chebyshev_op``
    (K13 on bf16 buffers, k 4) and ``jacobi_multirhs`` (K14, K16) on a bf16
    poisson64: the applies equal the CPU's bit for bit (the bf16 instances
    give their plain versions' bits, and the CPU runs the plain versions),
    the multi-RHS sweeps too; CG with each preconditioner converges in as
    many iterations as on the CPU, within one."""
    from gflownet_spai_tpu_torch.solvers import (cg, chebyshev_op, jacobi_multirhs,
                                                 jacobi_sweeps_op)

    a = gallery.poisson2d(64, dtype=np.float32)
    r = np.random.default_rng(3).standard_normal(a.shape[0]).astype(np.float32)
    B = np.random.default_rng(4).standard_normal((5, a.shape[0])).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        d = dia.coo_to_dia(a, device=dev)
        db = dia.dia_astype(d, BF16)
        ops = (jacobi_sweeps_op(db, sweeps=16), chebyshev_op(db, lmax=8.0, degree=16))
        assert [op.info["k"] for op in ops] == [4, 4]
        before = (dia.spmv_dia_power.type_launches["bf16"],
                  dia.spmv_dia_cheby.type_launches["bf16"],
                  dia.spmv_dia_power_rhs.type_launches["bf16"])
        rr = torch.as_tensor(r, device=dev)
        applies = [op(rr) for op in ops]
        jac = jacobi_multirhs(db, torch.as_tensor(B, device=dev), iters=16)
        its = [cg(d, torch.ones(d.n, device=dev), m_op=op, maxiter=500, rtol=1e-5).iterations
               for op in ops]
        out[str(dev)] = ([v.cpu() for v in applies], jac.x.cpu(), jac.residual.cpu(), its)
        if dev != "cpu":
            torch.cuda.synchronize()
            after = (dia.spmv_dia_power.type_launches["bf16"],
                     dia.spmv_dia_cheby.type_launches["bf16"],
                     dia.spmv_dia_power_rhs.type_launches["bf16"])
            assert all(a_ > b_ for a_, b_ in zip(after, before)), (before, after)
    got, want = out[str(cuda)], out["cpu"]
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=2e-2, atol=0.0)
    assert all(abs(g - w) <= 1 for g, w in zip(got[3], want[3])), (got[3], want[3])


# ---------------------------------------------------------------------------
# K5, K6, K7 (tile segment ops) and K17 (block-ELL SpMM)
# ---------------------------------------------------------------------------

EPS32 = torch.finfo(torch.float32).eps


@pytest.fixture
def no_plain_mod(monkeypatch):
    """``no_plain`` for any module: the named plain versions fail, the
    originals are returned."""
    def patch(mod, *names):
        saved = {nm: getattr(mod, nm) for nm in names}

        def fail(*_, **__):
            raise AssertionError("a CUDA tensor reached the plain version")

        for nm in names:
            monkeypatch.setattr(mod, nm, fail)
        return saved
    return patch


def _seg_layout(dev, kind):
    """``empty``: node ids skip tiles 2 and 5 (two empty tiles) and a hub
    owns 300 slots; ``padded``: one tile holds a 1,000-slot hub, so the
    padding fills most of S in every other tile; ``shuffled``: ``empty``
    with each tile's slots permuted and part of the padding marked -1 and
    part TN + 5 (no node's slots form a run)."""
    rng = np.random.default_rng(3)
    n, tn = 1500, 128
    if kind == "padded":
        ids = np.concatenate([rng.integers(0, n, 3000), np.full(1000, 40)])
    else:
        ids = rng.integers(0, n, 12000)
        ids = ids[(ids // tn != 2) & (ids // tn != 5)]
        ids = np.concatenate([ids, np.full(300, 900)])
    tiles = seg.build_seg_tiles(ids, n, tile_nodes=tn, device=dev)
    real = (tiles.local_dst < tn).sum(dim=1)
    if kind == "padded":
        assert float(real.float().mean()) < 0.3 * tiles.slots
    else:
        assert int((real == 0).sum()) == 2
    if kind == "shuffled":
        lid = tiles.local_dst.cpu().numpy().copy()
        for t in range(tiles.tiles):
            lid[t] = lid[t][rng.permutation(tiles.slots)]
            pad = np.flatnonzero(lid[t] == tn)
            lid[t, pad[::3]] = -1
            lid[t, pad[1::3]] = tn + 5
        tiles = dataclasses.replace(tiles, local_dst=torch.as_tensor(lid, device=dev))
        assert seg.layout_runs(tiles)[1] is not None
    return rng, tiles


def _k5_refs(tiles, scores, g):
    """The plain K5 forward and backward on ``scores`` and ``g`` (the
    backward at the plain forward's y) with their elementwise bounds;
    computed before the plain versions are replaced."""
    y = seg.segment_softmax_tiles_ref(tiles, scores)
    dx = seg.segment_softmax_tiles_bwd_ref(tiles, y, g)
    runs = seg._run_sums_ref(tiles, torch.ones_like(scores))
    bound_y = 1e-6 + (1e-5 + 4 * EPS32 * runs) * y.abs()
    bound_dx = 1e-6 + 1e-5 * dx.abs() + 4 * EPS32 * y.abs() * seg._run_sums_ref(
        tiles, (y * g).abs())
    return y, dx, bound_y, bound_dx


def _within(got, want, bound, what):
    err = (got - want).abs()
    assert bool((err <= bound).all()), f"{what}: max err {float(err.max()):.3e}"


def _run_len(tiles, ref_sum, ref_bcast):
    """[T, S, 1]: the length of each slot's run (0 for padding)."""
    ones = tiles.local_dst.new_ones((tiles.tiles, tiles.slots, 1), dtype=torch.float32)
    per_node = ref_sum(tiles, ones).reshape(tiles.tiles, tiles.tile_nodes, 1)
    return ref_bcast(tiles, per_node)


@pytest.mark.parametrize("kind", ["empty", "padded"])
@pytest.mark.parametrize("H", [4, 1])
def test_k5_matches_plain(cuda, no_plain_mod, kind, H):
    rng, tiles = _seg_layout(cuda, kind)
    ref = no_plain_mod(seg, "segment_softmax_tiles_ref", "segment_sum_tiles_ref",
                       "segment_broadcast_tiles_ref")
    scores = torch.as_tensor(rng.standard_normal((tiles.tiles, H, tiles.slots)) * 3,
                             dtype=torch.float32, device=cuda)
    before = seg.segment_softmax_tiles_mh.launches
    got = seg.segment_softmax_tiles_mh(tiles, scores)
    torch.cuda.synchronize()
    assert seg.segment_softmax_tiles_mh.launches == before + 1
    want = ref["segment_softmax_tiles_ref"](tiles, scores)
    runs = _run_len(tiles, ref["segment_sum_tiles_ref"],
                    ref["segment_broadcast_tiles_ref"]).permute(0, 2, 1)
    bound = 1e-6 + (1e-5 + 4 * EPS32 * runs) * want.abs()
    err = (got - want).abs()
    assert bool((err <= bound).all()), f"max err {float(err.max()):.3e}"
    assert not got[(tiles.local_dst == tiles.tile_nodes)[:, None].expand_as(got)].any()


@pytest.mark.parametrize("kind", ["empty", "padded"])
@pytest.mark.parametrize("D", [16, 4, 3, 2, 1])
def test_k6_k7_match_plain(cuda, no_plain_mod, kind, D):
    """K6 and K7 forward and as each other's backward (D 3 and 2 take the
    kernels' scalar instances)."""
    rng, tiles = _seg_layout(cuda, kind)
    ref = no_plain_mod(seg, "segment_sum_tiles_ref", "segment_broadcast_tiles_ref")
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                   device=cuda)
    vals, nodes = f(T, S, D).requires_grad_(True), f(T, TN, D).requires_grad_(True)
    k6, k7 = seg.segment_sum_tiles.launches, seg.segment_broadcast_tiles.launches
    got_sum = seg.segment_sum_tiles(tiles, vals)
    got_bc = seg.segment_broadcast_tiles(tiles, nodes)
    g_sum, g_bc = f(T * TN, D), f(T, S, D)
    (d_vals,) = torch.autograd.grad(got_sum, vals, g_sum)       # K7
    (d_nodes,) = torch.autograd.grad(got_bc, nodes, g_bc)       # K6
    torch.cuda.synchronize()
    assert (seg.segment_sum_tiles.launches - k6, seg.segment_broadcast_tiles.launches
            - k7) == (2, 2)
    v = vals.detach()
    want = ref["segment_sum_tiles_ref"](tiles, v)
    bound = 1e-5 * want.abs() + 4 * EPS32 * ref["segment_sum_tiles_ref"](tiles, v.abs())
    assert bool(((got_sum - want).abs() <= bound).all())
    want_nodes = ref["segment_sum_tiles_ref"](tiles, g_bc).reshape(T, TN, D)
    bound = 1e-5 * want_nodes.abs() + 4 * EPS32 * ref["segment_sum_tiles_ref"](
        tiles, g_bc.abs()).reshape(T, TN, D)
    assert bool(((d_nodes - want_nodes).abs() <= bound).all())
    assert torch.equal(got_bc, ref["segment_broadcast_tiles_ref"](tiles, nodes.detach()))
    assert torch.equal(d_vals, ref["segment_broadcast_tiles_ref"](
        tiles, g_sum.reshape(T, TN, D)))


def _offset(x):
    """A contiguous copy of ``x`` whose data_ptr is one element past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    return view


@pytest.mark.parametrize("kind", ["empty", "padded"])
@pytest.mark.parametrize("D", [16, 4, 1])
def test_k6_k7_unaligned_and_repeatable(cuda, no_plain_mod, kind, D):
    """Inputs and local_dst at a one-element offset take the kernels' scalar
    paths and give the same bits as the 16-byte paths (K6's order depends
    only on its slot lanes); K6 gives the same bits on a second launch;
    each call launches its kernel once."""
    rng, tiles = _seg_layout(cuda, kind)
    ref = no_plain_mod(seg, "segment_sum_tiles_ref", "segment_broadcast_tiles_ref")
    T, S, TN = tiles.tiles, tiles.slots, tiles.tile_nodes
    f = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,
                                   device=cuda)
    vals, nodes = f(T, S, D), f(T, TN, D)
    shifted = dataclasses.replace(tiles, local_dst=_offset(tiles.local_dst))
    sums, bcasts = [], []
    for lay, v, nv in ((tiles, vals, nodes), (tiles, vals, nodes),
                       (tiles, _offset(vals), _offset(nodes)),
                       (shifted, vals, nodes)):
        k6, k7 = seg.segment_sum_tiles.launches, seg.segment_broadcast_tiles.launches
        sums.append(seg.segment_sum_tiles(lay, v))
        assert seg.segment_sum_tiles.launches == k6 + 1
        bcasts.append(seg.segment_broadcast_tiles(lay, nv))
        assert seg.segment_broadcast_tiles.launches == k7 + 1
    torch.cuda.synchronize()
    want = ref["segment_sum_tiles_ref"](tiles, vals)
    bound = 1e-5 * want.abs() + 4 * EPS32 * ref["segment_sum_tiles_ref"](tiles, vals.abs())
    assert bool(((sums[0] - want).abs() <= bound).all())
    assert all(torch.equal(x, sums[0]) for x in sums[1:])
    want = ref["segment_broadcast_tiles_ref"](tiles, nodes)
    assert all(torch.equal(x, want) for x in bcasts)


@pytest.mark.parametrize("kind", ["empty", "padded", "shuffled"])
@pytest.mark.parametrize("H", [4, 1, 3])
def test_k5_fwd_bwd_on_every_layout(cuda, no_plain_mod, kind, H):
    """K5 forward and backward against their plain versions on layouts with
    300- and 1,000-slot hubs (runs longer than a lane's registers), empty
    tiles and nodes, and slots not in runs with -1 and TN + 5 padding; the
    same bits on a second launch and on inputs one element off 16 bytes;
    one launch per call, also through autograd."""
    rng, tiles = _seg_layout(cuda, kind)
    T, S = tiles.tiles, tiles.slots
    f = lambda: torch.as_tensor(rng.standard_normal((T, H, S)), dtype=torch.float32,
                                device=cuda)
    scores, g = f() * 3, f()
    want_y, want_dx, bound_y, bound_dx = _k5_refs(tiles, scores, g)
    no_plain_mod(seg, "segment_softmax_tiles_ref", "segment_softmax_tiles_bwd_ref",
                 "segment_sum_tiles_ref", "segment_broadcast_tiles_ref")
    ys, dxs = [], []
    for x, y, gg in ((scores, want_y, g), (scores, want_y, g),
                     (_offset(scores), _offset(want_y), _offset(g))):
        k5, k5b = seg.segment_softmax_tiles_mh.launches, seg.segment_softmax_tiles_bwd.launches
        ys.append(seg.segment_softmax_tiles_mh(tiles, x))
        dxs.append(seg.segment_softmax_tiles_bwd(tiles, y, gg))
        assert (seg.segment_softmax_tiles_mh.launches - k5,
                seg.segment_softmax_tiles_bwd.launches - k5b) == (1, 1)
    x = scores.clone().requires_grad_(True)
    y = seg.segment_softmax_tiles_mh(tiles, x)
    k5b = seg.segment_softmax_tiles_bwd.launches
    (dx,) = torch.autograd.grad(y, x, g)
    torch.cuda.synchronize()
    assert seg.segment_softmax_tiles_bwd.launches == k5b + 1
    _within(ys[0], want_y, bound_y, f"K5 on {kind}, H {H}")
    _within(dxs[0], want_dx, bound_dx, f"K5 backward on {kind}, H {H}")
    assert all(torch.equal(a, ys[0]) for a in ys[1:] + [y.detach()])
    assert all(torch.equal(a, dxs[0]) for a in dxs[1:])
    assert torch.equal(dx, seg.segment_softmax_tiles_bwd(tiles, y.detach(), g))


def test_segment_kernels_take_unsorted_layouts(cuda, no_plain_mod):
    """Layouts whose slots are not in runs: tile 0's local_dst reversed
    (padding first), and the shuffled layout (every tile permuted, padding
    ids -1 and TN + 5).  K5 forward and backward and K6 take them through
    the slot order of ``layout_runs`` and equal their plain versions within
    the K5 and K6 bounds; K7 equals its plain version exactly."""
    rng, tiles = _seg_layout(cuda, "empty")
    lid = tiles.local_dst.clone()
    lid[0] = lid[0].flip(0)
    cases = []
    for lay in (dataclasses.replace(tiles, local_dst=lid), _seg_layout(cuda, "shuffled")[1]):
        assert seg.layout_runs(lay)[1] is not None
        T, S, TN = lay.tiles, lay.slots, lay.tile_nodes
        f = lambda *shape: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                           device=cuda)
        scores, g, vals, nodes = f(T, 2, S) * 3, f(T, 2, S), f(T, S, 4), f(T, TN, 4)
        want_sum = seg.segment_sum_tiles_ref(lay, vals)
        cases.append((lay, scores, g, vals, nodes, _k5_refs(lay, scores, g), want_sum,
                      1e-5 * want_sum.abs() + 4 * EPS32 * seg.segment_sum_tiles_ref(
                          lay, vals.abs()), seg.segment_broadcast_tiles_ref(lay, nodes)))
    no_plain_mod(seg, "segment_softmax_tiles_ref", "segment_softmax_tiles_bwd_ref",
                 "segment_sum_tiles_ref", "segment_broadcast_tiles_ref")
    for lay, scores, g, vals, nodes, (y, dx, bound_y, bound_dx), want_sum, bound_sum, \
            want_bc in cases:
        got_y = seg.segment_softmax_tiles_mh(lay, scores)
        got_dx = seg.segment_softmax_tiles_bwd(lay, y, g)
        got_sum = seg.segment_sum_tiles(lay, vals)
        got_bc = seg.segment_broadcast_tiles(lay, nodes)
        torch.cuda.synchronize()
        _within(got_y, y, bound_y, "K5")
        _within(got_dx, dx, bound_dx, "K5 backward")
        _within(got_sum, want_sum, bound_sum, "K6")
        assert torch.equal(got_bc, want_bc)


def test_generic_gat_gradient_on_card(cuda):
    """Two generic GATv2 layers (edge_dim 2) on orsirr_like24's tile layout
    through K3-K7, values and parameter gradients against the per-edge
    path on the card (rtol 2e-4, atol 2e-5; gradients rtol 5e-3, atol
    5e-4 times the group's largest: the repo's bounds)."""
    seed = gallery.orsirr_like(24)
    seed = seed.with_data(seed.data.astype(np.float32))
    tg = pol.tiled_graph_from_seed(seed, tile_nodes=128, bucket_step=None, device=cuda)
    n2 = tg.tiles.num_nodes
    v = seed.data
    feats = np.stack([v, np.abs(v)], axis=1)
    attr = torch.as_tensor(np.concatenate([feats, np.broadcast_to(feats.mean(0), (n2, 2))]))
    attr_t = seg.to_tiles(tg.tiles.to("cpu"), attr).to(cuda)
    gen = torch.Generator().manual_seed(5)
    ps = [gat.gatv2_init(gen, 1, 4, 4, edge_dim=2), gat.gatv2_init(gen, 16, 4, 1, edge_dim=2)]
    ps = [[x.to(cuda).requires_grad_(True) for x in p] for p in ps]
    c = torch.randn((n2, 4), generator=gen).to(cuda)
    edges = seed.to(cuda)
    ea = attr[:seed.nnz].to(cuda)

    def tiled(p1, p2):
        h = torch.relu(gat.gatv2_apply_tiled(p1, tg.x, tg.tiles, tg.src_t, tg.dst_t,
                                             attr_t, n2, 4, 4, srcwin=tg.srcwin))
        return gat.gatv2_apply_tiled(p2, h, tg.tiles, tg.src_t, tg.dst_t, attr_t, n2, 1,
                                     4, srcwin=tg.srcwin)

    def per_edge(p1, p2):
        x = torch.ones((n2, 1), device=cuda)
        h = torch.relu(gat.gatv2_apply(p1, x, edges.row, edges.col, ea, n2, 4, 4))
        return gat.gatv2_apply(p2, h, edges.row, edges.col, ea, n2, 1, 4)

    counters = (seg.gather_rows_windows, seg.scatter_rows_windows,
                seg.segment_softmax_tiles_mh, seg.segment_sum_tiles,
                seg.segment_broadcast_tiles)
    before = [fn.launches for fn in counters]
    flat = ps[0] + ps[1]
    out = tiled(gat.GATv2Params(*ps[0]), gat.GATv2Params(*ps[1]))
    got = torch.autograd.grad((out * c).sum(), flat)
    torch.cuda.synchronize()
    assert all(fn.launches > b for fn, b in zip(counters, before))
    want_out = per_edge(gat.GATv2Params(*ps[0]), gat.GATv2Params(*ps[1]))
    want = torch.autograd.grad((want_out * c).sum(), flat)
    torch.testing.assert_close(out, want_out, rtol=2e-4, atol=2e-5)
    for group in (slice(0, 6), slice(6, 12)):
        scale = max(float(w.abs().max()) for w in want[group])
        for a, b in zip(got[group], want[group]):
            torch.testing.assert_close(a, b, rtol=5e-3, atol=5e-4 * scale)


def _bell_case(dev, blockshape, m=1024, n=2048, density=0.1, seed=0):
    """A random matrix with ``density`` of its blocks dense (standard
    normals), as a BELL on ``dev``."""
    rng = np.random.default_rng(seed)
    bm, bn = blockshape
    mask = rng.random((m // bm, n // bn)) < density
    dense = np.kron(mask, np.ones(blockshape)) * rng.standard_normal((m, n))
    from gflownet_spai_tpu_torch.sparse import coo_to_csr
    from gflownet_spai_tpu_torch.sparse.types import COO

    a = COO.fromdense(dense.astype(np.float32))
    return rng, bsr.csr_to_bell(coo_to_csr(a, canonical=True), blockshape).to(dev)


def _irregular_bell(blockshape, m=1024, n=2048, W=6, seed=0):
    """A hand-built BELL that ``csr_to_bell`` never gives: slots in shuffled
    order, explicit all-zero blocks between real ones, a real block in
    column 0 at a slot > 0, a repeated block column, block rows with no
    real block, and blocks that are zero in some 32-column chunks only."""
    rng = np.random.default_rng(seed)
    bm, bn = blockshape
    nbr, nbc = m // bm, n // bn
    data = np.zeros((nbr, W, bm, bn), np.float32)
    cols = np.zeros((nbr, W), np.int32)
    for r in range(nbr):
        if r % 5 == 0:
            continue                                    # no real block
        slots = rng.permutation(W)[:rng.integers(2, W + 1)]
        for t, w in enumerate(slots):
            cols[r, w] = rng.integers(0, nbc)
            if t % 3 == 2:
                continue                                # explicit zero block
            blk = rng.standard_normal((bm, bn)).astype(np.float32)
            if t % 3 == 1 and bn > 32:                  # zero 32-column chunks
                for j0 in range(0, bn, 64):
                    blk[:, j0:j0 + 32] = 0.0
            data[r, w] = blk
        cols[r, slots[1]] = cols[r, slots[0]]           # a repeated column
        if r % 7 == 1 and slots.max() > 0:
            w = int(slots.max())
            cols[r, w] = 0                              # column 0 at a slot > 0
            data[r, w] = rng.standard_normal((bm, bn))
    return rng, bsr.BELL(data=data, bcols=cols, shape=(m, n),
                         nnz=int(np.count_nonzero(data)))


@pytest.mark.parametrize("blockshape", [(8, 128), (16, 32), (32, 128), (64, 64),
                                        (128, 128)])
@pytest.mark.parametrize("K", [256, 260, 100, 64, 3, 1])
@pytest.mark.parametrize("kind", ["random", "irregular", "unaligned"])
def test_k17_matches_plain(cuda, no_plain_mod, blockshape, K, kind):
    """K17 at every bm of the kernel on a random block pattern and on the
    irregular BELL; ``unaligned`` puts X and A's blocks one float into
    their storage (X: the kernel's element-by-element path, as is any
    K % 4 != 0; A: copied by the wrapper)."""
    if kind == "random":
        rng, a = _bell_case(cuda, blockshape)
    else:
        rng, host = _irregular_bell(blockshape)
        a = host.to(cuda)
    off = int(kind == "unaligned")
    if off:
        data = torch.empty(a.data.numel() + 1, device=cuda)[1:].view_as(a.data)
        a = dataclasses.replace(a, data=data.copy_(a.data))
        assert a.data.is_contiguous() and a.data.data_ptr() % 16
    ref = no_plain_mod(bsr, "spmm_bell_ref")["spmm_bell_ref"]
    x = torch.as_tensor(rng.standard_normal(a.shape[1] * K + off), dtype=torch.float32,
                        device=cuda)[off:].view(a.shape[1], K)
    before = bsr.spmm_bell.launches
    got = bsr.spmm_bell(a, x) if K > 1 else bsr.spmv_bell(a, x[:, 0])[:, None]
    torch.cuda.synchronize()
    assert bsr.spmm_bell.launches == before + 1 and got.shape == (a.shape[0], K)
    want = ref(a, x)
    absa = dataclasses.replace(a, data=a.data.abs())
    bound = 1e-5 * want.abs() + 4 * EPS32 * ref(absa, x.abs())
    err = (got - want).abs()
    assert bool((err <= bound).all()), f"max err {float(err.max()):.3e}"
    if kind != "random":
        # rows with no real block are exactly zero
        empty = (a.data.abs().amax(dim=(1, 2, 3)) == 0).repeat_interleave(blockshape[0])
        assert bool(empty.any()) and not got[empty].any()


@pytest.mark.parametrize("W", [64, 70])
def test_k17_many_chunks(cuda, no_plain_mod, W):
    """Block rows of as many chunks as one scan pass flags (W 64 at bn 128:
    256) and of more (W 70: 280, two passes)."""
    rng, host = _irregular_bell((8, 128), m=64, n=1024, W=W)
    a = host.to(cuda)
    ref = no_plain_mod(bsr, "spmm_bell_ref")["spmm_bell_ref"]
    x = torch.as_tensor(rng.standard_normal((a.shape[1], 260)), dtype=torch.float32,
                        device=cuda)
    got = bsr.spmm_bell(a, x)
    torch.cuda.synchronize()
    want = ref(a, x)
    absa = dataclasses.replace(a, data=a.data.abs())
    bound = 1e-5 * want.abs() + 4 * EPS32 * ref(absa, x.abs())
    err = (got - want).abs()
    assert bool((err <= bound).all()), f"max err {float(err.max()):.3e}"


def test_k17_refuses_what_it_does_not_take(cuda):
    _, a = _bell_case(cuda, (8, 128), m=64, n=256, density=0.3)
    x = torch.zeros((256, 8), device=cuda)
    for bad, xx in ((dataclasses.replace(a, data=a.data.to(torch.float16)), x),
                    (dataclasses.replace(a, bcols=a.bcols.long()), x),
                    (dataclasses.replace(a, bcols=torch.full_like(a.bcols, 2)), x),
                    (a, x.double()), (a, x[:128]), (a.to("cpu"), x)):
        with pytest.raises(ValueError, match="spmm_bell"):
            bsr.spmm_bell(bad, xx)
    _, odd = _bell_case(cuda, (12, 128), m=96, n=256, density=0.3)
    with pytest.raises(ValueError, match="bm in"):
        bsr.spmm_bell(odd, x)


def _bf16_ulp(v):
    """One bf16 unit in the last place of each element of ``v`` (0 at 0)."""
    v = v.float()
    return torch.where(v == 0, torch.zeros_like(v),
                       torch.ldexp(torch.ones_like(v), torch.frexp(v)[1] - 8))


def _hold_k17_bf16(a, x, got, ref):
    """K17's bf16 output against its plain version on the same inputs: one
    bf16 ulp of the plain value (the two float32 sums may round to
    neighbouring bf16 values) plus 4·eps32·(|A|·|X|) (the float32 sums'
    other order)."""
    want = ref(a, x)
    mag = ref(dataclasses.replace(a, data=a.data.abs()), x.abs()).float()
    assert got.dtype == want.dtype == BF16
    err = (got.float() - want.float()).abs()
    bound = _bf16_ulp(want) + 4 * EPS32 * mag
    assert bool((err <= bound).all()), f"max err {float(err.max()):.3e}"


def _bf16_case(cuda, blockshape, K, kind):
    """bf16 blocks (the float32 case rounded; ``unaligned`` puts A's blocks
    and X one element into their storage) and X in float32 and bf16."""
    if kind == "random":
        rng, a = _bell_case(cuda, blockshape)
    else:
        rng, host = _irregular_bell(blockshape)
        a = host.to(cuda)
    off = int(kind == "unaligned")
    data = torch.empty(a.data.numel() + off, dtype=BF16, device=cuda)[off:].view_as(a.data)
    a = dataclasses.replace(a, data=data.copy_(a.data))
    assert a.data.is_contiguous() and bool(off) == bool(a.data.data_ptr() % 16)
    x32 = torch.as_tensor(rng.standard_normal((a.shape[1], K)), dtype=torch.float32,
                          device=cuda)
    xb = torch.empty(x32.numel() + off, dtype=BF16, device=cuda)[off:].view_as(x32)
    return a, x32, xb.copy_(x32)


@pytest.mark.parametrize("blockshape", [(8, 128), (16, 32), (32, 128), (64, 64),
                                        (128, 128)])
@pytest.mark.parametrize("K", [1, 7, 128, 200, 256])
@pytest.mark.parametrize("kind", ["random", "irregular", "unaligned"])
def test_k17_bf16_matches_plain(cuda, no_plain_mod, blockshape, K, kind):
    """bf16 blocks at every bm: on bf16 X the tensor-core kernel against the
    plain version and a second launch's bits; on float32 X the CUDA-core
    kernel's bf16-block instance, bit for bit the float32 instance on the
    widened blocks.  ``unaligned``: A copied by the wrapper, X element by
    element (as is any K % 8 != 0); K 1 through ``spmv_bell``."""
    a, x32, xb = _bf16_case(cuda, blockshape, K, kind)
    ref = no_plain_mod(bsr, "spmm_bell_ref")["spmm_bell_ref"]
    call = (lambda aa, xx: bsr.spmm_bell(aa, xx)) if K > 1 else \
        (lambda aa, xx: bsr.spmv_bell(aa, xx[:, 0])[:, None])
    counts = dict(bsr.spmm_bell.type_launches)
    got = call(a, xb)
    torch.cuda.synchronize()
    assert bsr.spmm_bell.type_launches["bf16 blocks, bf16 X"] == \
        counts["bf16 blocks, bf16 X"] + 1 and got.shape == (a.shape[0], K)
    _hold_k17_bf16(a, xb, got, ref)
    assert torch.equal(call(a, xb), got)
    got32 = call(a, x32)
    torch.cuda.synchronize()
    assert bsr.spmm_bell.type_launches["bf16 blocks, float32 X"] == \
        counts["bf16 blocks, float32 X"] + 1 and got32.dtype == torch.float32
    wide = dataclasses.replace(a, data=a.data.float())
    assert torch.equal(got32, call(wide, x32))
    if kind != "random":
        empty = (a.data.abs().amax(dim=(1, 2, 3)) == 0).repeat_interleave(blockshape[0])
        assert bool(empty.any()) and not got[empty].any() and not got32[empty].any()


@pytest.mark.parametrize("W", [64, 70])
def test_k17_bf16_many_chunks(cuda, no_plain_mod, W):
    """Both bf16-block instances on block rows of one full scan pass (W 64
    at bn 128: 256 chunks) and of two (W 70)."""
    rng, host = _irregular_bell((8, 128), m=64, n=1024, W=W)
    a = host.to(cuda)
    a = dataclasses.replace(a, data=a.data.to(BF16))
    ref = no_plain_mod(bsr, "spmm_bell_ref")["spmm_bell_ref"]
    x32 = torch.as_tensor(rng.standard_normal((a.shape[1], 264)), dtype=torch.float32,
                          device=cuda)
    got = bsr.spmm_bell(a, x32.to(BF16))
    torch.cuda.synchronize()
    _hold_k17_bf16(a, x32.to(BF16), got, ref)
    assert torch.equal(bsr.spmm_bell(a, x32),
                       bsr.spmm_bell(dataclasses.replace(a, data=a.data.float()), x32))


def test_k17_promotes_bf16_x_on_float32_blocks(cuda):
    """float32 blocks with bf16 X: X promoted to float32 and the float32
    instance run, a float32 result."""
    rng, a = _bell_case(cuda, (32, 128), m=256, n=512, density=0.2)
    xb = torch.as_tensor(rng.standard_normal((512, 40)), dtype=BF16, device=cuda)
    before = bsr.spmm_bell.type_launches["float32"]
    got = bsr.spmm_bell(a, xb)
    assert got.dtype == torch.float32
    assert bsr.spmm_bell.type_launches["float32"] == before + 1
    assert torch.equal(got, bsr.spmm_bell(a, xb.float()))


@pytest.mark.parametrize("blocks,xdt", [(torch.float16, torch.float32),
                                        (torch.float64, torch.float32),
                                        (torch.float64, torch.float64),
                                        (torch.float32, torch.float16),
                                        (BF16, torch.float16), (BF16, torch.float64)])
def test_k17_refuses_other_dtypes(cuda, blocks, xdt):
    _, a = _bell_case(cuda, (8, 128), m=64, n=256, density=0.3)
    a = dataclasses.replace(a, data=a.data.to(blocks))
    with pytest.raises(ValueError, match="spmm_bell: blocks"):
        bsr.spmm_bell(a, torch.zeros((256, 8), dtype=xdt, device=cuda))


@pytest.mark.parametrize("xdt", [torch.float32, BF16])
def test_k17_bf16_inf_under_zero_chunk_stays_finite(cuda, xdt):
    """bf16 blocks: X rows under an all-zero chunk (an explicit zero block, a
    32-column zero chunk of a real block) hold inf; the kernels skip those
    chunks and the sums stay finite, where the plain version gives NaN."""
    data = torch.zeros((2, 2, 16, 128))
    data[0, 0] = 1.0
    data[0, 0, :, 32:64] = 0.0          # a zero chunk of a real block
    cols = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)   # row 0 slot 1: a zero block
    data[1, 1] = 0.5
    data[1, 1, :, 32:64] = 0.0
    a = bsr.BELL(data=data.to(BF16), bcols=cols, shape=(32, 256), nnz=2 * 16 * 128).to(cuda)
    x = torch.ones((256, 16), dtype=xdt, device=cuda)
    x[128:] = float("inf")              # under row 0's zero block and row 1's slot 0 (zero)
    x[32:64] = float("inf")             # under the zero chunk of row 0's real block
    got = bsr.spmm_bell(a, x)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got[:16].float(), torch.full((16, 16), 96.0, device=cuda))
    assert torch.equal(got[16:].float(), torch.full((16, 16), 48.0, device=cuda))
    assert torch.isnan(bsr.spmm_bell_ref(a, x)[:16]).any()


@pytest.mark.parametrize("blockshape", [(8, 32), (32, 96), (128, 160), (16, 96)])
@pytest.mark.parametrize("K", [8, 64, 72, 264, 520])
def test_k17_bf16_column_tiles(cuda, no_plain_mod, monkeypatch, blockshape, K):
    """The tensor-core kernel at block widths that are not multiples of 64
    and at K around its column tiles, on the irregular BELL (its rows 0,
    5, ... hold no real block): at every column tile Kc no wider than K's
    64-column tiles, against the plain version, with the same bits at every
    Kc (a column's sum does not depend on the tile) and zero rows where no
    block is real."""
    rng, host = _irregular_bell(blockshape, m=16 * blockshape[0], n=12 * blockshape[1])
    a = host.to(cuda)
    a = dataclasses.replace(a, data=a.data.to(BF16))
    ref = no_plain_mod(bsr, "spmm_bell_ref")["spmm_bell_ref"]
    x = torch.as_tensor(rng.standard_normal((a.shape[1], K)), dtype=torch.float32,
                        device=cuda).to(BF16)
    got = bsr.spmm_bell(a, x)
    torch.cuda.synchronize()
    _hold_k17_bf16(a, x, got, ref)
    empty = (a.data.abs().amax(dim=(1, 2, 3)) == 0).repeat_interleave(blockshape[0])
    assert bool(empty.any()) and not got[empty].any()
    rule = bsr._col_tile
    for kc in (64, 128, 256):
        if kc <= -(-K // 64) * 64:
            monkeypatch.setattr(bsr, "_col_tile", lambda nbr, k, tma, kc=kc: kc)
            assert torch.equal(bsr.spmm_bell(a, x), got), f"Kc {kc}"
    monkeypatch.setattr(bsr, "_col_tile", rule)


def test_k17_bf16_chunk_list_made_once_per_bell(cuda, monkeypatch):
    """The chunk list is made with the BELL, not per call, and again after
    an in-place write to its blocks (the output follows the write)."""
    rng, host = _irregular_bell((8, 128), m=128, n=1024)
    made = []
    build = bsr._chunk_list
    monkeypatch.setattr(bsr, "_chunk_list", lambda d: made.append(1) or build(d))
    a = host.to(cuda)
    a = dataclasses.replace(a, data=a.data.to(BF16))
    assert len(made) == 1 and a.chunks is not None
    x = torch.as_tensor(rng.standard_normal((1024, 64)), dtype=BF16, device=cuda)
    first = bsr.spmm_bell(a, x)
    assert torch.equal(bsr.spmm_bell(a, x), first) and len(made) == 1
    a.data[0, 0, 3, 5] = 2.0                          # row 0 holds no real block
    second = bsr.spmm_bell(a, x)
    torch.cuda.synchronize()
    assert len(made) == 2 and bool(second[:8].any()) and not first[:8].any()
    assert torch.equal(second[8:], first[8:])
    torch.testing.assert_close(second[3], (2.0 * x[a.bcols[0, 0].long() * 128 + 5]
                                           .float()).to(BF16), rtol=0, atol=0)


def test_k17_bf16_bell_made_in_a_graph_capture(cuda):
    """A BELL made inside a CUDA-graph capture (its chunk list among the
    graph's work) with a product, replayed: the eager call's bits, and after
    new values written into the captured blocks, the product of those."""
    rng, host = _irregular_bell((32, 128), m=512, n=1024)
    data = torch.as_tensor(host.data, device=cuda).to(BF16)
    bcols = torch.as_tensor(host.bcols, device=cuda)
    x = torch.as_tensor(rng.standard_normal((1024, 256)), dtype=BF16, device=cuda)
    eager = bsr.spmm_bell(bsr.BELL(data=data, bcols=bcols, shape=host.shape, nnz=host.nnz), x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a = bsr.BELL(data=data, bcols=bcols, shape=host.shape, nnz=host.nnz)
        y = bsr.spmm_bell(a, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, eager)
    other = torch.roll(data, 1, dims=0)               # row i takes row i - 1's blocks
    data.copy_(other)
    graph.replay()
    torch.cuda.synchronize()
    want = bsr.spmm_bell(bsr.BELL(data=other.clone(), bcols=bcols, shape=host.shape,
                                  nnz=host.nnz), x)
    assert torch.equal(y, want) and not torch.equal(y, eager)


# ---------------------------------------------------------------------------
# The rowblock and DIA reward envs on the card (plain PyTorch, no kernel of
# their own): residual norms against the same env on the CPU (rtol 1e-5:
# float32 sums of ~10^5 terms in another order) and against float64 on the
# CPU (exact products: rtol 1e-4; gram 2e-3; bf16 storage 2e-2); rewards
# against the CPU within that residual tolerance carried through the reward
# (1000·α·1e-5·res/baseline, plus 1e-3); their own bits on a second call
# ---------------------------------------------------------------------------

def _reward_actions(num_edges, batch, seed):
    rng = np.random.default_rng(seed)
    acts = np.full((batch, 512), -1, np.int64)
    for b in range(batch):
        k = int(rng.integers(0, 511))
        acts[b, :k] = rng.choice(num_edges, size=k, replace=False)
        acts[b, k] = num_edges
    return acts


def _env_rewards(env, acts):
    """(rewards, residual norms) of the action lists on the env's device."""
    from gflownet_spai_tpu_torch.env import spai, spai_dia
    from gflownet_spai_tpu_torch.gfn.gflownet import _batched_rewards

    dev = env.baseline_residual.device
    acts = torch.as_tensor(acts, device=dev)
    keep = spai.keep_mask_from_actions(acts, env.num_edges)
    res = (spai_dia.residual_norms(env, keep) if isinstance(env, spai_dia.SpaiDiaEnv)
           else spai.batched_residual_norms(env, keep))
    return _batched_rewards(env, acts, torch.tensor(
        0.7, dtype=env.baseline_residual.dtype, device=dev)), res


def _hold_rewards(env_card, env_cpu, acts, want_res, rtol64):
    got, res = _env_rewards(env_card, acts)
    assert got.dtype == res.dtype == torch.float32
    again, res2 = _env_rewards(env_card, acts)
    assert torch.equal(got, again) and torch.equal(res, res2)
    cpu, cpu_res = _env_rewards(env_cpu, acts)
    np.testing.assert_allclose(res.cpu().numpy(), cpu_res.numpy(), rtol=1e-5)
    scale = float((cpu_res / env_cpu.baseline_residual).max())
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=1000 * 0.7 * 1e-5 * scale + 1e-3)
    np.testing.assert_allclose(res.cpu().numpy(), want_res.numpy(), rtol=rtol64)


def _seed_of(name, dtype):
    from gflownet_spai_tpu_torch.env import ilu
    from gflownet_spai_tpu_torch.sparse.types import COO

    a = gallery.get(name)
    a = COO(row=a.row, col=a.col, data=a.data.astype(dtype), shape=a.shape)
    return a, ilu.seed_pattern(a, method="ilu0", dtype=dtype)


def test_dia_env_rewards_on_the_card(cuda):
    from gflownet_spai_tpu_torch.env import spai_dia

    make = lambda dtype, dev: spai_dia.make_dia_env(
        *_seed_of("convdiff20000", dtype)[::-1], device=dev)
    env = make(np.float32, cuda)
    acts = _reward_actions(env.num_edges, 64, 0)
    _, want = _env_rewards(make(np.float64, "cpu"), acts)
    _hold_rewards(env, make(np.float32, "cpu"), acts, want, 1e-4)


@pytest.mark.parametrize("kw,rtol64", [
    (dict(), 1e-4), (dict(rowblock_layout="mc"), 1e-4),
    (dict(rowblock_compress="gram"), 2e-3), (dict(rowblock_order="window"), 1e-4),
    (dict(rowblock_order="window", rowblock_compress="gram"), 2e-3),
    (dict(rowblock_dtype=torch.bfloat16), 2e-2),
    (dict(rowblock_dtype=torch.bfloat16, rowblock_layout="mc"), 2e-2)])
def test_rowblock_env_rewards_on_the_card(cuda, kw, rtol64):
    from gflownet_spai_tpu_torch.env import spai

    a32, s32 = _seed_of("orsirr_like64", np.float32)
    make = lambda dev: spai.make_env(s32, original=a32, reward_path="rowblock",
                                     device=dev, **kw)
    env = make(cuda)
    acts = _reward_actions(env.num_edges, 64, 1)
    # float64: the pair env on the same edges (a window plan's enumeration
    # maps back through edge_perm)
    a64, s64 = _seed_of("orsirr_like64", np.float64)
    keep = spai.keep_mask_from_actions(torch.as_tensor(acts), env.num_edges)
    if env.rb.edge_perm is not None:
        sorted_keep = torch.empty_like(keep)
        sorted_keep[:, env.rb.edge_perm.cpu()] = keep
        keep = sorted_keep
    want = spai.batched_residual_norms(spai.make_env(s64, original=a64, device="cpu"),
                                       keep)
    _hold_rewards(env, make("cpu"), acts, want, rtol64)


def test_lstm_backward_policy_on_the_card(cuda):
    """The reference-parity LSTM backward policy (the train CLI's default)
    on the card against the CPU, values and gradients (rtol 1e-5, atol
    1e-5: float32 matmuls in another order), and the same bits on a second
    call."""
    gen = torch.Generator().manual_seed(3)
    p = pol.backward_policy_init(gen, 4, 86)
    acts = torch.full((5, 40), -1, dtype=torch.int64)
    rng = np.random.default_rng(4)
    for b in range(5):
        k = int(rng.integers(1, 39))
        acts[b, :k] = torch.as_tensor(rng.choice(85, size=k, replace=False))
        acts[b, k] = 85
    outs = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [x.to(dev).requires_grad_(True) for x in p]
        lp = pol.backward_policy_batch(pol.BackwardPolicyParams(*leaves),
                                       acts.to(dev), 4)
        grads = torch.autograd.grad(lp.square().sum(), leaves)
        outs.append((lp.detach().cpu(), [g.cpu() for g in grads]))
    again = pol.backward_policy_batch(pol.BackwardPolicyParams(*(x.to(cuda) for x in p)),
                                      acts.to(cuda), 4)
    assert torch.equal(again.cpu(), outs[0][0])
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    for g, h in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(g, h, rtol=1e-5, atol=1e-5)
