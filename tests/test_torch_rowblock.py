"""The row-block reward plan of the port (``sparse/rowblock.py``) and the
rowblock env (``env/spai.py``) against the JAX package.

The host planner is the JAX package's numpy code, so every integer array
of a plan, ``edge_perm`` and the float32 (and bf16) G blocks must equal
JAX's exactly.  Tolerances, the JAX oracles' (tests/test_sparse.py,
tests/test_env.py): ``residual_sq_batch`` against JAX rtol 1e-5 (float32,
another summation order); gram against exact rtol 2e-3 (the expanded
quadratic's float32 cancellation); window against sorted rtol 1e-5; bf16
against float32 storage rtol 2e-2 with a float32 result; the overflow
routing against the dense product rtol 1e-4; the rowblock env against the
pair env rtol 5e-4, atol 5e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse import rowblock as JRB
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.env import spai as t_spai
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse import rowblock as TRB
from gflownet_spai_tpu_torch.sparse.convert import coo_to_scipy
from gflownet_spai_tpu_torch.sparse.types import COO
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_residual_sq_jax = jax.jit(JRB.residual_sq_batch)

PLANS = [
    ("orsirr_like32", {}),
    ("orsirr_like32", {"layout": "mc"}),
    ("orsirr_like32", {"class_step": 1.25}),
    ("orsirr_like32", {"layout": "mc", "class_step": 1.25}),
    ("orsirr_like32", {"compress": "gram"}),
    ("orsirr_like32", {"order": "window"}),
    ("orsirr_like32", {"order": "window", "compress": "gram"}),
    ("orsirr_like32", {"max_block_slots": 128}),
    ("orsirr_like32", {"max_block_slots": 128, "order": "window"}),
    ("bcsstk03_like", {"max_block_slots": 16}),
    ("bcsstk03_like", {"order": "window", "class_step": 1.25}),
    ("poisson32", {"layout": "mc"}),
]


def _mats(name):
    return j_gallery.get(name), t_gallery.get(name)


def _assert_plans_equal(jp, tp):
    for f in ("win_idx", "diag_pos", "out_pos"):
        assert len(getattr(jp, f)) == len(getattr(tp, f))
        for x, y in zip(getattr(jp, f), getattr(tp, f)):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x), err_msg=f)
    for f in ("ov_pair_m", "ov_seg", "ov_diag", "ov_out_pos", "out_row", "out_col"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    for f in ("gvals", "lin"):
        for x, y in zip(getattr(jp, f), getattr(tp, f)):
            np.testing.assert_array_equal(y.float().numpy(),
                                          np.asarray(x.astype(jnp.float32)), err_msg=f)
            assert str(y.dtype).split(".")[-1] == str(x.dtype)
    assert (jp.edge_perm is None) == (tp.edge_perm is None)
    if jp.edge_perm is not None:
        np.testing.assert_array_equal(tp.edge_perm.numpy(), np.asarray(jp.edge_perm))
    for f in ("shape", "nnz_m", "out_nnz", "n_missing_diag", "npairs",
              "n_overflow_slots", "layout", "compress", "n_bucket_diag",
              "win_off", "win_w"):
        assert tuple(np.atleast_1d(getattr(tp, f))) == tuple(np.atleast_1d(getattr(jp, f))), f


@pytest.mark.parametrize("name,kw", PLANS)
def test_plan_and_residuals_equal_jax(name, kw):
    ja, ta = _mats(name)
    jp = JRB.build_rowblock_plan(ja, ja, **kw)
    tp = TRB.build_rowblock_plan(ta, ta, device="cpu", **kw)
    _assert_plans_equal(jp, tp)
    m = np.random.default_rng(5).random((4, ta.nnz)).astype(np.float32)
    want = np.asarray(_residual_sq_jax(jp, jnp.asarray(m)))
    got = TRB.residual_sq_batch(tp, torch.as_tensor(m))
    assert got.dtype == torch.float32 and got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert torch.equal(TRB.residual_sq_batch(tp, torch.as_tensor(m)), got)
    if tp.compress == "none":
        np.testing.assert_allclose(TRB.numeric(tp, torch.as_tensor(m[0])).numpy(),
                                   np.asarray(JRB.numeric(jp, jnp.asarray(m[0]))),
                                   rtol=1e-5, atol=1e-6)
    else:
        with pytest.raises(NotImplementedError, match="gram"):
            TRB.numeric(tp, torch.as_tensor(m[0]))


def test_numeric_matches_dense_product_and_rejects_unsorted():
    from gflownet_spai_tpu.sparse.gallery import random_spd

    a = random_spd(60, density=0.06, seed=7)
    a = COO(row=np.asarray(a.row), col=np.asarray(a.col),
            data=np.asarray(a.data, np.float32), shape=a.shape)
    plan = TRB.build_rowblock_plan(a, a, device="cpu")
    A = coo_to_scipy(a).toarray().astype(np.float64)
    C = A @ A
    got = TRB.numeric(plan, torch.as_tensor(a.data)).numpy()
    np.testing.assert_allclose(got, C[plan.out_row.numpy(), plan.out_col.numpy()],
                               rtol=1e-5, atol=1e-5)
    r2 = float(TRB.residual_sq_batch(plan, torch.as_tensor(a.data)[None])[0])
    np.testing.assert_allclose(r2, np.linalg.norm(C - np.eye(60), "fro") ** 2, rtol=1e-4)
    c = TRB.out_coo(plan, torch.as_tensor(got))
    assert c.shape == (60, 60) and c.nnz == plan.out_nnz
    bad = COO(row=a.col, col=a.row, data=a.data, shape=a.shape)   # column-major
    with pytest.raises(ValueError, match="row-major"):
        TRB.build_rowblock_plan(bad, a, device="cpu")
    for kw, word in (({"layout": "zz"}, "layout"), ({"compress": "zz"}, "compress"),
                     ({"order": "zz"}, "order")):
        with pytest.raises(ValueError, match=word):
            TRB.build_rowblock_plan(a, a, device="cpu", **kw)


def test_overflow_routing_matches_dense():
    """Tiny caps send every row (or some) through the overflow sub-plan; the
    residual and the C values do not change, and the sub-plan's per-slot
    layout covers each pair once."""
    from gflownet_spai_tpu.sparse.gallery import random_spd

    a = random_spd(60, density=0.06, seed=7)
    a = COO(row=np.asarray(a.row), col=np.asarray(a.col),
            data=np.asarray(a.data, np.float32), shape=a.shape)
    ref = TRB.build_rowblock_plan(a, a, device="cpu")
    assert ref.n_overflow_slots == 0 and not ref.ov_groups
    ov = TRB.build_rowblock_plan(a, a, max_block_slots=16, device="cpu")
    assert ov.n_overflow_slots == ov.out_nnz and not ov.gvals
    mixed = TRB.build_rowblock_plan(a, a, max_block_slots=128, device="cpu")
    assert 0 < mixed.n_overflow_slots < mixed.out_nnz
    rng = np.random.default_rng(3)
    mv = torch.as_tensor((a.data * (rng.random(a.nnz) > 0.3)).astype(np.float32))
    want_r = float(TRB.residual_sq_batch(ref, mv[None])[0])
    want_c = TRB.numeric(ref, mv).numpy()
    for plan in (ov, mixed):
        np.testing.assert_allclose(float(TRB.residual_sq_batch(plan, mv[None])[0]),
                                   want_r, rtol=1e-4)
        np.testing.assert_allclose(TRB.numeric(plan, mv).numpy(), want_c,
                                   rtol=1e-4, atol=1e-5)
        pairs = torch.cat([pm[pw != 0] for pm, pw, _, _ in plan.ov_groups])
        assert sorted(pairs.tolist()) == sorted(plan.ov_pair_m[plan.ov_w != 0].tolist())
        slots = torch.cat([pos for *_, pos in plan.ov_groups])
        assert sorted(slots.tolist()) == sorted(plan.ov_out_pos.tolist())


def test_bf16_storage_gives_float32_results():
    """bf16 G blocks equal JAX's bf16 bits; residuals within bf16 input
    noise of the float32 plan, as a float32 tensor; ``make_env`` plumbs the
    dtype through."""
    ja, ta = _mats("orsirr_like32")
    p32 = TRB.build_rowblock_plan(ta, ta, device="cpu")
    p16 = TRB.build_rowblock_plan(ta, ta, gemm_dtype=torch.bfloat16, device="cpu")
    _assert_plans_equal(JRB.build_rowblock_plan(ja, ja, gemm_dtype=jnp.bfloat16), p16)
    assert p16.gvals[0].dtype == torch.bfloat16
    m = torch.as_tensor(np.stack([ta.data, ta.data * 0.5]).astype(np.float32))
    r32, r16 = TRB.residual_sq_batch(p32, m), TRB.residual_sq_batch(p16, m)
    assert r16.dtype == torch.float32
    np.testing.assert_allclose(r16.numpy(), r32.numpy(), rtol=2e-2)
    env = t_spai.make_env(ta, original=ta, reward_path="rowblock",
                          rowblock_dtype=torch.bfloat16, device="cpu")
    assert env.rb.gvals[0].dtype == torch.bfloat16
    # against JAX eager (its jit on the CPU has no bf16 x bf16 = f32 dot, and
    # its mc layout does not run there): the cm and gram plans; the mc plan
    # against the cm plan, the same bf16-rounded operands
    for kw in ({}, {"compress": "gram"}, {"order": "window"}):
        jp = JRB.build_rowblock_plan(ja, ja, gemm_dtype=jnp.bfloat16, **kw)
        tp = TRB.build_rowblock_plan(ta, ta, gemm_dtype=torch.bfloat16, device="cpu", **kw)
        mm = m[:, tp.edge_perm] if tp.edge_perm is not None else m
        np.testing.assert_allclose(
            TRB.residual_sq_batch(tp, mm).numpy(),
            np.asarray(JRB.residual_sq_batch(jp, jnp.asarray(mm.numpy()))),
            rtol=1e-5, err_msg=str(kw))
    mc = TRB.build_rowblock_plan(ta, ta, gemm_dtype=torch.bfloat16, layout="mc",
                                 device="cpu")
    np.testing.assert_allclose(TRB.residual_sq_batch(mc, m).numpy(), r16.numpy(),
                               rtol=1e-5)


def test_gram_and_window_match_exact_sorted():
    ja, ta = _mats("orsirr_like32")
    ref = TRB.build_rowblock_plan(ta, ta, device="cpu")
    m = torch.as_tensor(np.random.default_rng(11).random((4, ta.nnz)).astype(np.float32))
    want = TRB.residual_norm_batch(ref, m)
    gram = TRB.build_rowblock_plan(ta, ta, compress="gram", device="cpu")
    assert gram.padded_slots < ref.padded_slots
    np.testing.assert_allclose(TRB.residual_norm_batch(gram, m).numpy(), want.numpy(),
                               rtol=2e-3)
    win = TRB.build_rowblock_plan(ta, ta, order="window", device="cpu")
    perm = win.edge_perm.numpy()
    assert sorted(perm.tolist()) == list(range(ta.nnz))
    # window mode has no m-axis padding
    assert sum(g.shape[0] * g.shape[2] for g in win.gvals) == sum(
        int((w < ta.nnz).sum()) for w in ref.win_idx)
    np.testing.assert_allclose(TRB.residual_norm_batch(win, m[:, perm]).numpy(),
                               want.numpy(), rtol=1e-5)
    wg = TRB.build_rowblock_plan(ta, ta, order="window", compress="gram", device="cpu")
    np.testing.assert_allclose(
        TRB.residual_norm_batch(wg, m[:, wg.edge_perm]).numpy(), want.numpy(), rtol=2e-3)
    fine = TRB.build_rowblock_plan(ta, ta, class_step=1.25, device="cpu")
    assert fine.padded_slots <= ref.padded_slots


def test_window_env_permutes_its_seed():
    """The env's seed follows ``edge_perm``; keep masks in the permuted
    enumeration score as the sorted env's."""
    _, ta = _mats("orsirr_like32")
    env_s = t_spai.make_env(ta, original=ta, reward_path="rowblock", device="cpu")
    env_w = t_spai.make_env(ta, original=ta, reward_path="rowblock",
                            rowblock_order="window", device="cpu")
    perm = env_w.rb.edge_perm.numpy()
    assert env_s.rb.edge_perm is None and env_s.plan is None
    np.testing.assert_array_equal(env_w.seed.row.numpy(), ta.row[perm])
    keep = torch.as_tensor(np.random.default_rng(2).random((3, ta.nnz)) > 0.3)
    np.testing.assert_allclose(
        t_spai.batched_residual_norms(env_w, keep[:, perm]).numpy(),
        t_spai.batched_residual_norms(env_s, keep).numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", ["bcsstk03_like", "olm500_like", "poisson32"])
def test_rowblock_env_matches_pair_env(name):
    """The oracle of tests/test_env.py: the same batched rewards and residual
    norms as the pair env, per action list."""
    ta = t_gallery.get(name)
    ta = COO(row=ta.row, col=ta.col, data=ta.data.astype(np.float32), shape=ta.shape)
    seed = t_ilu.seed_pattern(ta, method="ilu0", dtype=np.float32)
    env_pair = t_spai.make_env(seed, original=ta, device="cpu")
    env_rb = t_spai.make_env(seed, original=ta, reward_path="rowblock", device="cpu")
    assert env_rb.rb is not None and env_rb.plan is None
    np.testing.assert_allclose(float(env_rb.baseline_residual),
                               float(env_pair.baseline_residual), rtol=1e-5)
    rng = np.random.default_rng(5)
    acts = np.full((3, 40), -1, np.int64)
    for b in range(3):
        k = rng.integers(1, 40)
        acts[b, :k] = rng.choice(env_pair.num_edges, size=k, replace=False)
    acts = torch.as_tensor(acts)
    alpha = torch.tensor(0.37)
    np.testing.assert_allclose(t_spai.batched_rewards(env_rb, acts, alpha).numpy(),
                               t_spai.batched_rewards(env_pair, acts, alpha).numpy(),
                               rtol=5e-4, atol=5e-3)
    keep = t_spai.keep_mask_from_actions(acts, env_pair.num_edges)
    np.testing.assert_allclose(t_spai.batched_residual_norms(env_rb, keep).numpy(),
                               t_spai.batched_residual_norms(env_pair, keep).numpy(),
                               rtol=5e-5)
