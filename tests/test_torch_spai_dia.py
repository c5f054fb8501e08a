"""The DIA reward env of the port (``env/spai_dia.py``, the banded products
of ``ops/dia.py``) and the RCM helpers (``ops/rcm.py``) against the JAX
package and scipy.

Tolerances: the banded product against scipy rtol 1e-9 in float64 (the
oracle ``tests/test_spai_dia.py``); DIA rewards against the port's pair
(COO) env on the same kept edge set rtol 1e-9 in float64; port against JAX
rewards rtol 1e-5 in float32 (the same products summed in the same order,
the reductions in another); ``edge_coo``, the plan's segments and the RCM
permutations exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee

from gflownet_spai_tpu.env import ilu as j_ilu
from gflownet_spai_tpu.env import spai_dia as j_dia
from gflownet_spai_tpu.ops import rcm as j_rcm
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.env import spai as t_spai
from gflownet_spai_tpu_torch.env import spai_dia as t_dia
from gflownet_spai_tpu_torch.ops import rcm as t_rcm
from gflownet_spai_tpu_torch.ops.dia import (coo_to_dia, frobenius_sq_minus_identity_dia,
                                             spgemm_dia)
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse.convert import coo_to_scipy
from gflownet_spai_tpu_torch.sparse.types import COO


def _seeds(name, dtype):
    """(JAX A, JAX seed, port A, port seed): the ILU(0) seed in ``dtype``."""
    ja, ta = j_gallery.get(name), t_gallery.get(name)
    ja = ja.__class__(row=ja.row, col=ja.col, data=ja.data.astype(dtype), shape=ja.shape)
    ta = COO(row=ta.row, col=ta.col, data=ta.data.astype(dtype), shape=ta.shape)
    return (ja, j_ilu.seed_pattern(ja, method="ilu0", dtype=dtype),
            ta, t_ilu.seed_pattern(ta, method="ilu0", dtype=dtype))


def _actions(rng, num_edges, batch):
    """-1-padded delete lists of random depth, most ending in the terminal."""
    acts = np.full((batch, num_edges + 1), -1, np.int64)
    for b in range(batch):
        k = int(rng.integers(0, num_edges))
        row = rng.permutation(num_edges)[:k].tolist() + ([num_edges] if b % 3 else [])
        acts[b, :len(row)] = row
    return acts


@pytest.mark.parametrize("name", ["LF10_like", "olm500_like", "poisson32"])
def test_spgemm_dia_matches_scipy(name):
    coo = t_gallery.get(name)
    d = coo_to_dia(coo, device="cpu")
    c = spgemm_dia(d, d)
    A = coo_to_scipy(coo).astype(np.float64)
    np.testing.assert_allclose(c.todense().numpy(), (A @ A).toarray(),
                               rtol=1e-9, atol=1e-10)
    want = np.linalg.norm((A @ A).toarray() - np.eye(A.shape[0])) ** 2
    np.testing.assert_allclose(float(frobenius_sq_minus_identity_dia(c)), want,
                               rtol=1e-9)
    # out-of-range slots of the product are zero, as coo_to_dia stores them
    i = np.arange(c.n_pad)
    for s, off in enumerate(c.offsets):
        bad = (i + off < 0) | (i + off >= c.n) | (i >= c.n)
        assert not c.data[s].numpy()[bad].any()


def test_dia_env_rewards_equal_pair_env_on_the_same_edge_set():
    """Enumerations differ: the DIA env's kept (row, col) set becomes the
    pair env's keep mask; float64 rewards agree to 1e-9."""
    _, _, ta, ts = _seeds("olm500_like", np.float64)
    e_coo = t_spai.make_env(ts, original=ta, device="cpu")
    e_dia = t_dia.make_dia_env(ts, ta, device="cpu")
    assert e_dia.num_edges == e_coo.num_edges
    np.testing.assert_allclose(float(e_dia.baseline_residual),
                               float(e_coo.baseline_residual), rtol=1e-12)
    ec = t_dia.edge_coo(e_dia)
    n = ta.shape[1]
    key_dia = ec.row.astype(np.int64) * n + ec.col
    key_coo = ts.row.astype(np.int64) * n + ts.col
    to_coo = np.argsort(key_coo)[np.searchsorted(np.sort(key_coo), key_dia)]
    rng = np.random.default_rng(0)
    for alpha in (0.3, 0.7):
        keep_dia = rng.random((4, e_dia.num_edges)) > 0.4
        keep_coo = np.zeros_like(keep_dia)
        keep_coo[:, to_coo] = keep_dia
        r_dia = t_dia.rewards_from_keep(e_dia, torch.as_tensor(keep_dia),
                                        torch.tensor(alpha, dtype=torch.float64))
        r_coo = t_spai.rewards_from_keep(e_coo, torch.as_tensor(keep_coo),
                                         torch.tensor(alpha, dtype=torch.float64))
        np.testing.assert_allclose(r_dia.numpy(), r_coo.numpy(), rtol=1e-9)


@pytest.mark.parametrize("name,baseline", [("LF10_like", "matrix"),
                                           ("olm500_like", "identity"),
                                           ("LF10_like", "auto")])
def test_dia_env_matches_jax(name, baseline):
    """float32: the segments, ``edge_coo`` and the baseline exactly or to
    rounding, the batched rewards of the same action lists to 1e-5."""
    ja, js, ta, ts = _seeds(name, np.float32)
    jenv = j_dia.make_dia_env(js, ja, baseline=baseline)
    tenv = t_dia.make_dia_env(ts, ta, baseline=baseline, device="cpu")
    assert (tenv.row_start, tenv.seg_len, tenv.seg_off) == \
        (jenv.row_start, jenv.seg_len, jenv.seg_off)
    assert tenv.num_actions == jenv.num_actions
    assert tenv.baseline_flops == jenv.baseline_flops
    np.testing.assert_allclose(float(tenv.baseline_residual),
                               float(jenv.baseline_residual), rtol=1e-6)
    jec, tec = j_dia.edge_coo(jenv), t_dia.edge_coo(tenv)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(tec, f), np.asarray(getattr(jec, f)))
    assert tec.data.dtype == np.float32
    acts = _actions(np.random.default_rng(1), tenv.num_edges, 7)
    alpha = np.float32(0.37)
    want = np.asarray(jax.jit(j_dia.batched_rewards)(
        jenv, jnp.asarray(acts, jnp.int32), jnp.asarray(alpha)))
    got = t_dia.batched_rewards(tenv, torch.as_tensor(acts), torch.tensor(alpha))
    assert got.dtype == torch.float32 and got.shape == (7,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    again = t_dia.batched_rewards(tenv, torch.as_tensor(acts), torch.tensor(alpha))
    assert torch.equal(got, again)


def test_phantom_slots_refused_unless_allowed():
    """poisson32's ILU(0) seed stores zeros inside its ±1 diagonals (the grid
    row breaks): both packages count the same phantom slots, refuse the
    seed, and with ``allow_phantom`` score it alike (phantom slots cost no
    flops)."""
    ja, js, ta, ts = _seeds("poisson32", np.float32)
    phantom = t_dia.has_phantom_slots(coo_to_dia(ts, device="cpu"))
    assert phantom > 0
    from gflownet_spai_tpu.ops.dia import coo_to_dia as j_coo_to_dia

    assert phantom == j_dia.has_phantom_slots(j_coo_to_dia(js))
    with pytest.raises(ValueError, match="phantom"):
        t_dia.make_dia_env(ts, ta, device="cpu")
    jenv = j_dia.make_dia_env(js, ja, allow_phantom=True)
    tenv = t_dia.make_dia_env(ts, ta, allow_phantom=True, device="cpu")
    assert tenv.num_edges == ts.nnz + phantom == jenv.num_edges
    acts = _actions(np.random.default_rng(2), tenv.num_edges, 5)
    want = np.asarray(jax.jit(j_dia.batched_rewards)(
        jenv, jnp.asarray(acts, jnp.int32), jnp.asarray(0.6, jnp.float32)))
    got = t_dia.batched_rewards(tenv, torch.as_tensor(acts), torch.tensor(0.6))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_masked_seed_matches_jax():
    ja, js, ta, ts = _seeds("LF10_like", np.float32)
    jenv = j_dia.make_dia_env(js, ja)
    tenv = t_dia.make_dia_env(ts, ta, device="cpu")
    keep = np.random.default_rng(3).random(tenv.num_edges) > 0.5
    want = np.asarray(j_dia.masked_seed(jenv, jnp.asarray(keep)).data)
    got = t_dia.masked_seed(tenv, torch.as_tensor(keep))
    np.testing.assert_array_equal(got.data.numpy(), want)
    assert got.offsets == jenv.seed.offsets
    np.testing.assert_allclose(float(t_dia.kept_nnz(tenv, torch.as_tensor(keep))),
                               float(j_dia.kept_nnz(jenv, jnp.asarray(keep))))


# ---------------------------------------------------------------------------
# RCM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["poisson32", "LF10_like", "bcsstk03_like"])
def test_rcm_permutation_equals_jax(name):
    """The same BFS as the JAX package's (which takes its C++ copy where
    built): equal permutations, and ``permute`` gives the same matrix."""
    perm = t_rcm.rcm_permutation(t_gallery.get(name))
    np.testing.assert_array_equal(perm, j_rcm.rcm_permutation(j_gallery.get(name)))
    got = t_rcm.permute(t_gallery.get(name), perm)
    want = j_rcm.permute(j_gallery.get(name), perm)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))


def test_rcm_reduces_bandwidth_as_scipy():
    """The oracles of tests/test_ops.py: a scrambled band comes back
    narrow, and poisson32's bandwidth is within scipy's RCM's."""
    rng = np.random.default_rng(3)
    n = 200
    base = coo_to_scipy(t_gallery.get("olm500_like")).toarray()[:n, :n]
    p = rng.permutation(n)
    coo = COO.fromdense(base[np.ix_(p, p)])
    reordered, perm = t_rcm.rcm_reorder(coo)
    assert t_rcm.bandwidth(reordered) < t_rcm.bandwidth(coo)
    assert t_rcm.bandwidth(reordered) <= 5
    assert t_rcm.n_diagonals(reordered) < t_rcm.n_diagonals(coo)
    np.testing.assert_allclose(reordered.todense().numpy(), base[np.ix_(p, p)][np.ix_(perm, perm)])
    pc = t_gallery.get("poisson32")
    sci = np.asarray(reverse_cuthill_mckee(coo_to_scipy(pc), symmetric_mode=True))
    assert t_rcm.bandwidth(t_rcm.permute(pc, t_rcm.rcm_permutation(pc))) \
        <= t_rcm.bandwidth(t_rcm.permute(pc, sci.astype(np.int64))) * 1.5 + 2
