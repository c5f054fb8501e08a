"""PyTorch port vs the JAX package: batched multi-RHS CG (``cg_multi``, on
the K16 plain path), multi-RHS weighted Jacobi (``jacobi_multirhs``, on the
K14 plain path, fused and not), BiCGStab with its breakdown guards, and the
``cg_matrix`` / ``gmres_matrix`` wrappers.

Everything runs in float64 (the JAX package with x64), so iteration counts
must be equal and solutions agree to rtol 1e-8 (two float64 solvers whose
sums run in other orders, over up to a few hundred dependent iterations);
the fixed-sweep Jacobi results to rtol 1e-10.  BiCGStab amplifies rounding
on symmetric systems (poisson32 drifts from JAX's history by 1e-3 within 40
iterations), so its parity is held on the nonsymmetric and well-conditioned
gallery matrices, with residual histories to rtol 1e-5 (the recurrences
carry the rounding of the last iterations to ~1e-6); the breakdown case
(olm500_like) must stop at the same iteration, unconverged, with a finite
iterate, its history to rtol 1e-4 (the residual triples per iteration
before the guard stops it, and the rounding with it) but for the last
entry, computed from the collapsing r̂ᵀv."""

import importlib
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.ops import spmv as j_spmv
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

j_cg = importlib.import_module("gflownet_spai_tpu.solvers.cg")
j_bi = importlib.import_module("gflownet_spai_tpu.solvers.bicgstab")
j_gm = importlib.import_module("gflownet_spai_tpu.solvers.gmres")
j_mr = importlib.import_module("gflownet_spai_tpu.solvers.multirhs")
j_st = importlib.import_module("gflownet_spai_tpu.solvers.stationary")
t_cg = importlib.import_module("gflownet_spai_tpu_torch.solvers.cg")
t_bi = importlib.import_module("gflownet_spai_tpu_torch.solvers.bicgstab")
t_gm = importlib.import_module("gflownet_spai_tpu_torch.solvers.gmres")
t_mr = importlib.import_module("gflownet_spai_tpu_torch.solvers.multirhs")
t_st = importlib.import_module("gflownet_spai_tpu_torch.solvers.stationary")

CPU = "cpu"
X_TOL = dict(rtol=1e-8, atol=1e-10)
OP_TOL = dict(rtol=1e-10, atol=1e-12)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dias(name):
    return (J.coo_to_dia(j_gallery.get(name)),
            T.coo_to_dia(t_gallery.get(name), device=CPU))


def _scaled_poisson16():
    """poisson16 scaled by s = linspace(1, 40) on both sides (Jacobi then
    matters), with its one-diagonal Jacobi M, in both packages
    (``tests/test_solvers.py:309-339``)."""
    from gflownet_spai_tpu.sparse.convert import coo_to_scipy
    from gflownet_spai_tpu.sparse.types import COO as JCOO
    from gflownet_spai_tpu_torch.sparse.types import COO as TCOO

    A = coo_to_scipy(j_gallery.get("poisson16")).toarray()
    s = np.linspace(1.0, 40.0, A.shape[0])
    As = (A * s).T * s
    jcoo = JCOO.fromdense(jnp.asarray(As))
    tcoo = TCOO(row=np.asarray(jcoo.row), col=np.asarray(jcoo.col),
                data=np.asarray(jcoo.data), shape=jcoo.shape)
    jd, td = J.coo_to_dia(jcoo, max_diags=200), T.coo_to_dia(tcoo, max_diags=200, device=CPU)
    inv = np.pad(1.0 / np.diag(As), (0, jd.n_pad - jd.n))[None, :]
    jm = J.DIA(data=jnp.asarray(inv), offsets=(0,), shape=jd.shape, nnz=jd.n)
    tm = T.DIA(data=torch.as_tensor(inv), offsets=(0,), shape=td.shape, nnz=td.n)
    return jd, td, jm, tm, As


@pytest.mark.parametrize("precond", [False, True])
def test_cg_multi_matches_jax(precond):
    """Per-system iteration counts, solutions and NaN-after-convergence
    residual histories against JAX's ``cg_multi``, and every column
    against the port's single-RHS ``cg`` (K_pad padding included: K = 5
    pads to 8 systems)."""
    if precond:
        jd, td, jm, tm, As = _scaled_poisson16()
        kw = dict(maxiter=3000, rtol=1e-6)
    else:
        (jd, td), jm, tm, As = _dias("poisson16"), None, None, None
        kw = dict(maxiter=400, rtol=1e-6)
    K = 5 if not precond else 3
    bt = np.random.default_rng(3 + precond).standard_normal((K, td.n))
    want = j_mr.cg_multi(jd, jnp.asarray(bt), m=jm, **kw)
    got = t_mr.cg_multi(td, torch.as_tensor(bt), m=tm, **kw)
    assert got.converged.all()
    np.testing.assert_array_equal(_np(got.iterations), _np(want.iterations))
    np.testing.assert_array_equal(_np(got.converged), _np(want.converged))
    np.testing.assert_allclose(_np(got.xt), _np(want.xt), **X_TOL)
    its = _np(got.iterations)
    hist, jhist = _np(got.residuals), _np(want.residuals)
    for k in range(K):
        np.testing.assert_allclose(hist[:its[k], k], jhist[:its[k], k], rtol=1e-6)
        assert np.isnan(hist[its[k]:, k]).all()
        single = t_cg.cg(td, torch.as_tensor(bt[k]), m_op=tm, **kw)
        assert single.iterations == its[k]
        np.testing.assert_allclose(_np(got.xt[k]), _np(single.x), **X_TOL)
    if As is not None:
        np.testing.assert_allclose(_np(got.xt), np.linalg.solve(As, bt.T).T,
                                   rtol=5e-2, atol=5e-4)


def test_cg_multi_takes_callables():
    """A LinOp on [K, n] (no padding) runs the same iterations as the DIA
    path."""
    jd, td = _dias("poisson16")
    bt = np.random.default_rng(8).standard_normal((4, td.n))
    op = lambda vt: T.spmm_dia_t(td, vt)
    got = t_mr.cg_multi(op, torch.as_tensor(bt), maxiter=400, rtol=1e-6)
    want = t_mr.cg_multi(td, torch.as_tensor(bt), maxiter=400, rtol=1e-6)
    np.testing.assert_array_equal(_np(got.iterations), _np(want.iterations))
    np.testing.assert_allclose(_np(got.xt), _np(want.xt), **X_TOL)


@pytest.mark.parametrize("name,n_rhs,iters,k", [("poisson32", 4, 24, 1),
                                                ("poisson64", 2, 16, 4)])
def test_jacobi_multirhs_matches_jax(name, n_rhs, iters, k):
    """K systems at once (K14's plain path at the fused k the selection
    picks) against JAX's ``jacobi_multirhs`` and K single ``jacobi`` runs
    at the same k."""
    jd, td = _dias(name)
    B = np.random.default_rng(13).standard_normal((n_rhs, td.n))
    want = j_st.jacobi_multirhs(jd, jnp.asarray(B), iters=iters)
    got = t_st.jacobi_multirhs(td, torch.as_tensor(B), iters=iters)
    assert got.iterations == want.iterations == -(-iters // (2 * k)) * 2 * k
    assert got.x.shape == (n_rhs, td.n) and got.residual.shape == (n_rhs,)
    np.testing.assert_allclose(_np(got.x), _np(want.x), **OP_TOL)
    np.testing.assert_allclose(_np(got.residual), _np(want.residual), rtol=1e-10)
    for i in range(n_rhs):
        single = t_st.jacobi(td, torch.as_tensor(B[i]), iters=iters, fuse_k=k)
        np.testing.assert_allclose(_np(got.x[i]), _np(single.x), **OP_TOL)


@pytest.mark.parametrize("name", ["convdiff2d24", "LF10_like", "bcsstk03_like"])
def test_bicgstab_matches_jax(name):
    ja, ta = j_gallery.get(name), t_gallery.get(name).to(CPU)
    n = ta.shape[0]
    for b in (np.ones(n), np.random.default_rng(9).standard_normal(n)):
        want = j_bi.bicgstab(partial(j_spmv, ja), jnp.asarray(b), maxiter=2000, rtol=1e-8)
        got = t_bi.bicgstab(ta, torch.as_tensor(b), maxiter=2000, rtol=1e-8)
        assert got.iterations == int(want.iterations)
        assert got.converged == bool(want.converged) is True
        np.testing.assert_allclose(_np(got.x), _np(want.x), **X_TOL)
        it = got.iterations
        np.testing.assert_allclose(_np(got.residuals)[:it], _np(want.residuals)[:it],
                                   rtol=1e-5)
        assert np.isnan(_np(got.residuals)[it:]).all()
    x, res, iters, secs = t_bi.solve_with_bicgstab(ta, torch.as_tensor(b), maxiter=2000)
    assert res.shape == (iters,) and secs >= 0


def test_bicgstab_breakdown_matches_jax():
    """Strongly nonsymmetric olm500_like breaks BiCGStab: both stop at the
    same iteration with a finite iterate, honestly unconverged."""
    ja, ta = j_gallery.get("olm500_like"), t_gallery.get("olm500_like").to(CPU)
    want = j_bi.bicgstab(partial(j_spmv, ja), jnp.ones(500), maxiter=2000, rtol=1e-8)
    got = t_bi.bicgstab(ta, torch.ones(500, dtype=torch.float64), maxiter=2000, rtol=1e-8)
    assert got.iterations == int(want.iterations) < 2000
    assert not got.converged and not bool(want.converged)
    assert np.isfinite(_np(got.x)).all()
    it = got.iterations
    np.testing.assert_allclose(_np(got.residuals)[:it - 1], _np(want.residuals)[:it - 1],
                               rtol=1e-4)


def test_matrix_wrappers_match_jax():
    ja, ta = j_gallery.get("bcsstk03_like"), t_gallery.get("bcsstk03_like").to(CPU)
    b = np.random.default_rng(10).standard_normal(ta.shape[0])
    want = j_cg.cg_matrix(ja, jnp.asarray(b), maxiter=800, rtol=1e-8)
    got = t_cg.cg_matrix(ta, torch.as_tensor(b), maxiter=800, rtol=1e-8)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(_np(got.x), _np(want.x), **X_TOL)
    want = j_gm.gmres_matrix(ja, jnp.asarray(b), restart=20, maxiter=600, rtol=1e-8)
    got = t_gm.gmres_matrix(ta, torch.as_tensor(b), restart=20, maxiter=600, rtol=1e-8)
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(_np(got.x), _np(want.x), **X_TOL)
