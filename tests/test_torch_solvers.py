"""PyTorch port vs the JAX package: GMRES (left and right
preconditioning), CG, the ILU operators (dense, per-level, padded
schedule, bidiagonal recurrence), classic SPAI, and the polynomial
preconditioners on the fused kernels' plain paths (Jacobi sweeps, K12;
Chebyshev, K13 and K8) at the fused k the selection picks.

Everything runs in float64 (the gallery matrices' dtype; the JAX package
with x64), so iteration counts must be equal and the solutions agree to
rtol 1e-8 (two float64 solvers whose sums run in other orders, over up to
a few hundred dependent iterations).  Operator outputs: rtol 1e-10.
Classic SPAI solves its least squares in float32 on both sides (LAPACK
QR on the CPU): rtol 1e-4, atol 1e-6."""

import importlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.env import ilu as j_ilu
from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.solvers.cg import cg as j_cg
from gflownet_spai_tpu.solvers.gmres import gmres as j_gmres
from gflownet_spai_tpu.solvers import precond as j_pre
from gflownet_spai_tpu.solvers import spai_classic as j_spai
from gflownet_spai_tpu.solvers import stationary as j_st
from gflownet_spai_tpu.solvers import trisolve as j_tri
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.ops import spmv as j_spmv
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.solvers.cg import cg as t_cg
from gflownet_spai_tpu_torch.solvers.cg import solve_with_cg as t_solve_with_cg
from gflownet_spai_tpu_torch.solvers.gmres import gmres as t_gmres
from gflownet_spai_tpu_torch.solvers import precond as t_pre
from gflownet_spai_tpu_torch.solvers import stationary as t_st
from gflownet_spai_tpu_torch.solvers import trisolve as t_tri
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery

CPU = "cpu"
t_spai = importlib.import_module("gflownet_spai_tpu_torch.solvers.spai_classic")
X_TOL = dict(rtol=1e-8, atol=1e-10)
OP_TOL = dict(rtol=1e-10, atol=1e-12)


def _mats(name):
    return j_gallery.get(name), t_gallery.get(name)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["bcsstk03_like", "poisson32"])
@pytest.mark.parametrize("side", ["left", "right"])
def test_gmres_matches_jax(name, side):
    ja, ta = _mats(name)
    n = ta.shape[0]
    L, U = j_ilu.ilu0(ja)
    tL, tU = t_ilu.ilu0(ta)
    b = np.random.default_rng(2).standard_normal(n)
    for jm, tm in ((None, None), (j_pre.ilu_solve_op(L, U),
                                  t_pre.ilu_solve_op(tL, tU, device=CPU))):
        want = j_gmres(partial(j_spmv, ja), jnp.asarray(b), m_op=jm,
                             restart=20, maxiter=600, rtol=1e-8, side=side)
        got = t_gmres(ta.to(CPU), torch.as_tensor(b), m_op=tm, restart=20,
                            maxiter=600, rtol=1e-8, side=side)
        assert got.iterations == int(want.iterations)
        assert got.converged == bool(want.converged)
        np.testing.assert_allclose(_np(got.x), _np(want.x), **X_TOL)
        it = got.iterations
        np.testing.assert_allclose(_np(got.residuals)[:it], _np(want.residuals)[:it],
                                   rtol=1e-6)
        assert np.isnan(_np(got.residuals)[it:]).all()


@pytest.mark.parametrize("name", ["bcsstk03_like", "poisson32"])
def test_cg_matches_jax(name):
    ja, ta = _mats(name)
    n = ta.shape[0]
    b = np.random.default_rng(3).standard_normal(n)
    jop, top = j_pre.jacobi_op(ja), t_pre.jacobi_op(ta.to(CPU))
    for jm, tm in ((None, None), (jop, top)):
        want = j_cg(partial(j_spmv, ja), jnp.asarray(b), m_op=jm, maxiter=800,
                       rtol=1e-8)
        got = t_cg(ta.to(CPU), torch.as_tensor(b), m_op=tm, maxiter=800, rtol=1e-8)
        assert got.iterations == int(want.iterations) and got.converged
        np.testing.assert_allclose(_np(got.x), _np(want.x), **X_TOL)
    # the harness wrapper
    x, res, iters, secs = t_solve_with_cg(ta.to(CPU), torch.as_tensor(b), maxiter=800)
    assert res.shape == (iters,) and secs >= 0


@pytest.mark.parametrize("name,form", [("poisson32", "levels"),
                                       ("poisson48", "looped"),
                                       ("olm500_like", "bidiagonal")])
def test_ilu_ops_match_jax(name, form):
    """Dense and sparse ILU applies (``dense_max_n`` forced below n for the
    sparse one) against JAX's, in each form of the triangular solve."""
    ja, ta = _mats(name)
    L, U = j_ilu.ilu0(ja)
    tL, tU = t_ilu.ilu0(ta)
    plan = t_tri.TriSolvePlan(tL, lower=True, device=CPU)
    fn, _ = t_tri._tri_apply_fns(plan)
    want_fn = {"levels": t_tri._levels_solve, "looped": t_tri._looped_levels_solve}
    if form == "bidiagonal":
        assert isinstance(fn, partial) and fn.func is t_tri._bidiag_solve
    else:
        assert fn is want_fn[form]
    x = np.random.default_rng(4).standard_normal(ta.shape[0])
    jop = j_pre.ilu_solve_op(L, U)
    want = _np(jax.jit(lambda v: jop(v))(jnp.asarray(x)))
    for op in (t_pre.ilu_solve_op(tL, tU, device=CPU),
               t_pre.ilu_solve_op(tL, tU, dense_max_n=8, device=CPU)):
        np.testing.assert_allclose(_np(op(torch.as_tensor(x))), want, **OP_TOL)
    # the JAX package's own sparse solve at the same form
    jsp_op = j_tri.sparse_ilu_solve_op(L, U)
    jsp = _np(jax.jit(lambda v: jsp_op(v))(jnp.asarray(x)))
    np.testing.assert_allclose(_np(t_tri.sparse_ilu_solve_op(tL, tU, device=CPU)(
        torch.as_tensor(x))), jsp, **OP_TOL)
    if form != "bidiagonal":
        assert t_tri.sparse_ilu_solve_op(tL, tU, max_levels=10, device=CPU) is None


@pytest.mark.parametrize("name,k", [("bcsstk03_like", 1), ("orsirr_like16", 1),
                                    ("LF10_like", 2)])
def test_spai_classic_matches_jax(name, k):
    ja, ta = _mats(name)
    want = j_spai.spai_classic(ja, k=k, dtype=jnp.float32)
    got = t_spai.spai_classic(ta, k=k, dtype=torch.float32, device=CPU)
    np.testing.assert_array_equal(got.row, _np(want.row))
    np.testing.assert_array_equal(got.col, _np(want.col))
    assert got.data.dtype == np.float32
    np.testing.assert_allclose(got.data, _np(want.data), rtol=1e-4, atol=1e-6)
    pw, pt = j_spai.power_pattern(ja, 2, max_nnz_per_col=5), \
        t_spai.power_pattern(ta, 2, max_nnz_per_col=5)
    np.testing.assert_array_equal(pt.row, _np(pw.row))
    np.testing.assert_array_equal(pt.col, _np(pw.col))


def _dias(name):
    ja, ta = _mats(name)
    return J.coo_to_dia(ja), T.coo_to_dia(ta, device=CPU), ja, ta


@pytest.mark.parametrize("name,k", [("poisson48", 2), ("poisson64", 4)])
def test_polynomial_preconditioners_match_jax(name, k):
    """``jacobi_sweeps_op`` (K12 at fused k) and ``chebyshev_op`` (K13 at
    fused k; λmax from ``estimate_lmax`` fed JAX's start vector) applied
    to a vector, and their CG iteration counts, against JAX's."""
    jd, td, ja, ta = _dias(name)
    n = td.n
    rng = np.random.default_rng(6)
    r = rng.standard_normal(n)

    jj, tj = j_st.jacobi_sweeps_op(jd, sweeps=16), t_st.jacobi_sweeps_op(td, sweeps=16)
    assert tj.info["k"] == k and tj.info["sweeps"] == 16
    np.testing.assert_allclose(_np(tj(torch.as_tensor(r))), _np(jj(jnp.asarray(r))),
                               **OP_TOL)

    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), jd.data.dtype))
    lj = float(j_st.estimate_lmax(jd, iters=30))
    lt = float(t_st.estimate_lmax(td, iters=30, v0=torch.tensor(v0)))
    np.testing.assert_allclose(lt, lj, rtol=1e-12)
    lmax = 1.05 * lt
    jc = j_st.chebyshev_op(jd, lmax=lmax, lmin=lmax / 30, degree=16)
    tc = t_st.chebyshev_op(td, lmax=lmax, lmin=lmax / 30, degree=16)
    assert tc.info["k"] == k and tc.info["degree"] == 16
    np.testing.assert_allclose(_np(tc(torch.as_tensor(r))), _np(jc(jnp.asarray(r))),
                               **OP_TOL)

    b = rng.standard_normal(n)
    for jm, tm in ((jj, tj), (jc, tc)):
        want = j_cg(jd, jnp.asarray(b), m_op=jm, maxiter=500, rtol=1e-8)
        got = t_cg(td, torch.as_tensor(b), m_op=tm, maxiter=500, rtol=1e-8)
        assert got.iterations == int(want.iterations) and got.converged
        np.testing.assert_allclose(_np(got.x), _np(want.x), **X_TOL)


def test_unfused_paths_match_jax():
    """k = 1 on poisson32 (n_pad 1024): the unfused affine Jacobi sweep
    and the one-SpMV-per-step Chebyshev apply, and ``jacobi``."""
    jd, td, _, _ = _dias("poisson32")
    r = np.random.default_rng(7).standard_normal(td.n)
    tj = t_st.jacobi_sweeps_op(td, sweeps=6)
    assert tj.info["k"] == 1
    np.testing.assert_allclose(_np(tj(torch.as_tensor(r))),
                               _np(j_st.jacobi_sweeps_op(jd, sweeps=6)(jnp.asarray(r))),
                               **OP_TOL)
    tc = t_st.chebyshev_op(td, lmax=8.4, degree=8)
    assert tc.info["k"] == 1
    np.testing.assert_allclose(_np(tc(torch.as_tensor(r))),
                               _np(j_st.chebyshev_op(jd, lmax=8.4, degree=8)(
                                   jnp.asarray(r))), **OP_TOL)
    got = t_st.jacobi(td, torch.as_tensor(r), iters=10)
    want = j_st.jacobi(jd, jnp.asarray(r), iters=10)
    assert got.iterations == want.iterations
    np.testing.assert_allclose(_np(got.x), _np(want.x), **OP_TOL)
    np.testing.assert_allclose(float(got.residual), float(want.residual), rtol=1e-10)
    # M = I − ωD⁻¹A keeps identity rows in the padding [n, n_pad)
    m = t_st.jacobi_iteration_matrix(td)
    np.testing.assert_array_equal(_np(m.data), _np(j_st.jacobi_iteration_matrix(jd).data))
    assert (m.data[td.offsets.index(0), td.n:] == 1.0).all()
