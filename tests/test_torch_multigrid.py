"""PyTorch port vs the JAX package: the aggregation V-cycle
(``solvers/multigrid.py``): the Galerkin coarse operator, the grid
transfers, and ``vcycle_op`` with weighted-Jacobi (K12 / K8 plain paths)
and Chebyshev (K13 / K8) smoothing at gamma 1 and 2.

Float64 throughout (the JAX package with x64): the coarse operator equal to
rtol 1e-12 (one scatter-add of up to 8 terms per entry, summed in another
order), the cycle's apply to rtol 1e-10, and the CG iteration counts
equal.  The Chebyshev levels' λmax comes from ``estimate_lmax`` fed JAX's
start vectors (``jax.random.normal(PRNGKey(0), (n,))`` per level), so both
sides build the same polynomials."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.convert import coo_to_scipy
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

j_cg = importlib.import_module("gflownet_spai_tpu.solvers.cg")
j_mg = importlib.import_module("gflownet_spai_tpu.solvers.multigrid")
t_cg = importlib.import_module("gflownet_spai_tpu_torch.solvers.cg")
t_mg = importlib.import_module("gflownet_spai_tpu_torch.solvers.multigrid")
t_st = importlib.import_module("gflownet_spai_tpu_torch.solvers.stationary")

CPU = "cpu"
OP_TOL = dict(rtol=1e-10, atol=1e-12)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dias(name):
    return (J.coo_to_dia(j_gallery.get(name), max_diags=10**6),
            T.coo_to_dia(t_gallery.get(name), device=CPU))


def _jax_start_lmax(monkeypatch):
    """The port's V-cycle draws each level's power-iteration start vector
    as JAX does (another stream than torch's from the same seed)."""
    def lmax(d, iters=20, seed=0):
        v0 = jax.random.normal(jax.random.PRNGKey(seed), (d.n,), jnp.float64)
        return t_st.estimate_lmax(d, iters, v0=torch.tensor(np.asarray(v0)))
    monkeypatch.setattr(t_mg, "estimate_lmax", lmax)


@pytest.mark.parametrize("name", ["poisson32", "orsirr_like16"])
def test_galerkin_coarse_matches_jax(name):
    """A_c = ½ Pᵀ A P over two coarsenings, against JAX's and against the
    dense triple product."""
    jd, td = _dias(name)
    for _ in range(2):
        n = td.n
        n_c = (n + 1) // 2
        P = np.zeros((n, n_c))
        P[np.arange(n), np.arange(n) // 2] = 1.0
        want_dense = 0.5 * P.T @ _np(td.todense()) @ P
        jd, td = j_mg.galerkin_coarse_dia(jd), t_mg.galerkin_coarse_dia(td)
        assert td.offsets == jd.offsets and td.shape == jd.shape == (n_c, n_c)
        assert td.nnz == jd.nnz
        np.testing.assert_allclose(_np(td.data), _np(jd.data), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(_np(td.todense()), want_dense, rtol=1e-12, atol=1e-14)


def test_grid_transfers_match_jax():
    r = np.random.default_rng(1).standard_normal(11)
    np.testing.assert_array_equal(_np(t_mg.restrict(torch.as_tensor(r))),
                                  _np(j_mg.restrict(jnp.asarray(r))))
    zc = r[:6]
    np.testing.assert_array_equal(_np(t_mg.prolong(torch.as_tensor(zc), 11)),
                                  _np(j_mg.prolong(jnp.asarray(zc), 11)))


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("gamma", [1, 2])
def test_vcycle_matches_jax(monkeypatch, smoother, gamma):
    """poisson32, three levels down to 256 rows: the cycle applied to a
    random vector, and its CG iteration count (b = ones, rtol 1e-8).
    JAX's CG runs unjitted: compiling the cycle inside its loop takes
    longer than the few iterations it runs."""
    _jax_start_lmax(monkeypatch)
    jd, td = _dias("poisson32")
    kw = dict(levels=3, smoother=smoother, min_coarse_n=64, gamma=gamma)
    jop, top = j_mg.vcycle_op(jd, **kw), t_mg.vcycle_op(td, **kw)
    assert top.info["levels"] == 3 and top.info["gamma"] == gamma
    r = np.random.default_rng(21).standard_normal(td.n)
    np.testing.assert_allclose(_np(top(torch.as_tensor(r))), _np(jop(jnp.asarray(r))),
                               **OP_TOL)
    with jax.disable_jit():
        want = j_cg.cg(jd, jnp.ones(td.n), m_op=jop, maxiter=300, rtol=1e-8)
    got = t_cg.cg(td, torch.ones(td.n, dtype=torch.float64), m_op=top, maxiter=300,
                  rtol=1e-8)
    assert got.converged and got.iterations == int(want.iterations)
    A = coo_to_scipy(j_gallery.get("poisson32"))
    assert np.linalg.norm(A @ _np(got.x) - 1.0) / np.sqrt(td.n) < 1e-7


def test_vcycle_fused_smoothing_matches_jax():
    """poisson64's Jacobi V-cycle fuses its smoothing (k = 4 on the 16
    coarse sweeps of level 2, 2048 rows): the cycle applied to a vector."""
    jd, td = _dias("poisson64")
    kw = dict(levels=2, pre=2, post=2, coarse_sweeps=16, min_coarse_n=64)
    jop, top = j_mg.vcycle_op(jd, **kw), t_mg.vcycle_op(td, **kw)
    assert top.info["k"][-1] > 1
    r = np.random.default_rng(22).standard_normal(td.n)
    np.testing.assert_allclose(_np(top(torch.as_tensor(r))), _np(jop(jnp.asarray(r))),
                               **OP_TOL)


def test_vcycle_needs_two_levels():
    _, td = _dias("poisson16")
    with pytest.raises(ValueError):
        t_mg.vcycle_op(td, levels=1)
