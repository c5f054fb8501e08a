"""PyTorch port vs the JAX package: the padded-IO and ping-pong SpMVs (K10,
K11), the multi-RHS fused k-step SpMV (K14) and the DIA SpMMs (K15, K16):
their plain versions against the Pallas kernels in interpret mode, at the
shapes of ``tests/test_ops.py``, and the TPU VMEM selection functions that
fix the pad widths, K_pad and the fused k of ``jacobi_multirhs``.

Tolerances: selection functions exact.  K10, K11 rtol 2e-6, atol 1e-5 on
Poisson 256² and on orsirr_like24 (the Pallas kernels start their sums at
the main diagonal, the plain versions at zero in offset order: float32
rounding only).  K14 rtol 3e-6, atol 1e-4
as K12 (float32 over k dependent passes; the bound ``tests/test_ops.py``
holds the same kernel to).  K15, K16 rtol 1e-5, atol 1e-4 (``test_ops``'s
bound for the same kernels)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.solvers import stationary as j_st
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.solvers import stationary as t_st
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery

IO_TOL = dict(rtol=2e-6, atol=1e-5)
K14_TOL = dict(rtol=3e-6, atol=1e-4)
SPMM_TOL = dict(rtol=1e-5, atol=1e-4)
# the fused k of jacobi_multirhs (16 sweeps, fuse_k 8) on 2D Poisson grids
# for K = 1, 2, 4, 8, 16, 32 right-hand sides, as the TPU model picks it
MULTIRHS_K = {"poisson128": (8, 8, 8, 8, 8, 2), "poisson256": (8, 8, 2, 1, 1, 1),
              "poisson512": (8, 8, 1, 1, 1, 1), "poisson1024": (4, 1, 1, 1, 1, 1)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(data, offsets, n):
    """One DIA in both packages from the same host diagonals."""
    nnz = int((data != 0).sum())
    return (J.DIA(data=jnp.asarray(data), offsets=tuple(offsets), shape=(n, n), nnz=nnz),
            T.DIA(data=torch.as_tensor(data), offsets=tuple(offsets), shape=(n, n),
                  nnz=nnz))


def _poisson(k):
    """5-point Laplacian on a k×k grid, float32 diagonals (test_ops.py)."""
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    data = np.zeros((5, -(-n // 1024) * 1024), np.float32)
    data[2, :n] = 4.0
    data[0, i[r > 0]] = data[1, i[c > 0]] = -1.0
    data[3, i[c < k - 1]] = data[4, i[r < k - 1]] = -1.0
    return _pair(data, (-k, -1, 0, 1, k), n)


def _offsets_dia(name):
    """DIAs of a gallery matrix's offsets and padded size with zero
    diagonals: the selection functions read only offsets, halo and n_pad."""
    a = t_gallery.get(name)
    offs = np.unique(a.col.astype(np.int64) - a.row.astype(np.int64))
    n = a.shape[0]
    return _pair(np.zeros((len(offs), -(-n // 1024) * 1024), np.float32), offs.tolist(), n)


def _j_multirhs_k(m, fuse_k, iters, n_rhs):
    """The fused k ``jacobi_multirhs`` computes inline
    (``gflownet_spai_tpu/solvers/stationary.py:353-356``)."""
    k, trk = j_st._pick_power_config(m, fuse_k, iters)
    while k > 1 and not J.dia_power_rhs_ok(m, k, n_rhs, trk or J.dia_pp_tile(m)):
        k //= 2
        trk = J.dia_power_tile(m, k) if k > 1 else 0
    return k, trk


@pytest.mark.parametrize("name", ["poisson48", "poisson128", "poisson256", "poisson512",
                                  "poisson1024", "orsirr_like150"])
def test_selection_functions_match_jax(name):
    jd, td = _offsets_dia(name)
    assert T._spmv_io_tile(td) == J._spmv_io_tile(jd)
    assert T._spmv_io_fits(td) == J._spmv_io_fits(jd)
    tr = T.dia_pp_tile(td)
    assert T._pp_resident_ok(td, tr) == J._pp_resident_ok(jd, tr)
    for k in (2, 4, 8):
        for n_rhs in (1, 2, 4, 8, 16, 32):
            for t in (None, T.dia_power_tile(td, k)):
                assert T.dia_power_rhs_ok(td, k, n_rhs, t) == J.dia_power_rhs_ok(jd, k, n_rhs, t)
    for kp in (8, 16, 200, 256):
        assert T._spmm_t_tiles(td, kp) == J._spmm_t_tiles(jd, kp)
        assert T._spmm_t_fits(td, kp) == J._spmm_t_fits(jd, kp)
    jm, tm = j_st.jacobi_iteration_matrix(jd), t_st.jacobi_iteration_matrix(td)
    for n_rhs in (1, 2, 4, 8, 16, 32):
        assert (t_st._multirhs_config(tm, 8, 16, n_rhs)
                == _j_multirhs_k(jm, 8, 16, n_rhs))
    if name in MULTIRHS_K:
        assert tuple(t_st._multirhs_config(tm, 8, 16, n)[0]
                     for n in (1, 2, 4, 8, 16, 32)) == MULTIRHS_K[name]


def test_spmm_t_tiles_at_poisson1024():
    """(kb, tr) the transposed SpMM's model picks at K = 8 and K = 16: kb
    sets K_pad, the row count of ``cg_multi``'s buffers."""
    _, td = _offsets_dia("poisson1024")
    assert T._spmm_t_tiles(td, 8) == (8, 32768)
    assert T._spmm_t_tiles(td, 16) == (16, 16384)
    xt = torch.zeros((13, td.n))
    assert tuple(T.dia_pad_xt(td, xt).shape) == (16, td.n_pad + 2 * td.halo)


def test_layouts_match_jax():
    jd, td = _poisson(40)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(td.n).astype(np.float32)
    X = rng.standard_normal((3, td.n)).astype(np.float32)
    np.testing.assert_array_equal(_np(T.dia_pad_io(td, torch.as_tensor(x))),
                                  _np(J.dia_pad_io(jd, jnp.asarray(x))))
    np.testing.assert_array_equal(_np(T.dia_pad_xt(td, torch.as_tensor(X))),
                                  _np(J.dia_pad_xt(jd, jnp.asarray(X))))
    for tr in (None, 2048):
        np.testing.assert_array_equal(_np(T.dia_pad_pp_rhs(td, torch.as_tensor(X), tr=tr)),
                                      _np(J.dia_pad_pp_rhs(jd, jnp.asarray(X), tr=tr)))


def _orsirr24():
    """orsirr_like24's DIA (10 diagonals at odd offsets, reach 466) in both
    packages."""
    a = t_gallery.get("orsirr_like24")
    t0 = T.coo_to_dia(a.with_data(a.data.astype(np.float32)), device="cpu")
    return _pair(t0.data.numpy(), t0.offsets, t0.n)


# the case, and the padded-IO tile and interior blocks of its K10 grid
K10_K11_CASES = {"poisson256": (lambda: _poisson(256), 16384, 4),
                 "orsirr_like24": (_orsirr24, 1024, 1)}


@pytest.mark.parametrize("name", list(K10_K11_CASES))
def test_k10_k11_plain_match_pallas_interpret(name):
    """K10 (padded-IO, resident and streamed) and K11 (ping-pong, resident
    and streamed) at scale 0.5 on Poisson 256² (4 interior blocks of 16,384
    rows) and on orsirr_like24 (odd offsets, one interior block): y in the
    padded layout, halo blocks zero."""
    make, io_tile, blocks = K10_K11_CASES[name]
    jd, td = make()
    rng = np.random.default_rng(5)
    x = rng.standard_normal(td.n).astype(np.float32)
    tr = T._spmv_io_tile(td)
    assert tr == io_tile and td.n_pad // tr == blocks
    jxq, txq = J.dia_pad_io(jd, jnp.asarray(x)), T.dia_pad_io(td, torch.as_tensor(x))
    got = T.spmv_dia_padded_io(td, txq, scale=0.5)
    assert got.shape == txq.shape and got is not txq
    for fn in (J._spmv_pallas_io, J._spmv_pallas_io_stream):
        np.testing.assert_allclose(_np(got), np.asarray(fn(jd, jxq, scale=0.5,
                                                           interpret=True)), **IO_TOL)
    assert not got[:tr].any() and not got[tr + td.n_pad:].any()

    tr = T.dia_pp_tile(td)
    jxq, txq = J.dia_pad_pp(jd, jnp.asarray(x)), T.dia_pad_pp(td, torch.as_tensor(x))
    yq = torch.full_like(txq, 7.0)
    yq[tr:tr + td.n_pad] = 0.0          # the halo blocks must stay as they are
    got = T.spmv_dia_pingpong(td, txq, yq, scale=0.5)
    assert got is yq
    for fn in (J._spmv_pallas_pp, J._spmv_pallas_pp_stream):
        want = np.asarray(fn(jd, jxq, jnp.zeros_like(jxq), scale=0.5, interpret=True))
        np.testing.assert_allclose(_np(got)[tr:tr + td.n_pad], want[tr:tr + td.n_pad],
                                   **IO_TOL)
    assert (got[:tr] == 7.0).all() and (got[tr + td.n_pad:] == 7.0).all()


def test_k10_k11_chains_match_jax_fallbacks():
    """Three chained applies at scale 0.2 through each public entry on
    Poisson 16² (the JAX package's jnp paths, buffers swapped for K11)."""
    jd, td = _poisson(16)
    x = np.random.default_rng(6).standard_normal(td.n).astype(np.float32)
    jio, tio = J.dia_pad_io(jd, jnp.asarray(x)), T.dia_pad_io(td, torch.as_tensor(x))
    jx, jy = J.dia_pad_pp(jd, jnp.asarray(x)), None
    tx = T.dia_pad_pp(td, torch.as_tensor(x))
    jy, ty = jnp.zeros_like(jx), torch.zeros_like(tx)
    for _ in range(3):
        jio, tio = J.spmv_dia_padded_io(jd, jio, scale=0.2), T.spmv_dia_padded_io(td, tio, 0.2)
        jy = J.spmv_dia_pingpong(jd, jx, jy, scale=0.2)
        T.spmv_dia_pingpong(td, tx, ty, scale=0.2)
        jx, jy, tx, ty = jy, jx, ty, tx
    np.testing.assert_allclose(_np(tio), np.asarray(jio), **IO_TOL)
    np.testing.assert_allclose(_np(tx), np.asarray(jx), **IO_TOL)
    p = (tx.shape[0] - td.n_pad) // 2
    assert not tx[:p].any() and not ty[:p].any() and not tx[p + td.n_pad:].any()


@pytest.mark.parametrize("k,tr,n,K", [(1, 2048, 4096, 8), (2, 2048, 4096, 8),
                                      (8, 8192, 16384, 3)])
@pytest.mark.parametrize("affine", [False, True])
def test_k14_plain_matches_pallas_interpret(k, tr, n, K, affine):
    """K14 on a random tridiagonal at a non-default tile (2 row tiles; the
    windows overlap by k − 1 halos), scale 0.3, with and without the
    affine term; the public JAX fallback agrees on the same buffers."""
    rng = np.random.default_rng(12 + k)
    jd, td = _pair(rng.standard_normal((3, n)).astype(np.float32), (-1, 0, 1), n)
    X = rng.standard_normal((K, n)).astype(np.float32)
    C = rng.standard_normal((K, n)).astype(np.float32)
    jxq, txq = J.dia_pad_pp_rhs(jd, jnp.asarray(X), tr=tr), \
        T.dia_pad_pp_rhs(td, torch.as_tensor(X), tr=tr)
    jcq = J.dia_pad_pp_rhs(jd, jnp.asarray(C), tr=tr) if affine else None
    tcq = T.dia_pad_pp_rhs(td, torch.as_tensor(C), tr=tr) if affine else None
    dk = J.dia_power_data(jd, k, tr=tr)
    assert dk.shape[0] == n // tr == 2
    want = np.asarray(J._spmv_pallas_power_rhs(jd, dk, jxq, jnp.zeros_like(jxq), scale=0.3,
                                               k=k, cq=jcq, interpret=True))
    zq = torch.zeros_like(txq)
    got = T.spmv_dia_power_rhs(td, None, txq, zq, scale=0.3, k=k, add=tcq)
    assert got is zq
    np.testing.assert_allclose(_np(got), want, **K14_TOL)
    assert not got[:, :tr].any() and not got[:, tr + n:].any()
    jz = np.asarray(J.spmv_dia_power_rhs(jd, dk, jxq, jnp.zeros_like(jxq), scale=0.3, k=k,
                                         add=jcq))
    np.testing.assert_allclose(_np(got), jz, **K14_TOL)


def test_k15_plain_matches_pallas_interpret(monkeypatch):
    """K15 on Poisson 64² with X [4096, 256]; the VMEM budget is shrunk so
    the Pallas grid has 4 row tiles × 2 column tiles (``test_ops``)."""
    jd, td = _poisson(64)
    x = np.random.default_rng(0).standard_normal((td.n, 256)).astype(np.float32)
    monkeypatch.setattr(J, "_MAX_VMEM_BYTES", (2 * (1024 + 2 * jd.halo) * 128
                                               + 2 * 5 * 1024 + 2 * 1024 * 128 + 64) * 4)
    want = np.asarray(J._spmm_dia_pallas(jd, jnp.asarray(x), interpret=True))[:td.n]
    got = T.spmm_dia(td, torch.as_tensor(x))
    assert got.shape == (td.n, 256)
    np.testing.assert_allclose(_np(got), want, **SPMM_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(J.spmm_dia_jnp(jd, jnp.asarray(x))),
                               **SPMM_TOL)


@pytest.mark.parametrize("K", [1, 7, 260])
def test_k15_plain_matches_jnp_many_diagonals(K):
    """K15's plain version on orsirr_like24 (10 diagonals, a wide halo)
    at K = 1 and 7 (the kernel's word-by-word path) and 260 (past its
    16-byte column tiles) against ``spmm_dia_jnp``."""
    a = t_gallery.get("orsirr_like24")
    t0 = T.coo_to_dia(a.with_data(a.data.astype(np.float32)), device="cpu")
    jd, td = _pair(t0.data.numpy(), t0.offsets, t0.n)
    assert td.ndiags == 10
    x = np.random.default_rng(K).standard_normal((td.n, K)).astype(np.float32)
    got = T.spmm_dia(td, torch.as_tensor(x))
    assert got.shape == (td.n, K)
    np.testing.assert_allclose(_np(got), np.asarray(J.spmm_dia_jnp(jd, jnp.asarray(x))),
                               **SPMM_TOL)


def test_k16_plain_matches_pallas_interpret(monkeypatch):
    """K16 on Poisson 64² with 200 right-hand sides; the budget is shrunk
    so only (kb 8, tr 2048) fits: 25 RHS tiles × 2 row tiles, and K_pad
    follows kb in both packages."""
    jd, td = _poisson(64)
    xt = np.random.default_rng(1).standard_normal((200, td.n)).astype(np.float32)
    budget = (J._spmm_t_need(jd, 8, 2048) + 64) * 4
    monkeypatch.setattr(J, "_MAX_VMEM_BYTES", budget)
    monkeypatch.setattr(T, "_MAX_VMEM_BYTES", budget)
    assert T._spmm_t_tiles(td, 200) == J._spmm_t_tiles(jd, 200) == (8, 2048)
    jxtp, txtp = J.dia_pad_xt(jd, jnp.asarray(xt)), T.dia_pad_xt(td, torch.as_tensor(xt))
    assert txtp.shape == jxtp.shape == (200, td.n_pad + 2 * td.halo)
    want = np.asarray(J._spmm_dia_t_pallas(jd, jxtp, interpret=True))
    got = T.spmm_dia_t_padded(td, txtp)
    np.testing.assert_allclose(_np(got), want, **SPMM_TOL)
    # the [K, n] entry point and the JAX reference
    got_t = T.spmm_dia_t(td, torch.as_tensor(xt))
    np.testing.assert_allclose(_np(got_t), np.asarray(J.spmm_dia_t_jnp(jd, jnp.asarray(xt))),
                               **SPMM_TOL)
    np.testing.assert_allclose(_np(got_t), _np(got)[:, :td.n], **SPMM_TOL)


def test_multi_rhs_wrappers_refuse_what_the_kernels_do_not_take():
    """The layout checks that guard K14 and K16 on the card, exercised on
    CPU tensors through the helpers."""
    _, td = _poisson(32)
    xq = torch.zeros((3, td.n_pad + 2 * td.halo))
    assert T._check_pp(td, "spmv_dia_power_rhs", xq, xq.clone(), ndim=2) == td.halo
    with pytest.raises(ValueError):
        T._check_pp(td, "spmv_dia_power_rhs", xq, torch.zeros((2, xq.shape[1])), ndim=2)
    with pytest.raises(ValueError):
        T._check_pp(td, "spmv_dia_power_rhs", xq[:, :-2], ndim=2)    # P < halo
    with pytest.raises(ValueError):
        T._check_pp(td, "spmv_dia_pingpong", xq)                     # not 1-D
