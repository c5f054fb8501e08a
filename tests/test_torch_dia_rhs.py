"""PyTorch port vs the JAX package: the multi-right-hand-side DIA operator
that ``cg_multi`` applies without a padded copy of its iterate (K16 on the
unpadded [K_pad, n_pad] buffer, ``spmm_dia_t_rows``), the fused k JAX's
selection picks at ``chip_smoke.py``'s K14 shapes, and K14's k passes
composed as its CUDA entry runs them.

``solvers/multirhs._dia_apply_t`` hands the iterate itself to
``spmm_dia_t_rows`` (rounded to the diagonals' dtype, as JAX's buffer of
that dtype rounds it), which reads it as zero outside [0, n_pad): the
values of JAX's ``_dia_apply_t``, which copies it into a zero-padded
[K_pad, h + n_pad + h] buffer for ``spmm_dia_t_padded``.  Held against the
JAX Pallas kernel in interpret mode on that padded buffer and against
JAX's ``_dia_apply_t`` (its jnp branch on the CPU), both under
``jax.jit``, on poisson96, orsirr_like24 (10 diagonals, a wide halo) and a
band with an offset beyond n and a ragged last row tile (n 1,500 of n_pad
2,048), at K 1, 7, 13 and 16 (K_pad as ``cg_multi`` pads it).

Tolerances: float32 rtol 1e-5, atol 1e-4, the bound
``tests/test_torch_dia_multi.py`` holds K16's plain version to (its sums
start from zero in offset order, the Pallas kernel's elsewhere); bf16
diagonals rtol 2e-2, atol 2e-2·max|want|, ``tests/test_ops.py:786-790``'s
bound for bf16 diagonals (the JAX Pallas kernel accumulates in bf16, the
port in float32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.solvers import multirhs as j_mr
from gflownet_spai_tpu.solvers import stationary as j_st
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.solvers import multirhs as t_mr
from gflownet_spai_tpu_torch.solvers import stationary as t_st
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32_TOL = dict(rtol=1e-5, atol=1e-4)
BF = torch.bfloat16
BAND_N, BAND_OFFSETS = 1500, (-7, -1, 0, 2, 1600)    # 1600 >= n: an empty diagonal


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _host_dia(name):
    """(data [ndiags, n_pad] float32, offsets, n) of a case."""
    if name == "band":
        n_pad = -(-BAND_N // 1024) * 1024
        rng = np.random.default_rng(5)
        data = np.zeros((len(BAND_OFFSETS), n_pad), np.float32)
        i = np.arange(BAND_N)
        for s, off in enumerate(BAND_OFFSETS):
            ok = (i + off >= 0) & (i + off < BAND_N)
            data[s, i[ok]] = rng.standard_normal(int(ok.sum()))
        return data, BAND_OFFSETS, BAND_N
    a = t_gallery.get(name)
    d = T.coo_to_dia(a.with_data(a.data.astype(np.float32)), device="cpu")
    return d.data.numpy(), d.offsets, d.n


def _pair(name, bf16):
    data, offsets, n = _host_dia(name)
    nnz = int((data != 0).sum())
    jd = J.DIA(data=jnp.asarray(data), offsets=tuple(offsets), shape=(n, n), nnz=nnz)
    td = T.DIA(data=torch.as_tensor(data), offsets=tuple(offsets), shape=(n, n), nnz=nnz)
    if bf16:
        return J.dia_astype(jd, jnp.bfloat16), T.dia_astype(td, BF)
    return jd, td


def _iterate(td, K, seed):
    """``cg_multi``'s [K_pad, n_pad] float32 iterate: K seeded systems,
    zero beyond K and beyond n."""
    kb, _ = T._spmm_t_tiles(td, max(8, T._round_up(K, 8)))
    kp = T._round_up(K, kb)
    vt = np.zeros((kp, td.n_pad), np.float32)
    vt[:K, :td.n] = np.random.default_rng(seed).standard_normal((K, td.n))
    return vt


_j_pallas = jax.jit(functools.partial(J._spmm_dia_t_pallas, interpret=True))
_j_apply = jax.jit(j_mr._dia_apply_t)


def _check(got, want, bf16):
    got, want = _np(got), _np(want)
    if bf16:
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("name", ["poisson96", "orsirr_like24", "band"])
@pytest.mark.parametrize("K", [1, 7, 13, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_unpadded_apply_matches_jax_padded(name, K, bf16):
    """``_dia_apply_t`` on the unpadded iterate against the JAX Pallas
    kernel (interpret mode) on JAX's zero-padded buffer and against JAX's
    ``_dia_apply_t``; the port's output has the dtype of JAX's."""
    jd, td = _pair(name, bf16)
    vt = _iterate(td, K, seed=K)
    h = jd.halo
    jvt = jnp.asarray(vt).astype(jd.data.dtype)
    buf = jnp.zeros((vt.shape[0], h + jd.n_pad + h), jd.data.dtype).at[:, h:h + jd.n_pad] \
        .set(jvt)
    want = _j_pallas(jd, buf)
    got = t_mr._dia_apply_t(td, torch.as_tensor(vt))
    assert got.shape == tuple(want.shape) == vt.shape
    assert got.dtype == (BF if bf16 else torch.float32)
    _check(got, want, bf16)
    _check(got, _j_apply(jd, jvt), bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_unpadded_entry_equals_padded_entry(bf16):
    """``spmm_dia_t_rows`` on [K, n_pad] gives ``spmm_dia_t_padded``'s
    values on the same rows with zero halos, bit for bit (on the CPU both
    are the plain version; the card tests hold the kernel so)."""
    _, td = _pair("orsirr_like24", bf16)
    vt = torch.as_tensor(_iterate(td, 13, seed=3)).to(td.data.dtype)
    h = td.halo
    want = T.spmm_dia_t_padded(td, torch.nn.functional.pad(vt, (h, h)))
    got = T.spmm_dia_t_rows(td, vt)
    assert torch.equal(got, want)


def test_apply_hands_the_iterate_itself(monkeypatch):
    """``cg_multi``'s DIA apply makes no padded copy: on float32 diagonals
    ``spmm_dia_t_rows`` gets the iterate's own storage; on bf16 ones a
    rounded [K_pad, n_pad] copy, no wider."""
    seen = []

    def spy(d, xt):
        seen.append((xt.data_ptr(), tuple(xt.shape), xt.dtype))
        return T.spmm_dia_t_rows(d, xt)

    monkeypatch.setattr(t_mr, "spmm_dia_t_rows", spy)
    for bf16 in (False, True):
        _, td = _pair("poisson96", bf16)
        vt = torch.as_tensor(_iterate(td, 7, seed=1))
        t_mr._dia_apply_t(td, vt)
        ptr, shape, dtype = seen[-1]
        assert shape == tuple(vt.shape) and dtype == td.data.dtype
        assert (ptr == vt.data_ptr()) == (not bf16)


def _zero_dia(side):
    """Both packages' DIA of poisson``side``'s offsets and padded size with
    zero diagonals: the selection functions read only offsets, reach, halo
    and n_pad."""
    n = side * side
    offsets = (-side, -1, 0, 1, side)
    data = np.zeros((5, -(-n // 1024) * 1024), np.float32)
    return (J.DIA(data=jnp.asarray(data), offsets=offsets, shape=(n, n), nnz=0),
            T.DIA(data=torch.as_tensor(data), offsets=offsets, shape=(n, n), nnz=0))


@pytest.mark.parametrize("side,n_rhs,k_want", [(512, 2, 8), (128, 16, 8), (1024, 16, 1)])
def test_k14_k_at_the_smoke_shapes(side, n_rhs, k_want):
    """``jacobi_multirhs``'s fused k at ``chip_smoke.py``'s K14 shapes is
    JAX's: poisson512 with 2 right-hand sides and poisson128 with 16 fuse k
    8, poisson1024 with 16 k 1 (K14 runs any k as k passes)."""
    jd, td = _zero_dia(side)
    k, trk = j_st._pick_power_config(jd, 8, 16)
    while k > 1 and not J.dia_power_rhs_ok(jd, k, n_rhs, trk or J.dia_pp_tile(jd)):
        k //= 2
        trk = J.dia_power_tile(jd, k) if k > 1 else 0
    assert t_st._multirhs_config(td, 8, 16, n_rhs) == (k, trk)
    assert k == k_want


@pytest.mark.parametrize("k", [2, 3, 8])
@pytest.mark.parametrize("bf16", [False, True])
def test_k14_passes_compose(k, bf16):
    """K14's k passes as its CUDA entry runs them: the first pass reads the
    padded buffer's halo, every later one reads the last pass's rows as
    zero outside [0, n_pad).  Composed from k one-pass plain calls through
    zero-halo buffers, they give the k-pass plain version's bits, affine
    and not, on poisson96's Jacobi matrix (float32 and bf16 diagonals and
    buffers) with a halo of nonzero values in x."""
    _, td = _pair("poisson96", bf16)
    m = t_st.jacobi_iteration_matrix(td)
    dt = BF if bf16 else torch.float32
    gen = torch.Generator().manual_seed(k)
    xq = T.dia_pad_pp_rhs(m, torch.randn((5, m.n), generator=gen), tr=2 * m.halo)
    p = (xq.shape[1] - m.n_pad) // 2
    xq[:, :p] = torch.randn((5, p), generator=gen)          # read by the first pass only
    xq = xq.to(dt)
    cq = T.dia_pad_pp_rhs(m, torch.randn((5, m.n), generator=gen), tr=2 * m.halo).to(dt)
    for add in (None, cq):
        want = T.spmv_dia_power_rhs_ref(m, xq, torch.zeros_like(xq), scale=0.9, k=k, add=add)
        z = xq
        for _ in range(k):
            z = T.spmv_dia_power_rhs_ref(m, z, torch.zeros_like(xq), scale=0.9, k=1, add=add)
        assert z.dtype == dt and torch.equal(z, want)
