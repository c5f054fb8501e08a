"""PyTorch port vs the JAX package: the DIA format, the TPU VMEM selection
functions, and the plain versions of K8 (DIA SpMV), K12 (fused k-step
SpMV) and K13 (fused Chebyshev steps) against the Pallas kernels in
interpret mode, at the shapes of ``tests/test_ops.py``.

Tolerances: conversions and selection functions exact.  K8 rtol 2e-6,
atol 1e-5 (the Pallas kernel starts its sum at the main diagonal, the
plain version at zero in offset order: float32 rounding only).  K12 rtol
3e-6, atol 1e-4 and K13 rtol 3e-5, atol 1e-3, the bounds the JAX tests
hold the same kernels to against their own jnp recurrences (float32 over
k dependent passes).  The gradient of ``spmv_dia``: float64, rtol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.solvers import stationary as j_st
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.solvers import stationary as t_st
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery

CPU = "cpu"
K8_TOL = dict(rtol=2e-6, atol=1e-5)
K12_TOL = dict(rtol=3e-6, atol=1e-4)
K13_TOL = dict(rtol=3e-5, atol=1e-3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(data, offsets, n):
    """One DIA in both packages from the same host diagonals."""
    data = np.asarray(data)
    nnz = int((data != 0).sum())
    return (J.DIA(data=jnp.asarray(data), offsets=tuple(offsets), shape=(n, n), nnz=nnz),
            T.DIA(data=torch.as_tensor(data), offsets=tuple(offsets), shape=(n, n),
                  nnz=nnz))


def _poisson(k, n_pad=None):
    """5-point Laplacian on a k×k grid, float32 diagonals (test_ops.py)."""
    n = k * k
    n_pad = n_pad or -(-n // 1024) * 1024
    i = np.arange(n)
    r, c = i // k, i % k
    data = np.zeros((5, n_pad), np.float32)
    data[2, :n] = 4.0
    data[0, i[r > 0]] = -1.0
    data[1, i[c > 0]] = -1.0
    data[3, i[c < k - 1]] = -1.0
    data[4, i[r < k - 1]] = -1.0
    return _pair(data, (-k, -1, 0, 1, k), n)


@pytest.mark.parametrize("name", ["poisson32", "olm500_like", "LF10_like",
                                  "orsirr_like16"])
def test_conversions_match_jax(name):
    a = j_gallery.get(name)
    jd = J.coo_to_dia(a)
    td = T.coo_to_dia(t_gallery.get(name), device=CPU)
    assert td.offsets == jd.offsets and td.shape == jd.shape and td.nnz == jd.nnz
    assert (td.n_pad, td.halo) == (jd.n_pad, jd.halo)
    np.testing.assert_array_equal(_np(td.data), _np(jd.data))
    np.testing.assert_array_equal(_np(T.dia_transpose(td).data),
                                  _np(J.dia_transpose(jd).data))
    back_j, back_t = J.dia_to_coo(jd), T.dia_to_coo(td)
    for f in ("row", "col", "data"):
        np.testing.assert_array_equal(_np(getattr(back_t, f)), _np(getattr(back_j, f)))
    np.testing.assert_array_equal(_np(td.todense()), _np(jd.todense()))
    x = np.random.default_rng(1).standard_normal(td.n)
    tr = T.dia_pp_tile(td) or td.halo
    np.testing.assert_array_equal(_np(T.dia_pad_pp(td, torch.as_tensor(x))),
                                  _np(J.dia_pad_pp(jd, jnp.asarray(x))))
    np.testing.assert_array_equal(_np(T.dia_pad_x(td, torch.as_tensor(x))),
                                  _np(J.dia_pad_x(jd, jnp.asarray(x))))
    for k in (2, 3):
        np.testing.assert_array_equal(_np(T.dia_power_data(td, k, tr=tr)),
                                      _np(J.dia_power_data(jd, k, tr=tr)))


def _offsets_dia(name):
    """DIAs of the matrix's offsets and padded size (zero diagonals): the
    selection functions read only offsets, halo and n_pad."""
    a = t_gallery.get(name)
    offs = np.unique(a.col.astype(np.int64) - a.row.astype(np.int64))
    n = a.shape[0]
    n_pad = -(-n // 1024) * 1024
    return _pair(np.zeros((len(offs), n_pad), np.float32), offs.tolist(), n)


@pytest.mark.parametrize("name", ["poisson48", "poisson64", "poisson1000",
                                  "poisson1024", "orsirr_like150"])
def test_selection_functions_match_jax(name):
    jd, td = _offsets_dia(name)
    assert T.dia_pp_tile(td) == J.dia_pp_tile(jd)
    for k in (2, 3, 4, 8):
        tile = T.dia_power_tile(td, k)
        assert tile == J.dia_power_tile(jd, k)
        for tr in (None, tile):
            assert T.dia_power_ok(td, k, tr) == J.dia_power_ok(jd, k, tr)
            assert T.dia_power_stream_ok(td, k, tr) == J.dia_power_stream_ok(jd, k, tr)
        assert T.dia_cheby_ok(td, k) == J.dia_cheby_ok(jd, k)
    for sweeps in (4, 5, 16, 32):
        for fuse_k in (2, 8):
            assert (t_st._pick_power_config(td, fuse_k, sweeps)
                    == j_st._pick_power_config(jd, fuse_k, sweeps))


def test_selection_picks_the_slice_configs():
    """The fused k each harness row applies (Jacobi 16 sweeps fuse_k 8,
    Chebyshev degree 16 fuse_k 4) on the slice's matrices."""
    want = {"poisson48": (2, 2), "poisson64": (4, 4), "poisson1000": (1, 1),
            "poisson1024": (8, 2), "orsirr_like150": (1, 1)}
    for name, (kj, kc) in want.items():
        _, td = _offsets_dia(name)
        m = t_st.jacobi_iteration_matrix(td)
        assert t_st._pick_power_config(m, 8, 16)[0] == kj, name
        op = t_st.chebyshev_op(td, lmax=8.0, degree=16)
        assert op.info["k"] == kc, name
    _, td = _offsets_dia("poisson1024")
    assert t_st._pick_power_config(td, 8, 16) == (8, 65536)


def test_k8_plain_matches_pallas_interpret():
    jd, td = _poisson(64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(td.n).astype(np.float32)
    want_res = np.asarray(J._spmv_pallas(jd, J._pad_x(jd, jnp.asarray(x)),
                                         interpret=True))[:td.n]
    want_str = np.asarray(J._spmv_pallas_stream2(jd, J._pad_x(jd, jnp.asarray(x)),
                                                 interpret=True))[:td.n]
    got = T.spmv_dia(td, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want_res, **K8_TOL)
    np.testing.assert_allclose(got, want_str, **K8_TOL)
    # the padded entry point on the halo-padded buffer
    gotp = T.spmv_dia_padded(td, T.dia_pad_x(td, torch.as_tensor(x))).numpy()
    np.testing.assert_allclose(gotp[:td.n], want_res, **K8_TOL)
    assert not gotp[td.n:].any()


@pytest.mark.parametrize("affine", [False, True])
def test_k12_plain_matches_pallas_interpret_nondefault_tile(affine):
    """K12 at a tile other than the matrix's own (buffers at tr = 2048 on a
    4096-row tridiagonal with random diagonals): P comes from the shapes."""
    k, tr, n = 2, 2048, 4096
    rng = np.random.default_rng(11)
    jd, td = _pair(rng.standard_normal((3, n)).astype(np.float32), (-1, 0, 1), n)
    assert tr != T.dia_pp_tile(td)
    x = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32) if affine else None
    jxq = J.dia_pad_pp(jd, jnp.asarray(x), tr=tr)
    jcq = J.dia_pad_pp(jd, jnp.asarray(c), tr=tr) if affine else None
    dk = J.dia_power_data(jd, k, tr=tr)
    want = np.asarray(J._spmv_pallas_power(jd, dk, jxq, jnp.zeros_like(jxq),
                                           scale=0.3, k=k, cq=jcq, interpret=True))
    txq = T.dia_pad_pp(td, torch.as_tensor(x), tr=tr)
    tcq = T.dia_pad_pp(td, torch.as_tensor(c), tr=tr) if affine else None
    zq = torch.zeros_like(txq)
    got = T.spmv_dia_power(td, T.dia_power_data(td, k, tr=tr), txq, zq,
                           scale=0.3, k=k, add=tcq)
    assert got is zq
    np.testing.assert_allclose(got.numpy(), want, **K12_TOL)
    assert not got[:tr].any() and not got[tr + n:].any()


@pytest.mark.parametrize("k", [2, 3])
def test_k12_plain_matches_pallas_interpret_poisson(monkeypatch, k):
    """K12 on Poisson 256² (8 tiles of 8192 rows; the windows overlap), with
    and without the affine term."""
    jd, td = _poisson(256)
    monkeypatch.setattr(J, "dia_pp_tile", lambda dd: 8192)
    monkeypatch.setattr(T, "dia_pp_tile", lambda dd: 8192)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(td.n).astype(np.float32)
    c = rng.standard_normal(td.n).astype(np.float32)
    jxq, jcq = J.dia_pad_pp(jd, jnp.asarray(x)), J.dia_pad_pp(jd, jnp.asarray(c))
    dk = J.dia_power_data(jd, k)
    txq = T.dia_pad_pp(td, torch.as_tensor(x))
    tcq = T.dia_pad_pp(td, torch.as_tensor(c))
    for jadd, tadd in ((None, None), (jcq, tcq)):
        want = np.asarray(J._spmv_pallas_power(jd, dk, jxq, jnp.zeros_like(jxq),
                                               scale=0.3, k=k, cq=jadd,
                                               interpret=True))
        got = T.spmv_dia_power(td, None, txq, torch.zeros_like(txq), scale=0.3,
                               k=k, add=tadd).numpy()
        np.testing.assert_allclose(got, want, **K12_TOL)


def test_k13_plain_matches_pallas_interpret(monkeypatch):
    k = 3
    jd, td = _poisson(256)
    monkeypatch.setattr(J, "dia_pp_tile", lambda dd: 8192)
    monkeypatch.setattr(T, "dia_pp_tile", lambda dd: 8192)
    rng = np.random.default_rng(16)
    r = rng.standard_normal(td.n).astype(np.float32)
    dd0 = rng.standard_normal(td.n).astype(np.float32)
    z0 = rng.standard_normal(td.n).astype(np.float32)
    coeffs = tuple(t_st.chebyshev_coeffs(0.5, 8.0, k))
    assert coeffs == tuple(j_st.chebyshev_coeffs(0.5, 8.0, k))
    jq = lambda v: J.dia_pad_pp(jd, jnp.asarray(v))
    tq = lambda v: T.dia_pad_pp(td, torch.as_tensor(v))
    zo, ddo = J._spmv_pallas_cheby(jd, J.dia_power_data(jd, k), jq(z0), jq(dd0),
                                   jq(r), jq(np.zeros_like(r)), jq(np.zeros_like(r)),
                                   coeffs, k, interpret=True)
    z_dead, dd_dead = tq(np.zeros_like(r)), tq(np.zeros_like(r))
    gz, gdd = T.spmv_dia_cheby(td, None, tq(z0), tq(dd0), tq(r), z_dead, dd_dead,
                               coeffs, k)
    assert gz is z_dead and gdd is dd_dead
    np.testing.assert_allclose(gz.numpy(), np.asarray(zo), **K13_TOL)
    np.testing.assert_allclose(gdd.numpy(), np.asarray(ddo), **K13_TOL)
    # the public JAX fallback agrees on the same buffers
    zj, ddj = J.spmv_dia_cheby(jd, None, jq(z0), jq(dd0), jq(r), jq(0 * r),
                               jq(0 * r), coeffs, k)
    np.testing.assert_allclose(gz.numpy(), np.asarray(zj), **K13_TOL)
    np.testing.assert_allclose(gdd.numpy(), np.asarray(ddj), **K13_TOL)


def test_spmv_dia_gradient_matches_jax_grad():
    a = j_gallery.get("orsirr_like16")
    jd = J.coo_to_dia(a)
    td = T.coo_to_dia(t_gallery.get("orsirr_like16"), device=CPU)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(td.n)
    c = rng.standard_normal(td.n)

    def j_loss(data, x):
        import dataclasses
        return jnp.sum(jnp.asarray(c) * J.spmv_dia(dataclasses.replace(jd, data=data), x))

    jg_data, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jd.data, jnp.asarray(x))
    data = td.data.clone().requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    import dataclasses
    y = T.spmv_dia(dataclasses.replace(td, data=data), xt)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(J.spmv_dia(jd, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    (torch.as_tensor(c) * y).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(jg_data),
                               rtol=1e-12, atol=1e-12)


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take():
    """The checks that guard the CUDA launches, exercised on CPU tensors
    through the helpers (no card needed): float32 only, P ≥ halo."""
    _, td = _poisson(32)
    with pytest.raises(ValueError):
        T._check_cuda(td, "spmv_dia", torch.zeros(td.n))          # CPU tensors
    xq = torch.zeros(td.n_pad + 2 * 8)
    with pytest.raises(ValueError):
        T._check_pp(td, "spmv_dia_power", xq)                     # P < halo
    assert T._check_pp(td, "spmv_dia_power",
                       torch.zeros(td.n_pad + 2 * td.halo)) == td.halo
    # K12's Jacobi-16 call (k = 8, with c) on a 5-point grid of side R: the
    # rule fuses it in windows of 16 CTAs up to poisson2048 and streams
    # where no window fits (a 21504² grid)
    assert _rule(T._FUSED_AFFINE, 5, 8, 1024, 1 << 20) == (16, 5600)
    assert _rule(T._FUSED_AFFINE, 5, 8, 1792, 1792 ** 2) == (16, 5152)
    assert _rule(T._FUSED_AFFINE, 5, 8, 2048, 1 << 22) == (16, 4928)
    assert _rule(T._FUSED_AFFINE, 5, 8, 21504, 21504 ** 2) is None
    assert T._scratch(xq, td.n_pad, 0, 8).shape == (td.n_pad,)
    assert T._scratch(xq, td.n_pad, 0, 1) is None
    assert T._scratch(xq, td.n_pad, 4096, 8) is None
    # K8: its C entry's arguments; the skip path on wide bands whose
    # segments mostly hold only zeros (_K8_SKIP_RULE), reading flags of one
    # shape only
    assert len(T._ARGTYPES["dia_spmv"]) == 15
    assert not T._k8_skips(td) and T._k8_skips(_offsets_dia("orsirr_like150")[1])
    flags = T._flags(td)
    T._check_flags(td, flags, "spmv_dia")
    for bad in (flags[:-1], flags.to(torch.int32), flags.t()):
        with pytest.raises(ValueError, match="segment flags"):
            T._check_flags(td, bad, "spmv_dia")


# --- K12 / K13: the fused mode's window schedule and the selection rule ----

def _emulate_fused(d, kind, k, cluster, rows, src_q, *, scale=1.0, add=None,
                   ddq=None, rq=None, coeffs=()):
    """The window schedule of ``dia_fused_kernel`` (csrc/dia.cu) on the
    host: window w's CTAs stage their rows and a reach-wide halo of the
    input, run k passes, and after each pass take their neighbours'
    boundary rows; the halos beyond the window's two ends hold NaN (the
    kernel's zeros are never read into an output row).  Every pass computes
    every row of a CTA: the kernel's skipping of the rows outside the
    output rows' dependency cone is held only by the ``gpu`` tests (fused
    against streamed, bit for bit).  Sums in the working dtype, rounded to
    the buffers' at each store (bf16 diagonals or buffers: the 8-element
    staging of ``csrc/dia.cu``).  Returns the output interiors ([n_pad] z,
    and dd for K13)."""
    n_pad, p = d.n_pad, (src_q.shape[0] - d.n_pad) // 2
    elems = tuple(2 if t.dtype == torch.bfloat16 else 4 for t in (d.data, src_q))
    out, windows, _ = T._fused_geometry(kind, d.ndiags, k, d.reach, n_pad, cluster, rows,
                                        elems)
    al = T._fused_align(elems)
    rh = -(-d.reach // al) * al
    hk = -(-((k - 1) * d.reach) // al) * al
    vt = src_q.dtype                     # the buffers' dtype
    wt = T._acc_dtype(vt)                # the sums'
    data = torch.nn.functional.pad(d.data, (rows + hk, rows + hk + cluster * rows)).to(wt)
    at = lambda v, lo, n, vlo, vhi: torch.where(
        (torch.arange(lo, lo + n) >= vlo) & (torch.arange(lo, lo + n) < vhi),
        torch.nn.functional.pad(v, (rows + hk + rh, rows + hk + rh + cluster * rows))[
            p + lo + rows + hk + rh:p + lo + n + rows + hk + rh], 0.0)
    z_out, dd_out = torch.full((n_pad,), float("nan"), dtype=vt), None
    if kind == T._FUSED_CHEBY:
        dd_out = z_out.clone()
    for w in range(windows):
        row0 = [w * out - hk + r * rows for r in range(cluster)]
        cur = [at(src_q, r0 - rh, rows + 2 * rh, -p, n_pad + p) for r0 in row0]
        dd = [at(ddq, r0, rows, 0, n_pad) for r0 in row0] if ddq is not None else None
        for step in range(k):
            new = []
            for r, r0 in enumerate(row0):
                g = torch.arange(r0, r0 + rows)
                inside = (g >= 0) & (g < n_pad)
                acc = torch.zeros(rows, dtype=wt)
                for s, off in enumerate(d.offsets):
                    acc = acc + data[s, r0 + rows + hk:r0 + 2 * rows + hk] \
                        * cur[r][rh + off:rh + off + rows].to(wt)
                if kind == T._FUSED_CHEBY:
                    a, b = coeffs[step]
                    dn = (a * dd[r].to(wt) + b * (at(rq, r0, rows, 0, n_pad).to(wt) - acc)
                          ).to(vt)
                    v = cur[r][rh:rh + rows].to(wt) + dn.to(wt)
                    dd[r] = torch.where(inside, dn, 0.0)
                else:
                    v = acc * scale
                    if add is not None:
                        v = v + at(add, r0, rows, 0, n_pad).to(wt)
                nb = torch.full((rows + 2 * rh,), float("nan"), dtype=vt)
                nb[rh:rh + rows] = torch.where(inside, v, 0.0)
                new.append(nb)
            for r in range(cluster):
                if r > 0:
                    new[r][:rh] = new[r - 1][rows:rows + rh]
                if r < cluster - 1:
                    new[r][rh + rows:] = new[r + 1][rh:2 * rh]
            cur = new
        for r, r0 in enumerate(row0):
            lo, hi = max(r0, w * out), min(r0 + rows, w * out + out, n_pad)
            if hi > lo:
                z_out[lo:hi] = cur[r][rh + lo - r0:rh + hi - r0]
                if dd_out is not None:
                    dd_out[lo:hi] = dd[r][lo - r0:hi - r0]
    return z_out, dd_out


def _banded(n, offsets, seed, dtype=torch.float64):
    n_pad = -(-n // 1024) * 1024
    data = np.random.default_rng(seed).standard_normal((len(offsets), n_pad))
    data[:, n:] = 0.0
    return T.DIA(data=torch.as_tensor(data, dtype=dtype), offsets=tuple(offsets),
                 shape=(n, n), nnz=len(offsets) * n)


@pytest.mark.parametrize("offsets,n,k,cluster,rows", [
    ((-37, -1, 0, 2, 37), 3000, 3, 4, 160),     # n neither a multiple of S nor of the window
    ((-37, -1, 0, 2, 37), 3000, 2, 1, 1100),    # one CTA per window
    ((-5, 0, 13), 1500, 4, 2, 64),              # irregular offsets
    ((-50, 0, 50), 700, 8, 16, 64),             # the matrix inside one window
    ((-3, 0, 3), 200, 2, 1, 512),               # n smaller than one CTA's slice
])
@pytest.mark.parametrize("affine", [False, True])
def test_k12_fused_schedule_equals_plain(offsets, n, k, cluster, rows, affine):
    """The fused mode's windows, halos and output ranges give the plain
    version's rows exactly (float64, the same summation order), also with
    nonzero halo blocks in x (the first pass reads [-P, n_pad + P))."""
    d = _banded(n, offsets, seed=n + k)
    p = 2048
    rng = np.random.default_rng(k)
    xq = torch.as_tensor(rng.standard_normal(d.n_pad + 2 * p))
    add = torch.as_tensor(rng.standard_normal(d.n_pad + 2 * p)) if affine else None
    want = T.spmv_dia_power_ref(d, xq, torch.zeros_like(xq), scale=0.7, k=k, add=add)
    got, _ = _emulate_fused(d, T._FUSED_AFFINE if affine else T._FUSED_POWER, k,
                            cluster, rows, xq, scale=0.7, add=add)
    assert torch.equal(got, want[p:p + d.n_pad])


@pytest.mark.parametrize("offsets,n,k,cluster,rows", [
    ((-37, -1, 0, 2, 37), 3000, 2, 4, 160),
    ((-5, 0, 13), 1500, 4, 2, 64),
    ((-16, -1, 0, 1, 16), 256, 8, 1, 512),      # a coarse level smaller than one CTA
])
def test_k13_fused_schedule_equals_plain(offsets, n, k, cluster, rows):
    """As K12, for the Chebyshev steps: dd stays per row, z takes halos."""
    d = _banded(n, offsets, seed=n)
    p = 1024
    rng = np.random.default_rng(n)
    zq, ddq, rq = (torch.as_tensor(rng.standard_normal(d.n_pad + 2 * p)) for _ in range(3))
    coeffs = tuple(t_st.chebyshev_coeffs(0.3, 8.2, k))
    wz, wdd = T.spmv_dia_cheby_ref(d, zq, ddq, rq, torch.zeros_like(zq),
                                   torch.zeros_like(zq), coeffs, k)
    gz, gdd = _emulate_fused(d, T._FUSED_CHEBY, k, cluster, rows, zq, ddq=ddq, rq=rq,
                             coeffs=coeffs)
    assert torch.equal(gz, wz[p:p + d.n_pad]) and torch.equal(gdd, wdd[p:p + d.n_pad])



def _rule(kind, ndiags, k, reach, n_pad):
    """(cluster, rows) of the rule's fused plan on an H100, or None
    (the streamed mode)."""
    plan = T._fused_plan(kind, ndiags, k, reach, n_pad)
    return plan and (plan.cluster, plan.rows)


@pytest.mark.parametrize("kind,ndiags,k,reach,n_pad,want", [
    (T._FUSED_AFFINE, 5, 8, 1024, 1 << 20, (16, 5600)),      # poisson1024, Jacobi-16
    (T._FUSED_AFFINE, 5, 2, 1024, 1 << 20, (8, 4640)),       # poisson1024, Jacobi-4
    (T._FUSED_CHEBY, 5, 2, 1024, 1 << 20, (8, 4640)),        # poisson1024, Chebyshev
    (T._FUSED_AFFINE, 5, 8, 2048, 1 << 22, (16, 4928)),      # poisson2048, Jacobi-16
    (T._FUSED_AFFINE, 5, 4, 10_000, 1 << 20, None),          # reach 10,000: no window fits
    (T._FUSED_CHEBY, 5, 8, 256, 1 << 16, (16, 832)),         # Chebyshev V-cycle coarsest level
    (T._FUSED_AFFINE, 5, 8, 32, 32768, (1, 704)),            # Jacobi V-cycle coarsest level
    (T._FUSED_AFFINE, 5, 2, 128, 16384, None),               # poisson128 Jacobi-4: two launches
    (T._FUSED_AFFINE, 12, 8, 1024, 1 << 20, None),           # more than 9 diagonals stream
    # a 9-point damped-Jacobi M of a 2048² grid: its streamed passes exceed
    # the L2 and are priced at the HBM rate, so the rule fuses
    (T._FUSED_AFFINE, 9, 8, 2049, 1 << 22, (16, 3520)),
])
def test_fused_rule_answers(kind, ndiags, k, reach, n_pad, want):
    """The selection between K12's / K13's modes at the shapes that decide
    it, on an H100's co-resident clusters (the card's own count replaces
    them there)."""
    assert _rule(kind, ndiags, k, reach, n_pad) == want


@pytest.mark.parametrize("kind,ndiags,k,reach,n_pad", [
    (T._FUSED_POWER, 5, 8, 1024, 1 << 20), (T._FUSED_AFFINE, 3, 3, 37, 3072),
    (T._FUSED_CHEBY, 9, 4, 700, 61440), (T._FUSED_CHEBY, 5, 32, 16, 1024),
    (T._FUSED_AFFINE, 1, 2, 0, 1024), (T._FUSED_POWER, 7, 8, 4096, 1 << 21),
])
def test_fused_plan_is_a_launch_the_kernel_takes(kind, ndiags, k, reach, n_pad):
    """Every candidate the rule weighs fits a CTA's shared memory, owns a
    multiple of 32 rows (at least the halo in a cluster), and its windows
    cover n_pad; the rule fuses only below the streamed model, never at
    k = 1, and never without shared memory (the documented way to force
    the streamed mode)."""
    cands = list(T._fused_candidates(kind, ndiags, k, reach, n_pad, T._H100_ACTIVE,
                                     T._SMEM_BYTES))
    for c in cands:
        out, windows, smem = T._fused_geometry(kind, ndiags, k, reach, n_pad, c.cluster,
                                               c.rows)
        assert smem == c.smem <= T._SMEM_BYTES and c.rows % 32 == 0
        assert c.cluster == 1 or c.rows >= reach
        assert windows == c.windows and windows * out >= n_pad > (windows - 1) * out
    plan = T._fused_plan(kind, ndiags, k, reach, n_pad)
    assert plan is None or (plan in cands and plan.fused_us < plan.streamed_us
                            and plan.fused_us == min(c.fused_us for c in cands))
    assert T._fused_plan(kind, ndiags, 1, reach, n_pad) is None
    assert T._fused_plan(kind, ndiags, k, reach, n_pad, T._H100_ACTIVE, 0) is None


def test_offsets_tensor_is_made_with_the_matrix():
    """The kernels' int32 offsets exist once a DIA does, shared by every
    DIA of the same pattern (a copy, a transpose's transpose), so no kernel
    call copies from the host."""
    import dataclasses

    _, td = _poisson(24)
    assert td.offsets_t.dtype == torch.int32
    assert td.offsets_t.tolist() == list(td.offsets)
    assert dataclasses.replace(td, data=td.data * 2).offsets_t is td.offsets_t
    tt = T.dia_transpose(td)
    assert tt.offsets_t.tolist() == [-o for o in td.offsets]
    assert T.dia_transpose(tt).offsets_t is td.offsets_t
    m = t_st.jacobi_iteration_matrix(td)
    assert m.offsets_t is td.offsets_t
