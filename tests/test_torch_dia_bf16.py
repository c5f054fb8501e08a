"""PyTorch port vs the JAX package on bf16 diagonals (``dia_astype``).

The port's dtype rule (``gflownet_spai_tpu_torch/ops/dia.py``'s docstring):
outputs in promote(diagonals, vectors), the JAX jnp fallbacks' dtype, and
every product and sum in float32, each value rounded once where it is
stored.  The JAX Pallas kernels accumulate in bf16 instead, so:

- against the JAX Pallas kernels in interpret mode, on the inputs the JAX
  TPU path gives them (x cast to bf16 where JAX casts it): rtol 2e-2 and
  atol 2e-2·max|want|, ``tests/test_ops.py:786-790``'s bound for bf16
  diagonals;
- against float64 of the same bf16-rounded operands, tighter: on float32
  outputs (bf16 diagonals, float32 vectors) each element within
  FLOAT32_SUMS·eps32 of the sum of its terms' magnitudes per pass (what a
  float32 accumulation of them can be off by); on bf16 outputs within one
  bf16 rounding (2⁻⁸·|want|) plus that float32 slack, which a bf16
  accumulation would break;
- the fused schedule of K12 / K13 emulated on the host equals the plain
  version bit for bit, on bf16 diagonals with float32 and bf16 buffers;
- ``spmv_dia``'s gradient on bf16 diagonals against ``jax.grad``, the
  solvers on a bf16 matrix against the JAX package's, at the bf16 bound.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu.solvers import stationary as j_st
from gflownet_spai_tpu_torch import ops as t_ops
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.solvers import stationary as t_st
from test_torch_dia import _banded, _emulate_fused

BF = torch.bfloat16
JBF = jnp.bfloat16
EPS32 = 2.0 ** -24          # float32 unit roundoff
BF16_ROUND = 2.0 ** -8      # bf16 unit roundoff (8 significand bits)
FLOAT32_SUMS = 8            # float32 roundings an element's sum may carry, per pass


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == BF else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == JBF else x


def _dtype(x) -> str:
    """The dtype's name, for a torch tensor or a JAX / numpy array."""
    return str(x.dtype).removeprefix("torch.") if isinstance(x, torch.Tensor) \
        else np.dtype(x.dtype).name


def _oracle(got, want):
    """The JAX bf16 oracles' bound (``tests/test_ops.py:786-790``)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2 * np.abs(want).max())


def _pair(data, offsets, n):
    """One bf16 DIA in both packages from float32 host diagonals, through
    each package's ``dia_astype``."""
    data = np.asarray(data, np.float32)
    nnz = int((data != 0).sum())
    jd = J.DIA(data=jnp.asarray(data), offsets=tuple(offsets), shape=(n, n), nnz=nnz)
    td = T.DIA(data=torch.as_tensor(data), offsets=tuple(offsets), shape=(n, n), nnz=nnz)
    return J.dia_astype(jd, JBF), T.dia_astype(td, BF)


def _poisson(k):
    """5-point Laplacian on a k×k grid (exact in bf16)."""
    n = k * k
    i = np.arange(n)
    r, c = i // k, i % k
    data = np.zeros((5, -(-n // 1024) * 1024), np.float32)
    data[2, :n] = 4.0
    data[0, i[r > 0]] = data[1, i[c > 0]] = -1.0
    data[3, i[c < k - 1]] = data[4, i[r < k - 1]] = -1.0
    return _pair(data, (-k, -1, 0, 1, k), n)


def _random(n, offsets, seed, scale=0.2):
    """Random diagonals of a banded matrix, zero past n."""
    data = np.random.default_rng(seed).standard_normal((len(offsets), -(-n // 1024) * 1024))
    data[:, n:] = 0.0
    return _pair(scale * data, offsets, n)


def _rounded(x):
    """Host float32 values rounded to bf16 (as float32), through torch."""
    return torch.as_tensor(np.asarray(x, np.float32)).to(BF).float().numpy()


def _f64_rows(td, buf, start, rows):
    """float64 Σ_s data[s]·buf[start + off_s ...] along the last axis, and
    Σ_s |data[s]·buf[...]| (the bound's magnitude)."""
    data = td.data.double().numpy()
    buf = np.asarray(buf, np.float64)
    acc = np.zeros(buf.shape[:-1] + (rows,))
    mag = np.zeros_like(acc)
    for s, off in enumerate(td.offsets):
        t = data[s, :rows] * buf[..., start + off:start + off + rows]
        acc += t
        mag += np.abs(t)
    return acc, mag


def _hold64(got, want, mag, passes=1):
    """``got`` (float32 or bf16) against float64 ``want``: one bf16 rounding
    where ``got`` is bf16, and float32 sums' slack per pass."""
    rnd = BF16_ROUND if got.dtype == BF else 0.0
    got = _np(got).astype(np.float64)
    bound = rnd * np.abs(want) + passes * FLOAT32_SUMS * EPS32 * mag
    bad = np.abs(got - want) > bound
    assert not bad.any(), (f"{bad.sum()} elements off; worst "
                           f"{np.max(np.abs(got - want) - bound):.3e} over the bound")


def test_dia_astype_gives_jax_bits():
    """Round to nearest even, as JAX's astype, on random values and on
    exact ties (low 16 bits 0x8000, both parities of the kept bit)."""
    rng = np.random.default_rng(0)
    vals = rng.standard_normal((3, 2048)).astype(np.float32)
    bits = vals.view(np.uint32)
    bits[1, :512] = (bits[1, :512] & 0xFFFF0000) | 0x8000
    bits[1, 512:1024] = (bits[1, 512:1024] & 0xFFFE0000) | 0x18000
    jd, td = _pair(bits.view(np.float32), (-1, 0, 1), 2048)
    assert td.data.dtype == BF and jd.data.dtype == JBF
    np.testing.assert_array_equal(td.data.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jd.data).view(np.uint16))
    assert t_ops.dia_astype is T.dia_astype
    assert td.offsets_t.tolist() == [-1, 0, 1]
    back = T.dia_astype(td, torch.float32)
    assert back.data.dtype == torch.float32 and torch.equal(back.data, td.data.float())


def test_k8_matches_pallas_and_float64():
    """K8 (``_spmv_pallas`` and its two stream forms, x cast to bf16 as the
    TPU path casts it) against ``spmv_dia`` on float32 x (float32 out) and
    bf16 x (bf16 out), and ``spmv_dia_padded`` on ``dia_pad_x``'s bf16
    buffer; output dtypes as JAX's jnp path."""
    jd, td = _poisson(64)
    n = td.n
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    jxb = J._pad_x(jd, jnp.asarray(x).astype(JBF))
    wants = [np.asarray(J._spmv_pallas(jd, jxb, interpret=True))[:n],
             np.asarray(J._spmv_pallas_stream2(jd, jxb, interpret=True))[:n],
             np.asarray(J._spmv_pallas_stream(
                 jd, jnp.pad(jnp.asarray(x).astype(JBF), (0, jd.n_pad - n)),
                 interpret=True))[:n]]
    y32 = T.spmv_dia(td, torch.as_tensor(x))
    y16 = T.spmv_dia(td, torch.as_tensor(x).to(BF))
    yp = T.spmv_dia_padded(td, T.dia_pad_x(td, torch.as_tensor(x)))
    for want in wants:
        for got in (y32, y16, yp[:n]):
            _oracle(got, want)
    assert _dtype(y32) == _dtype(J.spmv_dia(jd, jnp.asarray(x))) == "float32"
    assert _dtype(y16) == _dtype(J.spmv_dia(jd, jnp.asarray(x).astype(JBF))) == "bfloat16"
    assert yp.dtype == BF and T.dia_pad_x(td, torch.as_tensor(x)).dtype == BF
    h = td.halo
    want, mag = _f64_rows(td, np.pad(x, (h, td.n_pad - n + h)), h, n)
    _hold64(y32, want, mag)
    xr = _rounded(x)
    want, mag = _f64_rows(td, np.pad(xr, (h, td.n_pad - n + h)), h, n)
    _hold64(y16, want, mag)


def test_k8_many_diagonals_float64():
    """K8's plain version on a 9-diagonal random band (reach 300) against
    float64, float32 and bf16 x."""
    _, td = _random(5000, (-300, -41, -7, -1, 0, 1, 7, 41, 300), seed=3)
    x = np.random.default_rng(4).standard_normal(td.n).astype(np.float32)
    h = td.halo
    for xt, xv in ((torch.as_tensor(x), x), (torch.as_tensor(x).to(BF), _rounded(x))):
        want, mag = _f64_rows(td, np.pad(xv, (h, td.n_pad - td.n + h)), h, td.n)
        _hold64(T.spmv_dia(td, xt), want, mag)


def test_k10_k11_match_pallas_and_float64():
    """K10 on ``dia_pad_io``'s bf16 buffer against ``_spmv_pallas_io`` and
    its stream form, K11 on bf16 ping-pong buffers against
    ``_spmv_pallas_pp`` / ``_pp_stream`` (JAX's K11 refuses float32 buffers
    with bf16 diagonals); both on float32 buffers against JAX's public
    fallback and float64.  Halo blocks zero / untouched."""
    jd, td = _poisson(64)
    n, n_pad = td.n, td.n_pad
    x = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    jio, tio = J.dia_pad_io(jd, jnp.asarray(x)), T.dia_pad_io(td, torch.as_tensor(x))
    assert tio.dtype == BF and jio.dtype == JBF
    got = T.spmv_dia_padded_io(td, tio, scale=0.2)
    assert got.dtype == BF
    p = (tio.shape[0] - n_pad) // 2
    assert not got[:p].any() and not got[p + n_pad:].any()
    for want in (J._spmv_pallas_io(jd, jio, scale=0.2, interpret=True),
                 J._spmv_pallas_io_stream(jd, jio, scale=0.2, interpret=True)):
        _oracle(got, want)
    want, mag = _f64_rows(td, _np(tio), p, n_pad)
    _hold64(got[p:p + n_pad], 0.2 * want, 0.2 * mag)
    # float32 buffer: promote, as the jnp fallback
    x32 = torch.zeros(tio.shape)
    x32[p:p + n] = torch.as_tensor(x)
    got32 = T.spmv_dia_padded_io(td, x32, scale=0.2)
    jwant = J.spmv_dia_padded_io(jd, jnp.asarray(x32.numpy()), scale=0.2)
    assert _dtype(got32) == _dtype(jwant) == "float32"
    _oracle(got32, jwant)
    want, mag = _f64_rows(td, x32.numpy(), p, n_pad)
    _hold64(got32[p:p + n_pad], 0.2 * want, 0.2 * mag)

    # K11
    jpp = J.dia_pad_pp(jd, jnp.asarray(x).astype(JBF))
    tpp = T.dia_pad_pp(td, torch.as_tensor(x).to(BF))
    assert tpp.dtype == BF and jpp.dtype == JBF
    p = (tpp.shape[0] - n_pad) // 2
    yq = torch.full_like(tpp, 3.0)
    got = T.spmv_dia_pingpong(td, tpp, yq, scale=0.2)
    assert got is yq and (got[:p] == 3.0).all() and (got[p + n_pad:] == 3.0).all()
    for want in (J._spmv_pallas_pp(jd, jpp, jnp.zeros_like(jpp), scale=0.2, interpret=True),
                 J._spmv_pallas_pp_stream(jd, jpp, jnp.zeros_like(jpp), scale=0.2,
                                          interpret=True)):
        _oracle(got[p:p + n_pad], np.asarray(want)[p:p + n_pad])
    want, mag = _f64_rows(td, _np(tpp), p, n_pad)
    _hold64(got[p:p + n_pad], 0.2 * want, 0.2 * mag)
    t32 = T.dia_pad_pp(td, torch.as_tensor(x))
    assert t32.dtype == torch.float32            # dia_pad_pp promotes
    got32 = T.spmv_dia_pingpong(td, t32, torch.zeros_like(t32), scale=0.2)
    j32 = J.dia_pad_pp(jd, jnp.asarray(x))
    _oracle(got32, J.spmv_dia_pingpong(jd, j32, jnp.zeros_like(j32), scale=0.2))
    want, mag = _f64_rows(td, t32.numpy(), p, n_pad)
    _hold64(got32[p:p + n_pad], 0.2 * want, 0.2 * mag)


def _power64(td, xq, k, scale, add=None, rnd=None):
    """float64 k affine passes of K12 / K14 along the last axis (each pass
    rounded by ``rnd`` when given), and the largest per-pass magnitude."""
    p = (xq.shape[-1] - td.n_pad) // 2
    h = td.halo
    cur = np.asarray(xq, np.float64)[..., p - h:p + td.n_pad + h]
    mag_max = np.zeros(cur.shape[:-1] + (td.n_pad,))
    for _ in range(k):
        acc, mag = _f64_rows(td, cur, h, td.n_pad)
        acc *= scale
        mag *= abs(scale)
        if add is not None:
            a = np.asarray(add, np.float64)[..., p:p + td.n_pad]
            acc += a
            mag += np.abs(a)
        if rnd is not None:
            acc = rnd(acc)
        mag_max = np.maximum(mag_max, mag)
        cur = np.pad(acc, [(0, 0)] * (acc.ndim - 1) + [(h, h)])
    return cur[..., h:h + td.n_pad], mag_max


@pytest.mark.parametrize("k,n,tr", [(2, 4096, 2048), (4, 16384, 8192)])
@pytest.mark.parametrize("affine", [False, True])
def test_k12_matches_pallas_and_float64(k, n, tr, affine):
    """K12 on a random tridiagonal (n 4096, tr 2048 at k 2, as
    ``test_ops``'s bf16 oracle; two tiles of 8192 at k 4): both Pallas
    forms (resident and streamed) on float32 buffers (``dia_astype``'s
    case) and on bf16 buffers (``jacobi_sweeps_op``'s), against the plain
    version; float32 buffers also against float64."""
    jd, td = _random(n, (-1, 0, 1), seed=14)
    rng = np.random.default_rng(k)
    x = rng.standard_normal(n).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32) if affine else None
    dk = J.dia_power_data(jd, k, tr=tr)
    assert dk.dtype == JBF
    for vt, jvt in ((torch.float32, jnp.float32), (BF, JBF)):
        jxq = J.dia_pad_pp(jd, jnp.asarray(x).astype(jvt), tr=tr)
        jcq = J.dia_pad_pp(jd, jnp.asarray(c).astype(jvt), tr=tr) if affine else None
        txq = T.dia_pad_pp(td, torch.as_tensor(x).to(vt), tr=tr)
        tcq = T.dia_pad_pp(td, torch.as_tensor(c).to(vt), tr=tr) if affine else None
        assert txq.dtype == vt
        got = T.spmv_dia_power(td, None, txq, torch.zeros_like(txq), scale=0.3, k=k,
                               add=tcq)
        assert got.dtype == vt
        assert _dtype(got) == _dtype(J.spmv_dia_power(jd, dk, jxq, jnp.zeros_like(jxq),
                                                      scale=0.3, k=k, add=jcq))
        for fn in (J._spmv_pallas_power, J._spmv_pallas_power_stream):
            _oracle(got, fn(jd, dk, jxq, jnp.zeros_like(jxq), scale=0.3, k=k, cq=jcq,
                            interpret=True))
        assert not got[:tr].any() and not got[tr + n:].any()
    xq32 = T.dia_pad_pp(td, torch.as_tensor(x), tr=tr)
    cq32 = T.dia_pad_pp(td, torch.as_tensor(c), tr=tr) if affine else None
    got32 = T.spmv_dia_power(td, None, xq32, torch.zeros_like(xq32), scale=0.3, k=k,
                             add=cq32)
    want, mag = _power64(td, xq32.numpy(), k, 0.3, None if c is None else cq32.numpy())
    _hold64(got32[tr:tr + n], want, mag, passes=k)


def test_k12_bf16_buffers_round_each_pass():
    """On bf16 buffers each pass is rounded to bf16: the plain version
    equals a float64 recurrence rounded to bf16 after every pass, pass by
    pass, within one bf16 rounding of the float32 sums' slack (k = 1), and
    with k passes it differs from the float32-buffer result by the
    roundings (nonzero) while staying inside the bf16 bound."""
    n = 4096
    _, td = _random(n, (-1, 0, 1), seed=15)
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    xq = T.dia_pad_pp(td, torch.as_tensor(x).to(BF))
    got1 = T.spmv_dia_power(td, None, xq, torch.zeros_like(xq), scale=0.3, k=1)
    p = (xq.shape[0] - td.n_pad) // 2
    want, mag = _power64(td, _np(xq), 1, 0.3)
    _hold64(got1[p:p + td.n_pad], want, mag)
    got4 = T.spmv_dia_power(td, None, xq, torch.zeros_like(xq), scale=0.3, k=4)
    step = xq
    for _ in range(4):
        step = T.spmv_dia_power(td, None, step, torch.zeros_like(xq), scale=0.3, k=1)
    assert torch.equal(got4, step)                  # k passes = k rounded single passes
    g32 = T.spmv_dia_power(td, None, xq.float(), torch.zeros(xq.shape), scale=0.3, k=4)
    assert not torch.equal(got4.float(), g32)
    _oracle(got4, g32)


def test_k13_matches_pallas_and_float64():
    """K13 on bf16 buffers against ``_spmv_pallas_cheby`` (JAX's K13
    refuses float32 buffers with bf16 diagonals) and, on float32 buffers,
    against JAX's public fallback and float64."""
    k = 3
    jd, td = _random(4096, (-1, 0, 1), seed=16)
    n = td.n
    rng = np.random.default_rng(16)
    r, dd0, z0 = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    coeffs = tuple(t_st.chebyshev_coeffs(0.3, 1.2, k))
    jq = lambda v, dt: J.dia_pad_pp(jd, jnp.asarray(v).astype(dt))
    tq = lambda v, dt: T.dia_pad_pp(td, torch.as_tensor(v).to(dt))
    zo, ddo = J._spmv_pallas_cheby(jd, J.dia_power_data(jd, k), jq(z0, JBF), jq(dd0, JBF),
                                   jq(r, JBF), jq(0 * r, JBF), jq(0 * r, JBF), coeffs, k,
                                   interpret=True)
    gz, gdd = T.spmv_dia_cheby(td, None, tq(z0, BF), tq(dd0, BF), tq(r, BF), tq(0 * r, BF),
                               tq(0 * r, BF), coeffs, k)
    assert gz.dtype == gdd.dtype == BF
    _oracle(gz, zo)
    _oracle(gdd, ddo)
    bufs = [tq(v, torch.float32) for v in (z0, dd0, r, 0 * r, 0 * r)]
    gz, gdd = T.spmv_dia_cheby(td, None, *bufs, coeffs, k)
    jz, jdd = J.spmv_dia_cheby(jd, None, *(jq(v, jnp.float32) for v in (z0, dd0, r, 0 * r,
                                                                       0 * r)), coeffs, k)
    assert _dtype(gz) == _dtype(jz) == "float32"
    _oracle(gz, jz)
    _oracle(gdd, jdd)
    # float64 recurrence on the same operands
    p = (bufs[0].shape[0] - td.n_pad) // 2
    h = td.halo
    z = bufs[0].double().numpy()[p - h:p + td.n_pad + h]
    dd = bufs[1].double().numpy()[p:p + td.n_pad]
    rr = bufs[2].double().numpy()[p:p + td.n_pad]
    mag_max = np.zeros(td.n_pad)
    for a, b in coeffs:
        t, mag = _f64_rows(td, z, h, td.n_pad)
        dd = a * dd + b * (rr - t)
        z = np.pad(z[h:h + td.n_pad] + dd, (h, h))
        mag_max = np.maximum(mag_max, np.abs(b) * mag + np.abs(a * dd) + np.abs(z[h:-h]))
    _hold64(gz[p:p + td.n_pad], z[h:h + td.n_pad], mag_max, passes=k)
    _hold64(gdd[p:p + td.n_pad], dd, mag_max, passes=k)


@pytest.mark.parametrize("k,K", [(1, 8), (2, 8), (8, 3)])
def test_k14_matches_pallas_and_float64(k, K):
    """K14 at k 1, 2 and 8 (tr 2048 on n 4096, windows overlapping by
    k − 1 halos; k 8 on n 16384 at tr 8192) on float32 and bf16 buffers
    against ``_spmv_pallas_power_rhs``; float32 buffers against float64."""
    n, tr = (16384, 8192) if k == 8 else (4096, 2048)
    jd, td = _random(n, (-1, 0, 1), seed=12 + k)
    rng = np.random.default_rng(20 + k)
    X = rng.standard_normal((K, n)).astype(np.float32)
    C = rng.standard_normal((K, n)).astype(np.float32)
    dk = J.dia_power_data(jd, k, tr=tr)
    for vt, jvt in ((torch.float32, jnp.float32), (BF, JBF)):
        jxq = J.dia_pad_pp_rhs(jd, jnp.asarray(X).astype(jvt), tr=tr)
        jcq = J.dia_pad_pp_rhs(jd, jnp.asarray(C).astype(jvt), tr=tr)
        txq = T.dia_pad_pp_rhs(td, torch.as_tensor(X).to(vt), tr=tr)
        tcq = T.dia_pad_pp_rhs(td, torch.as_tensor(C).to(vt), tr=tr)
        got = T.spmv_dia_power_rhs(td, None, txq, torch.zeros_like(txq), scale=0.3, k=k,
                                   add=tcq)
        want = J._spmv_pallas_power_rhs(jd, dk, jxq, jnp.zeros_like(jxq), scale=0.3, k=k,
                                        cq=jcq, interpret=True)
        assert got.dtype == vt and _dtype(got) == _dtype(want)
        _oracle(got, want)
        assert not got[:, :tr].any() and not got[:, tr + n:].any()
        if vt == torch.float32:
            w64, mag = _power64(td, txq.numpy(), k, 0.3, tcq.numpy())
            _hold64(got[:, tr:tr + n], w64[:, :n], mag[:, :n], passes=k)


def test_k15_matches_pallas_and_float64(monkeypatch):
    """K15 on Poisson 64² with X [4096, 256] in bf16 (the Pallas kernel
    takes X in the diagonals' dtype) over a grid of 4 row × 2 column tiles,
    against ``spmm_dia`` on bf16 X (bf16 out) and on its float32 copy
    (float32 out); float64 of the same operands."""
    jd, td = _poisson(64)
    x = _rounded(np.random.default_rng(0).standard_normal((td.n, 256)))
    monkeypatch.setattr(J, "_MAX_VMEM_BYTES", (2 * (1024 + 2 * jd.halo) * 128
                                               + 2 * 5 * 1024 + 2 * 1024 * 128 + 64) * 4)
    want = np.asarray(J._spmm_dia_pallas(jd, jnp.asarray(x).astype(JBF),
                                         interpret=True))[:td.n]
    g16 = T.spmm_dia(td, torch.as_tensor(x).to(BF))
    g32 = T.spmm_dia(td, torch.as_tensor(x))
    assert g16.dtype == BF and g32.dtype == torch.float32
    assert _dtype(J.spmm_dia(jd, jnp.asarray(x))) == "float32"
    _oracle(g16, want)
    _oracle(g32, want)
    h = td.halo
    w64, mag = _f64_rows(td, np.pad(x.T, ((0, 0), (h, td.n_pad - td.n + h))), h, td.n)
    _hold64(g16.T, w64, mag)
    _hold64(g32.T, w64, mag)


def test_k16_matches_pallas_and_float64():
    """K16 on ``dia_pad_xt``'s bf16 buffer against ``_spmm_dia_t_pallas``;
    ``spmm_dia_t`` on float32 Xt keeps float32 (as JAX's jnp path) and
    equals float64 within float32 sums."""
    jd, td = _poisson(64)
    xt = np.random.default_rng(1).standard_normal((13, td.n)).astype(np.float32)
    jxtp, txtp = J.dia_pad_xt(jd, jnp.asarray(xt)), T.dia_pad_xt(td, torch.as_tensor(xt))
    assert txtp.dtype == BF and jxtp.dtype == JBF and txtp.shape == jxtp.shape
    got = T.spmm_dia_t_padded(td, txtp)
    _oracle(got, J._spmm_dia_t_pallas(jd, jxtp, interpret=True))
    h = td.halo
    w64, mag = _f64_rows(td, _np(txtp), h, td.n_pad)
    _hold64(got, w64, mag)
    g32 = T.spmm_dia_t(td, torch.as_tensor(xt))
    j32 = J.spmm_dia_t(jd, jnp.asarray(xt))
    assert _dtype(g32) == _dtype(j32) == "float32"
    _oracle(g32, j32)
    w64, mag = _f64_rows(td, np.pad(xt, ((0, 0), (h, td.n_pad - td.n + h))), h, td.n)
    _hold64(g32, w64, mag)


@pytest.mark.parametrize("offsets,n,k,cluster,rows", [
    ((-37, -1, 0, 2, 37), 3000, 3, 4, 160),
    ((-37, -1, 0, 2, 37), 3000, 2, 1, 1104),
    ((-5, 0, 13), 1500, 4, 2, 64),
    ((-50, 0, 50), 700, 8, 16, 64),
])
@pytest.mark.parametrize("vt", [torch.float32, BF])
@pytest.mark.parametrize("kind", ["power", "affine", "cheby"])
def test_fused_schedule_on_bf16_diagonals_equals_plain(offsets, n, k, cluster, rows, vt,
                                                       kind):
    """The fused mode's windows (8-element staging on bf16), halos and
    output ranges give the plain version's rows bit for bit on bf16
    diagonals, with float32 buffers and with bf16 buffers (every pass
    rounded to bf16 at its store)."""
    d = _banded(n, offsets, seed=n + k, dtype=BF)
    p = 2048
    rng = np.random.default_rng(k)
    q = lambda: torch.as_tensor(rng.standard_normal(d.n_pad + 2 * p)).to(vt)
    xq = q()
    if kind == "cheby":
        ddq, rq = q(), q()
        coeffs = tuple(t_st.chebyshev_coeffs(0.3, 8.2, k))
        wz, wdd = T.spmv_dia_cheby_ref(d, xq, ddq, rq, torch.zeros_like(xq),
                                       torch.zeros_like(xq), coeffs, k)
        gz, gdd = _emulate_fused(d, T._FUSED_CHEBY, k, cluster, rows, xq, ddq=ddq, rq=rq,
                                 coeffs=coeffs)
        assert torch.equal(gz, wz[p:p + d.n_pad]) and torch.equal(gdd, wdd[p:p + d.n_pad])
        return
    add = q() if kind == "affine" else None
    want = T.spmv_dia_power_ref(d, xq, torch.zeros_like(xq), scale=0.7, k=k, add=add)
    got, _ = _emulate_fused(d, T._FUSED_AFFINE if add is not None else T._FUSED_POWER, k,
                            cluster, rows, xq, scale=0.7, add=add)
    assert got.dtype == want.dtype == vt
    assert torch.equal(got, want[p:p + d.n_pad])


def test_spmv_dia_gradient_matches_jax_grad():
    """``spmv_dia`` on bf16 diagonals and float32 x: the value and the
    gradients in x (float32) and in the diagonals (JAX returns them in
    float32, autograd in the diagonals' bf16) against ``jax.grad``."""
    jd, td = _random(3000, (-40, -1, 0, 3, 40), seed=7, scale=1.0)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(td.n).astype(np.float32)
    c = rng.standard_normal(td.n).astype(np.float32)

    def j_loss(data, x):
        return jnp.sum(jnp.asarray(c) * J.spmv_dia(dataclasses.replace(jd, data=data), x))

    jg_data, jg_x = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jd.data, jnp.asarray(x))
    data = td.data.clone().requires_grad_(True)
    xt = torch.as_tensor(x).requires_grad_(True)
    y = T.spmv_dia(dataclasses.replace(td, data=data), xt)
    assert y.dtype == torch.float32
    _oracle(y.detach(), J.spmv_dia(jd, jnp.asarray(x)))
    (torch.as_tensor(c) * y).sum().backward()
    assert xt.grad.dtype == torch.float32 and data.grad.dtype == BF
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(data.grad), _rounded(jg_data), rtol=2 ** -7, atol=1e-6)


def test_solvers_on_a_bf16_matrix_match_jax():
    """``jacobi_sweeps_op`` (K12 on bf16 buffers), ``chebyshev_op`` (K13 on
    bf16 buffers) and ``jacobi_multirhs`` (K14, K16) on a bf16 copy of
    poisson64 against the JAX package's, at the bf16 oracles' bound, with
    the same fused k; each within the bound of the float32 operator too."""
    jd, td = _poisson(64)
    j32 = J.DIA(data=jd.data.astype(jnp.float32), offsets=jd.offsets, shape=jd.shape,
                nnz=jd.nnz)
    rng = np.random.default_rng(8)
    r = rng.standard_normal(td.n).astype(np.float32)
    jop, top = j_st.jacobi_sweeps_op(jd, sweeps=16), t_st.jacobi_sweeps_op(td, sweeps=16)
    assert top.info["k"] == jop.fn.keywords["k"] > 1
    assert top.info["sweeps"] == 2 * jop.fn.keywords["pairs"] * jop.fn.keywords["k"]
    got = top(torch.as_tensor(r))
    assert got.dtype == torch.float32
    _oracle(got, jop(jnp.asarray(r)))
    _oracle(got, j_st.jacobi_sweeps_op(j32, sweeps=16)(jnp.asarray(r)))
    jc = j_st.chebyshev_op(jd, lmax=8.0, degree=16)
    tc = t_st.chebyshev_op(td, lmax=8.0, degree=16)
    assert tc.info["k"] == jc.fn.keywords["k"] > 1
    got = tc(torch.as_tensor(r))
    _oracle(got, jc(jnp.asarray(r)))
    _oracle(got, j_st.chebyshev_op(j32, lmax=8.0, degree=16)(jnp.asarray(r)))
    B = rng.standard_normal((3, td.n)).astype(np.float32)
    tm = t_st.jacobi_multirhs(td, torch.as_tensor(B), iters=16)
    jm = j_st.jacobi_multirhs(jd, jnp.asarray(B), iters=16)
    assert tm.iterations == jm.iterations
    assert tm.x.dtype == BF and tm.residual.dtype == BF
    _oracle(tm.x, jm.x)
    _oracle(tm.residual, jm.residual)


def test_kernel_dtypes():
    """The dtype rule the CUDA wrappers enforce (``_kernel_types``):
    (float32, float32), (bf16, float32), (bf16, bf16) are taken; float16,
    float64 and mixed buffers raise, naming the dtypes; a bf16 vector on
    float32 diagonals is promoted first by the entry points that return a
    new tensor."""
    _, tb = _poisson(32)
    t32 = T.dia_astype(tb, torch.float32)
    v = lambda dt: torch.zeros(8, dtype=dt)
    assert T._kernel_types(t32, "k", v(torch.float32)) == 0
    assert T._kernel_types(tb, "k", v(torch.float32), v(torch.float32)) == 1
    assert T._kernel_types(tb, "k", v(BF), v(BF), v(BF)) == 2
    for d, bufs in ((t32, (v(BF),)), (tb, (v(torch.float16),)), (tb, (v(torch.float64),)),
                    (T.dia_astype(tb, torch.float16), (v(torch.float32),)),
                    (T.dia_astype(tb, torch.float64), (v(torch.float64),)),
                    (tb, (v(BF), v(torch.float32))), (t32, (v(torch.float32), v(BF)))):
        with pytest.raises(ValueError, match="diagonals torch"):
            T._kernel_types(d, "k", *bufs)
    assert T._promoted(t32, v(BF)).dtype == torch.float32
    assert T._promoted(tb, v(BF)).dtype == BF
    assert T._promoted(tb, v(torch.float32)).dtype == torch.float32
    with pytest.raises(ValueError):
        T._check_cuda(tb, "spmv_dia", torch.zeros(tb.n, dtype=BF))   # CPU tensors


@pytest.mark.parametrize("kind,ndiags,k,reach,n_pad", [
    (T._FUSED_AFFINE, 5, 8, 1024, 1 << 20), (T._FUSED_POWER, 5, 2, 1024, 1 << 20),
    (T._FUSED_CHEBY, 5, 2, 1024, 1 << 20), (T._FUSED_AFFINE, 3, 3, 37, 3072),
    (T._FUSED_CHEBY, 9, 4, 700, 61440), (T._FUSED_AFFINE, 5, 8, 32, 32768),
    (T._FUSED_AFFINE, 9, 8, 2049, 1 << 22),
])
@pytest.mark.parametrize("types", [1, 2])
def test_fused_plan_on_bf16_is_a_launch_the_kernel_takes(kind, ndiags, k, reach, n_pad,
                                                         types):
    """On bf16 diagonals (float32 or bf16 buffers) every candidate fits a
    CTA's shared memory with 8-element staging (rows a multiple of 32, at
    least the halo in a cluster, windows covering n_pad); a CTA holds at
    least as many rows as on float32, and the rule fuses only below its
    streamed model."""
    elems = T._ELEMS[types]
    assert T._fused_align(elems) == 8
    cands = list(T._fused_candidates(kind, ndiags, k, reach, n_pad, T._H100_ACTIVE,
                                     T._SMEM_BYTES, elems))
    f32 = {c.cluster: c.rows for c in T._fused_candidates(
        kind, ndiags, k, reach, n_pad, T._H100_ACTIVE, T._SMEM_BYTES)}
    assert cands
    for c in cands:
        out, windows, smem = T._fused_geometry(kind, ndiags, k, reach, n_pad, c.cluster,
                                               c.rows, elems)
        assert smem == c.smem <= T._SMEM_BYTES and c.rows % 32 == 0
        assert c.cluster == 1 or c.rows >= reach
        assert windows == c.windows and windows * out >= n_pad > (windows - 1) * out
    assert max(c.rows for c in cands) > max(f32.values())
    plan = T._fused_plan(kind, ndiags, k, reach, n_pad, T._H100_ACTIVE, T._SMEM_BYTES,
                         elems)
    assert plan is None or (plan in cands and plan.fused_us < plan.streamed_us)
