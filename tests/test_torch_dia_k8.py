"""K8's segment flags and the semantics its skipping keeps, on the CPU.

K8's skip path (``csrc/dia.cu``) reads a diagonal only in the row tiles
where the matrix's segment flags (``ops/dia._segment_flags``, made with a
DIA that K8's rule sends to that path, else on demand by ``_flags``) say
the segment holds a word other than zero, and applies the skipped terms
fma(+-0.0, x[j], acc) only where they can change acc.  These tests hold
the rule against the matrices' share of entries, and the flags against a
numpy reckoning from
the COO pattern and from the stored words, through every way the port
makes a DIA, and the version check that makes them again after an
in-place write; and hold the port's ``spmv_dia`` against JAX's
``spmv_dia_jnp`` with inf and NaN in x placed where only stored zeros
reach them: NaN in the same rows, the rest within ``K8_TOL`` (float32
sums in another order).  The kernel itself, and its bits against the
one-thread-per-row kernel, are held on the card (``test_torch_gpu.py``,
``chip_smoke.py``, ``examples/k8_compare_torch.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import dia as J
from gflownet_spai_tpu_torch.ops import dia as T
from gflownet_spai_tpu_torch.solvers import multigrid as t_mg
from gflownet_spai_tpu_torch.solvers import stationary as t_st
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery

K8_TOL = dict(rtol=2e-6, atol=1e-5)
R = T._FLAG_ROWS
BF16 = torch.bfloat16
MATRICES = ["orsirr_like24", "poisson96", "banded ragged"]


def _banded_ragged():
    """A band whose last tile is ragged (n_pad 1000, not a multiple of the
    tile), with an offset beyond n (a diagonal that stores no word of the
    matrix) and a long-range diagonal holding three entries."""
    n = 1000
    rng = np.random.default_rng(11)
    offsets = (-700, -2, 0, 3, 1500)
    data = np.zeros((len(offsets), n), np.float32)
    i = np.arange(n)
    for s, off in enumerate(offsets):
        ok = (i + off >= 0) & (i + off < n)
        if abs(off) < 10:
            data[s, ok] = rng.uniform(0.5, 1.5, int(ok.sum()))
    data[0, [700, 850, 999]] = (0.25, -0.5, 2.0)
    return data, offsets, n


def _case(name):
    """(host diagonals [ndiags, n_pad] float32, offsets, n) of a test matrix."""
    if name == "banded ragged":
        return _banded_ragged()
    a = t_gallery.get(name)
    d = T.coo_to_dia(a.with_data(a.data.astype(np.float32)), device="cpu")
    return d.data.numpy().copy(), d.offsets, d.n


def _dia(data, offsets, n):
    return T.DIA(data=torch.as_tensor(data), offsets=tuple(offsets), shape=(n, n),
                 nnz=int((np.asarray(data) != 0).sum()))


def _word_flags(data):
    """numpy: [tiles, ndiags], 1 where a tile's segment of a diagonal holds
    a word other than zero (NaN counts; +0.0 and -0.0 do not)."""
    words = np.asarray(torch.as_tensor(data).float().numpy(), np.float64)
    nd, n_pad = words.shape
    tiles = -(-n_pad // R)
    pad = np.zeros((nd, tiles * R))
    pad[:, :n_pad] = words
    return (pad.reshape(nd, tiles, R) != 0).any(-1).T.astype(np.uint8)


def _pattern_flags(data, offsets, n):
    """numpy: [tiles, ndiags], 1 where a tile holds an entry of the matrix
    (row i, column i + off in range, nonzero value) on a diagonal."""
    data = np.asarray(torch.as_tensor(data).float())
    nd, n_pad = data.shape
    out = np.zeros((-(-n_pad // R), nd), np.uint8)
    i = np.arange(n)
    for s, off in enumerate(offsets):
        rows = i[(i + off >= 0) & (i + off < n) & (data[s, :n] != 0)]
        out[rows // R, s] = 1
    return out


def _held(d, data=None):
    """d's flags are [tiles, ndiags] uint8 on the data's device, a superset
    of the matrix's pattern and exactly the segments with a word other than
    zero, made from the data's current version."""
    data = d.data if data is None else data
    flags = T._flags(d)
    assert flags is d.flags
    assert flags.dtype == torch.uint8 and flags.device == d.data.device
    assert tuple(flags.shape) == (-(-d.n_pad // R), d.ndiags)
    got = flags.numpy()
    pattern = _pattern_flags(data, d.offsets, d.n)
    assert (got >= pattern).all(), "a segment holding an entry is not flagged"
    np.testing.assert_array_equal(got, _word_flags(data))
    assert d.flags_version == d.data._version


@pytest.mark.parametrize("name", MATRICES)
def test_flags_match_the_pattern(name):
    data, offsets, n = _case(name)
    d = _dia(data, offsets, n)
    _held(d)
    if name == "banded ragged":
        assert d.n_pad % R and not d.flags[:, offsets.index(1500)].any()
        assert d.flags[:, 0].tolist().count(1) == 3       # rows 700, 850, 999: three tiles
    elif name == "orsirr_like24":
        assert d.flags.float().mean() < 0.5                # most segments hold stored zeros


MAKERS = {
    "dia_transpose": T.dia_transpose,
    "dia_astype": lambda d: T.dia_astype(d, BF16),
    "dataclasses.replace": lambda d: dataclasses.replace(d, data=d.data * -3.0),
    "jacobi_iteration_matrix": t_st.jacobi_iteration_matrix,
}


@pytest.mark.parametrize("maker", list(MAKERS))
@pytest.mark.parametrize("name", MATRICES)
def test_flags_follow_every_way_of_making_a_dia(name, maker):
    """Every DIA the port makes gets its own flags with it (the Jacobi
    iteration matrix's padding rows hold a 1 on the main diagonal)."""
    data, offsets, n = _case(name)
    made = MAKERS[maker](_dia(data, offsets, n))
    _held(made)


def test_jacobi_matrix_keeps_the_skipped_segments():
    """``jacobi_iteration_matrix`` stores -ω·0/d = -0.0 where A stores a
    zero: those words flag nothing, so its flags are A's, with the main
    diagonal also flagged in the padding rows (a 1 there)."""
    data, offsets, n = _case("orsirr_like24")
    d = _dia(data, offsets, n)
    m = t_st.jacobi_iteration_matrix(d)
    assert bool(((m.data == 0) & torch.signbit(m.data)).any())
    want = T._flags(d).clone()
    want[:, offsets.index(0)] = 1
    assert torch.equal(T._flags(m), want)


def test_flags_of_the_galerkin_coarse_operator():
    """``multigrid``'s coarse DIA (made by ``index_add_`` into a fresh
    tensor) gets flags with it."""
    data, offsets, n = _case("orsirr_like24")
    coarse = t_mg.galerkin_coarse_dia(_dia(data, offsets, n))
    _held(coarse)


def test_k8_rule_reads_the_share_of_entries():
    """K8 takes its skip path on bands of more than ``_K8_SKIP_RULE``'s n0
    diagonals whose segments mostly hold only zeros, by host fields:
    ``coo_to_dia`` reckons the share of segments holding an entry on the
    host (orsirr_like150 2.45%, ``_segment_flags``'s mean), which its
    Jacobi matrix, transpose and bf16 copy keep and its Galerkin levels
    take as their estimate (their nnz counts every word the index map adds,
    zeros included); a DIA made without it is read by nnz / (ndiags·n).
    Not a fully stored band (poisson96), orsirr_like24 (10 diagonals, 31%
    of the segments), a band of n0 diagonals however sparse, or a wide one
    whose words are all stored."""
    ors = T.coo_to_dia(t_gallery.get("orsirr_like150"), device="cpu")
    assert ors.seg_share == pytest.approx(float(T._segment_flags(ors.data).float().mean()))
    assert 0.02 < ors.seg_share < 0.03
    c1 = t_mg.galerkin_coarse_dia(ors)
    c2 = t_mg.galerkin_coarse_dia(c1)
    assert c1.nnz > 0.5 * c1.ndiags * c1.n and c2.seg_share == ors.seg_share
    for d in (ors, t_st.jacobi_iteration_matrix(ors), T.dia_transpose(ors),
              T.dia_astype(ors, BF16), c1, c2):
        assert T._k8_skips(d) and isinstance(d.flags, torch.Tensor)
    for name in ("poisson96", "orsirr_like24"):
        d = T.coo_to_dia(t_gallery.get(name), device="cpu")
        assert not T._k8_skips(d) and not T._k8_skips(T.dia_transpose(d))
    n = 4096
    for nd in (T._K8_SKIP_RULE[0], 32):
        band = T.DIA(data=torch.ones(nd, n), offsets=tuple(range(nd)), shape=(n, n),
                     nnz=nd * n)
        sparse = dataclasses.replace(band, nnz=n // 8)
        assert not T._k8_skips(band) and T._k8_skips(sparse) == (nd == 32)
        assert band.flags is None and isinstance(sparse.flags, torch.Tensor) == (nd == 32)


def test_a_word_that_rounds_to_zero_in_bf16():
    """A float32 word below half bf16's least subnormal flags a segment
    that held only zeros; ``dia_astype`` rounds it to +0.0 and the bf16
    copy's segment is clear (K8 then applies the term only where the sum
    is -0.0, as its rows path would change it).  A -0.0 word, like +0.0,
    flags nothing on either type."""
    data, offsets, n = _case("poisson96")        # offsets (-96, -1, 0, 1, 96), n 9216
    last = n // R - 1                            # rows 9152..9215: offset 96 out of range
    assert not data[0, :R].any() and not data[4, last * R:].any()
    data[0, 3] = 3e-41
    data[4, last * R + 8] = -0.0
    d = _dia(data, offsets, n)
    _held(d)
    assert d.flags[0, 0] == 1 and d.flags[last, 4] == 0
    b = T.dia_astype(d, BF16)
    _held(b)
    assert torch.equal(b.data[0, :R], torch.zeros(R, dtype=BF16))
    assert b.flags[0, 0] == 0 and b.flags[last, 4] == 0
    assert torch.signbit(b.data[4, last * R + 8])


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_flags_are_made_again_after_an_in_place_write(dtype):
    """A write into a segment that held only zeros moves the data's
    version; ``_flags`` (K8's wrapper) then makes the flags again from the
    device data."""
    data, offsets, n = _case("orsirr_like24")
    d = T.dia_astype(_dia(data, offsets, n), dtype)
    before = T._flags(d)
    s, tile = next((s, t) for t in range(before.shape[0]) for s in range(d.ndiags)
                   if not before[t, s] and t * R < d.n)
    d.data[s, tile * R] = 1.5
    assert d.flags_version != d.data._version
    flags = T._flags(d)
    assert flags is d.flags and flags is not before and flags[tile, s] == 1
    _held(d)
    assert T._flags(d) is flags                  # unchanged data: the same flags


def test_flags_exist_once_the_dia_does():
    """Like the int32 offsets, the flags of a DIA that K8's rule sends to
    the skip path are made with the matrix (never in a kernel call, so a
    CUDA-graph capture of a call holds the flags it reads); every
    constructor and ``dataclasses.replace`` makes them.  A dense band,
    which the rows path reads, gets none until ``_flags`` asks."""
    ors = T.coo_to_dia(t_gallery.get("orsirr_like150"), device="cpu")
    assert T._k8_skips(ors) and ors.flags.shape == (352, 230)
    assert ors.flags_version == ors.data._version
    fields = {f.name: f for f in dataclasses.fields(T.DIA)}
    assert not fields["flags"].init and not fields["flags_version"].init
    data, offsets, n = _case("poisson96")
    d = _dia(data, offsets, n)
    assert not T._k8_skips(d) and d.flags is None
    assert T._flags(d) is d.flags and d.flags.shape == (144, 5)
    with torch.inference_mode():               # no version counter: made at every call
        inf_d = _dia(data, offsets, n)
    assert inf_d.flags_version is None
    first = T._flags(inf_d)
    assert T._flags(inf_d) is not first
    np.testing.assert_array_equal(first.numpy(), _word_flags(data))


def _emulate_skip(data, offsets, n, x):
    """K8's skip path on the host in float64: the scan's marks of x's
    32-element chunks holding inf or NaN, each 64-row tile's list (the
    flagged diagonals and those whose window of x touches a marked chunk),
    the listed terms added in offset order, and each run of skipped terms
    walked, with their words, only where the sum is -0.0."""
    data, x = np.asarray(data, np.float64), np.asarray(x, np.float64)
    flags = _word_flags(data)
    bad = ~np.isfinite(x)
    marks = [bad[c:c + 32].any() for c in range(0, n, 32)]
    xv = lambda j: x[j] if 0 <= j < n else 0.0
    y = np.zeros(n)
    for t in range(-(-n // R)):
        r0, r_end = t * R, min(t * R + R, n)
        need = []
        for s, off in enumerate(offsets):
            lo, hi = max(r0 + off, 0), min(r_end + off, n)
            need.append(bool(flags[t, s]) or (lo < hi and any(
                marks[(lo >> 5):((hi - 1) >> 5) + 1])))
        for i in range(r0, r_end):
            acc = 0.0
            for s, off in enumerate(offsets):
                if need[s]:
                    acc = acc + data[s, i] * xv(i + off)
                elif acc == 0.0 and np.signbit(acc):
                    acc = acc + data[s, i] * xv(i + off)
            y[i] = acc
    return y


@pytest.mark.parametrize("name", MATRICES)
def test_skip_schedule_emulated_in_float64(name):
    """The skip path's schedule (``_emulate_skip``) gives the sum over every
    term, in float64, exactly: NaN and inf in the same rows, every other
    value and sign the same, with inf and NaN in x both under stored zeros
    only and under nonzero words."""
    data, offsets, n, x, _ = _nonfinite_case(name)
    data = data.astype(np.float64)
    x = x.astype(np.float64)
    x[[5, n // 2]] = (np.inf, -np.inf)
    td = _dia(data, offsets, n)
    want = T.spmv_dia_ref(td, torch.as_tensor(x)).numpy()
    got = _emulate_skip(data, offsets, n, x)
    assert np.isnan(want).sum() > 0 and np.isinf(want).sum() + np.isnan(want).sum() > 2
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


def _nonfinite_case(name):
    """The test matrix with every stored word of two columns j1, j2 set to
    zero (the words stay stored: K8 skips their segments where a tile holds
    nothing else) and x with inf at j1 and NaN at j2: only stored zeros
    reach them."""
    data, offsets, n = _case(name)
    j1, j2 = n // 3, (2 * n) // 3 + 1
    for s, off in enumerate(offsets):
        for j in (j1, j2):
            if 0 <= j - off < n:
                data[s, j - off] = 0.0
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    x[j1], x[j2] = np.inf, np.nan
    rows = {j - off for j in (j1, j2) for off in offsets if 0 <= j - off < n}
    return data, offsets, n, x, sorted(rows)


@pytest.mark.parametrize("entry", ["spmv_dia", "spmv_dia_padded"])
@pytest.mark.parametrize("name", MATRICES)
def test_nonfinite_x_under_stored_zeros_matches_jax(name, entry):
    data, offsets, n, x, nan_rows = _nonfinite_case(name)
    td = _dia(data, offsets, n)
    jd = J.DIA(data=jnp.asarray(data), offsets=tuple(offsets), shape=(n, n), nnz=td.nnz)
    want = np.asarray(jax.jit(J.spmv_dia_jnp)(jd, jnp.asarray(x)))
    if entry == "spmv_dia":
        got = T.spmv_dia(td, torch.as_tensor(x)).numpy()
    else:
        got = T.spmv_dia_padded(td, T.dia_pad_x(td, torch.as_tensor(x))).numpy()[:n]
    assert np.flatnonzero(np.isnan(got)).tolist() == nan_rows
    assert np.flatnonzero(np.isnan(want)).tolist() == nan_rows
    finite = np.isfinite(want)
    assert np.isfinite(got[finite]).all()
    np.testing.assert_allclose(got[finite], want[finite], **K8_TOL)
