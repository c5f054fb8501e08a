"""PyTorch port vs the JAX package: block-ELL conversion (``csr_to_bell``),
the plain version of the block-ELL SpMM (K17) and ``spmv_bell`` against
``spmm_bell_jnp`` and both interpret-mode Pallas kernels (streamed and
X-resident), and the copied ``_resident_bk`` regime choice.

Tolerance rtol 1e-5, atol 1e-4 (tests/test_ops.py's BELL bound): the
block products sum in other orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from gflownet_spai_tpu.ops import bsr as j_bsr
from gflownet_spai_tpu.sparse import coo_to_csr as j_coo_to_csr
from gflownet_spai_tpu.sparse import scipy_to_coo as j_scipy_to_coo
from gflownet_spai_tpu_torch.convert import bell_from_jax
from gflownet_spai_tpu_torch.ops import bsr as t_bsr
from gflownet_spai_tpu_torch.sparse import coo_to_csr as t_coo_to_csr
from gflownet_spai_tpu_torch.sparse import scipy_to_coo as t_scipy_to_coo

TOL = dict(rtol=1e-5, atol=1e-4)


def _pair(m, n, density, blockshape, seed):
    rng = np.random.default_rng(seed)
    a = sp.random(m, n, density=density, random_state=rng, format="coo",
                  dtype=np.float32)
    jb = j_bsr.csr_to_bell(j_coo_to_csr(j_scipy_to_coo(a), canonical=True),
                           blockshape=blockshape)
    tb = t_bsr.csr_to_bell(t_coo_to_csr(t_scipy_to_coo(a), canonical=True),
                           blockshape=blockshape)
    return rng, a, jb, tb


@pytest.mark.parametrize("blockshape", [(8, 128), (32, 128), (16, 64)])
def test_csr_to_bell_equal(blockshape):
    _, a, jb, tb = _pair(64, 256, 0.05, blockshape, seed=1)
    np.testing.assert_array_equal(tb.data, np.asarray(jb.data))
    np.testing.assert_array_equal(tb.bcols, np.asarray(jb.bcols))
    assert (tb.shape, tb.nnz, tb.blockshape, tb.width) == \
        (tuple(jb.shape), jb.nnz, jb.blockshape, jb.width)
    np.testing.assert_array_equal(tb.todense().numpy(), np.asarray(jb.todense()))
    np.testing.assert_array_equal(tb.todense().numpy(), a.toarray())
    carried = bell_from_jax(jb)
    np.testing.assert_array_equal(carried.data, tb.data)
    np.testing.assert_array_equal(carried.bcols, tb.bcols)
    assert (carried.shape, carried.nnz) == (tb.shape, tb.nnz)


def test_spmm_bell_matches_streamed_kernel():
    """K17's plain version against ``_spmm_bell_pallas`` (the streamed
    kernel, interpret mode) and ``spmm_bell_jnp``."""
    rng, _, jb, tb = _pair(64, 256, 0.08, (8, 128), seed=5)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    got = t_bsr.spmm_bell(tb.to("cpu"), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bsr.spmm_bell_jnp(jb, jnp.asarray(x))),
                               **TOL)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_bsr._spmm_bell_pallas(jb, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_spmm_bell_matches_resident_kernel():
    """Against the X-resident kernel at two K tiles and at the tile
    ``_resident_bk`` picks (the port copies the choice)."""
    rng, _, jb, tb = _pair(64, 512, 0.06, (8, 128), seed=6)
    x = rng.standard_normal((512, 256)).astype(np.float32)
    bk = j_bsr._resident_bk(jb, 256)
    assert t_bsr._resident_bk(tb, 256) == bk == 256
    got = t_bsr.spmm_bell(tb.to("cpu"), torch.as_tensor(x)).numpy()
    with pltpu.force_tpu_interpret_mode():
        for k in (128, bk):
            want = np.asarray(j_bsr._spmm_bell_pallas_resident(jb, jnp.asarray(x), k))
            np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n,K", [(512, 256), (4096, 256), (4096, 100), (65536, 256),
                                 (16384, 640), (20480, 128), (40960, 128)])
def test_resident_bk_matches(n, K):
    """The TPU regime choice at the sizes the chip run uses (None: JAX
    would stream, as at 65,536 rows with K = 256)."""
    shape = (8, n)
    jb = j_bsr.BELL(data=jnp.zeros((1, 1, 8, 128)), bcols=jnp.zeros((1, 1), jnp.int32),
                    shape=shape, nnz=0)
    tb = t_bsr.BELL(data=np.zeros((1, 1, 8, 128), np.float32),
                    bcols=np.zeros((1, 1), np.int32), shape=shape, nnz=0)
    assert t_bsr._resident_bk(tb, K) == j_bsr._resident_bk(jb, K)


@pytest.mark.parametrize("blockshape", [(8, 128), (32, 128), (128, 128)])
def test_spmm_and_spmv_bell_match_jnp(blockshape):
    """The chip run's three blockshapes, K not a multiple of the kernel's
    column tile; ``spmv_bell`` against the one-column product."""
    rng, a, jb, tb = _pair(256, 384, 0.03, blockshape, seed=7)
    x = rng.standard_normal((384, 100)).astype(np.float32)
    got = t_bsr.spmm_bell(tb.to("cpu"), torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bsr.spmm_bell_jnp(jb, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(got, a.toarray().astype(np.float64) @ x, **TOL)
    v = x[:, 3].copy()
    np.testing.assert_allclose(
        t_bsr.spmv_bell(tb.to("cpu"), torch.as_tensor(v)).numpy(),
        np.asarray(j_bsr.spmv_bell(jb, jnp.asarray(v))), **TOL)


def test_spmm_bell_ref_chunks_block_rows(monkeypatch):
    """The plain version walks block rows in chunks under its word budget;
    a budget of one block row gives the same product."""
    rng, _, _, tb = _pair(128, 256, 0.1, (8, 128), seed=9)
    x = torch.as_tensor(rng.standard_normal((256, 16)).astype(np.float32))
    whole = t_bsr.spmm_bell_ref(tb.to("cpu"), x)
    monkeypatch.setattr(t_bsr, "_REF_WORDS", 1)
    torch.testing.assert_close(t_bsr.spmm_bell_ref(tb.to("cpu"), x), whole,
                               rtol=0, atol=0)


def _irregular_bell(blockshape, m, n, W, seed):
    """Host arrays of a BELL that ``csr_to_bell`` never gives: slots in
    shuffled order, explicit all-zero blocks between real ones, a real
    block in column 0 at a slot > 0, a repeated block column, block rows
    with no real block, and blocks zero in some 32-column chunks only (the
    semantics K17 must keep while it skips all-zero chunks)."""
    rng = np.random.default_rng(seed)
    bm, bn = blockshape
    nbr, nbc = m // bm, n // bn
    data = np.zeros((nbr, W, bm, bn), np.float32)
    cols = np.zeros((nbr, W), np.int32)
    for r in range(nbr):
        if r % 5 == 0:
            continue                                    # no real block
        slots = rng.permutation(W)[:rng.integers(2, W + 1)]
        for t, w in enumerate(slots):
            cols[r, w] = rng.integers(0, nbc)
            if t % 3 == 2:
                continue                                # explicit zero block
            blk = rng.standard_normal((bm, bn)).astype(np.float32)
            if t % 3 == 1 and bn > 32:                  # zero 32-column chunks
                for j0 in range(0, bn, 64):
                    blk[:, j0:j0 + 32] = 0.0
            data[r, w] = blk
        cols[r, slots[1]] = cols[r, slots[0]]           # a repeated column
        if r % 7 == 1 and slots.max() > 0:
            w = int(slots.max())
            cols[r, w] = 0                              # column 0 at a slot > 0
            data[r, w] = rng.standard_normal((bm, bn))
    return rng, data, cols


@pytest.mark.parametrize("blockshape", [(8, 128), (16, 32), (64, 64)])
@pytest.mark.parametrize("K", [1, 3, 100])
def test_spmm_bell_ref_matches_jnp_on_irregular_bells(blockshape, K):
    """The plain K17 against ``spmm_bell_jnp`` and dense float64 on BELLs
    with shuffled slots, zero blocks and chunks, repeated columns and
    empty block rows; ``spmv_bell`` at K = 1."""
    m, n = 128, 256
    rng, data, cols = _irregular_bell(blockshape, m, n, W=5, seed=K)
    nnz = int(np.count_nonzero(data))
    jb = j_bsr.BELL(data=jnp.asarray(data), bcols=jnp.asarray(cols), shape=(m, n), nnz=nnz)
    tb = t_bsr.BELL(data=data, bcols=cols, shape=(m, n), nnz=nnz).to("cpu")
    x = rng.standard_normal((n, K)).astype(np.float32)
    got = t_bsr.spmm_bell_ref(tb, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(j_bsr.spmm_bell_jnp(jb, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(got, tb.todense().double().numpy() @ x, **TOL)
    empty = np.repeat(~data.any(axis=(1, 2, 3)), blockshape[0])
    assert empty.any() and not got[empty].any()
    if K == 1:
        np.testing.assert_allclose(
            t_bsr.spmv_bell(tb, torch.as_tensor(x[:, 0])).numpy(),
            np.asarray(j_bsr.spmv_bell(jb, jnp.asarray(x[:, 0]))), **TOL)
