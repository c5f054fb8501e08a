"""The tensor-core K17's chunk list and column tiles (``ops/bsr.py``
``_chunk_list``, ``_chunks``, ``_col_tile``) on the CPU.

The bf16 × bf16 kernel (``csrc/bsr_bf16.cu``) multiplies, per block row,
only the [bm, 32] chunks its list names, in list order.  So the list is
held against a numpy count of the nonzero chunks (NaN counts, -0.0 does
not) on BELLs ``csr_to_bell`` never gives, and a product summed over the
listed chunks alone, in float32 and rounded to bf16 once as the kernel
rounds, against ``spmm_bell_jnp``: one bf16 ulp plus FLOAT32_SUMS·eps32
of |A|·|X| (two float32 sums in other orders may round to neighbouring
bf16 values).  Where X holds inf only under unlisted chunks that product
stays finite.  The column-tile rule is pinned at ``chip_smoke.py``'s
``[bell]`` shapes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import bsr as j_bsr
from gflownet_spai_tpu_torch.ops import bsr as t_bsr
from test_torch_bell import _irregular_bell

BF = torch.bfloat16
EPS32 = 2.0 ** -24
FLOAT32_SUMS = 8
_jnp_spmm = jax.jit(j_bsr.spmm_bell_jnp)


def _bell(blockshape, W=6, seed=0):
    """The irregular BELL of 10 block rows (shuffled slots, explicit zero
    blocks, zero 32-column chunks inside real blocks, repeated block
    columns, block rows 0 and 5 with no real block) with bf16 blocks, a NaN
    word and a -0.0 word in otherwise empty chunks of row 0; as host arrays
    and a CPU torch BELL."""
    m, n = 10 * blockshape[0], 512 // blockshape[1] * blockshape[1]
    rng, data, cols = _irregular_bell(blockshape, m, n, W, seed)
    empty = np.argwhere(~data.reshape(data.shape[0], W, blockshape[0], -1, 32).any(axis=(2, 4)))
    r, w, j = empty[0]
    data[r, w, 1, 32 * j + 3] = np.nan            # listed: NaN is a word other than zero
    r, w, j = empty[1]
    data[r, w, 0, 32 * j] = -0.0                  # not listed
    tb = t_bsr.BELL(data=torch.as_tensor(data).to(BF), bcols=torch.as_tensor(cols),
                    shape=(m, n), nnz=int(np.count_nonzero(data)))
    return rng, data, cols, tb


def _numpy_lists(data):
    """Per block row, the indices w·bn/32 + j of its chunks that hold a
    word other than zero, in slot order."""
    nbr, W, bm, bn = data.shape
    nz = (data != 0).reshape(nbr, W, bm, bn // 32, 32).any(axis=(2, 4)).reshape(nbr, -1)
    return [np.flatnonzero(row) for row in nz]


def _listed_product(tb, lists, x):
    """Y = A·X summed over the listed chunks alone, each chunk's products
    and the row's sum in float32, rounded to bf16 once (the kernel's
    function; it sums in another float32 order)."""
    nbr, W, bm, bn = tb.data.shape
    cj = bn // 32
    a = tb.data.float()
    xf = x.float()
    y = torch.zeros((nbr * bm, x.shape[1]))
    for i, chunks in enumerate(lists):
        for c in chunks.tolist():
            w, j = divmod(c, cj)
            r0 = int(tb.bcols[i, w]) * bn + 32 * j
            y[i * bm:(i + 1) * bm] += a[i, w, :, 32 * j:32 * j + 32] @ xf[r0:r0 + 32]
    return y.to(BF)


def _ulp(v):
    return np.where(v == 0, 0.0, np.ldexp(1.0, np.frexp(v)[1] - 8))


@pytest.mark.parametrize("blockshape", [(8, 128), (16, 32), (32, 96), (64, 64), (128, 160)])
def test_chunk_list_matches_numpy(blockshape):
    """The list's counts and indices equal numpy's on the irregular BELL;
    a BELL made on the CPU carries none until ``_chunks`` asks."""
    _, data, _, tb = _bell(blockshape)
    assert tb.chunks is None
    got = t_bsr._chunks(tb)
    nbr, W, bm, bn = data.shape
    assert got.dtype == torch.int32 and tuple(got.shape) == (nbr, 1 + W * bn // 32)
    want = _numpy_lists(data)
    for i, row in enumerate(want):
        assert int(got[i, 0]) == len(row)
        np.testing.assert_array_equal(got[i, 1:1 + len(row)].numpy(), row)
        # the rest of the row: the other indices, in order
        rest = np.setdiff1d(np.arange(W * bn // 32), row)
        np.testing.assert_array_equal(got[i, 1 + len(row):].numpy(), rest)
    counts = got[:, 0].numpy()
    assert (counts == 0).any() and (counts < W * bn // 32).all()


def test_chunk_list_made_once_and_again_after_an_in_place_write():
    """``_chunks`` returns the kept list while ``data`` is unchanged, and
    makes it again after an in-place write (its version counter moved)."""
    _, data, _, tb = _bell((8, 128))
    first = t_bsr._chunks(tb)
    assert t_bsr._chunks(tb) is first and tb.chunks is first
    empty_row = int(np.flatnonzero(~data.any(axis=(1, 2, 3)))[0])
    tb.data[empty_row, 2, 0, 100] = 1.5                      # chunk 2·4 + 3 of an empty row
    again = t_bsr._chunks(tb)
    assert again is not first and tb.chunks is again
    assert int(again[empty_row, 0]) == 1 and int(again[empty_row, 1]) == 2 * 4 + 3
    assert int(first[empty_row, 0]) == 0
    keep = [i for i in range(data.shape[0]) if i != empty_row]
    assert torch.equal(again[keep], first[keep])
    # a replaced BELL (another tensor) gets a list of its own
    moved = dataclasses.replace(tb, data=tb.data.clone())
    assert moved.chunks is None and torch.equal(t_bsr._chunks(moved), again)


@pytest.mark.parametrize("blockshape", [(8, 128), (16, 32), (32, 96)])
@pytest.mark.parametrize("K", [1, 8, 72])
def test_listed_chunks_product_matches_jnp(blockshape, K):
    """The product over the listed chunks alone against ``spmm_bell_jnp``
    on finite X; with inf in X only under unlisted chunks it stays
    finite, where the plain version gives NaN."""
    rng, data, cols, tb = _bell(blockshape, seed=K)
    data = np.where(np.isnan(data), 0.0, data).astype(np.float32)   # finite A for the compare
    # every all-zero slot (padding, explicit zero block) at a block column
    # of its own, which no listed chunk reads
    n = tb.shape[1] + blockshape[1]
    cols = np.where(data.any(axis=(2, 3)), cols, n // blockshape[1] - 1).astype(np.int32)
    tb = t_bsr.BELL(data=torch.as_tensor(data).to(BF), bcols=torch.as_tensor(cols),
                    shape=(tb.shape[0], n), nnz=tb.nnz)
    lists = _numpy_lists(data)
    x = torch.as_tensor(rng.standard_normal((n, K)), dtype=torch.float32).to(BF)
    lst = t_bsr._chunks(tb)
    got = _listed_product(tb, [lst[i, 1:1 + int(lst[i, 0])].numpy()
                               for i in range(lst.shape[0])], x)
    jb = j_bsr.BELL(data=jnp.asarray(tb.data.float().numpy()).astype(jnp.bfloat16),
                    bcols=jnp.asarray(cols), shape=tb.shape, nnz=tb.nnz)
    want = np.asarray(_jnp_spmm(jb, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    mag = np.abs(tb.todense().double().numpy()) @ np.abs(x.double().numpy())
    err = np.abs(got.float().numpy() - want)
    assert (err <= _ulp(np.abs(want)) + FLOAT32_SUMS * EPS32 * mag).all()
    # inf in X under every row of X that no listed chunk reads: the zero
    # slots' column and the zero chunks' rows that no other chunk reads
    nbr, W, bm, bn = data.shape
    read = np.zeros(n, bool)
    for i, row in enumerate(lists):
        for c in row:
            w, j = divmod(int(c), bn // 32)
            read[cols[i, w] * bn + 32 * j:cols[i, w] * bn + 32 * j + 32] = True
    assert (~read[-bn:]).all()
    xi = x.clone()
    xi[torch.as_tensor(~read)] = float("inf")
    assert bool(torch.isfinite(_listed_product(tb, lists, xi).float()).all())
    assert torch.isnan(t_bsr.spmm_bell_ref(tb, xi).float()).any()


# chip_smoke.py's [bell] cases: (matrix side, blockshape) at K 256, and
# the block rows each gives
_BELL_SHAPES = {(4096, (8, 128)): 512, (4096, (32, 128)): 128, (4096, (128, 128)): 32,
                (65536, (8, 128)): 8192, (65536, (128, 128)): 512}


@pytest.mark.parametrize("case,kc", [((4096, (8, 128)), 256), ((4096, (32, 128)), 128),
                                     ((4096, (128, 128)), 64), ((65536, (8, 128)), 256),
                                     ((65536, (128, 128)), 256)])
def test_col_tile_at_bell_shapes(case, kc):
    """K = 256: Kc 256 (A read once) where nbr blocks give each of the 132
    SMs one, else the widest tile whose grid does (the fastest of the three
    at each shape on an H100); spmv_bell's K = 1 and any K % 8 != 0 take
    the path without TMA, Kc 64."""
    nbr = _BELL_SHAPES[case]
    assert t_bsr._col_tile(nbr, 256, True) == kc
    assert nbr * -(-256 // kc) >= 132 or kc == 64
    assert t_bsr._col_tile(nbr, 1, False) == t_bsr._col_tile(nbr, 7, False) == 64


@pytest.mark.parametrize("nbr,K,kc", [(8192, 8, 64), (8192, 64, 64), (8192, 72, 128),
                                      (8192, 264, 256), (8192, 520, 256), (100, 256, 128),
                                      (50, 256, 64), (40, 520, 128), (1, 65535 * 128, 256)])
def test_col_tile_around_its_edges(nbr, K, kc):
    """No tile wider than K's 64-column tiles; the grid's fill decides."""
    assert t_bsr._col_tile(nbr, K, True) == kc
