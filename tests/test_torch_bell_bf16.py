"""PyTorch port vs the JAX package on bf16 block-ELL blocks (K17).

The port's dtype rule (``gflownet_spai_tpu_torch/ops/bsr.py``'s
docstring): the output in promote(blocks, X), ``spmm_bell_jnp``'s dtype;
every product and sum in float32, one rounding where the output is
stored.  The JAX TPU kernels store the blocks' dtype whatever X is, and
the streamed one sums its W block products in bf16.  So:

- against ``spmm_bell_jnp``: the dtype equal; on bf16 × bf16 at most one
  bf16 ulp apart (two float32 sums in other orders may round to
  neighbouring bf16 values); on bf16 blocks × float32 X each element
  within FLOAT32_SUMS·eps32 of |A|·|X| (what float32 sums in other orders
  can be apart);
- against ``_spmm_bell_pallas_resident`` (interpret mode; float32 sums,
  one rounding to bf16): one bf16 ulp, after rounding the port's float32
  output to bf16 where X is float32;
- against ``_spmm_bell_pallas`` (interpret mode), whose `y_ref +=` sums
  the W block products in the bf16 output block: within W·2⁻⁸·(|A|·|X|),
  W roundings of a partial sum no larger than |A|·|X|.

The two faults this file was written for: the plain version raised on
bf16 blocks with float32 X, and ``bell_from_jax`` kept an
``ml_dtypes.bfloat16`` array that ``BELL.to`` could not move.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gflownet_spai_tpu.ops import bsr as j_bsr
from gflownet_spai_tpu_torch.convert import bell_from_jax
from gflownet_spai_tpu_torch.ops import bsr as t_bsr
from test_torch_bell import _irregular_bell, _pair
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF = torch.bfloat16
JBF = jnp.bfloat16
EPS32 = 2.0 ** -24          # float32 unit roundoff
BF16_ROUND = 2.0 ** -8      # bf16 unit roundoff
FLOAT32_SUMS = 8            # float32 roundings an output's sum may carry, in eps32·|A|·|X|
_jnp_spmm = jax.jit(j_bsr.spmm_bell_jnp)


def _bf16_pair(m, n, density, blockshape, seed):
    """The same random matrix as a JAX BELL with bf16 blocks and its port
    counterpart through ``bell_from_jax`` (the JAX bits)."""
    rng, _, jb, _ = _pair(m, n, density, blockshape, seed)
    jb = dataclasses.replace(jb, data=jb.data.astype(JBF))
    return rng, jb, bell_from_jax(jb).to("cpu")


def _x(rng, n, K, xdt):
    """X in float32 and in ``xdt`` (bf16: rounded as JAX rounds) for both."""
    x = rng.standard_normal((n, K)).astype(np.float32)
    jx = jnp.asarray(x).astype(JBF if xdt == BF else jnp.float32)
    return jx, torch.as_tensor(np.asarray(jx.astype(jnp.float32))).to(xdt)


def _f32(a):
    """A torch or JAX array as a float32 numpy array (bf16 exactly)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _mag(jb, jx):
    """|A|·|X| in float64 (the bounds' scale)."""
    dense = np.abs(np.asarray(jb.todense().astype(jnp.float32), np.float64))
    return dense @ np.abs(_f32(jx).astype(np.float64))


def _bf16_ulp(v):
    """One bf16 unit in the last place of each element of ``v`` (0 at 0)."""
    return np.where(v == 0, 0.0, np.ldexp(1.0, np.frexp(v)[1] - 8))


def _within(got, want, bound, what):
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = err > bound
    assert not bad.any(), (f"{what}: {bad.sum()} of {bad.size} elements off; worst "
                           f"{np.max(err - bound):.3e} over the bound")


def test_bell_from_jax_carries_bf16_blocks():
    """A JAX BELL with bf16 blocks carries over with the JAX bits (a
    ``TypeError`` at ``.to`` before: numpy held ``ml_dtypes.bfloat16``),
    and moves and densifies as a torch bf16 BELL."""
    _, jb, tb = _bf16_pair(64, 512, 0.08, (8, 128), seed=1)
    assert tb.data.dtype == BF and tb.blockshape == (8, 128) and tb.width == jb.width
    np.testing.assert_array_equal(tb.data.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(jb.data).view(np.uint16))
    np.testing.assert_array_equal(tb.bcols.numpy(), np.asarray(jb.bcols))
    assert (tb.shape, tb.nnz) == (tuple(jb.shape), jb.nnz)
    dense = tb.todense()
    assert dense.dtype == BF
    np.testing.assert_array_equal(_f32(dense), _f32(jb.todense()))


@pytest.mark.parametrize("blockshape", [(8, 128), (32, 128)])
def test_spmm_bell_ref_bf16_blocks_float32_x(blockshape):
    """bf16 blocks with float32 X (a ``RuntimeError`` in the plain version
    before): float32 out, as ``spmm_bell_jnp``, within the float32 sums'
    bound; the ops entry ``spmm_bell`` takes the same path on the CPU.
    The BELL is the port's idiom, ``data.to(torch.bfloat16)``."""
    rng, _, jb, tb = _pair(128, 1024, 0.08, blockshape, seed=2)
    jb = dataclasses.replace(jb, data=jb.data.astype(JBF))
    tb = dataclasses.replace(tb.to("cpu"), data=torch.as_tensor(tb.data).to(BF))
    jx, tx = _x(rng, 1024, 256, torch.float32)
    got = t_bsr.spmm_bell_ref(tb, tx)
    want = _jnp_spmm(jb, jx)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _within(got.numpy(), np.asarray(want), FLOAT32_SUMS * EPS32 * _mag(jb, jx),
            "vs spmm_bell_jnp")
    assert torch.equal(t_bsr.spmm_bell(tb, tx), got)


@pytest.mark.parametrize("m,n,blockshape", [(64, 512, (8, 128)), (128, 1024, (32, 128))])
def test_spmm_bell_ref_bf16_matches_jnp(m, n, blockshape):
    """bf16 × bf16: bf16 out, at most one bf16 ulp from ``spmm_bell_jnp``
    (how many outputs differ is printed: 0 of 16,384 and 1 of 32,768 on
    these cases); float32 blocks with bf16 X promote X, float32 out."""
    rng, jb, tb = _bf16_pair(m, n, 0.08, blockshape, seed=3)
    jx, tx = _x(rng, n, 256, BF)
    got = t_bsr.spmm_bell_ref(tb, tx)
    want = _jnp_spmm(jb, jx)
    assert got.dtype == BF and want.dtype == JBF
    g, w = _f32(got), _f32(want)
    _within(g, w, _bf16_ulp(np.abs(w)), "vs spmm_bell_jnp")
    print(f"{int((g != w).sum())} of {g.size} outputs differ from spmm_bell_jnp's bits")
    a32 = dataclasses.replace(tb, data=tb.data.float())
    up = t_bsr.spmm_bell_ref(a32, tx)
    assert up.dtype == torch.float32
    assert torch.equal(up, t_bsr.spmm_bell_ref(a32, tx.float()))


@pytest.mark.parametrize("xdt", [torch.float32, BF])
def test_spmm_bell_bf16_matches_resident_kernel(xdt):
    """Against ``_spmm_bell_pallas_resident`` in interpret mode, which
    stores the blocks' dtype (bf16) whatever X is: one bf16 ulp after
    rounding the port's output to bf16."""
    rng, jb, tb = _bf16_pair(64, 512, 0.08, (8, 128), seed=4)
    jx, tx = _x(rng, 512, 256, xdt)
    got = _f32(t_bsr.spmm_bell(tb, tx).to(BF))
    with pltpu.force_tpu_interpret_mode():
        want = j_bsr._spmm_bell_pallas_resident(jb, jx, j_bsr._resident_bk(jb, 256))
    assert want.dtype == JBF
    want = _f32(want)
    _within(got, want, _bf16_ulp(np.abs(want)), "vs the resident kernel")


@pytest.mark.parametrize("xdt", [torch.float32, BF])
def test_spmm_bell_bf16_matches_streamed_kernel(xdt):
    """Against ``_spmm_bell_pallas`` in interpret mode, which sums the W
    block products in its bf16 output block: within W·2⁻⁸·(|A|·|X|)."""
    rng, jb, tb = _bf16_pair(64, 512, 0.08, (8, 128), seed=5)
    jx, tx = _x(rng, 512, 128, xdt)
    got = _f32(t_bsr.spmm_bell(tb, tx))
    with pltpu.force_tpu_interpret_mode():
        want = j_bsr._spmm_bell_pallas(jb, jx)
    assert want.dtype == JBF
    _within(got, _f32(want), jb.width * BF16_ROUND * _mag(jb, jx), "vs the streamed kernel")


@pytest.mark.parametrize("blockshape", [(8, 128), (32, 128)])
@pytest.mark.parametrize("xdt", [torch.float32, BF])
def test_spmm_bell_bf16_irregular(blockshape, xdt):
    """bf16 blocks on a BELL that ``csr_to_bell`` never gives (shuffled
    slots, explicit zero blocks and chunks, repeated columns, empty block
    rows) against the same matrix's ``spmm_bell_jnp``; ``spmv_bell``
    against JAX's."""
    m, n = 128, 1024
    rng, data, cols = _irregular_bell(blockshape, m, n, W=5, seed=6)
    jb = j_bsr.BELL(data=jnp.asarray(data).astype(JBF), bcols=jnp.asarray(cols),
                    shape=(m, n), nnz=int(np.count_nonzero(data)))
    tb = bell_from_jax(jb).to("cpu")
    jx, tx = _x(rng, n, 64, xdt)
    got = t_bsr.spmm_bell(tb, tx)
    want = _jnp_spmm(jb, jx)
    assert str(got.dtype).removeprefix("torch.") == np.dtype(want.dtype).name
    mag = _mag(jb, jx)
    bf16 = xdt == BF
    bound = _bf16_ulp(np.abs(_f32(want))) if bf16 else FLOAT32_SUMS * EPS32 * mag
    _within(_f32(got), _f32(want), bound, "vs spmm_bell_jnp")
    empty = np.repeat(~data.any(axis=(1, 2, 3)), blockshape[0])
    assert empty.any() and not _f32(got)[empty].any()
    v = t_bsr.spmv_bell(tb, tx[:, 0])
    jv = j_bsr.spmv_bell(jb, jx[:, 0])
    _within(_f32(v), _f32(jv), bound[:, 0], "spmv_bell vs JAX's")
