"""``ops.scan`` of the port against the JAX package: ``linear_scan`` values
and gradients (the analytic one-reverse-scan adjoint) and the
``suffix_logsumexp`` adjoint, finite on −inf lanes.

Tolerance rtol 1e-5, atol 1e-5: float32 throughout, and the port's doubling
scan associates the products in another order than JAX's
``associative_scan``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops import scan as j_scan
from gflownet_spai_tpu_torch.ops import scan as t_scan
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL, ATOL = 1e-5, 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape,axis", [((37, 3), 0), ((4, 50), -1),
                                        ((3, 33, 5), -2), ((1, 1), 0)])
def test_linear_scan_values_and_grads(shape, axis):
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.3, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    tgt = rng.standard_normal(shape).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(j_scan.linear_scan(a, b, axis) * tgt)

    want_h = j_scan.linear_scan(jnp.asarray(a), jnp.asarray(b), axis)
    want_da, want_db = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a),
                                                       jnp.asarray(b))
    ta = torch.as_tensor(a).requires_grad_(True)
    tb = torch.as_tensor(b).requires_grad_(True)
    h = t_scan.linear_scan(ta, tb, axis)
    _close(h, want_h)
    da, db = torch.autograd.grad((h * torch.as_tensor(tgt)).sum(), (ta, tb))
    _close(da, want_da)
    _close(db, want_db)


def test_linear_scan_broadcast_gate():
    """A [..., T, 1] gate broadcast over [..., T, H] values (the linear
    backward policy's use): its gradient sums over the broadcast axis, as
    ``jnp.broadcast_to`` outside the JAX call gives."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.2, 1.0, (2, 40, 1)).astype(np.float32)
    b = rng.standard_normal((2, 40, 4)).astype(np.float32)
    tgt = rng.standard_normal((2, 40, 4)).astype(np.float32)
    want = jax.jit(jax.grad(lambda a, b: jnp.sum(j_scan.linear_scan(
        jnp.broadcast_to(a, b.shape), b, -2) * tgt), argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    ta = torch.as_tensor(a).requires_grad_(True)
    tb = torch.as_tensor(b).requires_grad_(True)
    got = torch.autograd.grad(
        (t_scan.linear_scan(ta, tb, axis=-2) * torch.as_tensor(tgt)).sum(), (ta, tb))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


def test_suffix_logsumexp_grad_finite_on_neg_inf_lanes():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 30)).astype(np.float32)
    x[1, 20:] = -np.inf          # trailing −inf lanes (padded taken list)
    x[2, ::3] = -np.inf          # interleaved −inf lanes
    x[3, :] = -np.inf            # a row with nothing left
    sbar = rng.standard_normal((4, 30)).astype(np.float32)

    def jloss(x):
        s = j_scan.suffix_logsumexp(x)
        return jnp.sum(jnp.where(jnp.isfinite(s), s, 0.0) * sbar)

    want_s = j_scan.suffix_logsumexp(jnp.asarray(x))
    want_g = jax.jit(jax.grad(jloss))(jnp.asarray(x))
    tx = torch.as_tensor(x).requires_grad_(True)
    s = t_scan.suffix_logsumexp(tx)
    np.testing.assert_array_equal(np.isfinite(s.detach().numpy()),
                                  np.isfinite(np.asarray(want_s)))
    fin = np.isfinite(np.asarray(want_s))
    np.testing.assert_allclose(s.detach().numpy()[fin], np.asarray(want_s)[fin],
                               rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(
        (torch.where(torch.isfinite(s), s, 0.0) * torch.as_tensor(sbar)).sum(), tx)
    assert torch.isfinite(g).all()
    _close(g, want_g)
