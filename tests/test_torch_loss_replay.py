"""The GFlowNet objectives, the replay buffer, the flow head and the three
backward policies of the port against the JAX package, on the same numpy
inputs and carried-over parameters.

Tolerances: values and gradients rtol 5e-5, atol 5e-5 (float32 sums in
another order; the gradients' bound is the repo's own, tests/test_segment.py,
tightened where the math has no long sums); replay rewards and sampling
logits are moved or ranked, not computed, so they must match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.gfn import loss as j_loss
from gflownet_spai_tpu.gfn import replay as j_replay
from gflownet_spai_tpu.models import policies as j_pol
from gflownet_spai_tpu_torch.gfn import loss as t_loss
from gflownet_spai_tpu_torch.gfn import replay as t_replay
from gflownet_spai_tpu_torch.models import policies as t_pol

RTOL, ATOL = 5e-5, 5e-5


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _t(x, grad=False):
    return torch.as_tensor(np.asarray(x)).requires_grad_(grad)


def _batch(seed=0, B=5, T=9):
    """Per-step log-probs, flows and rewards for B trajectories of T slots;
    entry B−1 has length 0 (an empty replay slot)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, T + 1, B)
    lengths[-1] = 0
    on = np.arange(T)[None, :] < lengths[:, None]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(fwd=np.where(on, -np.abs(f(B, T)), 0).astype(np.float32),
                back=np.where(on, -np.abs(f(B, T)), 0).astype(np.float32),
                flows=f(B, T + 1), log_r=f(B), lengths=lengths.astype(np.int32),
                weights=np.r_[rng.uniform(0.5, 1.5, B - 1), 0.0].astype(np.float32),
                terminated=np.r_[rng.integers(0, 2, B - 1) == 1, True],
                log_z=np.float32(0.7))


def _grads_both(jfn, tfn, arrays):
    """Value and gradient of a scalar function in every array, both sides."""
    keys = list(arrays)
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(len(keys)))))(
        *(jnp.asarray(arrays[k]) for k in keys))
    leaves = [_t(arrays[k], True) for k in keys]
    tv = tfn(*leaves)
    tg = torch.autograd.grad(tv, leaves)
    return (jv, jg), (tv, tg)


@pytest.mark.parametrize("weighted", [False, True])
def test_tb_and_vargrad_match(weighted):
    d = _batch(1)
    w = d["weights"] if weighted else None
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else _t(w)
    arrays = dict(log_z=d["log_z"], log_r=d["log_r"], fwd=d["fwd"].sum(-1),
                  back=d["back"].sum(-1))
    (jv, jg), (tv, tg) = _grads_both(
        lambda z, r, f, b: j_loss.trajectory_balance_loss(z, r, f, b, weights=wj),
        lambda z, r, f, b: t_loss.trajectory_balance_loss(z, r, f, b, weights=wt),
        arrays)
    _close(tv, jv)
    for g, w_ in zip(tg, jg):
        _close(g, w_)
    del arrays["log_z"]
    (jv, jg), (tv, tg) = _grads_both(
        lambda r, f, b: j_loss.vargrad_loss(r, f, b, weights=wj),
        lambda r, f, b: t_loss.vargrad_loss(r, f, b, weights=wt), arrays)
    _close(tv, jv)
    for g, w_ in zip(tg, jg):
        _close(g, w_)


@pytest.mark.parametrize("lam", [0.9, 1.0])
@pytest.mark.parametrize("partial", [False, True])
def test_subtb_matches(lam, partial):
    """Weights with a length-0 weight-0 entry (tests/test_gfn.py's
    regression: finite, not 0/0), and ``terminated`` for partial
    trajectories."""
    d = _batch(2)
    term = d["terminated"] if partial else None
    lengths = d["lengths"]
    arrays = dict(flows=d["flows"], log_r=d["log_r"], fwd=d["fwd"], back=d["back"])
    (jv, jg), (tv, tg) = _grads_both(
        lambda fl, r, f, b: j_loss.subtb_loss(
            fl, r, f, b, jnp.asarray(lengths), lam=lam,
            weights=jnp.asarray(d["weights"]),
            terminated=None if term is None else jnp.asarray(term)),
        lambda fl, r, f, b: t_loss.subtb_loss(
            fl, r, f, b, _t(lengths).long(), lam=lam, weights=_t(d["weights"]),
            terminated=None if term is None else _t(term)),
        arrays)
    assert np.isfinite(float(tv.detach()))
    _close(tv, jv)
    for g, w_ in zip(tg, jg):
        assert torch.isfinite(g).all()
        _close(g, w_)


def test_log_reward_matches():
    r = np.array([-3.0, 0.0, 1e-12, 2.5, 1000.0], np.float32)
    _close(t_loss.log_reward(_t(r)), j_loss.log_reward(jnp.asarray(r)))


# ---------------------------------------------------------------------------
# Replay buffer
# ---------------------------------------------------------------------------

def _traj_batch(rng, B, T, A):
    """B −1-padded trajectories over A actions (terminal A−1), a few
    repeated, with rewards."""
    acts = np.full((B, T), -1, np.int64)
    for b in range(B):
        k = int(rng.integers(0, T))
        acts[b, :k] = rng.choice(A - 1, k, replace=False)
        acts[b, k] = A - 1
    acts[1] = acts[0]                       # a duplicate trajectory
    return acts, rng.standard_normal(B).astype(np.float32) * 10


def _filled(buf):
    r = np.asarray(buf.rewards if not isinstance(buf.rewards, torch.Tensor)
                   else buf.rewards.numpy())
    a = np.asarray(buf.actions if not isinstance(buf.actions, torch.Tensor)
                   else buf.actions.numpy())
    keep = np.isfinite(r)
    rows = sorted((float(x), tuple(int(v) for v in y))
                  for x, y in zip(r[keep], a[keep]))
    return rows


def test_replay_update_and_resize_match():
    rng = np.random.default_rng(0)
    K, T, A = 6, 8, 30
    jb, tb = j_replay.replay_init(K, T), t_replay.replay_init(K, T)
    for _ in range(4):
        acts, rew = _traj_batch(rng, 5, T, A)
        jb = j_replay.replay_update(jb, jnp.asarray(acts, jnp.int32), jnp.asarray(rew))
        tb = t_replay.replay_update(tb, _t(acts), _t(rew))
        assert _filled(tb) == _filled(jb)
    assert len(_filled(tb)) == K
    for width in (12, 5, T):
        assert _filled(t_replay.replay_resize(tb, width)) \
            == _filled(j_replay.replay_resize(jb, width))
        assert t_replay.replay_resize(tb, width).actions.shape == (K, width)


def test_replay_signatures_wrap_as_int32():
    """The port's signatures are JAX's int32 wraparound sums.  (The tests
    run JAX with x64 on, where its int32 products sum into int64; reduced
    mod 2^32 that is the int32 sum JAX computes without x64.)"""
    rng = np.random.default_rng(5)
    acts = rng.integers(-1, 200000, (7, 3000))
    want = np.asarray(j_replay._signatures(jnp.asarray(acts, jnp.int32)))
    want = ((want.astype(np.int64) + 2**31) % 2**32) - 2**31
    got = t_replay._signatures(_t(acts)).numpy()
    assert got.dtype == np.int64 and np.abs(got).max() < 2**31
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prioritized", [0.0, 1.0])
def test_replay_sample_logits_match(monkeypatch, prioritized):
    """The categorical logits ``replay_sample`` draws from: JAX's are
    captured at ``jax.random.categorical``; draws come from each side's own
    generator and always land on filled slots."""
    rng = np.random.default_rng(1)
    K, T, A = 8, 6, 20
    jb, tb = j_replay.replay_init(K, T), t_replay.replay_init(K, T)
    acts, rew = _traj_batch(rng, 5, T, A)
    jb = j_replay.replay_update(jb, jnp.asarray(acts, jnp.int32), jnp.asarray(rew))
    tb = t_replay.replay_update(tb, _t(acts), _t(rew))
    seen = {}

    def capture(key, logits, shape=None, **kw):
        seen["logits"] = np.asarray(logits)
        return jnp.zeros(shape, jnp.int32)

    monkeypatch.setattr(jax.random, "categorical", capture)
    j_replay.replay_sample(jb, jax.random.PRNGKey(0), 3, prioritized=prioritized)
    # compare on the filled slots, in buffer order of rewards (ties in the
    # top-k order may differ between the two frameworks)
    jr, tr = np.asarray(jb.rewards), tb.rewards.numpy()
    jl, tl = seen["logits"], t_replay.replay_logits(tb, prioritized).numpy()
    np.testing.assert_array_equal(np.sort(tl[np.isfinite(tr)]),
                                  np.sort(jl[np.isfinite(jr)]))
    assert np.isneginf(tl[~np.isfinite(tr)]).all()
    a, r, valid = t_replay.replay_sample(tb, torch.Generator().manual_seed(0),
                                         50, prioritized=prioritized)
    assert bool(valid.all()) and torch.isfinite(r).all()
    empty = t_replay.replay_init(4, T)
    assert not bool(t_replay.replay_sample(empty, torch.Generator(), 5)[2].any())


# ---------------------------------------------------------------------------
# Flow head and backward policies
# ---------------------------------------------------------------------------

A_POL, T_POL, HID = 40, 12, 4


def _padded_actions(seed=0, B=4):
    rng = np.random.default_rng(seed)
    acts = np.full((B, T_POL), -1, np.int64)
    for b in range(B - 1):
        k = int(rng.integers(0, T_POL))
        acts[b, :k] = rng.choice(A_POL - 1, k, replace=False)
        acts[b, k] = A_POL - 1
    return acts                               # the last row is all padding


def _to_torch(p, cls):
    return cls(*(torch.tensor(np.asarray(x)) for x in p))


def _policy_grads(jfn, tfn, jp, cls, acts, tgt):
    want_lp = jfn(jp, jnp.asarray(acts, jnp.int32))
    want_g = jax.jit(jax.grad(
        lambda p: jnp.sum(jfn(p, jnp.asarray(acts, jnp.int32)) * tgt)))(jp)
    tp = _to_torch(jp, cls)
    leaves = [x.requires_grad_(True) for x in tp]
    got_lp = tfn(cls(*leaves), torch.as_tensor(acts))
    got_g = torch.autograd.grad((got_lp * torch.as_tensor(tgt)).sum(), leaves,
                                allow_unused=True)
    _close(got_lp, want_lp)
    for g, w in zip(got_g, want_g):
        _close(torch.zeros(w.shape) if g is None else g, w)


def test_flow_head_matches():
    rng = np.random.default_rng(2)
    jp = j_pol.FlowHeadParams(
        poly_w=jnp.asarray(rng.standard_normal(4), jnp.float32),
        edge_d=jnp.asarray(rng.standard_normal(A_POL), jnp.float32))
    acts = _padded_actions(2)
    tgt = rng.standard_normal((acts.shape[0], T_POL + 1)).astype(np.float32)
    _policy_grads(j_pol.flow_head_logF, t_pol.flow_head_logF, jp,
                  t_pol.FlowHeadParams, acts, tgt)


def test_lstm_backward_matches():
    jp = j_pol.backward_policy_init(jax.random.PRNGKey(4), HID, A_POL,
                                    dtype=jnp.float32)
    acts = _padded_actions(4)
    tgt = np.random.default_rng(4).standard_normal(acts.shape).astype(np.float32)
    _policy_grads(lambda p, a: j_pol.backward_policy_batch(p, a, HID),
                  lambda p, a: t_pol.backward_policy_batch(p, a, HID),
                  jp, t_pol.BackwardPolicyParams, acts, tgt)
    # the one-trajectory form is the batch's row
    tp = _to_torch(jp, t_pol.BackwardPolicyParams)
    a0 = torch.as_tensor(acts[0])
    _close(t_pol.backward_policy_logprobs(tp, a0, HID),
           j_pol.backward_policy_logprobs(jp, jnp.asarray(acts[0], jnp.int32), HID))


def test_linear_backward_matches():
    jp = j_pol.linear_backward_init(jax.random.PRNGKey(5), HID, A_POL,
                                    dtype=jnp.float32)
    rng = np.random.default_rng(5)
    jp = jp._replace(emb_g=jnp.asarray(rng.standard_normal(A_POL), jnp.float32))
    acts = _padded_actions(5)
    tgt = rng.standard_normal(acts.shape).astype(np.float32)
    _policy_grads(j_pol.linear_backward_batch, t_pol.linear_backward_batch, jp,
                  t_pol.LinearBackwardParams, acts, tgt)
    tp = _to_torch(jp, t_pol.LinearBackwardParams)
    _close(t_pol.linear_backward_logprobs(tp, torch.as_tensor(acts[1])),
           j_pol.linear_backward_logprobs(jp, jnp.asarray(acts[1], jnp.int32)))


def test_uniform_backward_matches():
    acts = _padded_actions(6)
    _close(t_pol.uniform_backward_logprobs(torch.as_tensor(acts), A_POL - 1),
           j_pol.uniform_backward_logprobs(jnp.asarray(acts, jnp.int32), A_POL - 1))
