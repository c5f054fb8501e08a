"""The sampling slice as a whole: the port's ``setup`` and ``sample`` against
the JAX package on ``orsirr_like16`` with the bucketed tile layout, the
port's own trajectories scored by JAX; device selection; and the import
boundary (the port loads no JAX)."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.env import spai as j_spai
from gflownet_spai_tpu.gfn.rollout import trajectory_logprobs as j_traj_lp
from gflownet_spai_tpu.models import policies as j_pol
from gflownet_spai_tpu.train import TrainConfig as JConfig
from gflownet_spai_tpu.train import setup as j_setup
from gflownet_spai_tpu_torch.convert import params_from_jax
from gflownet_spai_tpu_torch.gfn import sample as t_sample
from gflownet_spai_tpu_torch.train import TrainConfig as TConfig
from gflownet_spai_tpu_torch.train import setup as t_setup

REPO = Path(__file__).resolve().parent.parent
CFG = dict(matrix="orsirr_like16", env_format="coo", gat_tiled_min_edges=0)


@pytest.fixture(scope="module")
def both():
    ja, jseed, jenv, jgraph, jmcfg, _, jstate = j_setup(JConfig(**CFG))
    ta, tseed, tenv, tgraph, tmcfg, _, _ = t_setup(TConfig(platform="cpu", **CFG))
    return dict(jseed=jseed, jenv=jenv, jgraph=jgraph, jmcfg=jmcfg,
                jparams=jstate.params, tseed=tseed, tenv=tenv, tgraph=tgraph,
                tmcfg=tmcfg)


def _eq(t, j):
    np.testing.assert_array_equal(
        t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t), np.asarray(j))


def test_setup_matches(both):
    js, ts, je, te = both["jseed"], both["tseed"], both["jenv"], both["tenv"]
    assert te.num_actions == je.num_actions == both["jmcfg"].num_actions \
        == both["tmcfg"].num_actions == 1673
    _eq(ts.row, js.row)
    _eq(ts.col, js.col)
    np.testing.assert_allclose(ts.data, np.asarray(js.data), rtol=1e-6)
    _eq(te.plan.out_row, je.plan.out_row)
    _eq(te.plan.out_col, je.plan.out_col)
    np.testing.assert_allclose(float(te.baseline_residual),
                               float(je.baseline_residual), rtol=1e-5)
    assert te.baseline_flops == je.baseline_flops
    jg, tg = both["jgraph"], both["tgraph"]
    assert [(b.tiles.tiles, b.tiles.slots) for b in tg.gat_buckets] \
        == [(b.tiles.tiles, b.tiles.slots) for b in jg.gat_buckets] \
        == [(2, 128), (2, 1024)]
    for tb, jb in zip(tg.gat_buckets, jg.gat_buckets):
        _eq(tb.tiles.local_dst, jb.tiles.local_dst)
        _eq(tb.tile_idx, jb.tile_idx)
        _eq(tb.src_t, jb.src_t)
        for f in ("lsrc", "blk", "out_slot", "out_src"):
            _eq(getattr(tb.srcwin, f), getattr(jb.srcwin, f))
    _eq(tg.tiles.local_dst, jg.tiles.local_dst)
    _eq(tg.src_t, jg.src_t)


def test_sample_scored_by_jax(both):
    """Carried-over params, the port's own draws: JAX agrees on the logits,
    on every reward and on every per-step log-prob."""
    jparams, mcfg = both["jparams"], both["tmcfg"]
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    gen = torch.Generator().manual_seed(0)
    out = t_sample(tparams, both["tenv"], both["tgraph"], mcfg, gen, 6)
    jlogits = j_pol.forward_policy_logits(jparams.forward, both["jgraph"],
                                          mcfg.num_actions, mcfg.hidden_dim,
                                          mcfg.heads)
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-5)
    actions = out.rollout.actions.numpy()
    lengths = out.rollout.lengths.numpy()
    assert (actions[np.arange(6), lengths - 1] == mcfg.num_actions - 1).all()
    want_r = j_spai.batched_rewards(both["jenv"], jnp.asarray(actions, jnp.int32),
                                    j_pol.forward_policy_alpha(jparams.forward))
    np.testing.assert_allclose(out.rewards.numpy(), np.asarray(want_r),
                               rtol=1e-5, atol=1e-3)
    want_lp = np.asarray(jax.vmap(lambda a: j_traj_lp(jlogits, a))(
        jnp.asarray(actions, jnp.int32)))
    np.testing.assert_allclose(out.rollout.fwd_logprobs.numpy(), want_lp,
                               rtol=1e-5, atol=1e-4)


def test_setup_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_setup(TConfig(**CFG))


@pytest.mark.parametrize("overrides,slice_word", [
    (dict(env_format="rowblock"), "rowblock"),
    (dict(env_format="auto", rowblock_min_nnz=100), "rowblock"),   # unstructured
    (dict(env_format="auto", matrix="LF10_like"), "DIA"),          # banded
    (dict(env_format="dia"), "DIA"),
])
def test_unported_env_formats_raise(overrides, slice_word):
    """``env_format`` ``rowblock``, ``dia`` and an ``auto`` that resolves to
    either: ``setup`` builds the env JAX's ``setup`` builds (the row-block
    env, the DIA env, with the same action count), or refuses as JAX does:
    ``dia`` on orsirr_like12, whose ILU(0) seed stores zeros inside its
    diagonals."""
    cfg = {**CFG, "matrix": "orsirr_like12", **overrides}
    try:
        _, _, jenv, *_ = j_setup(JConfig(**cfg))
    except ValueError as e:
        assert slice_word == "DIA" and "phantom" in str(e)
        with pytest.raises(ValueError, match="phantom"):
            t_setup(TConfig(platform="cpu", **cfg))
        return
    _, _, tenv, *_ = t_setup(TConfig(platform="cpu", **cfg))
    kind = lambda env: ("DIA" if type(env).__name__ == "SpaiDiaEnv" else
                        "rowblock" if env.rb is not None else "coo")
    assert kind(tenv) == kind(jenv) == slice_word
    assert tenv.num_actions == jenv.num_actions


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gflownet_spai_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gflownet_spai_tpu' or m.startswith('gflownet_spai_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('gflownet_spai_tpu_torch')]))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    assert "gflownet_spai_tpu_torch" in {n.split(".")[0] for n in names}
    assert not {n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "gflownet_spai_tpu")}
