"""PyTorch port vs the JAX package: gallery, ILU(0) seed, pair plan, env
baseline and batched rewards (small matrices, CPU)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse
import torch

from gflownet_spai_tpu.env import ilu as j_ilu
from gflownet_spai_tpu.env import spai as j_spai
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.io import read_mtx as j_read_mtx
from gflownet_spai_tpu.sparse.ops import SpGEMMPlan as JPlan
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.env import spai as t_spai
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse.io import read_mtx as t_read_mtx
from gflownet_spai_tpu_torch.sparse.ops import SpGEMMPlan as TPlan
from gflownet_spai_tpu_torch.sparse.types import COO as TCOO

MATRICES = ["LF10_like", "bcsstk03_like", "orsirr_like12"]


def _f32_pair(name):
    """The same matrix from both packages, values cast to float32 as
    ``setup`` casts them."""
    j = j_gallery.get(name)
    t = t_gallery.get(name)
    j = JCOO(row=j.row, col=j.col, data=j.data.astype(jnp.float32), shape=j.shape)
    t = TCOO(row=t.row, col=t.col, data=t.data.astype(np.float32), shape=t.shape)
    return j, t


def _seeds(name):
    j, t = _f32_pair(name)
    return (j, t, j_ilu.seed_pattern(j, "ilu0", jnp.float32),
            t_ilu.seed_pattern(t, "ilu0", np.float32))


@pytest.mark.parametrize("name", MATRICES)
def test_gallery_matrices_equal(name):
    j, t = j_gallery.get(name), t_gallery.get(name)
    assert tuple(j.shape) == tuple(t.shape)
    np.testing.assert_array_equal(np.asarray(j.row), t.row)
    np.testing.assert_array_equal(np.asarray(j.col), t.col)
    np.testing.assert_array_equal(np.asarray(j.data), t.data)


@pytest.mark.parametrize("name,symmetry", [("bcsstk03_like", "symmetric"),
                                           ("orsirr_like12", "general")])
def test_read_mtx_matches(tmp_path, name, symmetry):
    a = t_gallery.get(name)
    path = tmp_path / f"{name}.mtx"
    m = scipy.sparse.coo_matrix((a.data, (a.row, a.col)), shape=a.shape)
    scipy.io.mmwrite(str(path), m, symmetry=symmetry)
    j, t = j_read_mtx(path), t_read_mtx(path)
    assert tuple(j.shape) == tuple(t.shape) == tuple(a.shape)
    np.testing.assert_array_equal(np.asarray(j.row), t.row)
    np.testing.assert_array_equal(np.asarray(j.col), t.col)
    np.testing.assert_allclose(t.data, np.asarray(j.data), rtol=1e-15)
    np.testing.assert_array_equal(t.row, a.row)   # the stored entries, sorted


@pytest.mark.parametrize("name", MATRICES)
def test_ilu0_seed_matches(name):
    _, _, js, ts = _seeds(name)
    np.testing.assert_array_equal(np.asarray(js.row), ts.row)
    np.testing.assert_array_equal(np.asarray(js.col), ts.col)
    np.testing.assert_allclose(ts.data, np.asarray(js.data), rtol=1e-6)


@pytest.mark.parametrize("name", ["LF10_like", "bcsstk03_like"])
def test_spgemm_plan_pattern_and_numeric(name):
    ja, ta, js, ts = _seeds(name)
    jp, tp = JPlan(js, ja), TPlan(ts, ta, device="cpu")
    np.testing.assert_array_equal(np.asarray(jp.out_row), tp.out_row.numpy())
    np.testing.assert_array_equal(np.asarray(jp.out_col), tp.out_col.numpy())
    rng = np.random.default_rng(5)
    a_vals = rng.standard_normal(ts.nnz).astype(np.float32)
    b_vals = rng.standard_normal(ta.nnz).astype(np.float32)
    want = np.asarray(jp.numeric(jnp.asarray(a_vals), jnp.asarray(b_vals)))
    got = tp.numeric(torch.as_tensor(a_vals), torch.as_tensor(b_vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["LF10_like", "bcsstk03_like"])
@pytest.mark.parametrize("baseline", ["matrix", "identity", "auto"])
def test_make_env_baseline_matches(name, baseline):
    ja, ta, js, ts = _seeds(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert (t_spai.resolve_baseline(ts, ta, baseline)
                == j_spai.resolve_baseline(js, ja, baseline))
        jenv = j_spai.make_env(js, original=ja, baseline=baseline)
        tenv = t_spai.make_env(ts, original=ta, baseline=baseline, device="cpu")
    assert tenv.num_actions == jenv.num_actions
    assert tenv.baseline_flops == jenv.baseline_flops
    np.testing.assert_allclose(float(tenv.baseline_residual),
                               float(jenv.baseline_residual), rtol=1e-5)


def _action_lists(rng, num_edges, batch):
    """-1-padded delete lists, most ending in the terminal action."""
    T = num_edges + 1
    acts = np.full((batch, T), -1, np.int64)
    for b in range(batch):
        k = int(rng.integers(0, num_edges))
        row = rng.permutation(num_edges)[:k].tolist()
        if b % 3:
            row.append(num_edges)     # terminal
        acts[b, :len(row)] = row
    return acts


@pytest.mark.parametrize("name", ["LF10_like", "bcsstk03_like"])
def test_batched_rewards_match(name):
    ja, ta, js, ts = _seeds(name)
    jenv = j_spai.make_env(js, original=ja)
    tenv = t_spai.make_env(ts, original=ta, device="cpu")
    acts = _action_lists(np.random.default_rng(1), ts.nnz, 7)
    alpha = np.float32(0.7)
    want = np.asarray(j_spai.batched_rewards(
        jenv, jnp.asarray(acts, jnp.int32), jnp.asarray(alpha)))
    got = t_spai.batched_rewards(tenv, torch.as_tensor(acts),
                                 torch.tensor(alpha)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_unported_paths_raise():
    ja, ta, js, ts = _seeds("LF10_like")
    with pytest.raises(NotImplementedError, match="rowblock"):
        t_spai.make_env(ts, original=ta, reward_path="rowblock", device="cpu")
    with pytest.raises(NotImplementedError, match="spai_classic"):
        t_ilu.seed_pattern(ta, "spai")
