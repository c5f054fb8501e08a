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
from gflownet_spai_tpu_torch.train.config import TrainConfig
from gflownet_spai_tpu_torch.train.loop import setup

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
    """``make_env(reward_path="rowblock")`` builds the row-block env, an
    unknown reward path is refused, and ``env_format='dia'`` builds the
    DIA env."""
    from gflownet_spai_tpu_torch.env.spai_dia import SpaiDiaEnv

    ja, ta, js, ts = _seeds("LF10_like")
    env = t_spai.make_env(ts, original=ta, reward_path="rowblock", device="cpu")
    assert env.rb is not None and env.plan is None
    with pytest.raises(ValueError, match="reward_path"):
        t_spai.make_env(ts, original=ta, reward_path="nosuch", device="cpu")
    _, _, env, *_ = setup(TrainConfig(matrix="LF10_like", env_format="dia",
                                      platform="cpu"))
    assert isinstance(env, SpaiDiaEnv)


# ---------------------------------------------------------------------------
# CSR / ELL / BSR containers, conversions, SpMV / SpMM, SpGEMM and utils
# ---------------------------------------------------------------------------

def _formats(name):
    """Each format of the same float32 matrix from both packages."""
    from gflownet_spai_tpu import sparse as js
    from gflownet_spai_tpu_torch import sparse as ts

    j, t = _f32_pair(name)
    jc, tc = js.coo_to_csr(j), ts.coo_to_csr(t)
    m, n = t.shape
    pad = (-m % 8, -n % 16)
    jp = JCOO(row=j.row, col=j.col, data=j.data, shape=(m + pad[0], n + pad[1]))
    tp = TCOO(row=t.row, col=t.col, data=t.data, shape=(m + pad[0], n + pad[1]))
    return dict(coo=(j, t), csr=(jc, tc),
                ell=(js.csr_to_ell(jc, pad_multiple=4), ts.csr_to_ell(tc, pad_multiple=4)),
                bsr=(js.csr_to_bsr(js.coo_to_csr(jp), (8, 16)),
                     ts.csr_to_bsr(ts.coo_to_csr(tp), (8, 16))))


@pytest.mark.parametrize("name", ["LF10_like", "orsirr_like12"])
def test_sparse_formats_match(name):
    """CSR / ELL / BSR conversions field by field, ``todense``, ``to_coo``
    and ``spmv`` / ``spmm`` of every format against the JAX package
    (float32, rtol 1e-5, atol 1e-5: sums in other orders)."""
    from gflownet_spai_tpu import sparse as js
    from gflownet_spai_tpu_torch import sparse as ts

    fields = dict(coo=("row", "col", "data"), csr=("indptr", "indices", "data"),
                  ell=("cols", "data"), bsr=("indptr", "indices", "data"))
    rng = np.random.default_rng(0)
    for fmt, (j, t) in _formats(name).items():
        for f in fields[fmt]:
            np.testing.assert_array_equal(np.asarray(getattr(t, f)),
                                          np.asarray(getattr(j, f)), err_msg=fmt + f)
        np.testing.assert_array_equal(t.todense().numpy(), np.asarray(j.todense()))
        jc, tc = js.to_coo(j), ts.to_coo(t)
        np.testing.assert_array_equal(np.asarray(tc.row), np.asarray(jc.row))
        np.testing.assert_array_equal(np.asarray(tc.data), np.asarray(jc.data))
        x = rng.standard_normal(t.shape[1]).astype(np.float32)
        b = rng.standard_normal((t.shape[1], 5)).astype(np.float32)
        td = t.to("cpu")
        np.testing.assert_allclose(ts.spmv(td, torch.as_tensor(x)).numpy(),
                                   np.asarray(js.spmv(j, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5, err_msg=fmt)
        np.testing.assert_allclose(ts.spmm(td, torch.as_tensor(b)).numpy(),
                                   np.asarray(js.spmm(j, jnp.asarray(b))),
                                   rtol=1e-5, atol=1e-5, err_msg=fmt)


def test_spgemm_transpose_eye_and_io_match(tmp_path):
    from gflownet_spai_tpu import sparse as js
    from gflownet_spai_tpu.sparse import ops as j_ops
    from gflownet_spai_tpu_torch import sparse as ts
    from gflownet_spai_tpu_torch.sparse import ops as t_ops

    j, t = _f32_pair("bcsstk03_like")
    jc, tc = js.spgemm(j, j), ts.spgemm(t, t)
    np.testing.assert_array_equal(tc.row.numpy(), np.asarray(jc.row))
    np.testing.assert_array_equal(tc.col.numpy(), np.asarray(jc.col))
    np.testing.assert_allclose(tc.data.numpy(), np.asarray(jc.data), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t_ops.transpose_perm(t), j_ops.transpose_perm(j))
    je, te = js.eye_coo(7), ts.eye_coo(7)
    np.testing.assert_array_equal(te.todense().numpy(), np.asarray(je.todense()))
    a = t_gallery.get("orsirr_like12")
    path = tmp_path / "a.mtx"
    scipy.io.mmwrite(str(path), scipy.sparse.coo_matrix((a.data, (a.row, a.col)),
                                                        shape=a.shape))
    jr, tr = js.read_mtx_csr(path), ts.read_mtx_csr(path)
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(tr, f), np.asarray(getattr(jr, f)))
    vpath = tmp_path / "b.mtx"
    scipy.io.mmwrite(str(vpath), np.arange(1.0, 6.0)[:, None])
    np.testing.assert_array_equal(ts.read_mtx_vector(vpath),
                                  np.asarray(js.read_mtx_vector(vpath)))


def test_sparse_utils_match():
    from gflownet_spai_tpu.sparse import utils as ju
    from gflownet_spai_tpu_torch.sparse import utils as tu

    j, t = _f32_pair("LF10_like")
    td = t.to("cpu")

    def same(tc, jc):
        assert tuple(tc.shape) == tuple(jc.shape)
        for f in ("row", "col", "data"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))

    jf, tf = ju.flatten_coo(j), tu.flatten_coo(td)
    same(tf, jf)
    same(tu.unflatten_coo(tf, t.shape), ju.unflatten_coo(jf, j.shape))
    with pytest.raises(ValueError, match="element counts"):
        tu.unflatten_coo(tf, (3, 3))
    idx = np.array([3, 0, 5, 1])
    same(tu.sparse_one_hot(torch.as_tensor(idx), 7), ju.sparse_one_hot(jnp.asarray(idx), 7))
    for axis in (0, 1):
        same(tu.concat_coo([td, td], axis=axis), ju.concat_coo([j, j], axis=axis))
    pos = np.array([0, 5, -1, t.nnz + 3, 17])
    same(tu.delete_edges_flat(td, torch.as_tensor(pos)),
         ju.delete_edges_flat(j, jnp.asarray(pos)))
