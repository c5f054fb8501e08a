"""PyTorch port vs the JAX package: the validation harness
(``validate_preconditioners``), the port's validate CLI on the CPU (its
V-cycle row included), its checkpoint restore, and the classic-SPAI seed
pattern.

Iteration counts must be equal: both harnesses run the same float64
matrices (bcsstk03_like from the gallery, the JAX package with x64), or,
for the CLI's float32 rows, the same float32 arithmetic.  The SPAI seed
solves its least squares in float32 on both sides: rtol 1e-4, atol 1e-6."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.env import ilu as j_ilu
from gflownet_spai_tpu.solvers import solve_with_gmres as j_solve_with_gmres
from gflownet_spai_tpu.solvers import validate_preconditioners as j_validate
from gflownet_spai_tpu.solvers.precond import ilu_solve_op as j_ilu_op
from gflownet_spai_tpu.solvers.spai_classic import spai_classic as j_spai_classic
from gflownet_spai_tpu.sparse import gallery as j_gallery
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.solvers import validate_preconditioners as t_validate
from gflownet_spai_tpu_torch.sparse import gallery as t_gallery
from gflownet_spai_tpu_torch.sparse.types import COO as TCOO
from gflownet_spai_tpu_torch.train import TrainConfig as TConfig
from gflownet_spai_tpu_torch.train import train as t_train
from gflownet_spai_tpu_torch.validate.__main__ import main as validate_main

MATRIX = "bcsstk03_like"
CLI = ["--matrix", MATRIX, "--epochs", "8", "--batch-size", "4", "--maxiter", "500",
       "--jacobi-poly", "4", "--chebyshev", "4", "--platform", "cpu"]
ROWS = ("none", "ilu", "sampled_spai", "classic_spai", "jacobi_poly", "chebyshev")


def test_validate_preconditioners_matches_jax():
    ja, ta = j_gallery.get(MATRIX), t_gallery.get(MATRIX)
    jm = j_spai_classic(ja, k=1, dtype=jnp.float64)
    tm = TCOO(row=np.asarray(jm.row), col=np.asarray(jm.col),
              data=np.asarray(jm.data), shape=jm.shape)
    want = j_validate(ja, sampled_m=jm, jacobi_poly=4)
    got = t_validate(ta, sampled_m=tm, jacobi_poly=4, device="cpu")
    assert set(got) == set(want) == {"none", "ilu", "spai", "jacobi_poly"}
    for key in want:
        assert got[key].iterations == want[key].iterations, key
        assert got[key].converged == want[key].converged, key
        np.testing.assert_allclose(got[key].final_residual, want[key].final_residual,
                                   rtol=1e-6)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("validate")
    rc = validate_main(CLI + ["--out-dir", str(out)])
    return rc, json.loads((out / "validation.json").read_text())


def test_validate_cli_writes_the_rows(cli_run, capsys):
    rc, report = cli_run
    assert rc in (0, 1)
    for key in ROWS:
        assert key in report and report[key]["iterations"] >= 1, key
        assert np.isfinite(report[key]["true_residual"]), key
    assert "vcycle" not in report
    assert report["jacobi_poly"]["iterations"] <= report["none"]["iterations"]
    assert report["chebyshev"]["iterations"] <= report["none"]["iterations"]
    assert report["sampled_spai"]["seed_nnz"] == 726     # the spai seed


def test_validate_cli_rows_match_jax(cli_run):
    """The CLI's none and ILU rows (float32 A and b, float64 ILU factors)
    against JAX's GMRES(20) on the same operands."""
    _, report = cli_run
    a = j_gallery.get(MATRIX)
    a32 = JCOO(row=a.row, col=a.col, data=jnp.asarray(a.data, jnp.float32),
               shape=a.shape)
    b = jnp.ones((a.shape[0],), jnp.float32)
    L, U = j_ilu.ilu0(a32)
    for key, m in (("none", None), ("ilu", j_ilu_op(L, U))):
        _, res, iters, _ = j_solve_with_gmres(a32, b, m, maxiter=500, restart=20)
        assert report[key]["iterations"] == iters, key
        np.testing.assert_allclose(report[key]["final_residual"], float(res[-1]),
                                   rtol=1e-3)


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_validate_cli_vcycle_matches_jax(tmp_path, monkeypatch, smoother):
    """``--vcycle 2``: the CLI's vcycle row (float32) takes as many GMRES(20)
    iterations as JAX's ``vcycle_op`` on the same float32 matrix (n 112 is
    below ``min_coarse_n``, so one level: 16 Jacobi sweeps, or a degree-32
    Chebyshev polynomial whose λmax both sides estimate from JAX's start
    vector).  JAX's solve runs unjitted: jit compiles the cycle's 185
    diagonals × 16 sweeps for many minutes."""
    import jax

    from gflownet_spai_tpu.ops.dia import coo_to_dia as j_coo_to_dia
    from gflownet_spai_tpu.solvers.multigrid import vcycle_op as j_vcycle_op
    from gflownet_spai_tpu_torch.solvers import multigrid as t_mg
    from gflownet_spai_tpu_torch.solvers import stationary as t_st

    def lmax(d, iters=20, seed=0):
        v0 = jax.random.normal(jax.random.PRNGKey(seed), (d.n,), jnp.float32)
        return t_st.estimate_lmax(d, iters, v0=torch.tensor(np.asarray(v0)))

    monkeypatch.setattr(t_mg, "estimate_lmax", lmax)
    rc = validate_main(["--matrix", MATRIX, "--epochs", "1", "--batch-size", "4",
                        "--maxiter", "500", "--final-samples", "16", "--vcycle", "2",
                        "--vcycle-smoother", smoother, "--platform", "cpu",
                        "--out-dir", str(tmp_path)])
    assert rc in (0, 1)
    row = json.loads((tmp_path / "validation.json").read_text())["vcycle"]
    assert row["levels"] == 2 and row["smoother"] == smoother
    a = j_gallery.get(MATRIX)
    a32 = JCOO(row=a.row, col=a.col, data=jnp.asarray(a.data, jnp.float32),
               shape=a.shape)
    op = j_vcycle_op(j_coo_to_dia(a32, max_diags=10**6), levels=2, smoother=smoother)
    with jax.disable_jit():
        _, res, iters, _ = j_solve_with_gmres(a32, jnp.ones((a.shape[0],), jnp.float32),
                                              op, maxiter=500, restart=20)
    assert row["iterations"] == iters < 500
    np.testing.assert_allclose(row["final_residual"], float(res[-1]), rtol=1e-3)
    assert row["true_residual"] <= 100 * 1e-5


def test_validate_cli_restores_a_port_training_run(tmp_path, capsys):
    run = tmp_path / "run"
    t_train(TConfig(matrix=MATRIX, seed_method="spai", loss="subtb", backward="linear",
                    batch_size=4, num_epochs=3, lr=5e-3, replay_size=16,
                    replay_prioritized=1.0, out_dir=str(run), platform="cpu"),
            progress=False)
    rc = validate_main(CLI + ["--from-checkpoint", str(run),
                              "--out-dir", str(tmp_path / "v")])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "restored trained policy at epoch 3" in out
    assert "train epoch" not in out
    report = json.loads((tmp_path / "v" / "validation.json").read_text())
    assert set(ROWS) <= set(report)


@pytest.mark.parametrize("name,k", [(MATRIX, 1), ("LF10_like", 2)])
def test_spai_seed_pattern_matches_jax(name, k):
    want = j_ilu.seed_pattern(j_gallery.get(name), method="spai", k=k)
    got = t_ilu.seed_pattern(t_gallery.get(name), method="spai", k=k)
    np.testing.assert_array_equal(got.row, np.asarray(want.row))
    np.testing.assert_array_equal(got.col, np.asarray(want.col))
    assert got.data.dtype == np.float32 == np.asarray(want.data).dtype
    np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=1e-4, atol=1e-6)
    assert torch.is_tensor(got.data) is False
