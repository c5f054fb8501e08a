"""The port's launchers (``examples/*_torch.py``) against the JAX ones:
with ``subprocess.run`` patched, ``thinning_orsirr_torch.py`` and the
sampled part of ``config2_poisson_spai_torch.py`` build the JAX launchers'
argument lists with the module names and run directories swapped;
``chebyshev_cg_torch.py --device cpu`` at grid 32 exits 0, and its rows'
operators give the JAX package's ``solvers.cg`` iteration counts with the
same operators at the same grid (float64 and the same λmax: equal counts,
as ``tests/test_torch_solvers.py`` holds CG; the launcher's float32 run
within one iteration of them).  No launcher imports jax or the JAX
package."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gflownet_spai_tpu.ops.dia import coo_to_dia as j_coo_to_dia
from gflownet_spai_tpu.solvers import cg as j_cg
from gflownet_spai_tpu.solvers import chebyshev_op as j_chebyshev_op
from gflownet_spai_tpu.solvers import estimate_lmax as j_estimate_lmax
from gflownet_spai_tpu.solvers.multigrid import vcycle_op as j_vcycle_op
from gflownet_spai_tpu.sparse import gallery as j_gallery
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
LAUNCHERS = ("grid_gfn", "spai_pipeline", "chebyshev_cg", "config2_poisson_spai",
             "thinning_oracle", "thinning_orsirr")
GRID = 32


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorder:
    """Stands in for ``subprocess.run``: records each command."""

    def __init__(self):
        self.calls = []

    def __call__(self, cmd, *args, **kwargs):
        self.calls.append(list(cmd))
        return subprocess.CompletedProcess(cmd, 0)


def _swap(cmds, jax_run, torch_run):
    """The JAX commands with the port's module names and run directories."""
    out = []
    for cmd in cmds:
        out.append([c.replace("gflownet_spai_tpu.", "gflownet_spai_tpu_torch.")
                    .replace(jax_run, torch_run) for c in cmd])
    return out


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_imports_neither_jax_nor_the_jax_package(name):
    tree = ast.parse((EXAMPLES / f"{name}_torch.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "optax", "gflownet_spai_tpu"), m


def _train_config(main_mod, config_cls, argv):
    """``argv`` parsed as a train CLI's ``main`` parses it."""
    import dataclasses

    args = vars(main_mod.build_parser().parse_args(argv))
    return dataclasses.asdict(dataclasses.replace(config_cls(), **{
        k: v for k, v in args.items()
        if k not in ("legacy", "multihost") and v != getattr(config_cls(), k, None)}))


@pytest.mark.parametrize("argv", [[], ["300", "50"]])
def test_thinning_orsirr_builds_the_jax_argument_lists(argv, monkeypatch):
    """The port's commands are JAX's with ``--terminal-bias 0`` added to the
    train call (the recipe names it, the JAX launcher leaves it to the
    default), and both train calls parse to the same ``TrainConfig``."""
    import gflownet_spai_tpu.train.__main__ as j_train_main
    import gflownet_spai_tpu_torch.train.__main__ as t_train_main
    from gflownet_spai_tpu.train import TrainConfig as JConfig
    from gflownet_spai_tpu_torch.train import TrainConfig as TConfig

    rec = _Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    monkeypatch.setattr(sys, "argv", ["thinning_orsirr.py", *argv])
    _load("thinning_orsirr").main()
    jax_calls = rec.calls
    rec.calls = []
    _load("thinning_orsirr_torch").main(argv)
    k = argv[0] if argv else "150"
    assert len(jax_calls) == 2
    want = _swap(jax_calls, f"runs/thin_orsirr{k}", f"runs/torch_thin_orsirr{k}")
    assert rec.calls == [want[0] + ["--terminal-bias", "0"], want[1]]
    j_cfg = _train_config(j_train_main, JConfig, jax_calls[0][3:])
    t_cfg = _train_config(t_train_main, TConfig, rec.calls[0][3:])
    j_cfg["out_dir"] = t_cfg["out_dir"]
    assert t_cfg == j_cfg and t_cfg["terminal_bias"] == 0.0
    rec.calls = []
    _load("thinning_orsirr_torch").main([*argv, "--device", "cpu"])
    assert all(c[-2:] == ["--platform", "cpu"] for c in rec.calls)


def test_thinning_orsirr_a985_flags(monkeypatch, tmp_path):
    """``examples/thinning_a985_torch.sh`` calls train and validate with the
    launcher's argument lists, α, demonstration fractions, warm-start
    length, epochs and run directory set to the α 0.985 run's (run here
    with stand-ins for ``python`` and ``nvidia-smi`` that record their
    arguments)."""
    bin_dir, calls = tmp_path / "bin", tmp_path / "calls.jsonl"
    bin_dir.mkdir()
    (bin_dir / "python").write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        f"open({str(calls)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n")
    (bin_dir / "nvidia-smi").write_text("#!/bin/sh\necho 'card, 700.00 W'\n")
    for f in bin_dir.iterdir():
        f.chmod(0o755)
    out = subprocess.run(
        ["bash", str(EXAMPLES / "thinning_a985_torch.sh"), "runs/a985"], cwd=tmp_path,
        env={**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"},
        capture_output=True, text=True, check=True).stdout
    assert out.startswith("card, 700.00 W")
    got = [json.loads(line) for line in calls.read_text().splitlines()]

    rec = _Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    _load("thinning_orsirr_torch").main(["150", "1500"])
    set_to = {"--alpha-fixed": "0.985", "--replay-seed-thinning": "0.2,0.3,0.4",
              "--warmstart-epochs": "5000", "--out-dir": "runs/a985",
              "--from-checkpoint": "runs/a985"}
    want = []
    for cmd in rec.calls:
        cmd = list(cmd[1:])
        for flag, value in set_to.items():
            if flag in cmd:
                cmd[cmd.index(flag) + 1] = value
        want.append(cmd)
    want[1][want[1].index("--out-dir") + 1] = "runs/a985_val"
    assert got == want
    assert got[0][got[0].index("--epochs") + 1] == "1500"


def test_thinning_oracle_refuses_gmres_with_cg(capsys):
    with pytest.raises(SystemExit) as e:
        _load("thinning_oracle_torch").main(["--gmres", "--cg"])
    assert e.value.code == 2
    assert "not allowed with argument" in capsys.readouterr().err


def test_thinning_oracle_gmres_rows_name_restart_and_inner_iterations(capsys):
    """Each GMRES row says it ran GMRES(20) and counted inner iterations,
    and its count is scipy's GMRES(20) inner-iteration count (37 on the
    half-thinned seed: two restart cycles)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from gflownet_spai_tpu_torch.env import ilu
    from gflownet_spai_tpu_torch.sparse import gallery

    mod = _load("thinning_oracle_torch")
    assert mod.main(["--matrix", "orsirr_like16", "--seed-k", "1", "--alphas", "0.95",
                     "--fracs", "0,0.5", "--gmres", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert len(rows) == 2
    a = gallery.get("orsirr_like16")
    seed = ilu.seed_pattern(a, method="spai", k=1)
    keep = np.ones(seed.nnz, bool)
    keep[np.argsort(np.abs(seed.data.astype(np.float64)))[:int(0.5 * seed.nnz)]] = False
    A = sp.csr_matrix((a.data.astype(np.float64), (a.row, a.col)), shape=a.shape)
    b = A @ np.ones(a.shape[0])
    M = sp.csr_matrix((seed.data.astype(np.float64)[keep], (seed.row[keep], seed.col[keep])),
                      shape=seed.shape)
    n = [0]
    spla.gmres(A, b, rtol=1e-5, maxiter=10260, M=M, restart=20,
               callback=lambda _: n.__setitem__(0, n[0] + 1), callback_type="pr_norm")
    assert all(r["solver"] == "gmres(restart 20), inner iterations" for r in rows)
    assert rows[1]["nnz"] == keep.sum() and rows[1]["iters"] == n[0] > 20


def test_config2_sampled_builds_the_jax_argument_list(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    import gflownet_spai_tpu.validate.__main__ as j_validate

    seen = []
    monkeypatch.setattr(j_validate, "main", lambda argv: seen.append(list(argv)) or 0)
    rec = _Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    for run in ("runs/config2_sampled_64", "runs/torch_config2_sampled_64"):
        (tmp_path / run).mkdir(parents=True)
        (tmp_path / run / "validation.json").write_text(json.dumps({"run": run}))
    assert _load("config2_poisson_spai").run_sampled(64, 150) == \
        {"run": "runs/config2_sampled_64"}
    got = _load("config2_poisson_spai_torch").run_sampled(64, 150, None)
    assert got == {"run": "runs/torch_config2_sampled_64"}
    want = _swap([seen[0]], "runs/config2_sampled_64", "runs/torch_config2_sampled_64")[0]
    assert rec.calls == [[sys.executable, "-m", "gflownet_spai_tpu_torch.validate", *want]]


def _jax_rows(jd, lmax, degree=64, levels=6):
    lmin = 8.0 * np.sin(np.pi / (2 * (GRID + 1))) ** 2
    return (None, j_chebyshev_op(jd, lmax=lmax, lmin=lmin, degree=degree),
            j_vcycle_op(jd, pre=2, post=2, levels=levels, coarse_sweeps=16),
            j_vcycle_op(jd, levels=min(levels, 3), smoother="chebyshev"),
            j_vcycle_op(jd, levels=min(levels, 3), smoother="chebyshev", gamma=2))


def test_chebyshev_cg_matches_jax_cg_at_grid_32():
    proc = subprocess.run([sys.executable, str(EXAMPLES / "chebyshev_cg_torch.py"),
                           str(GRID), "--device", "cpu"], capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT),
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    cli = json.loads(proc.stdout.strip().splitlines()[-1])
    assert cli["grid"] == GRID and all(r["converged"] for r in cli["rows"])

    mod = _load("chebyshev_cg_torch")
    jd = j_coo_to_dia(j_gallery.poisson2d(GRID))                 # float64
    lmax = 1.05 * float(j_estimate_lmax(jd, iters=30))
    jb = jnp.ones((jd.n,), jd.data.dtype)
    want = [int(j_cg(jd, jb, m_op=m, maxiter=mod.MAXITER, rtol=mod.RTOL).iterations)
            for m in _jax_rows(jd, lmax)]
    d = mod.poisson_dia(GRID, "cpu", np.float64)
    b = torch.ones((d.n,), dtype=torch.float64)
    rows = mod.rows(d, GRID, 64, 6, lmax)
    got = [int(mod.cg(d, b, m_op=m, maxiter=mod.MAXITER, rtol=mod.RTOL).iterations)
           for _, m in rows]
    assert got == want
    assert [r["row"] for r in cli["rows"]] == [tag for tag, _ in rows]
    assert all(abs(r["iterations"] - w) <= 1 for r, w in zip(cli["rows"], want))
