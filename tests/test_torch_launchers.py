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


@pytest.mark.parametrize("argv", [[], ["300", "50"]])
def test_thinning_orsirr_builds_the_jax_argument_lists(argv, monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    monkeypatch.setattr(sys, "argv", ["thinning_orsirr.py", *argv])
    _load("thinning_orsirr").main()
    jax_calls = rec.calls
    rec.calls = []
    _load("thinning_orsirr_torch").main(argv)
    k = argv[0] if argv else "150"
    assert len(jax_calls) == 2
    assert rec.calls == _swap(jax_calls, f"runs/thin_orsirr{k}",
                              f"runs/torch_thin_orsirr{k}")
    rec.calls = []
    _load("thinning_orsirr_torch").main([*argv, "--device", "cpu"])
    assert all(c[-2:] == ["--platform", "cpu"] for c in rec.calls)


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
                          timeout=300, cwd=str(ROOT))
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
