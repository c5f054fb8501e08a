"""The port's binding of the native host library (``native/gfnspai.cpp``)
against its numpy paths and the JAX package: one case for each test of
``tests/test_native.py``, and two processes that build the library at once.

Parsing, RCM and the SpGEMM plan are exact (the same integers and the same
float64 values); ILU(0) values within 1e-12 (both paths run the same loop
in the same order, so in practice they agree bit for bit).  The JAX
package is compared through its public functions, whichever path they
take."""

import gzip
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from gflownet_spai_tpu import sparse as j_sparse
from gflownet_spai_tpu.env import ilu as j_ilu
from gflownet_spai_tpu.ops import rcm as j_rcm
from gflownet_spai_tpu.sparse.types import COO as JCOO
from gflownet_spai_tpu_torch import native
from gflownet_spai_tpu_torch.env import ilu as t_ilu
from gflownet_spai_tpu_torch.ops import rcm as t_rcm
from gflownet_spai_tpu_torch.sparse import gallery, read_mtx, write_mtx
from gflownet_spai_tpu_torch.sparse.convert import coo_to_scipy
from gflownet_spai_tpu_torch.sparse.ops import SpGEMMPlan, spgemm
from gflownet_spai_tpu_torch.sparse.types import COO

ROOT = Path(__file__).resolve().parents[1]
ILU_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), f"g++ build of {native.SOURCE} failed"


def _coo_arrays(coo):
    return tuple(np.asarray(x) for x in (coo.row, coo.col, coo.data))


def _python_read(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return read_mtx(path)


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_text(text)
    return path


MTX_FILES = {
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 4\n1 1 2.0\n2 1 -1.0\n3 2 -1.0\n3 3 2.0\n",
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n2 2 2\n1 1\n2 2\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n% a comment line\n"
            "4 4 3\n2 1 1.5\n3 1 -2.0\n4 3 0.25\n",
    "quirks": "%%MatrixMarket matrix coordinate real general\n"
              "%-------------------------------------------\n"
              "% name: test/quirky   id: 0\n"
              "%-------------------------------------------\n3 3 5\n"
              "3 3 4.0e+00\n1 1 1.0E-01\n2 2 -3.25e2\n3 1 2\n1 3 -7.5e-03\n",
    "integer": "%%MatrixMarket matrix coordinate integer symmetric\n"
               "3 3 4\n1 1 2\n2 1 -1\n3 2 -1\n3 3 2\n",
}


def test_parse_poisson32_written_by_the_port(tmp_path, monkeypatch):
    coo = gallery.get("poisson32")
    path = tmp_path / "p.mtx"
    write_mtx(path, coo)
    nr, nc, rows, cols, vals = native.parse_mtx(path)
    assert (nr, nc) == coo.shape
    want = _coo_arrays(j_sparse.read_mtx(path))
    for got in ((rows, cols, vals), _coo_arrays(read_mtx(path)),
                _coo_arrays(_python_read(path, monkeypatch))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(vals, coo.data)


@pytest.mark.parametrize("name", sorted(MTX_FILES))
def test_parse_matches_jax_and_the_python_path(name, tmp_path, monkeypatch):
    """symmetric, pattern, skew-symmetric, the SuiteSparse quirks (comment
    lines, Fortran exponents, unsorted entries) and the integer field: the
    library, the Python parser and a gzipped copy (always the Python parser)
    give JAX's COO exactly, and scipy's matrix."""
    path = _write(tmp_path, f"{name}.mtx", MTX_FILES[name])
    gz = tmp_path / f"{name}.mtx.gz"
    with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    want = _coo_arrays(j_sparse.read_mtx(path))
    got = read_mtx(path)
    for coo in (got, _python_read(path, monkeypatch), read_mtx(gz)):
        for g, w in zip(_coo_arrays(coo), want):
            np.testing.assert_array_equal(g, w)
        assert coo.row.dtype == np.int32 and coo.data.dtype == np.float64
    np.testing.assert_array_equal(got.todense(), scipy.io.mmread(str(path)).toarray())


def test_array_format_falls_through_to_the_python_parser(tmp_path):
    path = _write(tmp_path, "arr.mtx", "%%MatrixMarket matrix array real general\n"
                                        "2 2\n1.0\n3.0\n2.0\n4.0\n")
    with pytest.raises(ValueError):
        native.parse_mtx(path)
    np.testing.assert_array_equal(read_mtx(path).todense(), [[1.0, 2.0], [3.0, 4.0]])


@pytest.mark.parametrize("name", ["poisson32", "LF10_like", "orsirr_like24"])
def test_ilu0_native_matches_python_and_jax(name, monkeypatch):
    a = gallery.get(name)
    L, U = t_ilu.ilu0(a)
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        Lp, Up = t_ilu.ilu0(a)
    jL, jU = j_ilu.ilu0(j_sparse.gallery.get(name))
    for got, py, jx in ((L, Lp, jL), (U, Up, jU)):
        np.testing.assert_array_equal(got.row, py.row)
        np.testing.assert_array_equal(got.col, py.col)
        np.testing.assert_allclose(got.data, py.data, rtol=ILU_TOL, atol=ILU_TOL)
        np.testing.assert_array_equal(got.row, np.asarray(jx.row))
        np.testing.assert_allclose(got.data, np.asarray(jx.data), rtol=ILU_TOL,
                                   atol=ILU_TOL)
    # (A - L·U) vanishes on pattern(A)
    A = coo_to_scipy(a).tocsr()
    diff = (A - coo_to_scipy(L) @ coo_to_scipy(U)).toarray()
    np.testing.assert_allclose(diff[A.toarray() != 0], 0.0, atol=1e-10)


def test_ilu0_zero_pivot_raises_on_both_paths(monkeypatch):
    A = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 1.0]]))
    with pytest.raises(ZeroDivisionError):
        native.ilu0_values(A.indptr, A.indices, A.data)
    a = COO.fromdense(A.toarray())
    with pytest.raises(ZeroDivisionError):
        t_ilu.ilu0(a)
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ZeroDivisionError):
        t_ilu.ilu0(a)


def test_rcm_matches_jax_and_narrows_a_scrambled_band(monkeypatch):
    rng = np.random.default_rng(0)
    base = coo_to_scipy(gallery.get("olm500_like")).toarray()[:200, :200]
    p = rng.permutation(200)
    dense = base[np.ix_(p, p)]
    coo = COO.fromdense(dense)
    perm = t_rcm.rcm_permutation(coo)
    assert sorted(perm) == list(range(200))
    assert t_rcm.bandwidth(t_rcm.permute(coo, perm)) <= 5
    np.testing.assert_array_equal(
        perm, j_rcm.rcm_permutation(JCOO.fromdense(dense)))
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        np.testing.assert_array_equal(perm, t_rcm.rcm_permutation(coo))
    orsirr = gallery.get("orsirr_like24")
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        want = t_rcm.rcm_permutation(orsirr)
    np.testing.assert_array_equal(t_rcm.rcm_permutation(orsirr), want)


@pytest.mark.parametrize("pair", [("LF10_like", "LF10_like"), ("seed", "orsirr_like24")])
def test_spgemm_plan_matches_the_python_plan(pair, monkeypatch):
    """The same pattern and the same (pair_a, pair_b, pair_out) triplets in
    the same order as the numpy plan; the product against scipy."""
    if pair[0] == "seed":
        b = gallery.get(pair[1])
        a = t_ilu.seed_pattern(b, dtype=np.float64)
    else:
        a = b = gallery.get(pair[0])
    plan = SpGEMMPlan(a, b, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        py = SpGEMMPlan(a, b, device="cpu")
    for f in ("out_row", "out_col", "pair_a", "pair_b", "pair_out"):
        got, want = getattr(plan, f), getattr(py, f)
        assert got.dtype == torch.int64
        assert torch.equal(got, want), f
    assert (plan.out_nnz, plan.npairs) == (py.out_nnz, py.npairs)
    assert bool((torch.diff(plan.pair_out) >= 0).all())
    got = spgemm(a, b)
    want = (coo_to_scipy(a) @ coo_to_scipy(b)).toarray()
    np.testing.assert_allclose(got.todense(), want, rtol=1e-9, atol=1e-12)


def test_spgemm_plan_with_duplicates_in_b_takes_the_numpy_path():
    """A B with a repeated entry is row-sorted but not canonical: the plan
    gives the numpy path's pairs (the library would leave them unordered)."""
    b = COO(row=np.array([0, 0, 1], np.int32), col=np.array([1, 1, 0], np.int32),
            data=np.array([1.0, 2.0, 3.0]), shape=(2, 2))
    a = COO(row=np.array([0, 1], np.int32), col=np.array([0, 1], np.int32),
            data=np.array([1.0, 1.0]), shape=(2, 2))
    plan = SpGEMMPlan(a, b, device="cpu")
    assert plan.pair_b.tolist() == [0, 1, 2] and plan.pair_out.tolist() == [0, 0, 1]


def test_two_processes_build_the_library_at_once(tmp_path):
    """Two processes that find no library both compile it (each into a
    temporary name, renamed into place) and both load a whole file."""
    env = {**os.environ, "GFLOWNET_SPAI_KERNEL_DIR": str(tmp_path / "kernels"),
           "PYTHONPATH": str(ROOT)}
    code = ("from gflownet_spai_tpu_torch import native, sparse\n"
            "assert native.available()\n"
            "import numpy as np, scipy.sparse as sp\n"
            "A = sp.csr_matrix(np.array([[4.0, 1.0], [1.0, 3.0]]))\n"
            "v = native.ilu0_values(A.indptr, A.indices, A.data)\n"
            "assert np.allclose(v, [4.0, 1.0, 0.25, 2.75])\n"
            "print(native.library_path())\n")
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {Path(out.strip()) for out, _ in outs}
    assert len(paths) == 1
    lib = paths.pop()
    assert lib.parent == tmp_path / "native" and lib.exists()
    assert [f.name for f in lib.parent.iterdir()] == [lib.name]
