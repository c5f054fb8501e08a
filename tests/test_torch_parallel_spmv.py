"""The sparse side of the port's ``parallel/`` against the JAX package: the
mesh and its collectives (values, and the gradient convention of
``parallel/mesh.py``), the halo-exchange and all-gather SpMVs, the fused
k-step halo SpMV, distributed GMRES / CG / Jacobi, and the weak-scaling
harness.

One gloo world of four ranks (a (1, 4) mesh; the collectives also on
(2, 2)) runs every multi-rank case once: a module-scoped fixture spawns
``python <this file> rank world dir``, the ranks meet through a
``file://`` rendezvous and pickle their results.  The JAX side runs the
same functions in the pytest process on a JAX (1, 4) mesh from conftest's
virtual devices.  The 1×1 mesh runs in the pytest process with no process
group.

Tolerances: SpMVs rtol 1e-5 in float32 (atol 1e-6 of the largest
magnitude); solvers in float64: equal iteration counts, x within rtol
1e-4, residual norms within rtol 1e-5; the collectives exact.
"""

import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
WORLD = 4
JOIN_S = 110


def _np(t):
    return t.detach().cpu().numpy()


def _t_dia(name, dtype=np.float32):
    from gflownet_spai_tpu_torch.ops import coo_to_dia
    from gflownet_spai_tpu_torch.sparse import gallery
    from gflownet_spai_tpu_torch.sparse.types import COO

    if name == "diag8192":
        n = 8192
        a = COO(row=np.arange(n), col=np.arange(n), data=np.arange(1.0, n + 1.0),
                shape=(n, n))
    else:
        a = gallery.get(name)
    a = COO(row=a.row, col=a.col, data=np.asarray(a.data, dtype), shape=a.shape)
    return coo_to_dia(a, device="cpu")


def _x(name, n_pad, n, seed):
    x = np.zeros(n_pad, np.float32)
    x[:n] = np.random.default_rng(seed).standard_normal(n)
    return x


SPMV_CASES = (("poisson32", 0), ("olm500_like", 1), ("diag8192", 4))


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, workdir):
    import datetime

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdv", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=100))
    from gflownet_spai_tpu_torch.parallel import make_mesh

    meshes = {(1, 4): make_mesh(1, 4, "cpu"), (2, 2): make_mesh(2, 2, "cpu")}
    out = {}
    for name, fn in CASES.items():
        out[name] = fn(meshes)
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _shard(mesh, v):
    R, i = mesh.size("rows"), mesh.index("rows")
    n = v.shape[0] // R
    return torch.as_tensor(v[i * n:(i + 1) * n])


def _case_collectives(meshes):
    """Values of every collective on both meshes, and the gradients of the
    convention: each rank back-propagates its share loss / R of a loss
    every rows rank computes alike."""
    from gflownet_spai_tpu_torch.parallel.mesh import (all_gather, neighbour_exchange,
                                                       pmax, pmean, psum, reduce_grads)

    out = {}
    for shape, mesh in meshes.items():
        d, r = mesh.index("dp"), mesh.index("rows")
        R = mesh.size("rows")
        v = torch.tensor([10.0 * d + r, 1.0])
        fl, fr = neighbour_exchange(mesh, v + 100, v - 100)
        res = {"psum": _np(psum(mesh, v)), "pmean_dp": _np(pmean(mesh, v, "dp")),
               "pmax": _np(pmax(mesh, v)), "gather": _np(all_gather(mesh, v)),
               "tiled": _np(all_gather(mesh, v, tiled=True)),
               "from_left": _np(fl), "from_right": _np(fr)}
        # d/dx of psum(x²) on rank r is 2·x_r; of Σ_k k·gather(x)[k] it is r
        x = torch.tensor(float(r + 1), requires_grad=True)
        (psum(mesh, x * x) / R).backward()
        res["grad_psum"] = float(x.grad)
        x = torch.tensor(float(r + 1), requires_grad=True)
        (torch.sum(torch.arange(R, dtype=torch.float32) * all_gather(mesh, x)) / R).backward()
        res["grad_gather"] = float(x.grad)
        # a replicated parameter: rank shares summed over rows, mean over dp
        w = torch.tensor(2.0, requires_grad=True)
        loss = psum(mesh, w * (r + 1.0)) * (d + 1.0)
        g, = torch.autograd.grad(loss / R, [w])
        res["grad_replicated"] = float(reduce_grads(mesh, [g])[0])
        out[shape] = res
    return out


def _case_spmv(meshes):
    from gflownet_spai_tpu_torch.parallel import halo_spmv, partition_dia, spmv_allgather

    mesh = meshes[(1, 4)]
    out = {}
    for name, seed in SPMV_CASES:
        d = partition_dia(_t_dia(name), 4)
        x = _shard(mesh, _x(name, d.n_pad, d.n, seed))
        out[name] = {"halo": _np(halo_spmv(mesh, d, x)),
                     "allgather": _np(spmv_allgather(mesh, d, x))}
    return out


def _case_power(meshes):
    from gflownet_spai_tpu_torch.parallel import halo_spmv_power, partition_dia

    mesh = meshes[(1, 4)]
    d = partition_dia(_t_dia("poisson128"), 4)
    x = _shard(mesh, _x("poisson128", d.n_pad, d.n, 2))
    z = halo_spmv_power(mesh, d, x, k=2, scale=0.3)
    try:
        halo_spmv_power(mesh, d, x, k=5)
        err = ""
    except ValueError as e:
        err = str(e)
    return {"z": _np(z), "err": err}


def _case_solvers(meshes):
    from gflownet_spai_tpu_torch.parallel import (distributed_cg, distributed_gmres,
                                                  distributed_jacobi)

    mesh = meshes[(1, 4)]
    d32 = _t_dia("poisson32", np.float64)
    b = torch.ones(1024, dtype=torch.float64)
    g = distributed_gmres(mesh, d32, b, restart=30, maxiter=2000, rtol=1e-8)
    c = distributed_cg(mesh, d32, b, maxiter=2000, rtol=1e-8)
    d128 = _t_dia("poisson128", np.float64)
    b128 = torch.as_tensor(np.random.default_rng(5).standard_normal(16384))
    xj, rj = distributed_jacobi(mesh, d128, b128, iters=24, k=2)
    xa, ra = distributed_jacobi(mesh, d32, b, iters=60, k=8)
    return {"gmres": {"x": _np(g.x), "it": g.iterations, "res": _np(g.residuals),
                      "conv": g.converged},
            "cg": {"x": _np(c.x), "it": c.iterations, "res": _np(c.residuals),
                   "conv": c.converged},
            "jacobi": {"x": _np(xj), "r": float(rj)},
            "jacobi_auto": {"x": _np(xa), "r": float(ra)}}


def _case_bench_scaling(meshes):
    from gflownet_spai_tpu_torch import bench_scaling

    return bench_scaling.run([1, 2, 4], 4096, reps=2, device="cpu")


def _case_mesh_errors(meshes):
    from gflownet_spai_tpu_torch.parallel import make_mesh

    errs = {}
    for args in ((2, 4, "cpu"), (1, 4, "cuda")):
        try:
            make_mesh(*args)
            errs[args] = ""
        except ValueError as e:
            errs[args] = str(e)
    return errs


CASES = {"collectives": _case_collectives, "spmv": _case_spmv, "power": _case_power,
         "solvers": _case_solvers, "bench_scaling": _case_bench_scaling,
         "mesh_errors": _case_mesh_errors}


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The pytest side
# ---------------------------------------------------------------------------

def _j_dia(name, dtype):
    from gflownet_spai_tpu.ops import coo_to_dia
    from gflownet_spai_tpu.sparse import gallery
    from gflownet_spai_tpu.sparse.types import COO

    if name == "diag8192":
        return coo_to_dia(COO.fromdense(np.diag(np.arange(1.0, 8193.0)).astype(dtype)))
    a = gallery.get(name)
    return coo_to_dia(COO(row=a.row, col=a.col, data=a.data.astype(dtype), shape=a.shape))


def _jax_oracles():
    import jax
    import jax.numpy as jnp

    from gflownet_spai_tpu.parallel import (distributed_cg, distributed_gmres,
                                            distributed_jacobi, halo_spmv,
                                            halo_spmv_power, make_mesh, partition_dia,
                                            spmv_allgather)

    mesh = make_mesh(1, 4)
    jo = {"spmv": {}}
    for name, seed in SPMV_CASES:
        d = partition_dia(_j_dia(name, np.float32), 4)
        x = jnp.asarray(_x(name, d.n_pad, d.shape[0], seed))
        jo["spmv"][name] = {
            "halo": np.asarray(jax.jit(lambda x, d=d: halo_spmv(mesh, d, x))(x)),
            "allgather": np.asarray(jax.jit(lambda x, d=d: spmv_allgather(mesh, d, x))(x))}
    d = partition_dia(_j_dia("poisson128", np.float32), 4)
    x = jnp.asarray(_x("poisson128", d.n_pad, d.shape[0], 2))
    jo["power"] = np.asarray(jax.jit(
        lambda x: halo_spmv_power(mesh, d, x, k=2, scale=0.3))(x))
    with pytest.raises(ValueError, match="halo"):
        halo_spmv_power(mesh, d, x, k=5)
    d32 = _j_dia("poisson32", np.float64)
    b = jnp.ones((1024,), jnp.float64)
    g = distributed_gmres(mesh, d32, b, restart=30, maxiter=2000, rtol=1e-8)
    c = distributed_cg(mesh, d32, b, maxiter=2000, rtol=1e-8)
    xj, rj = distributed_jacobi(mesh, _j_dia("poisson128", np.float64),
                                jnp.asarray(np.random.default_rng(5).standard_normal(16384)),
                                iters=24, k=2)
    xa, ra = distributed_jacobi(mesh, d32, b, iters=60, k=8)
    jo["solvers"] = {
        "gmres": {"x": np.asarray(g.x), "it": int(g.iterations),
                  "res": np.asarray(g.residuals), "conv": bool(g.converged)},
        "cg": {"x": np.asarray(c.x), "it": int(c.iterations),
               "res": np.asarray(c.residuals), "conv": bool(c.converged)},
        "jacobi": {"x": np.asarray(xj), "r": float(rj)},
        "jacobi_auto": {"x": np.asarray(xa), "r": float(ra)}}
    return jo


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("parallel_spmv"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, HERE, str(r), str(WORLD), workdir],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True) for r in range(WORLD)]
    t0 = time.perf_counter()
    try:
        oracles = _jax_oracles()
    finally:
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(1.0, JOIN_S - (time.perf_counter() - t0)))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = []
    for r in range(WORLD):
        with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return {"out": outs, "jax": oracles}


def _whole(world, case, name, key):
    return np.concatenate([world["out"][r][case][name][key] for r in range(WORLD)])


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_collectives_values(world, shape):
    for rank in range(WORLD):
        o = world["out"][rank]["collectives"][shape]
        dp, R = shape
        d, r = rank // R, rank % R
        vals = [[10.0 * d + j, 1.0] for j in range(R)]
        np.testing.assert_array_equal(o["psum"], np.sum(vals, axis=0))
        np.testing.assert_array_equal(o["pmax"], np.max(vals, axis=0))
        np.testing.assert_array_equal(o["gather"], vals)
        np.testing.assert_array_equal(o["tiled"], np.reshape(vals, -1))
        pm = np.mean([[10.0 * e + r, 1.0] for e in range(dp)], axis=0)
        np.testing.assert_allclose(o["pmean_dp"], pm, rtol=1e-7)
        left = np.array(vals[r - 1]) + 100 if r > 0 else np.zeros(2)
        right = np.array(vals[r + 1]) - 100 if r + 1 < R else np.zeros(2)
        np.testing.assert_array_equal(o["from_left"], left)
        np.testing.assert_array_equal(o["from_right"], right)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_collective_gradients_follow_the_convention(world, shape):
    """Each rank back-propagates loss / R through sum-transpose collectives:
    d psum(x²)/dx_r = 2·x_r and d Σ_k k·gather(x)_k/dx_r = r — the
    gradient of the one replicated loss, not R times it.  A replicated
    parameter's rank shares, summed over rows and averaged over dp, give
    dL/dw = mean_d (d + 1)·Σ_r (r + 1)."""
    dp, R = shape
    want_w = np.mean([(d + 1) * sum(range(1, R + 1)) for d in range(dp)])
    for rank in range(WORLD):
        o = world["out"][rank]["collectives"][shape]
        r = rank % R
        assert o["grad_psum"] == 2.0 * (r + 1)
        assert o["grad_gather"] == float(r)
        assert o["grad_replicated"] == pytest.approx(want_w, rel=1e-7)


@pytest.mark.parametrize("name", [c for c, _ in SPMV_CASES])
@pytest.mark.parametrize("kind", ["halo", "allgather"])
def test_spmv_matches_jax(world, name, kind):
    """``halo_spmv`` (neighbour exchange, K8's plain version on the
    halo-extended shard) and ``spmv_allgather`` against JAX's on the same
    partitioned matrix and x."""
    got = _whole(world, "spmv", name, kind)
    want = world["jax"]["spmv"][name][kind]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_halo_spmv_power_matches_jax(world):
    """One k·halo exchange then K12's k passes equal JAX's fused halo SpMV;
    a k·halo past the shard raises on both."""
    got = np.concatenate([world["out"][r]["power"]["z"] for r in range(WORLD)])
    want = world["jax"]["power"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())
    assert "halo" in world["out"][0]["power"]["err"]


@pytest.mark.parametrize("solver", ["gmres", "cg"])
def test_distributed_krylov_matches_jax(world, solver):
    j = world["jax"]["solvers"][solver]
    for r in range(WORLD):
        o = world["out"][r]["solvers"][solver]
        assert o["it"] == j["it"] and o["conv"] and j["conv"]
        np.testing.assert_allclose(o["x"], j["x"], rtol=1e-4)
        np.testing.assert_allclose(o["res"][:o["it"]], j["res"][:j["it"]], rtol=1e-5)


@pytest.mark.parametrize("case", ["jacobi", "jacobi_auto"])
def test_distributed_jacobi_matches_jax(world, case):
    """k sweeps fused per exchange (k 2 on poisson128; k 8 reduced to 1 on
    poisson32, whose halo fills a shard): x and the true residual norm."""
    j = world["jax"]["solvers"][case]
    for r in range(WORLD):
        o = world["out"][r]["solvers"][case]
        np.testing.assert_allclose(o["x"], j["x"], rtol=1e-4, atol=1e-12)
        np.testing.assert_allclose(o["r"], j["r"], rtol=1e-5)


def test_bench_scaling_sub_meshes(world):
    """The weak-scaling harness on 1, 2 and 4 ranks of the world: one record
    per size on rank 0, none elsewhere."""
    recs = world["out"][0]["bench_scaling"]
    assert [r["devices"] for r in recs] == [1, 2, 4]
    for r in recs:
        assert r["rows"] >= 4096 * r["devices"] and r["time_s"] > 0
        assert r["nnz_per_s"] == pytest.approx(r["nnz"] / r["time_s"])
    assert recs[0]["efficiency"] == 1.0
    assert all(world["out"][k]["bench_scaling"] == [] for k in range(1, WORLD))


def test_make_mesh_refuses(world):
    errs = world["out"][0]["mesh_errors"]
    assert "need 8 ranks" in errs[(2, 4, "cpu")]
    assert "NCCL" in errs[(1, 4, "cuda")]


# --- the 1×1 mesh on one process, no process group -------------------------

def test_single_device_mesh_without_process_group():
    """Every collective is the identity; the distributed SpMVs and solvers
    equal the single-device ones (the same iteration counts)."""
    import torch.distributed as dist

    from gflownet_spai_tpu_torch.ops.dia import spmv_dia
    from gflownet_spai_tpu_torch.parallel import (distributed_cg, distributed_gmres,
                                                  distributed_jacobi, halo_spmv,
                                                  halo_spmv_power, make_mesh,
                                                  partition_dia, single_device_mesh,
                                                  spmv_allgather)
    from gflownet_spai_tpu_torch.parallel.mesh import all_gather, neighbour_exchange, psum
    from gflownet_spai_tpu_torch.solvers.cg import cg
    from gflownet_spai_tpu_torch.solvers.gmres import gmres
    from gflownet_spai_tpu_torch.solvers.stationary import jacobi

    assert not dist.is_initialized()
    mesh = single_device_mesh("cpu")
    with pytest.raises(ValueError, match="need 2 ranks"):
        make_mesh(2, 1, "cpu")
    v = torch.arange(3.0)
    assert torch.equal(psum(mesh, v), v) and torch.equal(all_gather(mesh, v)[0], v)
    fl, fr = neighbour_exchange(mesh, v, v)
    assert not fl.any() and not fr.any()
    d = _t_dia("poisson128")
    dp = partition_dia(d, 1)
    x = torch.as_tensor(_x("poisson128", dp.n_pad, d.n, 3))
    want = spmv_dia(dp, x)
    torch.testing.assert_close(halo_spmv(mesh, dp, x), want, rtol=0, atol=0)
    torch.testing.assert_close(spmv_allgather(mesh, dp, x), want, rtol=0, atol=0)
    z = halo_spmv_power(mesh, dp, x, k=2, scale=0.3)
    torch.testing.assert_close(z, 0.09 * spmv_dia(dp, spmv_dia(dp, x)), rtol=1e-5, atol=1e-5)
    d64 = _t_dia("poisson32", np.float64)
    b = torch.ones(1024, dtype=torch.float64)
    got, ref = distributed_cg(mesh, d64, b, maxiter=500, rtol=1e-8), cg(d64, b, maxiter=500,
                                                                         rtol=1e-8)
    assert got.iterations == ref.iterations
    torch.testing.assert_close(got.x, ref.x, rtol=1e-6, atol=1e-9)
    got = distributed_gmres(mesh, d64, b, restart=30, maxiter=500, rtol=1e-8)
    ref = gmres(d64, b, restart=30, maxiter=500, rtol=1e-8)
    assert got.iterations == ref.iterations
    torch.testing.assert_close(got.x, ref.x, rtol=1e-6, atol=1e-9)
    xj, _ = distributed_jacobi(mesh, d64, b, iters=16, k=1)
    torch.testing.assert_close(xj, jacobi(d64, b, iters=16, fuse_k=1).x, rtol=1e-10, atol=1e-12)
