"""The port's multi-process bootstrap (``parallel/multihost.py``): the
environment parsing against the JAX package's, and a real two-process
gloo run bootstrapped from ``GFNSPAI_*`` through a ``file://``
rendezvous: a cross-process ``psum`` on the process-spanning mesh, then
the train CLI with ``--multihost`` (the sharded sampler on a (1, 2) mesh
and the dp step on (2, 1)), which trains and checkpoints from rank 0, and
the rank check ``parallel.check``."""

import json
import os
import subprocess
import sys

import pytest

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))

_VARS = ("GFNSPAI_COORDINATOR", "GFNSPAI_NUM_PROCS", "GFNSPAI_PROC_ID",
         "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
         "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _worker(run_dir):
    """One process of the two: bootstrap, psum, the train CLI twice, then
    the rank check (``parallel.check``) on the running group."""
    import torch

    from gflownet_spai_tpu_torch.parallel.mesh import psum
    from gflownet_spai_tpu_torch.parallel.multihost import (global_mesh,
                                                            initialize_from_env,
                                                            process_summary)
    from gflownet_spai_tpu_torch.train.__main__ import main as train_main

    assert initialize_from_env(device="cpu")
    summary = process_summary()
    assert summary["process_count"] == 2 and summary["backend"] == "gloo"
    mesh = global_mesh(dp=1, rows=2, device="cpu")
    got = psum(mesh, torch.tensor([float(summary["process_index"]) + 1.0]))
    assert float(got) == 3.0, got
    common = ["--multihost", "--platform", "cpu", "--matrix", "LF10_like", "--epochs", "3",
              "--batch-size", "4", "--loss", "subtb", "--backward", "linear",
              "--replay-size", "4", "--log-every", "1"]
    assert train_main(common + ["--sampler", "sharded", "--rows-devices", "2",
                                "--out-dir", os.path.join(run_dir, "sharded")]) == 0
    assert train_main(common + ["--dp-devices", "2",
                                "--out-dir", os.path.join(run_dir, "dp")]) == 0
    from gflownet_spai_tpu_torch.parallel import check

    assert check.main(["--platform", "cpu", "--poisson", "32"]) == 0
    print("OK", json.dumps(summary), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1])
    sys.exit(0)


def test_multihost_env_parsing():
    """The JAX package's cases (GFNSPAI_* and JAX's names, all three or
    none, the id in range), and torchrun's variables."""
    from gflownet_spai_tpu.parallel.multihost import multihost_env as j_env
    from gflownet_spai_tpu_torch.parallel.multihost import multihost_env

    cases = [{}, {"GFNSPAI_COORDINATOR": "h:1", "GFNSPAI_NUM_PROCS": "4",
                  "GFNSPAI_PROC_ID": "2"},
             {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2",
              "JAX_PROCESS_ID": "0"}]
    for env in cases:
        assert multihost_env(env) == j_env(env)
    assert multihost_env(cases[1]) == {"coordinator_address": "h:1", "num_processes": 4,
                                       "process_id": 2}
    for env, match in (({"GFNSPAI_COORDINATOR": "h:1"}, "all three"),
                       ({"GFNSPAI_COORDINATOR": "h:1", "GFNSPAI_NUM_PROCS": "2",
                         "GFNSPAI_PROC_ID": "2"}, "outside")):
        with pytest.raises(ValueError, match=match):
            multihost_env(env)
        with pytest.raises(ValueError, match=match):
            j_env(env)
    assert multihost_env({"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29400",
                          "WORLD_SIZE": "8", "RANK": "5"}) == {
        "coordinator_address": "10.0.0.1:29400", "num_processes": 8, "process_id": 5}


def test_initialize_without_variables_is_one_process():
    """Nothing configured: no process group, the 1×1 summary (JAX's keys)."""
    from gflownet_spai_tpu.parallel.multihost import process_summary as j_summary
    from gflownet_spai_tpu_torch.parallel.multihost import (initialize_from_env,
                                                            process_summary)

    assert initialize_from_env(environ={}, device="cpu") is False
    s = process_summary()
    assert set(s) == set(j_summary())
    assert s["process_count"] == 1 and s["backend"] == "none"


def test_two_process_cli_multihost(tmp_path):
    """Two OS processes bootstrapped from GFNSPAI_* (file:// rendezvous): a
    cross-process psum, then ``--multihost`` training with the sharded
    sampler over rows and the dp step over dp; rank 0 alone writes the
    metrics and the checkpoints; the rank check's halo SpMV over the two
    ranks equals each rank's whole-matrix SpMV."""
    env = {k: v for k, v in os.environ.items() if k not in _VARS + ("XLA_FLAGS",)}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO, GFNSPAI_NUM_PROCS="2",
               GFNSPAI_COORDINATOR=f"file://{tmp_path}/rdv", GFNSPAI_TIMEOUT_S="100")
    procs = [subprocess.Popen([sys.executable, HERE, str(tmp_path / "runs")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=dict(env, GFNSPAI_PROC_ID=str(i)), text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=110)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out[-3000:]
        assert "OK" in out
    for run in ("sharded", "dp"):
        d = tmp_path / "runs" / run
        assert (d / "checkpoint" / "epoch_3.pt").exists()
        lines = (d / "metrics.jsonl").read_text().splitlines()
        assert len(lines) == 3                      # rank 0 alone wrote
        assert all(json.loads(x)["loss"] == json.loads(x)["loss"] for x in lines)
    assert '"process_count": 2' in outs[0] and '"backend": "gloo"' in outs[1]
    recs = [json.loads(x) for out in outs for x in out.splitlines() if x.startswith('{"rank"')]
    assert sorted(r["rank"] for r in recs) == [0, 1]
    assert all(r["world"] == 2 and r["spmv_rel_err"] <= 1e-6 for r in recs)
    assert recs[0]["dp_loss"] == recs[1]["dp_loss"]
