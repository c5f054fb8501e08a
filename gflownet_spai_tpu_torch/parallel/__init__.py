"""Multi-device execution on ``torch.distributed`` (counterpart of
``gflownet_spai_tpu/parallel/``): the (dp, rows) mesh and its collectives,
halo-exchange SpMV, distributed solvers, the dp train step, the sharded
head, sampler and GAT, and the multi-process bootstrap.  One process per
device; every function runs on each rank over that rank's shard."""

from .mesh import Mesh, make_mesh, single_device_mesh
from .halo_spmv import halo_spmv, halo_spmv_power, partition_dia, spmv_allgather
from .dp import (make_dp_train_step, sharded_residual_norms,
                 sharded_rowblock_residual_norms)
from .solvers import distributed_cg, distributed_gmres, distributed_jacobi
from .tp import pad_head, shard_head, sharded_policy_logits
from .sampler import ShardedRollout, replicated_oracle_gumbels, sharded_rollout
from .multihost import global_mesh, initialize_from_env, process_summary

__all__ = [
    "Mesh", "make_mesh", "single_device_mesh",
    "halo_spmv", "halo_spmv_power", "partition_dia", "spmv_allgather",
    "make_dp_train_step", "sharded_residual_norms",
    "sharded_rowblock_residual_norms",
    "distributed_cg", "distributed_gmres", "distributed_jacobi",
    "pad_head", "shard_head", "sharded_policy_logits",
    "ShardedRollout", "replicated_oracle_gumbels", "sharded_rollout",
    "global_mesh", "initialize_from_env", "process_summary",
]
