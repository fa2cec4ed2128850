"""Parallelism on ``torch.distributed``: device meshes, scenario-batch
(dp) and DOF sharding, explicit-SPMD training steps, halo-exchange
solves, time-axis pipeline parallelism, expert-parallel surrogate banks,
multi-process init.

PyTorch counterpart of ``difffe_tpu/parallel/`` (its ``__all__``).  NCCL
on the card, gloo when the caller asks for the CPU
(``multihost.initialize(device="cpu")``)."""

from .expert import make_dispatch, moe_apply, route_by_bucket
from .halo import halo_cg_solve, make_halo_apply, make_halo_solver
from .pipeline import pipelined_rollout
from .sharding import (
    batch_dof_sharding,
    batch_sharding,
    make_device_mesh,
    make_inversion_step,
    make_inversion_step_shard_map,
    replicated,
    shard_batch,
)

__all__ = [
    "batch_dof_sharding",
    "make_dispatch",
    "moe_apply",
    "route_by_bucket",
    "pipelined_rollout",
    "halo_cg_solve",
    "make_halo_apply",
    "make_halo_solver",
    "batch_sharding",
    "make_device_mesh",
    "make_inversion_step",
    "make_inversion_step_shard_map",
    "replicated",
    "shard_batch",
]
