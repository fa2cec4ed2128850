"""Control layer: heat-equation rollouts, receding-horizon MPC and
topology optimization (PyTorch counterpart of ``difffe_tpu/control``)."""

from .heat import (
    heat_step_tridiag,
    heat_system_tridiag,
    rollout,
    rollout_batched,
)
from .mpc import (
    MPCConfig,
    gaussian_actuators,
    make_planner,
    make_planner_batched,
    receding_horizon,
    tracking_cost,
)
from .topopt import (
    TopOptConfig,
    compliance,
    density_filter,
    oc_update,
    optimize,
    optimize_batched,
)

__all__ = [
    "heat_step_tridiag",
    "heat_system_tridiag",
    "rollout",
    "rollout_batched",
    "MPCConfig",
    "gaussian_actuators",
    "make_planner",
    "make_planner_batched",
    "receding_horizon",
    "tracking_cost",
    "TopOptConfig",
    "compliance",
    "density_filter",
    "oc_update",
    "optimize",
    "optimize_batched",
]
