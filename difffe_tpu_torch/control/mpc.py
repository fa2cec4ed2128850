"""Receding-horizon source control of the heat equation (MPC).

PyTorch counterpart of ``difffe_tpu/control/mpc.py``.  The planner
optimizes the controls q (H, c) of a whole horizon by Adam over adjoint
gradients through ``control.heat.rollout``; each MPC step applies the
first planned control and warm-starts the next plan with the shifted
sequence.

The JAX planners run their Adam steps as one ``lax.scan`` (and ``vmap``
B of them); here the steps are a Python loop over ``torch.optim.Adam``
with optax's defaults (``inverse._adam``), whose losses stay on the device
until the loop ends.  The batched planner is one Adam over q (B, H, c) on
the sum of the per-scenario costs: Adam is elementwise and the scenarios
are independent, so every scenario follows the same iterates as its own
Adam would.  The rollouts take the ``"auto"`` route: on the card every
forward and every adjoint step is one launch of kernel K2, 2·H·plan_iters
launches a plan (on K2's warp route from 2048 scenarios).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..inverse import _adam_loop
from ..mesh import FEMesh
from ..ops.assembly import assemble_lumped_mass
from .heat import (heat_step_tridiag, heat_system_tridiag, rollout,
                   rollout_batched)


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 50          # H — BASELINE config 3 uses H=50
    dt: float = 1e-3
    lr: float = 0.1
    plan_iters: int = 100      # Adam steps per (re-)plan
    control_penalty: float = 1e-4
    terminal_weight: float = 1.0


def gaussian_actuators(mesh: FEMesh, centers, width: float) -> torch.Tensor:
    """Actuator basis (n_controls, n_nodes): Gaussian bumps at ``centers``
    (scalars in 1D, points (n_controls, dim) otherwise).  The forcing is
    q(x, t) = Σ_c a_c(t)·B_c(x)."""
    centers = torch.as_tensor(centers, dtype=mesh.dtype, device=mesh.device)
    if mesh.dim == 1:
        d2 = (mesh.nodes[None, :, 0] - centers[:, None]) ** 2
    else:
        d2 = ((mesh.nodes[None, :, :] - centers[:, None, :]) ** 2).sum(-1)
    return torch.exp(-d2 / (2.0 * width ** 2))


def tracking_cost(mesh: FEMesh, traj: torch.Tensor, target: torch.Tensor,
                  controls: torch.Tensor, cfg: MPCConfig) -> torch.Tensor:
    """Σ_t mean((u_t − target)² on free nodes) / H + α·mean(q²) + the
    terminal term, per scenario: traj (..., H, n), target broadcast
    against it, controls (..., H, c) → (...).  Never reduces across the
    leading (scenario) axes."""
    free = 1.0 - mesh.bc_mask
    nfree = free.sum().clamp_min(1.0)
    err = (traj - target) ** 2 * free
    run = (err.sum(-1) / nfree).mean(-1)
    term = cfg.terminal_weight * err[..., -1, :].sum(-1) / nfree
    reg = cfg.control_penalty * (controls ** 2).mean((-2, -1))
    return run + term + reg


def make_planner(mesh: FEMesh, kappa, actuators: torch.Tensor,
                 target: torch.Tensor, cfg: MPCConfig):
    """Full-horizon planner ``plan(u0 (n,), q_init (H, c)) → (q_opt (H, c),
    losses (plan_iters,))``, plan_iters Adam steps of rollout + adjoint."""

    def plan(u0, q_init):
        q = q_init.detach().clone().requires_grad_(True)

        def cost():
            traj = rollout(mesh, kappa, u0, q @ actuators, cfg.dt)
            return tracking_cost(mesh, traj, target, q, cfg)

        losses = _adam_loop([q], cost, cfg.plan_iters, cfg.lr)
        return q.detach(), losses

    return plan


def make_planner_batched(mesh: FEMesh, kappa, actuators: torch.Tensor,
                         cfg: MPCConfig):
    """Scenario-batched planner ``plan(u0 (B, n), targets (B, H, n), q_init
    (B, H, c)) → (q_opt (B, H, c), losses (B, plan_iters))``: B
    independent horizon optimizations, per-scenario κ (B, …) supported (a
    κ whose leading axis is B is per scenario, as in
    ``rollout_batched``)."""

    def plan(u0_b, target_b, q_init_b):
        q = q_init_b.detach().clone().requires_grad_(True)

        def cost():
            # the rollout's time-leading layout (H, B, n) and back
            f_seq = (q @ actuators).transpose(0, 1)
            traj = rollout_batched(mesh, kappa, u0_b, f_seq,
                                   cfg.dt).transpose(0, 1)
            return tracking_cost(mesh, traj, target_b, q, cfg)

        losses = _adam_loop([q], cost, cfg.plan_iters, cfg.lr)
        return q.detach(), losses

    return plan


def receding_horizon(mesh: FEMesh, kappa, u0: torch.Tensor,
                     actuators: torch.Tensor, target: torch.Tensor,
                     cfg: MPCConfig, n_mpc_steps: int,
                     disturbance: Optional[
                         Callable[[int, torch.Tensor], torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-loop MPC: plan, apply the first control, advance, shift,
    repeat.

    Returns (states (n_mpc_steps+1, n_nodes), applied controls
    (n_mpc_steps, n_controls)).  ``disturbance(step, u) → u`` optionally
    perturbs the realized state (plant/model mismatch).
    """
    plan = make_planner(mesh, kappa, actuators, target, cfg)
    bands = heat_system_tridiag(mesh, kappa, cfg.dt)
    M = assemble_lumped_mass(mesh)
    u = torch.as_tensor(u0, dtype=mesh.dtype, device=mesh.device)
    q_warm = torch.zeros((cfg.horizon, actuators.shape[0]), dtype=mesh.dtype,
                         device=mesh.device)
    states, applied = [u], []
    for step in range(n_mpc_steps):
        q_opt, _ = plan(u, q_warm)
        q0 = q_opt[0]
        with torch.no_grad():
            u = heat_step_tridiag(mesh, bands, M, u, q0 @ actuators, cfg.dt)
        if disturbance is not None:
            u = disturbance(step, u)
        states.append(u)
        applied.append(q0)
        # shift the warm start: drop the applied control, repeat the last
        q_warm = torch.cat([q_opt[1:], q_opt[-1:]], dim=0)
    return torch.stack(states), torch.stack(applied)
