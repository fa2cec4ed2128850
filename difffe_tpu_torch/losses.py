"""Physics-informed loss functions.

PyTorch counterpart of ``difffe_tpu/losses.py``: the reference's two
modes, ``fem_match`` (MSE against the FEM solution for the same forcing,
computed once and cached, carrying no gradient) and ``variational`` (the
finite-difference strong-form residual on the interior of the free-node
set, uniform spacing), plus ``energy``, the Ritz energy ½uᵀKu − uᵀF,
matrix-free, which the FEM solution minimizes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .mesh import FEMesh
from .ops.assembly import assemble_load, stiffness_apply
from .solver import solve_poisson

MODES = ("fem_match", "variational", "energy")


def fem_match_loss(mesh: FEMesh, u_pred: torch.Tensor,
                   u_fem: torch.Tensor) -> torch.Tensor:
    """MSE(u_pred, u_fem) with no gradient through u_fem."""
    return ((u_pred - u_fem.detach()) ** 2).mean()


def variational_fd_loss(mesh: FEMesh, u_pred: torch.Tensor,
                        f: torch.Tensor) -> torch.Tensor:
    """FD strong-form residual lap(u) + f, lap_i = (u_{i−1} − 2u_i +
    u_{i+1})/h², averaged over free nodes whose two neighbours are free."""
    if mesh.dim != 1:
        raise NotImplementedError("variational FD loss is 1D (as in "
                                  "reference)")
    x = mesh.nodes[:, 0]
    n = mesh.n_nodes
    h = (x[-1] - x[0]) / (n - 1)
    u = u_pred
    lap = (u[..., :-2] - 2.0 * u[..., 1:-1] + u[..., 2:]) / (h * h)
    residual = lap + f[..., 1:-1]
    free = 1.0 - mesh.bc_mask
    valid = free[:-2] * free[1:-1] * free[2:]
    count = valid.sum().clamp_min(1.0)
    return ((residual ** 2) * valid).sum(dim=-1) / count


def energy_loss(mesh: FEMesh, kappa, u_pred: torch.Tensor,
                f: torch.Tensor) -> torch.Tensor:
    """Ritz energy ½uᵀKu − uᵀF (matrix-free)."""
    Ku = stiffness_apply(mesh, kappa, u_pred)
    F = assemble_load(mesh, f)
    return 0.5 * (u_pred * Ku).sum(dim=-1) - (u_pred * F).sum(dim=-1)


class PhysicsLoss:
    """``loss = PhysicsLoss(mesh, forcing_fn, mode)(u_pred)``, the
    reference's class shape.  The ``fem_match`` target is solved once, on
    first use, and cached."""

    def __init__(self, mesh: FEMesh,
                 forcing_fn: Callable[[torch.Tensor], torch.Tensor],
                 mode: str = "fem_match", solver=None, kappa=1.0):
        if mode not in MODES:
            raise ValueError(f"Unknown mode: {mode!r}")
        self.mesh = mesh
        self.forcing_fn = forcing_fn
        self.mode = mode
        self.kappa = solver.kappa if solver is not None else kappa
        self._u_fem: Optional[torch.Tensor] = None

    def _coords(self) -> torch.Tensor:
        # 1D passes x as (n,), 2D as (n, 2)
        return self.mesh.nodes[:, 0] if self.mesh.dim == 1 \
            else self.mesh.nodes

    @property
    def u_fem(self) -> torch.Tensor:
        if self._u_fem is None:
            f = self.forcing_fn(self._coords())
            with torch.no_grad():
                self._u_fem = solve_poisson(self.mesh, self.kappa, f)
        return self._u_fem

    def __call__(self, u_pred: torch.Tensor) -> torch.Tensor:
        if self.mode == "fem_match":
            return fem_match_loss(self.mesh, u_pred, self.u_fem)
        f = self.forcing_fn(self._coords())
        if self.mode == "variational":
            return variational_fd_loss(self.mesh, u_pred, f)
        return energy_loss(self.mesh, self.kappa, u_pred, f)

    forward = __call__
