"""Explicit halo-exchange domain decomposition in 3D: differentiable
distributed box solves on ``torch.distributed``.

PyTorch counterpart of ``difffe_tpu/parallel/halo3d.py``, the 3D analogue
of parallel/halo.py: the (nz+1, ny+1, nx+1) node grid is split by
z-planes over the ranks of the ``axis`` mesh dimension.  The box operator
is a 7-point stencil (ops/stencil3d.py), so only the (±1, 0, 0) offsets
cross a rank boundary: each CG matvec exchanges one (ny+1, nx+1) plane
with each z-neighbour through the same exchange as the 2D solver, then
applies the stencil locally.

:func:`make_halo_apply_3d` works on this rank's block of planes;
:func:`make_halo_solver_3d` keeps the contract of
``ops.stencil3d.solve_poisson_structured_3d`` with κ, f, g and u whole on
every rank of the axis group, the CG's state split by planes, per-scenario
dots (``pcg.batched_dot(3)``) all-reduced over the group, and the
implicit-function-theorem backward with
``ops.stencil3d.residual_vjp_manual_3d`` — the value and gradient of the
single-process solve with ``dot=batched_dot(3)``.  Gradients follow the
package's convention (parallel/_collectives.py), as in parallel/halo.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.stencil import _shift2d
from ..ops.stencil3d import (OFFSETS3, StructuredGrid3, boundary_mask_box,
                             load_box, residual_vjp_manual_3d,
                             stencil3d_apply, stencil3d_coefficients)
from ._collectives import exchange
from .halo import _HaloSolve, _HaloSolver


def _local_stencil3d_apply(C_loc: torch.Tensor, u_loc: torch.Tensor,
                           group) -> torch.Tensor:
    """The 7-point stencil on this rank's z-planes with the plane exchange.

    C_loc: (..., 7, d_local, H, W); u_loc: (..., d_local, H, W).
    """
    above, below = exchange(group, u_loc[..., :1, :, :],
                            u_loc[..., -1:, :, :])
    u_ext = torch.cat([above, u_loc, below], dim=-3)
    d = u_loc.shape[-3]
    out = torch.zeros_like(u_loc)
    for k, (dz, dy, dx) in enumerate(OFFSETS3):
        # u_ext plane 1 + z is local plane z; dz ∈ {−1, 0, 1}; the
        # in-plane (dy, dx) shift is local (zero fill = physical boundary)
        shifted = _shift2d(u_ext[..., 1 + dz:1 + dz + d, :, :], dy, dx)
        out = out + C_loc[..., k, :, :, :] * shifted
    return out


def make_halo_apply_3d(device_mesh, axis: str = "dof",
                       batch_axis: Optional[str] = None,
                       batched: bool = False):
    """Sharded K·u over a z-plane-decomposed node grid.

    Returns ``apply(C, u)`` on this rank's plane blocks: unbatched C (7,
    d, H, W), u (d, H, W); ``batched=True``: C (B, 7, d, H, W), u (B, d,
    H, W).  D = nz+1 must divide by the ``axis`` size.  Differentiable.
    """
    group = device_mesh.get_group(axis)

    def apply(C, u):
        return _local_stencil3d_apply(C, u, group)

    return apply


def make_halo_solver_3d(device_mesh, grid: StructuredGrid3, *,
                        tol: float = 0.0, maxiter: Optional[int] = None,
                        axis: str = "dof",
                        batch_axis: Optional[str] = None):
    """Differentiable z-sharded structured 3D Poisson solve.

    Returns ``solve(kappa, f, g) → u`` with the contract of
    ``solve_poisson_structured_3d`` — κ a per-tet field (ne,) or (B, ne)
    (or cube-shaped), f/g node grids (optionally batched) — except that
    every CG matvec (forward and adjoint) runs through the plane exchange,
    z-planes split over ``axis``; the scenarios are the caller's shard
    over ``batch_axis``.  nz+1 must divide by the ``axis`` size;
    ``maxiter`` defaults to the node count.
    """
    def residual_vjp(kappa, f, g, u, lam, C):
        gk, gf, gg = residual_vjp_manual_3d(grid, kappa[0], f, g, u, lam,
                                            C=C)
        return gf, gg, gk

    solver = _HaloSolver(
        device_mesh, axis, grid.node_shape, -3, tol, maxiter,
        coefficients=lambda kappa: stencil3d_coefficients(grid, kappa),
        mask=lambda dtype, device: boundary_mask_box(grid, dtype, device),
        load=lambda f: load_box(grid, f), apply_whole=stencil3d_apply,
        local_apply=_local_stencil3d_apply, residual_vjp=residual_vjp)

    def solve(kappa, f, g):
        return _HaloSolve.apply(solver, f, g, kappa)

    return solve
