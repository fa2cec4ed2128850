"""Explicit halo-exchange domain decomposition: differentiable distributed
2D solves on ``torch.distributed``.

PyTorch counterpart of ``difffe_tpu/parallel/halo.py``: the node grid
(H, W) = (ny+1, nx+1) is split by rows over the ranks of the ``axis``
dimension of the mesh, each rank exchanges one boundary row with each
neighbour (``_collectives.exchange``, point-to-point sends in the axis
group; zeros stand at the physical boundaries, and nothing is sent at
group size 1) and applies the 7-point stencil (ops/stencil.py) to its
rows.

* :func:`make_halo_apply` and :func:`halo_cg_solve` take and return this
  rank's row block of each grid, the shard_map body's view.
* :func:`make_halo_solver` (BASELINE config 4: batched κ-field inversion
  with PCG solves sharded across a host) keeps the contract of
  ``ops.stencil.solve_poisson_structured``: κ, f, g and u are whole on
  every rank of the axis group, and only the CG's state is split by rows.
  Each rank forms the coefficient planes and right-hand side of the whole
  grid, O(H·W) against the CG's O(iterations·H·W/P).  Its backward is the
  implicit-function theorem: one adjoint halo CG and the closed-form
  residual cotangents (``ops.stencil.residual_vjp_manual``), with no tape
  through the iterations.  The per-scenario CG dots are
  ``pcg.batched_dot(2)`` all-reduced over the axis group, so the value and
  gradient equal the single-process solve with ``dot=batched_dot(2)``.

Gradients follow the package's convention (parallel/_collectives.py): the
solver's backward sums the ranks' partial cotangents of u and returns
partial cotangents of κ, f and g (the rank's rows of λ), whose sum over
the axis group is the gradient.  The scenario batch may be split over
``batch_axis`` by the caller (``Sharding.local``); scenarios are
independent, so that axis needs no collective.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.pcg import batched_dot, first_order_only, pcg
from ..ops.stencil import (OFFSETS, StructuredGrid, _shift2d,
                           boundary_mask_grid, load_grid,
                           residual_vjp_manual, stencil_apply,
                           stencil_coefficients)
from ._collectives import all_gather, exchange


def _exchange_halos(u_loc: torch.Tensor, group):
    """(row_above, row_below) of this rank's block of rows ``u_loc``
    (..., h_local, W): the last row of the previous rank and the first row
    of the next one, zeros at the physical boundaries."""
    return exchange(group, u_loc[..., :1, :], u_loc[..., -1:, :])


def _local_stencil_apply(C_loc: torch.Tensor, u_loc: torch.Tensor,
                         group) -> torch.Tensor:
    """The 7-point stencil on this rank's rows with the halo exchange.

    C_loc: (..., 7, h_local, W); u_loc: (..., h_local, W), leading axes
    scenario batches.
    """
    row_above, row_below = _exchange_halos(u_loc, group)
    u_ext = torch.cat([row_above, u_loc, row_below], dim=-2)
    h = u_loc.shape[-2]
    out = torch.zeros_like(u_loc)
    for k, (dr, dc) in enumerate(OFFSETS):
        # u_ext row 1 + r is local row r; dr ∈ {−1, 0, 1}
        shifted = _shift2d(u_ext[..., 1 + dr:1 + dr + h, :], 0, dc)
        out = out + C_loc[..., k, :, :] * shifted
    return out


def make_halo_apply(device_mesh, axis: str = "dof",
                    batch_axis: Optional[str] = None, batched: bool = False):
    """Build a sharded K·u over a row-decomposed node grid.

    Returns ``apply(C, u) → K·u`` on this rank's row blocks: unbatched C
    (7, h, W), u (h, W); with ``batched=True`` C (B, 7, h, W), u (B, h,
    W), the scenario axis the caller's shard over ``batch_axis`` (kept for
    the JAX signature: scenarios need no collective).  The row count H
    must divide by the ``axis`` size.  Differentiable in C and u (the
    exchange's backward sends the cotangents back).
    """
    group = device_mesh.get_group(axis)

    def apply(C, u):
        return _local_stencil_apply(C, u, group)

    return apply


def _axis_dot(group, dot=None):
    """A CG inner product over the whole grid: ``dot`` (default the global
    sum) of this rank's rows, all-reduced over ``group``."""
    def local(u, v):
        return (u * v).sum()

    dot = dot or local

    def reduced(u, v):
        s = dot(u, v)
        dist.all_reduce(s, group=group)
        return s

    return reduced


def halo_cg_solve(device_mesh, C: torch.Tensor, m: torch.Tensor,
                  b: torch.Tensor, maxiter: int, axis: str = "dof"):
    """Distributed Jacobi-PCG with the halo-exchange matvec (forward only;
    :func:`make_halo_solver` is the differentiable form).

    C: (7, h, W) stencil planes (BC-free), m: (h, W) Dirichlet mask, b:
    (h, W) eliminated right-hand side — this rank's row blocks; returns
    its rows of x.  The CG dots are global sums all-reduced over ``axis``.
    """
    group = device_mesh.get_group(axis)
    p_mask = 1.0 - m

    def A(v):
        return m * v + p_mask * _local_stencil_apply(C, p_mask * v, group)

    diagA = m + p_mask * C[0]
    Minv = 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))
    with torch.no_grad():
        return pcg(A, b, lambda r: Minv * r, torch.zeros_like(b), 0.0,
                   maxiter, dot=_axis_dot(group))


# --------------------------------------------------------------------------
# Differentiable, batched DOF-sharded solve (BASELINE config 4)
# --------------------------------------------------------------------------

class _HaloSolve(torch.autograd.Function):
    """u = A(κ)⁻¹ b(κ, f, g) on whole batched grids, the CG split over the
    axis group; backward by the implicit function theorem."""

    @staticmethod
    def forward(ctx, solver, f, g, *kappa):
        C = solver.coefficients(*kappa)
        C_b, f_b, g_b = solver.with_batch(C, f, g)
        m = solver.mask(f_b.dtype, f_b.device)
        p = 1.0 - m
        mg = m * g_b
        b = mg + p * (solver.load(f_b) - solver.apply_whole(C_b, mg))
        u = solver.pcg(C_b, b, mg)
        ctx.solver = solver
        ctx.save_for_backward(f, g, u, *kappa)
        nd = len(solver.node_shape)
        squeeze = f.ndim == nd and C.ndim == nd + 1 and g.ndim == nd
        return u[0] if squeeze else u

    @staticmethod
    def backward(ctx, gbar):
        first_order_only("a halo solver's solve")
        solver = ctx.solver
        f, g, u, *kappa = ctx.saved_tensors
        nd = len(solver.node_shape)
        C = solver.coefficients(*kappa)
        gb = gbar if gbar.ndim == nd + 1 else gbar[None]
        C_b = C if C.ndim == nd + 2 else C[None]
        B = max(C_b.shape[0], gb.shape[0])
        C_b = C_b.expand((B,) + C_b.shape[1:])
        gb = gb.expand((B,) + solver.node_shape).clone(
            memory_format=torch.contiguous_format)
        # the ranks' cotangents of the whole u are partials: sum them
        dist.all_reduce(gb, group=solver.group)
        lam = solver.pcg(C_b, gb, torch.zeros_like(gb))
        # this rank's part of λ alone: the residual map's cotangents are
        # linear in λ, so the ranks' sum is the gradient
        lam = solver.own_part_only(lam)
        if gbar.ndim == nd:
            lam = lam[0]
        return (None,) + solver.residual_vjp(kappa, f, g, u, lam, C)


class _HaloSolver:
    """A structured grid's operators, the axis group and the CG policy:
    what a halo solve needs between its forward and its backward.

    ``split_dim`` is the node axis split over the group (−2, the rows of a
    2D grid; −3, the z-planes of a box); ``local_apply(C, u, group)`` is
    the stencil on a rank's part with the halo exchange."""

    def __init__(self, device_mesh, axis, node_shape, split_dim, tol,
                 maxiter, *, coefficients, mask, load, apply_whole,
                 local_apply, residual_vjp):
        self.group = device_mesh.get_group(axis)
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.node_shape = tuple(node_shape)
        n_split = self.node_shape[split_dim]
        if n_split % self.size:
            raise ValueError(f"{n_split} node layers are not divisible by "
                             f"the {self.size} ranks of mesh axis {axis!r}")
        self.h = n_split // self.size
        self.split_dim = split_dim
        self.tol = tol
        self.maxiter = maxiter if maxiter is not None \
            else math.prod(self.node_shape)
        self.dot = _axis_dot(self.group, batched_dot(len(self.node_shape)))
        self.coefficients, self.mask, self.load = coefficients, mask, load
        self.apply_whole, self.local_apply = apply_whole, local_apply
        self.residual_vjp = residual_vjp

    def with_batch(self, C, f, g):
        """C/f/g broadcast to a shared leading scenario axis."""
        nd = len(self.node_shape)
        C_b = C if C.ndim == nd + 2 else C[None]
        f_b = f if f.ndim == nd + 1 else f[None]
        g_b = g if g.ndim == nd + 1 else g[None]
        B = max(C_b.shape[0], f_b.shape[0], g_b.shape[0])
        return (C_b.expand((B,) + C_b.shape[1:]),
                f_b.expand((B,) + self.node_shape),
                g_b.expand((B,) + self.node_shape))

    def own(self, x):
        return x.narrow(self.split_dim, self.rank * self.h, self.h)

    def own_part_only(self, x):
        out = torch.zeros_like(x)
        self.own(out).copy_(self.own(x))
        return out

    def pcg(self, C_b, b, x0):
        """Jacobi-PCG on this rank's part of whole batched grids; the whole
        solution, gathered over the axis group."""
        m = self.own(self.mask(b.dtype, b.device))
        p = 1.0 - m
        C_l = self.own(C_b)

        def A(v):
            return m * v + p * self.local_apply(C_l, p * v, self.group)

        diagA = m + p * C_l[:, 0]
        Minv = 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                                 torch.ones_like(diagA))
        x = pcg(A, self.own(b).contiguous(), lambda r: Minv * r,
                self.own(x0).contiguous(), self.tol, self.maxiter,
                dot=self.dot)
        return all_gather(x, self.group, dim=self.split_dim)


def make_halo_solver(device_mesh, grid: StructuredGrid, *,
                     tol: float = 0.0, maxiter: Optional[int] = None,
                     axis: str = "dof", batch_axis: Optional[str] = None):
    """Build a differentiable DOF-sharded structured Poisson solve.

    Returns ``solve(kappa_lu, f, g) → u`` with the contract of
    ``ops.stencil.solve_poisson_structured`` — kappa_lu a (κ_lower,
    κ_upper) pair of (ny, nx) or (B, ny, nx) per-triangle fields, f the
    forcing on the (H, W) = (ny+1, nx+1) node grid (optionally batched), g
    the Dirichlet boundary values — except that every CG matvec (forward
    and adjoint) runs through the halo exchange, node rows split over the
    ``axis`` mesh dimension.  H must divide by the ``axis`` size; the
    scenarios are the caller's shard over ``batch_axis`` (module note).
    ``maxiter`` defaults to H·W, at ``tol`` 0 a fixed trip count.
    """
    def residual_vjp(kappa, f, g, u, lam, C):
        (gl, gu), gf, gg = residual_vjp_manual(grid, tuple(kappa), f, g, u,
                                               lam, C=C)
        return gf, gg, gl, gu

    solver = _HaloSolver(
        device_mesh, axis, grid.node_shape, -2, tol, maxiter,
        coefficients=lambda kl, ku: stencil_coefficients(grid, kl, ku),
        mask=lambda dtype, device: boundary_mask_grid(grid, dtype, device),
        load=lambda f: load_grid(grid, f), apply_whole=stencil_apply,
        local_apply=_local_stencil_apply, residual_vjp=residual_vjp)

    def solve(kappa_lu, f, g):
        kl, ku = kappa_lu
        return _HaloSolve.apply(solver, f, g, kl, ku)

    return solve
