"""Geometric multigrid for structured 3D box grids.

PyTorch counterpart of ``difffe_tpu/ops/multigrid3.py``.  Fixed-trip
Jacobi-PCG iteration counts grow like O(n) with the grid side; a geometric
V-cycle preconditioner grows them more slowly (the JAX module states
~10-20 to 1e-10; with per-tet κ uniform in [1, 2] both packages take 28
iterations at 16³, and the port 50 at 32³ and 88 at 64³), the 3D
analogue of ops/multigrid.py:

* smoother     — weighted Jacobi (ω = 2/3), symmetric pre/post sweeps;
* restriction  — full weighting, separable: the 27-point [1,2,1]³/64
                 stencil as three axis passes of [1,2,1]/4 and a stride-2
                 subsample (slices and adds only);
* prolongation — trilinear interpolation, axis-separable the same way;
* coarse ops   — re-discretized: per-tet κ averaged to a per-cube scalar,
                 2×2×2 cube-averaged a level, re-assembled through
                 ``stencil3d.stencil3d_coefficients``;
* coarsest     — extra smoothing sweeps.

Layout: node grids are (..., nz+1, ny+1, nx+1) with leading scenario axes,
and every transfer acts on the trailing three (grid) axes.  The JAX
module's ``*_bm`` family keeps the scenario batch on the TPU's lane axis
(batch-minor, (nz+1, ny+1, nx+1, B)); that is a TPU layout, so the family
keeps its names here but takes batch-leading arrays and per-scenario CG
dots (``pcg.batched_dot(3)``): the same per-scenario α/β, trip count and
freeze, and the same warm-state contract (the state is opaque).
``solve_poisson_structured_3d_mg`` is a ``torch.autograd.Function`` whose
backward runs the same MG-CG (first order only, as the JAX custom VJP).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F_

from .pcg import batched_dot, first_order_only, pcg
from .stencil3d import (StructuredGrid3, _kappa_cotangent, boundary_mask_box,
                        kappa_to_cube, load_box, residual_vjp_manual_3d,
                        stencil3d_apply, stencil3d_coefficients,
                        stencil3d_kappa_grad)

# --------------------------------------------------------------------------
# Separable transfer operators on the trailing grid axes
# --------------------------------------------------------------------------


def _restrict_axis(r: torch.Tensor, axis: int) -> torch.Tensor:
    """[1,2,1]/4 smoothing and stride-2 subsample along ``axis`` (counted
    from the end): out[i] = ¼·r[2i−1] + ½·r[2i] + ¼·r[2i+1], zero outside
    (the transfers only see masked residuals, zero on Dirichlet rows)."""
    r = r.movedim(axis, -1)
    center = r[..., ::2]
    odd = r[..., 1:-1:2]
    out = 0.5 * center + 0.25 * (F_.pad(odd, (1, 0)) + F_.pad(odd, (0, 1)))
    return out.movedim(-1, axis)


def restrict_full_weighting_3d(r: torch.Tensor) -> torch.Tensor:
    """(..., 2a+1, 2b+1, 2c+1) fine node grid → (..., a+1, b+1, c+1)
    coarse, 27-point full weighting by three separable passes."""
    return _restrict_axis(_restrict_axis(_restrict_axis(r, -3), -2), -1)


def _prolong_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """Linear interpolation along ``axis`` (counted from the end): m+1
    coarse → 2m+1 fine (fine[2i] = c[i], fine[2i+1] = ½(c[i] + c[i+1])),
    interleaved by stack and reshape."""
    c = c.movedim(axis, -1)
    odd = 0.5 * (c[..., :-1] + c[..., 1:])
    body = torch.stack([c[..., :-1], odd], dim=-1).flatten(-2)
    return torch.cat([body, c[..., -1:]], dim=-1).movedim(-1, axis)


def prolong_trilinear(c: torch.Tensor) -> torch.Tensor:
    """(..., a+1, b+1, c+1) coarse → (..., 2a+1, 2b+1, 2c+1) fine."""
    return _prolong_axis(_prolong_axis(_prolong_axis(c, -3), -2), -1)


def coarsen_kappa_3d(k6: torch.Tensor) -> torch.Tensor:
    """Per-tet κ (..., nz, ny, nx, 6) → coarse (..., nz/2, ny/2, nx/2, 6):
    the tets averaged to a per-cube scalar, 2×2×2 cube-averaged, broadcast
    back over the 6 coarse tets.  Leading axes pass through."""
    k = k6.mean(dim=-1)
    nz, ny, nx = k.shape[-3:]
    kc = k.reshape(k.shape[:-3] + (nz // 2, 2, ny // 2, 2, nx // 2, 2))
    kc = kc.mean(dim=(-5, -3, -1))
    return kc[..., None].expand(kc.shape + (6,))


# --------------------------------------------------------------------------
# Hierarchy + V-cycle
# --------------------------------------------------------------------------

def _n_levels(grid: StructuredGrid3, max_levels: int) -> int:
    lv = 1
    n = min(grid.nx, grid.ny, grid.nz)
    while lv < max_levels and n % 2 == 0 and n > 2:
        n //= 2
        lv += 1
    return lv


def build_hierarchy_3d(grid: StructuredGrid3, kappa, max_levels: int = 6):
    """Per-level (C planes, Dirichlet mask m, ω·D⁻¹), fine → coarse.

    kappa: flat (..., n_elements) in FEMesh.box order or
    (..., nz, ny, nx, 6); leading axes are scenarios."""
    k6 = kappa_to_cube(grid, kappa)
    levels = []
    g = grid
    for _ in range(_n_levels(grid, max_levels)):
        C = stencil3d_coefficients(g, k6)
        m = boundary_mask_box(g, k6.dtype, k6.device)
        p = 1.0 - m
        diagA = m + p * C[..., 0, :, :, :]
        wdinv = (2.0 / 3.0) / torch.where(diagA.abs() > 1e-30, diagA,
                                          torch.ones_like(diagA))
        levels.append((C, m, wdinv))
        if (g.nx % 2 or g.ny % 2 or g.nz % 2
                or min(g.nx, g.ny, g.nz) <= 2):
            break
        k6 = coarsen_kappa_3d(k6)
        g = StructuredGrid3(nx=g.nx // 2, ny=g.ny // 2, nz=g.nz // 2,
                            hx=g.hx * 2, hy=g.hy * 2, hz=g.hz * 2)
    return levels


def _A3(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil3d_apply(C, p * v)


def _smooth3(C, m, wdinv, x, b, sweeps: int):
    for _ in range(sweeps):
        x = x + wdinv * (b - _A3(C, m, x))
    return x


def v_cycle_3d(levels, b: torch.Tensor, level: int = 0, pre: int = 2,
               post: int = 2, coarse_sweeps: int = 12, gamma: int = 1):
    """One multigrid cycle for A e = b from a zero guess; ``gamma``: 1 =
    V-cycle (the default), 2 = W-cycle."""
    C, m, wdinv = levels[level]
    if level == len(levels) - 1:
        return _smooth3(C, m, wdinv, torch.zeros_like(b), b, coarse_sweeps)
    x = _smooth3(C, m, wdinv, torch.zeros_like(b), b, pre)
    mc = levels[level + 1][1]
    for _ in range(gamma):
        r = b - _A3(C, m, x)
        # Dirichlet rows carry no error; zero them around the transfer so
        # the coarse problem stays consistent with its own boundary mask
        rc = (1.0 - mc) * restrict_full_weighting_3d((1.0 - m) * r)
        ec = v_cycle_3d(levels, rc, level + 1, pre, post, coarse_sweeps,
                        gamma)
        x = x + (1.0 - m) * prolong_trilinear(ec)
        x = _smooth3(C, m, wdinv, x, b, post)
    return x


# --------------------------------------------------------------------------
# MG-preconditioned CG solve (implicit-function-theorem backward)
# --------------------------------------------------------------------------

def _pcg_mg3(levels, b, x0, tol, maxiter, gamma: int = 1):
    """(x, iterations, r); per-scenario dots on batched right-hand sides."""
    C, m, _ = levels[0]
    return pcg(lambda v: _A3(C, m, v), b,
               lambda r: v_cycle_3d(levels, (1.0 - m) * r,
                                    gamma=gamma) + m * r,
               x0, tol, maxiter, with_diagnostics=True,
               dot=batched_dot(3) if b.ndim > 3 else None)


def _mg3_setup(grid, kappa, f, g, max_levels):
    levels = build_hierarchy_3d(grid, kappa, max_levels)
    C, m, _ = levels[0]
    p = 1.0 - m
    b = m * g + p * (load_box(grid, f) - stencil3d_apply(C, m * g))
    return levels, b, (m * g).expand(b.shape)


class _SolveMG3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, tol, maxiter, max_levels, gamma, kappa, f, g):
        levels, b, x0 = _mg3_setup(grid, kappa, f, g, max_levels)
        maxit = maxiter if maxiter is not None else 100
        u, _, _ = _pcg_mg3(levels, b, x0, tol, maxit, gamma)
        ctx.cfg = (grid, tol, maxit, gamma)
        ctx.levels = levels
        ctx.save_for_backward(kappa, f, g, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        first_order_only("solve_poisson_structured_3d_mg")
        grid, tol, maxit, gamma = ctx.cfg
        kappa, f, g, u = ctx.saved_tensors
        lam, _, _ = _pcg_mg3(ctx.levels, gbar, torch.zeros_like(gbar), tol,
                             maxit, gamma)
        gk, gf, gg = residual_vjp_manual_3d(grid, kappa, f, g, u, lam,
                                            C=ctx.levels[0][0])
        return None, None, None, None, None, gk, gf, gg


def solve_poisson_structured_3d_mg(grid: StructuredGrid3, kappa,
                                   f: torch.Tensor, g: torch.Tensor,
                                   tol: float = 1e-10,
                                   maxiter: Optional[int] = None,
                                   max_levels: int = 6,
                                   gamma: int = 1) -> torch.Tensor:
    """MG-preconditioned CG Poisson solve on the box grid.

    Same contract as ``stencil3d.solve_poisson_structured_3d`` (leading
    scenario axes solved as independent scenarios); iteration counts grow
    more slowly with the grid than Jacobi-PCG's.  ``maxiter`` defaults to
    100.  Differentiable wrt κ, f and g through
    one adjoint MG-CG solve."""
    return _SolveMG3.apply(grid, tol, maxiter, int(max_levels), int(gamma),
                           kappa, f, g)


def mg3_diagnostics(grid: StructuredGrid3, kappa, f, g, tol: float = 1e-10,
                    maxiter: int = 100, max_levels: int = 6,
                    gamma: int = 1):
    """(u, iterations, final residual norm): the iteration count is a
    Python int, the norm per scenario over the grid axes."""
    levels, b, x0 = _mg3_setup(grid, kappa, f, g, max_levels)
    x, iters, r = _pcg_mg3(levels, b, x0, tol, maxiter, gamma)
    return x, iters, (r * r).sum(dim=(-3, -2, -1)).sqrt()


# --------------------------------------------------------------------------
# The batched family (batch-minor in the JAX module, batch-leading here)
# --------------------------------------------------------------------------

def build_hierarchy_bm(grid: StructuredGrid3, k6: torch.Tensor,
                       max_levels: int = 6):
    """The batched hierarchy: k6 (B, nz, ny, nx, 6) → per-level
    (C (B, 7, nz'+1, ny'+1, nx'+1), m, ω·D⁻¹ (B, nz'+1, ny'+1, nx'+1))."""
    return build_hierarchy_3d(grid, k6, max_levels)


def v_cycle_bm(levels, b: torch.Tensor, level: int = 0, pre: int = 2,
               post: int = 2, coarse_sweeps: int = 12):
    """The batched V-cycle on (B, nz'+1, ny'+1, nx'+1) state."""
    return v_cycle_3d(levels, b, level, pre, post, coarse_sweeps, gamma=1)


def pcg_mg_bm(levels, b, x0, tol, maxiter, pre: int = 2, post: int = 2,
              coarse_sweeps: int = 12):
    """The batched MG-PCG: per-scenario α/β, V-cycle preconditioner.
    Returns x."""
    C, m, _ = levels[0]
    return pcg(lambda v: _A3(C, m, v), b,
               lambda r: v_cycle_bm(levels, (1.0 - m) * r, pre=pre,
                                    post=post,
                                    coarse_sweeps=coarse_sweeps) + m * r,
               x0, tol, maxiter, dot=batched_dot(3))


def kappa_mse_grad_step_3d_mg(grid: StructuredGrid3, kappa, f, g, u_data,
                              iters: int, warm_state=None,
                              return_state: bool = False, pre: int = 1,
                              post: int = 1, coarse_sweeps: int = 8):
    """MG-preconditioned κ-inversion gradient step: loss =
    mean((u(κ) − u_data)²) over batch and nodes; returns
    (loss, ∂loss/∂κ) [+ the warm state].

    ``stencil3d.kappa_mse_grad_step_3d`` with the Jacobi preconditioner
    replaced by a V-cycle: ``iters`` MG-PCG iterations (forward and
    adjoint) replace Jacobi-PCG ones (at 48³ with this cycle, 120 of them
    meet 600 Jacobi iterations' κ gradient to 4e-12, 30 leave it 1e-2
    off).  kappa (B, n_elements) flat or (B, nz, ny, nx, 6); f,
    u_data (B,) + node grid; g a node grid.  The warm state is the opaque
    (u, λ) pair (batch-leading here).  Not differentiable: it is the
    step."""
    if not (kappa.ndim == 2 or (kappa.ndim == 5 and kappa.shape[-1] == 6)):
        raise ValueError(
            f"batched 3D solve expects kappa (B, {grid.n_elements}) flat or "
            f"(B, nz, ny, nx, 6); got shape {tuple(kappa.shape)}")
    if f.ndim != 4:
        raise ValueError(
            f"batched 3D solve expects f (B,) + node grid {grid.node_shape}; "
            f"got shape {tuple(f.shape)}")
    with torch.no_grad():
        levels = build_hierarchy_bm(grid, kappa_to_cube(grid, kappa))
        C, m, _ = levels[0]
        p = 1.0 - m
        mg = m * g
        b = mg + p * (load_box(grid, f) - stencil3d_apply(C, mg))
        if warm_state is None:
            x0, l0 = mg.expand(b.shape), torch.zeros_like(b)
        else:
            x0, l0 = warm_state

        def Mi(r):
            return v_cycle_bm(levels, (1.0 - m) * r, pre=pre, post=post,
                              coarse_sweeps=coarse_sweeps) + m * r

        def A(v):
            return _A3(C, m, v)

        dot = batched_dot(3)
        u = pcg(A, b, Mi, x0, 0.0, iters, dot=dot)
        diff = u - u_data
        numel = diff.numel()
        loss = (diff * diff).sum() / numel
        lam = pcg(A, (2.0 / numel) * diff, Mi, l0, 0.0, iters, dot=dot)
        gk = _kappa_cotangent(
            grid, -stencil3d_kappa_grad(grid, p * lam, mg + p * u), kappa)
    if return_state:
        return loss, gk, (u, lam)
    return loss, gk
