"""Natural (Neumann/Robin) BCs and general Dirichlet masks on the 2D
structured-grid path.

PyTorch counterpart of ``difffe_tpu/ops/stencil_natural.py``.  The stencil
solvers of ops/stencil.py hard-code the factory full-boundary Dirichlet
mask, but mask-based elimination works for any Dirichlet node set m
(A = m + p·K·p is the eliminated operator whatever m is), and natural BCs
only touch:

* the load: Neumann adds ∮ g_N v ds (an assembled node vector,
  ops/neumann.py) and Robin adds ∮ r v ds, both to F on free rows;
* the boundary rows' coefficients: Robin's ∮ α u v ds boundary mass
  couples grid-adjacent nodes only, so it folds into the 7-plane stencil
  (``fold_robin_planes`` maps each COO entry to its OFFSETS plane, a
  host-side check on the indices).

So the natural-BC family takes the same stencil machinery: the torch PCG
here (``solve_poisson_structured_natural``), and for batched fixed-trip
solves the whole-CG kernel K3a (``solve_structured_pallas_natural``; the
kernel route keeps the JAX module's names, where ``pallas`` names the
kernel).  The kernel takes the folded planes unpadded, (5, B, H, W)
contiguous: the TPU padded W to 128 lanes and B to ``block_b``.

Both solves are ``torch.autograd.Function``s with the implicit-function-
theorem backward of the JAX custom VJPs, first order only.  A tol-gated
PCG solve runs as the ``torch.library`` op
``difffe::stencil_natural_cg_gated`` (the loop on CPU and CUDA tensors
alike, one node of an exported program; ops/pcg.py), which takes the
planes, the Robin planes and the mask.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .kernels._build import kernel_op
from .pcg import batched_dot, first_order_only, gated_iters, pcg
from .stencil import (OFFSETS, StructuredGrid, _reduce_to, _shift2d,
                      load_grid, stencil_apply, stencil_coefficients,
                      stencil_kappa_grad)


def _offsets(grid: StructuredGrid, rows, cols):
    """Row-major grid position of each COO row and the (dr, dc) offset to
    its column, on the host."""
    nx1 = grid.node_shape[1]
    r = torch.as_tensor(rows).detach().cpu().numpy()
    c = torch.as_tensor(cols).detach().cpu().numpy()
    ri, ci = np.divmod(r, nx1)
    rj, cj = np.divmod(c, nx1)
    return r, c, ri, ci, rj - ri, cj - ci


def robin_is_axis_adjacent(grid: StructuredGrid, rows, cols) -> bool:
    """True when every COO entry sits on the center or an axis-adjacent
    plane (offsets (0,0), (0,±1), (±1,0)): the 5-point set the whole-CG
    kernel carries.  Boundary-edge Robin terms always qualify (grid
    boundary edges are axis-aligned); host-side."""
    _, _, _, _, dr, dc = _offsets(grid, rows, cols)
    return set(zip(dr.tolist(), dc.tolist())) <= set(OFFSETS[:5])


def robin_plane_index(grid: StructuredGrid, rows, cols) -> list:
    """The stencil plane (index into OFFSETS) of each COO entry, checked
    on the host; raises ValueError when an entry connects nodes that are
    not grid-adjacent."""
    r, c, _, _, dr, dc = _offsets(grid, rows, cols)
    plane_of = {off: k for k, off in enumerate(OFFSETS)}
    planes = []
    for k in range(len(r)):
        off = (int(dr[k]), int(dc[k]))
        if off not in plane_of:
            raise ValueError(
                f"Robin entry ({int(r[k])},{int(c[k])}) connects "
                f"non-adjacent grid nodes (offset {off}) — not foldable "
                f"into the stencil; use the generic path")
        planes.append(plane_of[off])
    return planes


def fold_robin_planes(grid: StructuredGrid, rows, cols, vals,
                      load) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a RobinBC's COO boundary stiffness into 7 stencil planes.

    rows/cols: (K,) int node indices (checked on the host); vals: (..., K)
    differentiable entries; load: (..., n_nodes).  Returns
    (C_r (..., 7, ny+1, nx+1), load grid (..., ny+1, nx+1)).  Raises
    ValueError when an entry connects nodes that are not grid-adjacent
    (the facade then falls back to the generic routes)."""
    ny1, nx1 = grid.node_shape
    planes = robin_plane_index(grid, rows, cols)
    _, _, ri, ci, _, _ = _offsets(grid, rows, cols)
    vals = torch.as_tensor(vals)
    flat_pos = torch.as_tensor(
        np.asarray(planes, np.int64) * (ny1 * nx1) + ri * nx1 + ci,
        device=vals.device)
    lead = vals.shape[:-1]
    C_r = vals.new_zeros(lead + (7 * ny1 * nx1,)).index_add(-1, flat_pos,
                                                            vals)
    load = torch.as_tensor(load)
    return (C_r.reshape(lead + (7, ny1, nx1)),
            load.reshape(load.shape[:-1] + (ny1, nx1)))


def _apply_tot(C, C_r, v):
    out = stencil_apply(C, v)
    if C_r is not None:
        out = out + stencil_apply(C_r, v)
    return out


def _natural_load(qn, rload):
    """The natural terms' load grid: Neumann plus Robin (0 for neither)."""
    extra = 0.0
    if qn is not None:
        extra = extra + qn
    if rload is not None:
        extra = extra + rload
    return extra


def _jacobi(m, C, C_r):
    p = 1.0 - m
    diagA = m + p * (C[..., 0, :, :]
                     + (C_r[..., 0, :, :] if C_r is not None else 0.0))
    return 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))


def _pcg_nat_loop(C, C_r, m, b, x0, tol, maxiter):
    """(x, iterations) of the generalized-mask Jacobi PCG; per-scenario
    dots on batched right-hand sides (what the JAX facade's vmap gives),
    one global dot otherwise."""
    p = 1.0 - m
    Minv = _jacobi(m, C, C_r)
    x, iters, _ = pcg(lambda v: m * v + p * _apply_tot(C, C_r, p * v), b,
                      lambda r_: Minv * r_, x0, tol, maxiter,
                      dot=batched_dot(2) if b.ndim > 2 else None,
                      with_diagnostics=True)
    return x, iters


def _natural_cg_gated(C, C_r, m, b, x0, tol, maxiter):
    """The tol-gated solve, the op's implementation on CPU and CUDA
    tensors alike."""
    x, iters = _pcg_nat_loop(C, C_r, m, b, x0, tol, maxiter)
    gated_iters.append(iters)
    return x


#: the tol-gated generalized-mask solve as the op
#: ``difffe::stencil_natural_cg_gated``
stencil_natural_cg_gated = kernel_op(
    "stencil_natural_cg_gated",
    "(Tensor C, Tensor? C_r, Tensor m, Tensor b, Tensor x0, float tol, "
    "int maxiter) -> Tensor",
    _natural_cg_gated, _natural_cg_gated,
    lambda C, C_r, m, b, *_: torch.empty_like(b))


def _pcg_nat(grid, C, C_r, m, b, x0, tol, maxiter):
    """The generalized-mask Jacobi PCG (``_pcg_nat_loop``); tol-gated
    solves through ``difffe::stencil_natural_cg_gated``."""
    maxit = maxiter if maxiter is not None else (grid.nx + 1) * (grid.ny + 1)
    if tol > 0.0:
        return stencil_natural_cg_gated(C, C_r, m, b, x0, float(tol),
                                        int(maxit))
    return _pcg_nat_loop(C, C_r, m, b, x0, tol, maxit)[0]


def _solve_nat_impl(grid, kappa_lu, f, g, m, qn, C_r, rload, tol,
                    maxiter):
    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    p = 1.0 - m
    mg = m * g
    b = mg + p * (load_grid(grid, f) + _natural_load(qn, rload)
                  - _apply_tot(C, C_r, mg))
    u = _pcg_nat(grid, C, C_r, m, b, mg.expand(b.shape), tol, maxiter)
    return u, C


def _natural_cotangents(grid, kappa_lu, f, g, m, qn, C_r, rload, u, lam,
                        K_tot):
    """λᵀ∂R/∂(κ, f, g, m, qn, C_r, rload) of the residual map at fixed u,
    reduced to the primals' shapes; ``K_tot`` applies the total stencil
    (K plus the Robin planes).  The mask gets no cotangent: it is 0/1 set
    data."""
    kl, ku = kappa_lu
    p = 1.0 - m
    pl_ = p * lam
    w = m * g + p * u
    # κ cotangent: closed-form per-triangle contraction (K part only, the
    # Robin planes carry no κ)
    g_low, g_up = stencil_kappa_grad(grid, pl_, w)
    grad_f = load_grid(grid, pl_)
    grad_g = m * (lam - K_tot(pl_))
    # natural loads enter b as +p·(…): their cotangent is p·λ
    grad_qn = None if qn is None else _reduce_to(pl_, qn.shape)
    grad_rload = None if rload is None else _reduce_to(pl_, rload.shape)
    # Robin planes enter as −(pλ)ᵀ R(w): ∂/∂C_r[k] = −(pλ) ⊙ shift(w, off_k)
    grad_Cr = None
    if C_r is not None:
        planes = [-pl_ * _shift2d(w, dr, dc) for dr, dc in OFFSETS]
        grad_Cr = _reduce_to(torch.stack(planes, dim=-3), C_r.shape)
    return (_reduce_to(-g_low, kl.shape), _reduce_to(-g_up, ku.shape),
            _reduce_to(grad_f, f.shape), _reduce_to(grad_g, g.shape),
            None, grad_qn, grad_Cr, grad_rload)


class _SolveNatural(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, tol, maxiter, kl, ku, f, g, m, qn, C_r, rload):
        u, C = _solve_nat_impl(grid, (kl, ku), f, g, m, qn, C_r, rload, tol,
                               maxiter)
        ctx.cfg = (grid, tol, maxiter)
        ctx.C = C
        ctx.save_for_backward(kl, ku, f, g, m, qn, C_r, rload, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        first_order_only("solve_poisson_structured_natural")
        grid, tol, maxiter = ctx.cfg
        kl, ku, f, g, m, qn, C_r, rload, u = ctx.saved_tensors
        lam = _pcg_nat(grid, ctx.C, C_r, m, gbar, torch.zeros_like(gbar),
                       tol, maxiter)
        C = ctx.C
        return (None, None, None) + _natural_cotangents(
            grid, (kl, ku), f, g, m, qn, C_r, rload, u, lam,
            lambda v: _apply_tot(C, C_r, v))


def solve_poisson_structured_natural(grid: StructuredGrid, kappa_lu,
                                     f: torch.Tensor, g: torch.Tensor,
                                     m: torch.Tensor,
                                     qn: Optional[torch.Tensor] = None,
                                     C_r: Optional[torch.Tensor] = None,
                                     rload: Optional[torch.Tensor] = None,
                                     tol: float = 0.0,
                                     maxiter: Optional[int] = None
                                     ) -> torch.Tensor:
    """Structured solve with a general Dirichlet mask and natural BCs.

    kappa_lu: (κ_lower, κ_upper) per-triangle (…, ny, nx); f, g: node
    grids (leading scenario axes allowed); m: (ny+1, nx+1) Dirichlet mask,
    any node set; qn: optional Neumann load grid (edge-assembled,
    ops/neumann.py); C_r/rload: optional folded Robin planes and load grid
    (``fold_robin_planes``).  Returns u on the node grid, differentiable
    wrt κ, f, g, qn, C_r and rload through one adjoint solve.  Batched
    right-hand sides take per-scenario CG dots (the JAX facade's vmap)."""
    kl, ku = kappa_lu
    return _SolveNatural.apply(grid, tol, maxiter, kl, ku, f, g, m, qn, C_r,
                               rload)


# --------------------------------------------------------------------------
# Batched natural-BC solve on the whole-CG kernel K3a
# --------------------------------------------------------------------------

def _prep_nat_pallas(grid, kappa_lu, f, g, m, qn, C_r, rload):
    """Fold the general mask and the natural terms into K3a's inputs:
    (C_tot (B', 7, H, W), D (5, B, H, W), b, M⁻¹, x0 (B, H, W), B), all
    contiguous.  C_r, where given, must be axis-adjacent
    (``robin_is_axis_adjacent``): planes 5/6 of the total operator then
    stay zero, which is what lets the 5-point kernel carry it."""
    from .kernels.stencil_cg_kernel import _fold_bc_planes

    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    if C.ndim == 3:
        C = C[None]
    if f.ndim == 2:
        f = f[None]
    C_tot = C
    if C_r is not None:
        C_tot = C + (C_r if C_r.ndim == 4 else C_r[None])
    B = max(C_tot.shape[0], f.shape[0])
    H, W = grid.node_shape
    p = 1.0 - m
    mg = m * g
    b = (mg + p * (load_grid(grid, f) + _natural_load(qn, rload)
                   - stencil_apply(C_tot, mg))).expand(B, H, W).contiguous()
    Minv = _jacobi(m, C_tot, None).expand(B, H, W).contiguous()
    x0 = mg.expand(B, H, W).contiguous()
    # the general mask folded into the planes: D0 = m + p·C0·p,
    # Dk = p·Ck·shift(p)
    D = _fold_bc_planes(C_tot[:, :5].expand(B, 5, H, W), m).contiguous()
    return C_tot, D, b, Minv, x0, B


def _nat_pallas_impl(grid, kappa_lu, f, g, m, qn, C_r, rload, iters,
                     block_b):
    from .kernels.stencil_cg_kernel import _cg

    C_tot, D, b, Minv, x0, B = _prep_nat_pallas(grid, kappa_lu, f, g, m,
                                                qn, C_r, rload)
    x = _cg(D, b, Minv, x0, iters, block_b)
    x = x[0] if f.ndim == 2 and x.shape[0] == 1 else x
    return x, (C_tot, D, Minv, B)


class _SolveNaturalKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, iters, block_b, kl, ku, f, g, m, qn, C_r, rload):
        u, saved = _nat_pallas_impl(grid, (kl, ku), f, g, m, qn, C_r, rload,
                                    iters, block_b)
        ctx.cfg = (grid, iters, block_b)
        ctx.prepared = saved
        ctx.save_for_backward(kl, ku, f, g, m, qn, C_r, rload, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        from .kernels.stencil_cg_kernel import _cg

        first_order_only("the K3a route (solve_structured_pallas_natural)")
        grid, iters, block_b = ctx.cfg
        C_tot, D, Minv, B = ctx.prepared
        kl, ku, f, g, m, qn, C_r, rload, u = ctx.saved_tensors
        # the adjoint A λ = ḡ (A symmetric, zero initial guess) through the
        # same kernel on the forward's prepared planes
        H, W = grid.node_shape
        gb = (gbar if gbar.ndim == 3 else gbar[None]).expand(
            B, H, W).contiguous()
        lam = _cg(D, gb, Minv, torch.zeros_like(gb), iters, block_b)
        if gbar.ndim == 2:
            lam = lam[0]
        C_app = C_tot[0] if (C_tot.shape[0] == 1 and gbar.ndim == 2) \
            else C_tot
        return (None, None, None) + _natural_cotangents(
            grid, (kl, ku), f, g, m, qn, C_r, rload, u, lam,
            lambda v: stencil_apply(C_app, v))


def solve_structured_pallas_natural(grid: StructuredGrid, kappa_lu,
                                    f: torch.Tensor, g: torch.Tensor,
                                    m: torch.Tensor,
                                    qn: Optional[torch.Tensor] = None,
                                    C_r: Optional[torch.Tensor] = None,
                                    rload: Optional[torch.Tensor] = None,
                                    iters: int = 128,
                                    block_b: int = 8) -> torch.Tensor:
    """Batched natural-BC structured solve on the whole-CG kernel K3a.

    Same contract as :func:`solve_poisson_structured_natural` with a fixed
    trip count (``iters``): K3a forward and adjoint, on the route its plan
    picks (ops/kernels/stencil_cg_kernel.py; the plain version on CPU
    tensors).  C_r must be axis-adjacent (``robin_is_axis_adjacent``;
    boundary-edge Robin always is).  ``block_b`` keeps the JAX signature
    (≥ 1) and changes nothing on the card."""
    kl, ku = kappa_lu
    return _SolveNaturalKernel.apply(grid, int(iters), block_b, kl, ku, f, g,
                                     m, qn, C_r, rload)
