"""Structured-grid 2D operators: stencil-form stiffness for rectangle meshes.

PyTorch counterpart of ``difffe_tpu/ops/stencil.py``.  For meshes from
``FEMesh.rectangle`` (uniform grid, lower-left triangle split) the P1
stiffness matrix is a 7-point stencil on the node grid, with coefficient
planes that are fixed linear combinations of the per-triangle κ fields.
The planes are assembled with pads and adds (no scatter), and K·u is seven
shifted multiply-adds on (..., ny+1, nx+1) node planes; leading axes are
scenario batches.

Offsets are indexed as::

    0: ( 0,  0)   1: ( 0, +1)   2: ( 0, −1)   3: (+1, 0)
    4: (−1,  0)   5: (+1, −1)   6: (−1, +1)      (row=y, col=x)

``solve_poisson_structured`` and ``apply_inv`` are
``torch.autograd.Function``s with the JAX package's implicit-function-
theorem backward: one adjoint solve through ``apply_inv`` itself plus the
closed-form residual VJP.  Both backwards are written in differentiable
torch ops, so double backward (Hessian-vector products) composes as it
does in JAX.

A tol-gated solve reads one boolean an iteration, which ``torch.export``
cannot trace, so ``apply_inv`` runs every tol-gated solve as one
``torch.library`` op, ``difffe::stencil_cg_gated``, whose implementation
on CPU and CUDA tensors is the loop: an exported program holds the op as
one node (utils/export.py).  Each gated solve appends its CG iteration
count to :data:`gated_iters` (``pcg.gated_iters``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F_

from .kernels._build import kernel_op
from .pcg import dot_ndim, dot_of, gated_iters

OFFSETS = ((0, 0), (0, 1), (0, -1), (1, 0), (-1, 0), (1, -1), (-1, 1))


@dataclasses.dataclass(frozen=True)
class StructuredGrid:
    """Static geometry of a uniform rectangle mesh (nx × ny quads)."""

    nx: int
    ny: int
    hx: float
    hy: float

    @property
    def node_shape(self) -> Tuple[int, int]:
        return (self.ny + 1, self.nx + 1)

    @classmethod
    def unit(cls, nx: int, ny: int,
             x_range=(0.0, 1.0), y_range=(0.0, 1.0)) -> "StructuredGrid":
        return cls(nx=nx, ny=ny,
                   hx=(x_range[1] - x_range[0]) / nx,
                   hy=(y_range[1] - y_range[0]) / ny)


def kappa_lu_from_elements(grid: StructuredGrid, ke: torch.Tensor):
    """Flat per-element κ (..., n_elements) in ``FEMesh.rectangle`` order
    (quads row-major, [lower, upper] interleaved per quad) → per-triangle
    plane fields ``(κ_lower (..., ny, nx), κ_upper (..., ny, nx))``.
    A strided view, so κ cotangents flow back to the flat layout."""
    k2 = ke.reshape(ke.shape[:-1] + (grid.ny, grid.nx, 2))
    return k2[..., 0], k2[..., 1]


def _unit_blocks(grid: StructuredGrid, dtype, device):
    hx2, hy2 = grid.hx ** 2, grid.hy ** 2
    s = 1.0 / (2.0 * grid.hx * grid.hy)
    Ml = torch.tensor([[hx2 + hy2, -hy2, -hx2],
                       [-hy2, hy2, 0.0],
                       [-hx2, 0.0, hx2]], dtype=dtype, device=device) * s
    Mu = torch.tensor([[hx2, -hx2, 0.0],
                       [-hx2, hx2 + hy2, -hy2],
                       [0.0, -hy2, hy2]], dtype=dtype, device=device) * s
    return Ml, Mu


def local_blocks(grid: StructuredGrid, kappa_lower, kappa_upper):
    """Local 3×3 stiffness blocks of all lower/upper triangles,
    (..., ny, nx, 3, 3) each; vertex order lower=(a,b,d), upper=(b,c,d)
    with a=(i,j), b=(i,j+1), c=(i+1,j+1), d=(i+1,j)."""
    Ml, Mu = _unit_blocks(grid, kappa_lower.dtype, kappa_lower.device)
    return (kappa_lower[..., None, None] * Ml,
            kappa_upper[..., None, None] * Mu)


def _stencil_coefficients_reference(grid: StructuredGrid,
                                    kappa_lower, kappa_upper):
    """Generic plane assembly from the full local blocks (18 slice-adds):
    the oracle :func:`stencil_coefficients` is tested against."""
    Kl, Ku = local_blocks(grid, kappa_lower, kappa_upper)
    lead = torch.broadcast_shapes(Kl.shape[:-4], Ku.shape[:-4])
    ny, nx = grid.ny, grid.nx
    C = Kl.new_zeros(lead + (7, ny + 1, nx + 1))
    LOWER = ((0, 0), (0, 1), (1, 0))
    UPPER = ((0, 1), (1, 1), (1, 0))
    off_idx = {off: k for k, off in enumerate(OFFSETS)}
    for K, verts in ((Kl, LOWER), (Ku, UPPER)):
        for p, (pr, pc) in enumerate(verts):
            for q, (qr, qc) in enumerate(verts):
                k = off_idx[(qr - pr, qc - pc)]
                # K[..., i, j, p, q] lands at node (i+pr, j+pc)
                C[..., k, pr:pr + ny, pc:pc + nx] += K[..., p, q]
    return C


def _embed(q: torch.Tensor, pr: int, pc: int) -> torch.Tensor:
    """Place a (..., ny, nx) per-quad field on the (..., ny+1, nx+1) node
    grid at vertex offset (pr, pc) ∈ {0,1}², zero elsewhere."""
    return F_.pad(q, (pc, 1 - pc, pr, 1 - pr))


def stencil_coefficients(grid: StructuredGrid, kappa_lower, kappa_upper):
    """The 7 coefficient planes C (..., 7, ny+1, nx+1) in closed form.
    Planes 5/6 (the cross-diagonal neighbours) are identically zero for
    isotropic κ on the lower-left split and kept as zero planes so every
    consumer shares one layout."""
    kl, ku = torch.broadcast_tensors(kappa_lower, kappa_upper)
    hx2, hy2 = grid.hx ** 2, grid.hy ** 2
    s = 1.0 / (2.0 * grid.hx * grid.hy)
    l00, l01, l10 = _embed(kl, 0, 0), _embed(kl, 0, 1), _embed(kl, 1, 0)
    u01, u10, u11 = _embed(ku, 0, 1), _embed(ku, 1, 0), _embed(ku, 1, 1)
    C0 = s * ((hx2 + hy2) * (l00 + u11) + hy2 * (l01 + u10)
              + hx2 * (l10 + u01))
    C1 = (-s * hy2) * (l00 + u10)      # ( 0, +1)
    C2 = (-s * hy2) * (l01 + u11)      # ( 0, −1)
    C3 = (-s * hx2) * (l00 + u01)      # (+1,  0)
    C4 = (-s * hx2) * (l10 + u11)      # (−1,  0)
    Z = torch.zeros_like(C0)           # (+1, −1), (−1, +1)
    return torch.stack([C0, C1, C2, C3, C4, Z, Z], dim=-3)


def _shift2d(u: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """v[r, c] = u[r+dr, c+dc] with zero fill (last two axes)."""
    if dr > 0:
        u = F_.pad(u[..., dr:, :], (0, 0, 0, dr))
    elif dr < 0:
        u = F_.pad(u[..., :dr, :], (0, 0, -dr, 0))
    if dc > 0:
        u = F_.pad(u[..., :, dc:], (0, dc))
    elif dc < 0:
        u = F_.pad(u[..., :, :dc], (-dc, 0))
    return u


def stencil_apply(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(K·u) on the node grid: Σ_k C[k] ⊙ shift(u, offset_k).
    C: (..., 7, ny+1, nx+1); u: (..., ny+1, nx+1)."""
    out = C[..., 0, :, :] * u
    for k, (dr, dc) in enumerate(OFFSETS[1:], start=1):
        out = out + C[..., k, :, :] * _shift2d(u, dr, dc)
    return out


# --------------------------------------------------------------------------
# BC-eliminated CG solve on the grid (boundary = Dirichlet, as in
# FEMesh.rectangle); backward by the implicit function theorem.
# --------------------------------------------------------------------------

def boundary_mask_grid(grid: StructuredGrid, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """1 on boundary nodes, 0 inside — FEMesh.rectangle's BC set."""
    m = torch.zeros(grid.node_shape, dtype=dtype, device=device)
    m[0, :] = 1.0
    m[-1, :] = 1.0
    m[:, 0] = 1.0
    m[:, -1] = 1.0
    return m


def load_grid(grid: StructuredGrid, f: torch.Tensor) -> torch.Tensor:
    """Centroid-rule load on the node grid (``assemble_load`` of the
    rectangle mesh): each node collects area/3 · centroid mean from its
    adjacent triangles."""
    area3 = (0.5 * grid.hx * grid.hy) / 3.0
    fl = (f[..., :-1, :-1] + f[..., :-1, 1:] + f[..., 1:, :-1]) / 3.0
    fu = (f[..., :-1, 1:] + f[..., 1:, 1:] + f[..., 1:, :-1]) / 3.0
    # lower (a,b,d) = (i,j),(i,j+1),(i+1,j); upper (b,c,d)
    return area3 * (_embed(fl, 0, 0) + _embed(fl, 0, 1) + _embed(fl, 1, 0)
                    + _embed(fu, 0, 1) + _embed(fu, 1, 1)
                    + _embed(fu, 1, 0))


def stencil_kappa_grad(grid: StructuredGrid, lam: torch.Tensor,
                       w: torch.Tensor):
    """∂(λᵀ K(κ) w)/∂κ per triangle in closed form: (g_lower, g_upper),
    (..., ny, nx)."""
    hx2, hy2 = grid.hx ** 2, grid.hy ** 2
    s = 1.0 / (2.0 * grid.hx * grid.hy)
    la, lb = lam[..., :-1, :-1], lam[..., :-1, 1:]
    lc, ld = lam[..., 1:, 1:], lam[..., 1:, :-1]
    wa, wb = w[..., :-1, :-1], w[..., :-1, 1:]
    wc, wd = w[..., 1:, 1:], w[..., 1:, :-1]
    g_low = s * (la * ((hx2 + hy2) * wa - hy2 * wb - hx2 * wd)
                 + lb * (hy2 * (wb - wa))
                 + ld * (hx2 * (wd - wa)))
    g_up = s * (lb * (hx2 * (wb - wc))
                + lc * (-hx2 * wb + (hx2 + hy2) * wc - hy2 * wd)
                + ld * (hy2 * (wd - wc)))
    return g_low, g_up


def _reduce_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum away broadcast lead axes so a cotangent matches its primal."""
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    return x


def residual_vjp_manual(grid: StructuredGrid, kappa_lu, f, g, u, lam,
                        C: Optional[torch.Tensor] = None):
    """Cotangents of the IFT residual map R(κ, f, g) = b(f, g, κ) − A(κ)u
    at fixed u: (λᵀ∂R/∂κ, λᵀ∂R/∂f, λᵀ∂R/∂g), reduced to the primals'
    shapes.  With w = m⊙g + p⊙u: ∂f = F*(pλ), ∂g = m⊙(λ − K(pλ)),
    ∂κ = −(λ|_tri)ᵀ K_unit (w|_tri) per triangle."""
    kl, ku = kappa_lu
    m = boundary_mask_grid(grid, lam.dtype, lam.device)
    p = 1.0 - m
    pl_ = p * lam
    w = m * g + p * u
    g_low, g_up = stencil_kappa_grad(grid, pl_, w)
    if C is None:
        C = stencil_coefficients(grid, kl, ku)
    grad_f = load_grid(grid, pl_)
    grad_g = m * (lam - stencil_apply(C, pl_))
    return ((_reduce_to(-g_low, kl.shape), _reduce_to(-g_up, ku.shape)),
            _reduce_to(grad_f, f.shape), _reduce_to(grad_g, g.shape))


def _operator(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil_apply(C, p * v)


def _apply_inv_loop(grid, kl, ku, b, tol, maxiter, dot):
    """(x, CG iterations) of the Jacobi-preconditioned solve."""
    from .pcg import pcg

    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, b.dtype, b.device)
    p = 1.0 - m
    diagA = m + p * C[..., 0, :, :]
    Minv = 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))
    x, iters, _ = pcg(lambda v: _operator(C, m, v), b, lambda r: Minv * r,
                      torch.zeros_like(b), tol, maxiter, dot=dot,
                      with_diagnostics=True)
    return x, iters


def _stencil_cg_gated(kl, ku, b, nx, ny, hx, hy, tol, maxiter, dot_ndim):
    """The tol-gated ``apply_inv`` solve, the op's implementation on CPU
    and CUDA tensors alike: ``dot_ndim`` 0 is the global dot, n > 0
    ``pcg.batched_dot(n)``."""
    x, iters = _apply_inv_loop(StructuredGrid(nx, ny, hx, hy), kl, ku, b,
                               tol, maxiter, dot_of(dot_ndim))
    gated_iters.append(iters)
    return x


#: the tol-gated solve as the op ``difffe::stencil_cg_gated``
stencil_cg_gated = kernel_op(
    "stencil_cg_gated",
    "(Tensor kl, Tensor ku, Tensor b, int nx, int ny, float hx, float hy, "
    "float tol, int maxiter, int dot_ndim) -> Tensor",
    _stencil_cg_gated, _stencil_cg_gated,
    lambda kl, ku, b, *_: torch.empty_like(b))


def _apply_inv_impl(grid, kl, ku, b, tol, maxiter, dot):
    maxit = maxiter if maxiter is not None else (grid.nx + 1) * (grid.ny + 1)
    if tol > 0.0:
        return stencil_cg_gated(kl, ku, b, grid.nx, grid.ny, grid.hx,
                                grid.hy, float(tol), int(maxit),
                                dot_ndim(dot))
    return _apply_inv_loop(grid, kl, ku, b, tol, maxit, dot)[0]


class _ApplyInv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, tol, maxiter, dot, kl, ku, b):
        x = _apply_inv_impl(grid, kl, ku, b, tol, maxiter, dot)
        ctx.cfg = (grid, tol, maxiter, dot, tuple(b.shape))
        ctx.save_for_backward(kl, ku, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        grid, tol, maxiter, dot, b_shape = ctx.cfg
        kl, ku, x = ctx.saved_tensors
        lam = apply_inv(grid, (kl, ku), xbar, tol, maxiter, dot)
        m = boundary_mask_grid(grid, x.dtype, x.device)
        p = 1.0 - m
        # λᵀAx = λᵀ(m⊙x) + (pλ)ᵀK(px): ∂κ per triangle in closed form
        g_low, g_up = stencil_kappa_grad(grid, p * lam, p * x)
        return (None, None, None, None, _reduce_to(-g_low, kl.shape),
                _reduce_to(-g_up, ku.shape), _reduce_to(lam, b_shape))


def apply_inv(grid: StructuredGrid, kappa_lu, b: torch.Tensor,
              tol: float = 0.0, maxiter: Optional[int] = None,
              dot: Optional[Callable] = None) -> torch.Tensor:
    """x = A(κ)⁻¹ b for the BC-eliminated operator A = m + p·K(κ)·p.

    A differentiable linear-solve primitive: its backward solves A λ = x̄
    with this same primitive (A is symmetric), so reverse mode composes to
    any order.  ``dot`` is the CG inner product: None (one global dot
    coupling the whole batch, as in JAX) or ``pcg.batched_dot(n)``
    (independent per-scenario solves, what JAX gets from ``vmap``)."""
    kl, ku = kappa_lu
    return _ApplyInv.apply(grid, tol, maxiter, dot, kl, ku, b)


def _solve_impl(grid, kl, ku, f, g, tol, maxiter, dot):
    """u = m·g + A⁻¹[p·(F − K(m·g))] through ``apply_inv``."""
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype, f.device)
    p = 1.0 - m
    F = load_grid(grid, f)
    mg = m * g
    rhs = p * (F - stencil_apply(C, mg))
    return mg + apply_inv(grid, (kl, ku), rhs, tol, maxiter, dot)


class _SolveStructured(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, tol, maxiter, dot, kl, ku, f, g):
        u = _solve_impl(grid, kl, ku, f, g, tol, maxiter, dot)
        ctx.cfg = (grid, tol, maxiter, dot)
        ctx.save_for_backward(kl, ku, f, g, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        grid, tol, maxiter, dot = ctx.cfg
        kl, ku, f, g, u = ctx.saved_tensors
        # adjoint solve through the differentiable primitive, then the
        # closed-form residual VJP: both differentiable again
        lam = apply_inv(grid, (kl, ku), gbar, tol, maxiter, dot)
        (gl, gu), gf, gg = residual_vjp_manual(grid, (kl, ku), f, g, u, lam)
        return None, None, None, None, gl, gu, gf, gg


def solve_poisson_structured(grid: StructuredGrid, kappa_lu,
                             f: torch.Tensor, g: torch.Tensor,
                             tol: float = 0.0,
                             maxiter: Optional[int] = None,
                             dot: Optional[Callable] = None) -> torch.Tensor:
    """Solve −∇·(κ∇u)=f on the structured grid, Dirichlet boundary = g.

    kappa_lu: (κ_lower, κ_upper) per-triangle fields (..., ny, nx);
    f, g: (..., ny+1, nx+1) node grids.  Returns u on the node grid,
    differentiable wrt κ, f and g through one adjoint solve (IFT).
    ``dot`` as in :func:`apply_inv`.
    """
    kl, ku = kappa_lu
    return _SolveStructured.apply(grid, tol, maxiter, dot, kl, ku, f, g)
