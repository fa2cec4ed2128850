"""Structured-grid 3D operators: 7-point stencil form for box meshes.

PyTorch counterpart of ``difffe_tpu/ops/stencil3d.py``.  For meshes from
``FEMesh.box`` (uniform grid, six Kuhn tetrahedra per cube) the P1
stiffness matrix is exactly a 7-point stencil on the node grid for any
per-tet isotropic κ: every Kuhn tet couples one edge per axis, all with
the weight ``w_a = h_b·h_c / (6·h_a)``, so the three edge-coefficient
volumes are fixed sums of zero-padded per-cube κ fields and K·u is seven
shifted multiply-adds.

Layout: node grids are (..., nz+1, ny+1, nx+1) (z outer, x innermost, the
``FEMesh.box`` node numbering); per-tet κ is (..., n_elements) flat in
mesh order (cube-major, 6 tets interleaved) or shaped (..., nz, ny, nx, 6).
Leading axes are scenario batches.  Offsets are indexed as::

    0: (0,0,0)  1: (0,0,+1)  2: (0,0,−1)  3: (0,+1,0)
    4: (0,−1,0) 5: (+1,0,0)  6: (−1,0,0)        (dz, dy, dx)

The JAX module's ``_bm_*`` helpers keep the scenario batch on the TPU's
128-wide lane axis (batch-minor).  That is a TPU layout and is not
ported: the batched functions here are batch-leading and take
per-scenario CG dots (``pcg.batched_dot(3)``), which gives the batch-minor
functions' results, the same per-scenario α/β, trip count and freeze.

``solve_poisson_structured_3d`` and ``apply_inv_3d`` are
``torch.autograd.Function``s with the implicit-function-theorem backward;
``apply_inv_3d``'s backward calls itself, so double backward composes.
A tol-gated solve runs as the ``torch.library`` op
``difffe::stencil3d_cg_gated`` (the loop on CPU and CUDA tensors alike,
one node of an exported program), as the 2D one does (ops/stencil.py);
it appends its iterations to ``pcg.gated_iters``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F_

from .kernels._build import kernel_op
from .pcg import batched_dot, dot_ndim, dot_of, gated_iters, pcg

OFFSETS3 = ((0, 0, 0), (0, 0, 1), (0, 0, -1), (0, 1, 0), (0, -1, 0),
            (1, 0, 0), (-1, 0, 0))

# Which tets of the Kuhn split (FEMesh.box path order) contribute to the
# axis edge whose base vertex sits at cube-local offset (da, db) in the two
# transverse axes: x-edges key (dy, dz), y-edges (dx, dz), z-edges (dx, dy).
_X_TERMS = {(0, 0): (0, 1), (1, 0): (2,), (0, 1): (4,), (1, 1): (3, 5)}
_Y_TERMS = {(0, 0): (2, 3), (1, 0): (0,), (0, 1): (5,), (1, 1): (1, 4)}
_Z_TERMS = {(0, 0): (4, 5), (1, 0): (1,), (0, 1): (3,), (1, 1): (0, 2)}

# Kuhn tet local vertex offsets (dz, dy, dx), FEMesh.box path order.
_TET_VERTS = (
    ((0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)),  # x then y
    ((0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)),  # x then z
    ((0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)),  # y then x
    ((0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)),  # y then z
    ((0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)),  # z then x
    ((0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)),  # z then y
)


@dataclasses.dataclass(frozen=True)
class StructuredGrid3:
    """Static geometry of a uniform box mesh (nx × ny × nz cubes)."""

    nx: int
    ny: int
    nz: int
    hx: float
    hy: float
    hz: float

    @property
    def node_shape(self) -> Tuple[int, int, int]:
        return (self.nz + 1, self.ny + 1, self.nx + 1)

    @property
    def n_elements(self) -> int:
        return 6 * self.nx * self.ny * self.nz

    @classmethod
    def unit(cls, nx: int, ny: int, nz: int, x_range=(0.0, 1.0),
             y_range=(0.0, 1.0), z_range=(0.0, 1.0)) -> "StructuredGrid3":
        return cls(nx=nx, ny=ny, nz=nz,
                   hx=(x_range[1] - x_range[0]) / nx,
                   hy=(y_range[1] - y_range[0]) / ny,
                   hz=(z_range[1] - z_range[0]) / nz)


def _weights(grid: StructuredGrid3):
    """The edge weights (w_x, w_y, w_z) of every Kuhn tet."""
    return (grid.hy * grid.hz / (6.0 * grid.hx),
            grid.hx * grid.hz / (6.0 * grid.hy),
            grid.hx * grid.hy / (6.0 * grid.hz))


def _is_cube(kappa: torch.Tensor) -> bool:
    return kappa.ndim >= 4 and kappa.shape[-1] == 6


def kappa_to_cube(grid: StructuredGrid3, kappa: torch.Tensor) -> torch.Tensor:
    """(..., n_elements) flat mesh-order κ → (..., nz, ny, nx, 6)."""
    if _is_cube(kappa):
        return kappa
    return kappa.reshape(kappa.shape[:-1] + (grid.nz, grid.ny, grid.nx, 6))


def _pad_axis(q: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad one axis (negative, counted from the end) by (lo, hi)."""
    pad = [0, 0] * (-axis)
    pad[-2], pad[-1] = lo, hi
    return F_.pad(q, pad)


def edge_coefficients(grid: StructuredGrid3, kappa6: torch.Tensor):
    """The three edge-coefficient volumes (negative couplings).

    Returns (Cx, Cy, Cz): Cx (..., nz+1, ny+1, nx) couples node (k,j,i) to
    (k,j,i+1); Cy (..., nz+1, ny, nx+1); Cz (..., nz, ny+1, nx+1).  Each is
    −w_a · Σ κ_t over the tets sharing the edge.
    """
    wx, wy, wz = _weights(grid)

    def accumulate(terms, w, axes):
        out = None
        for (da, db), tets in terms.items():
            s = kappa6[..., tets[0]]
            for t in tets[1:]:
                s = s + kappa6[..., t]
            s = _pad_axis(_pad_axis(s, axes[0], da, 1 - da), axes[1], db,
                          1 - db)
            out = s if out is None else out + s
        return -w * out

    return (accumulate(_X_TERMS, wx, (-2, -3)),
            accumulate(_Y_TERMS, wy, (-1, -3)),
            accumulate(_Z_TERMS, wz, (-1, -2)))


def stencil3d_coefficients(grid: StructuredGrid3, kappa) -> torch.Tensor:
    """The 7 coefficient volumes C (..., 7, nz+1, ny+1, nx+1).

    Plane k couples each node to its OFFSETS3[k] neighbour; the diagonal
    plane is minus the sum of the others (P1 element matrices have zero
    row sums)."""
    Cx, Cy, Cz = edge_coefficients(grid, kappa_to_cube(grid, kappa))
    C1, C2 = _pad_axis(Cx, -1, 0, 1), _pad_axis(Cx, -1, 1, 0)
    C3, C4 = _pad_axis(Cy, -2, 0, 1), _pad_axis(Cy, -2, 1, 0)
    C5, C6 = _pad_axis(Cz, -3, 0, 1), _pad_axis(Cz, -3, 1, 0)
    C0 = -(C1 + C2 + C3 + C4 + C5 + C6)
    return torch.stack([C0, C1, C2, C3, C4, C5, C6], dim=-4)


def _shift3d(u: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """v[z,y,x] = u[z+dz, y+dy, x+dx] with zero fill (last three axes)."""
    for axis, d in ((-3, dz), (-2, dy), (-1, dx)):
        if d > 0:
            u = _pad_axis(u.narrow(axis, d, u.shape[axis] - d), axis, 0, d)
        elif d < 0:
            u = _pad_axis(u.narrow(axis, 0, u.shape[axis] + d), axis, -d, 0)
    return u


def stencil3d_apply(C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(K·u) on the node grid: Σ_k C[k] ⊙ shift(u, offset_k).
    C: (..., 7, nz+1, ny+1, nx+1); u: (..., nz+1, ny+1, nx+1)."""
    out = C[..., 0, :, :, :] * u
    for k, off in enumerate(OFFSETS3[1:], start=1):
        out = out + C[..., k, :, :, :] * _shift3d(u, *off)
    return out


# --------------------------------------------------------------------------
# BC-eliminated CG solve on the grid (Dirichlet on all six faces, as in
# FEMesh.box); backward by the implicit function theorem.
# --------------------------------------------------------------------------

def boundary_mask_box(grid: StructuredGrid3, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """1 on boundary nodes, 0 inside — FEMesh.box's BC set."""
    m = torch.ones(grid.node_shape, dtype=dtype, device=device)
    m[1:-1, 1:-1, 1:-1] = 0.0
    return m


def _cube_slice(u: torch.Tensor, dz: int, dy: int, dx: int) -> torch.Tensor:
    """Per-cube view of a node-grid field at vertex offset (dz, dy, dx)."""
    nz1, ny1, nx1 = u.shape[-3:]
    return u[..., dz:dz + nz1 - 1, dy:dy + ny1 - 1, dx:dx + nx1 - 1]


def load_box(grid: StructuredGrid3, f: torch.Tensor) -> torch.Tensor:
    """Centroid-rule load on the node grid (``assemble_load`` of the box
    mesh): F_p += V/4 · mean(f over the tet), V = hx·hy·hz/6."""
    v4 = (grid.hx * grid.hy * grid.hz / 6.0) / 4.0
    F = torch.zeros_like(f)
    for verts in _TET_VERTS:
        contrib = v4 * (sum(_cube_slice(f, *v) for v in verts) / 4.0)
        for (dz, dy, dx) in verts:
            F[..., dz:dz + grid.nz, dy:dy + grid.ny,
              dx:dx + grid.nx] += contrib
    return F


def _base_of(terms, t):
    return next(key for key, tets in terms.items() if t in tets)


# Per tet, the base offsets of its x-, y- and z-edge (the tables inverted).
_TET_EDGE_BASES = tuple((_base_of(_X_TERMS, t), _base_of(_Y_TERMS, t),
                         _base_of(_Z_TERMS, t)) for t in range(6))


def stencil3d_kappa_grad(grid: StructuredGrid3, lam: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """∂(λᵀ K(κ) w)/∂κ per tet in closed form: Σ_axes w_a (λ_a − λ_b)
    (w_a − w_b) over the tet's one edge per axis.  Returns
    (..., nz, ny, nx, 6)."""
    wx, wy, wz = _weights(grid)
    Ex = ((lam[..., :, :, 1:] - lam[..., :, :, :-1])
          * (w[..., :, :, 1:] - w[..., :, :, :-1]))
    Ey = ((lam[..., :, 1:, :] - lam[..., :, :-1, :])
          * (w[..., :, 1:, :] - w[..., :, :-1, :]))
    Ez = ((lam[..., 1:, :, :] - lam[..., :-1, :, :])
          * (w[..., 1:, :, :] - w[..., :-1, :, :]))
    nz, ny, nx = grid.nz, grid.ny, grid.nx
    gs = []
    for (xy, xz), (ydx, ydz), (zdx, zdy) in _TET_EDGE_BASES:
        gs.append(wx * Ex[..., xz:xz + nz, xy:xy + ny, :]
                  + wy * Ey[..., ydz:ydz + nz, :, ydx:ydx + nx]
                  + wz * Ez[..., :, zdy:zdy + ny, zdx:zdx + nx])
    return torch.stack(gs, dim=-1)


def _reduce_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum away broadcast lead axes so a cotangent matches its primal."""
    extra = x.ndim - len(shape)
    if extra > 0:
        x = x.sum(dim=tuple(range(extra)))
    return x


def _kappa_cotangent(grid, gk6, kappa):
    """A per-tet cotangent (..., nz, ny, nx, 6) in κ's layout and shape."""
    if not _is_cube(kappa):
        gk6 = gk6.reshape(gk6.shape[:-4] + (grid.n_elements,))
    return _reduce_to(gk6, kappa.shape)


def residual_vjp_manual_3d(grid: StructuredGrid3, kappa, f, g, u, lam,
                           C: Optional[torch.Tensor] = None):
    """Cotangents of the IFT residual map R(κ, f, g) = b(f, g, κ) − A(κ)u
    at fixed u: (λᵀ∂R/∂κ, λᵀ∂R/∂f, λᵀ∂R/∂g), reduced to the primals'
    shapes (the 2D derivation with the 3D κ-gradient)."""
    m = boundary_mask_box(grid, lam.dtype, lam.device)
    p = 1.0 - m
    pl_ = p * lam
    w = m * g + p * u
    gk6 = stencil3d_kappa_grad(grid, pl_, w)
    if C is None:
        C = stencil3d_coefficients(grid, kappa)
    grad_f = load_box(grid, pl_)
    grad_g = m * (lam - stencil3d_apply(C, pl_))
    return (_kappa_cotangent(grid, -gk6, kappa), _reduce_to(grad_f, f.shape),
            _reduce_to(grad_g, g.shape))


def _operator(C, m, v):
    p = 1.0 - m
    return m * v + p * stencil3d_apply(C, p * v)


def _jacobi(C, m):
    """M⁻¹ of the BC-eliminated operator: 1/diag, with 1 where it is 0."""
    diagA = m + (1.0 - m) * C[..., 0, :, :, :]
    return 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))


def _max_iters(grid: StructuredGrid3, maxiter):
    return maxiter if maxiter is not None else math.prod(grid.node_shape)


def _apply_inv_loop(grid, kappa, b, tol, maxiter, dot):
    """(x, CG iterations) of the Jacobi-preconditioned solve."""
    C = stencil3d_coefficients(grid, kappa)
    m = boundary_mask_box(grid, b.dtype, b.device)
    Minv = _jacobi(C, m)
    x, iters, _ = pcg(lambda v: _operator(C, m, v), b, lambda r: Minv * r,
                      torch.zeros_like(b), tol, maxiter, dot=dot,
                      with_diagnostics=True)
    return x, iters


def _stencil3d_cg_gated(kappa, b, nx, ny, nz, hx, hy, hz, tol, maxiter,
                        dot_ndim):
    """The tol-gated ``apply_inv_3d`` solve, the op's implementation on CPU
    and CUDA tensors alike (``dot_ndim`` as ``pcg.dot_of`` reads it)."""
    x, iters = _apply_inv_loop(StructuredGrid3(nx, ny, nz, hx, hy, hz),
                               kappa, b, tol, maxiter, dot_of(dot_ndim))
    gated_iters.append(iters)
    return x


#: the tol-gated box solve as the op ``difffe::stencil3d_cg_gated``
stencil3d_cg_gated = kernel_op(
    "stencil3d_cg_gated",
    "(Tensor kappa, Tensor b, int nx, int ny, int nz, float hx, float hy, "
    "float hz, float tol, int maxiter, int dot_ndim) -> Tensor",
    _stencil3d_cg_gated, _stencil3d_cg_gated,
    lambda kappa, b, *_: torch.empty_like(b))


def _apply_inv_impl(grid, kappa, b, tol, maxiter, dot):
    maxit = _max_iters(grid, maxiter)
    if tol > 0.0:
        return stencil3d_cg_gated(kappa, b, grid.nx, grid.ny, grid.nz,
                                  grid.hx, grid.hy, grid.hz, float(tol),
                                  int(maxit), dot_ndim(dot))
    return _apply_inv_loop(grid, kappa, b, tol, maxit, dot)[0]


class _ApplyInv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, tol, maxiter, dot, kappa, b):
        x = _apply_inv_impl(grid, kappa, b, tol, maxiter, dot)
        ctx.cfg = (grid, tol, maxiter, dot, tuple(b.shape))
        ctx.save_for_backward(kappa, x)
        return x

    @staticmethod
    def backward(ctx, xbar):
        grid, tol, maxiter, dot, b_shape = ctx.cfg
        kappa, x = ctx.saved_tensors
        lam = apply_inv_3d(grid, kappa, xbar, tol, maxiter, dot)
        m = boundary_mask_box(grid, x.dtype, x.device)
        p = 1.0 - m
        # λᵀAx = λᵀ(m⊙x) + (pλ)ᵀK(px): ∂κ per tet in closed form
        gk6 = -stencil3d_kappa_grad(grid, p * lam, p * x)
        return (None, None, None, None, _kappa_cotangent(grid, gk6, kappa),
                _reduce_to(lam, b_shape))


def apply_inv_3d(grid: StructuredGrid3, kappa, b: torch.Tensor,
                 tol: float = 0.0, maxiter: Optional[int] = None,
                 dot: Optional[Callable] = None) -> torch.Tensor:
    """x = A(κ)⁻¹ b for the BC-eliminated box operator A = m + p·K(κ)·p.

    A differentiable linear-solve primitive: its backward solves A λ = x̄
    with this same primitive (A is symmetric), so reverse mode composes to
    any order.  ``dot`` is the CG inner product (default one global dot;
    ``pcg.batched_dot(3)`` gives independent per-scenario solves)."""
    return _ApplyInv3d.apply(grid, tol, maxiter, dot, kappa, b)


def _solve_impl_3d(grid, kappa, f, g, tol, maxiter, dot):
    """u = m·g + A⁻¹[p·(F − K(m·g))] through ``apply_inv_3d``."""
    C = stencil3d_coefficients(grid, kappa)
    m = boundary_mask_box(grid, f.dtype, f.device)
    p = 1.0 - m
    mg = m * g
    rhs = p * (load_box(grid, f) - stencil3d_apply(C, mg))
    return mg + apply_inv_3d(grid, kappa, rhs, tol, maxiter, dot)


class _SolveStructured3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, tol, maxiter, dot, kappa, f, g):
        u = _solve_impl_3d(grid, kappa, f, g, tol, maxiter, dot)
        ctx.cfg = (grid, tol, maxiter, dot)
        ctx.save_for_backward(kappa, f, g, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        grid, tol, maxiter, dot = ctx.cfg
        kappa, f, g, u = ctx.saved_tensors
        # adjoint solve through the differentiable primitive, then the
        # closed-form residual VJP: both differentiable again
        lam = apply_inv_3d(grid, kappa, gbar, tol, maxiter, dot)
        gk, gf, gg = residual_vjp_manual_3d(grid, kappa, f, g, u, lam)
        return None, None, None, None, gk, gf, gg


def solve_poisson_structured_3d(grid: StructuredGrid3, kappa,
                                f: torch.Tensor, g: torch.Tensor,
                                tol: float = 0.0,
                                maxiter: Optional[int] = None,
                                dot: Optional[Callable] = None
                                ) -> torch.Tensor:
    """Solve −∇·(κ∇u)=f on the box grid, Dirichlet boundary = g.

    kappa: per-tet field, flat (..., 6·nx·ny·nz) in FEMesh.box element
    order or shaped (..., nz, ny, nx, 6); f, g: node grids
    (..., nz+1, ny+1, nx+1).  Returns u on the node grid, differentiable
    wrt κ, f and g through one adjoint solve (IFT).  ``dot`` as in
    :func:`apply_inv_3d`.
    """
    return _SolveStructured3d.apply(grid, tol, maxiter, dot, kappa, f, g)


def solve_poisson_structured_3d_batched(grid: StructuredGrid3, kappa,
                                        f: torch.Tensor, g: torch.Tensor,
                                        tol: float = 0.0,
                                        maxiter: Optional[int] = None
                                        ) -> torch.Tensor:
    """Batched box solve with independent per-scenario CG.

    kappa: (B, 6·nx·ny·nz) flat or (B, nz, ny, nx, 6); f: (B,) + node grid;
    g: node grid or (B,) + node grid.  Returns u (B,) + node grid,
    differentiable wrt κ, f and g: the per-scenario solve the JAX package
    runs batch-minor."""
    if not (kappa.ndim == 2 or (kappa.ndim == 5 and kappa.shape[-1] == 6)):
        raise ValueError(
            f"batched 3D solve expects kappa (B, {grid.n_elements}) flat or "
            f"(B, nz, ny, nx, 6); got shape {tuple(kappa.shape)}")
    if f.ndim != 4:
        raise ValueError(
            f"batched 3D solve expects f (B,) + node grid {grid.node_shape}; "
            f"got shape {tuple(f.shape)}")
    return solve_poisson_structured_3d(grid, kappa, f, g, tol, maxiter,
                                       batched_dot(3))


def kappa_mse_grad_step_3d(grid: StructuredGrid3, kappa, f, g, u_data,
                           iters: int, warm_state=None,
                           return_state: bool = False):
    """One κ-inversion gradient step on plain tensors: loss =
    mean((u(κ) − u_data)²) over batch and nodes; returns (loss, ∂loss/∂κ)
    [+ the warm state].

    Batched: kappa (B, ne) flat or (B, nz, ny, nx, 6); f, u_data
    (B,) + node grid; g a node grid.  Both solves run ``iters`` fixed
    PCG iterations with per-scenario dots; the forward starts from m·g
    (or the state's u), the adjoint from 0 (or the state's λ).  The state
    is the opaque (u, λ) pair.  Not differentiable: it is the step."""
    with torch.no_grad():
        C = stencil3d_coefficients(grid, kappa)
        m = boundary_mask_box(grid, f.dtype, f.device)
        p = 1.0 - m
        mg = m * g
        b = mg + p * (load_box(grid, f) - stencil3d_apply(C, mg))
        Minv = _jacobi(C, m)
        if warm_state is None:
            x0, l0 = mg.expand(b.shape), torch.zeros_like(b)
        else:
            x0, l0 = warm_state
        dot = batched_dot(3)

        def A(v):
            return _operator(C, m, v)

        u = pcg(A, b, lambda r: Minv * r, x0, 0.0, iters, dot=dot)
        diff = u - u_data
        numel = diff.numel()
        loss = (diff * diff).sum() / numel
        lam = pcg(A, (2.0 / numel) * diff, lambda r: Minv * r, l0, 0.0,
                  iters, dot=dot)
        gk = _kappa_cotangent(
            grid, -stencil3d_kappa_grad(grid, p * lam, mg + p * u), kappa)
    if return_state:
        return loss, gk, (u, lam)
    return loss, gk


# --------------------------------------------------------------------------
# Routers.  The JAX package split these by TPU measurements (the lane-packed
# batch below B = 128, the 16 MB scoped-VMEM cliff, the remote compile
# helper's grid cap); none of those exists on the card.
# --------------------------------------------------------------------------

def choose_3d_block_b(grid: StructuredGrid3, batch: int,
                      operand_dtype=None, iters=None) -> int:
    """Scenarios per kernel block for the 3D grad step: always 1 (the CUDA
    kernels run one scenario per thread block)."""
    return 1


def choose_3d_grad_step(grid: StructuredGrid3, batch: int,
                        operand_dtype=None, iters=None) -> str:
    """The 3D κ-inversion grad-step implementation: always 'kernel', the
    fused step of ops/kernels/stencil3d_cg_kernel.py (one K4b launch),
    which keeps its CG vectors in shared memory or a global workspace at
    any box size.  The JAX package's other answer, 'xla_bm', is
    :func:`kappa_mse_grad_step_3d` here."""
    return "kernel"


def choose_3d_path(grid: StructuredGrid3, batch: int):
    """The batched 3D solve: a callable ``(kappaB, fB, g, tol, maxiter) ->
    uB`` on batch-leading arrays — :func:`solve_poisson_structured_3d_batched`
    at every batch size."""
    return functools.partial(solve_poisson_structured_3d_batched, grid)
