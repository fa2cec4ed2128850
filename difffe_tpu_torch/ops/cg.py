"""Matrix-free preconditioned conjugate gradients with an implicit adjoint.

PyTorch counterpart of ``difffe_tpu/ops/cg.py``.  The operator is the
mask-eliminated K̃v = m⊙v + P·K(P·v), applied element by element
(ops/assembly.py: ``element_apply`` over blocks assembled once per solve,
the hoisting of the JAX ``_applyK_fixed``), and preconditioned with
Jacobi.  The loop is the shared body of ops/pcg.py with a per-scenario
inner product over the node axis, so a (B, n) batch is B independent
solves (the JAX package ``vmap``s them); an unbatched (n,) solve is one.

Gradients come from the implicit function theorem, not from the loop: for
u solving A(θ)u = b(θ),

    dL/dθ = λᵀ(∂b/∂θ − (∂A/∂θ)u),   Aλ = ḡ   (A symmetric: the same solve)

— one adjoint CG solve, then the vector-Jacobian product of the residual
map θ ↦ b(θ) − A(θ)u at fixed u, taken by autograd.  θ holds κ, the load,
the node coordinates and the Dirichlet values (plus α and r of a Robin
term, and the mass and τ of the shifted solve).  The solves are
differentiable once: their backward refuses ``create_graph``, as the JAX
``custom_vjp`` whose backward loop cannot be differentiated.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..mesh import FEMesh
from .assembly import (assemble_tridiag_1d, element_apply, element_family,
                       local_stiffness, scatter_add_nodes, stiffness_apply)
from .pcg import batched_dot, pcg
from .robin import RobinBC, robin_apply, robin_diag
from .solve import apply_dirichlet_operator, dirichlet_rhs

_DOT = batched_dot(1)


def stiffness_diag(mesh: FEMesh, kappa) -> torch.Tensor:
    """diag(K) (…, n_nodes), the Jacobi preconditioner's source."""
    if element_family(mesh) == "p1_line":
        d, _ = assemble_tridiag_1d(mesh, kappa)
        return d
    return scatter_add_nodes(mesh, torch.diagonal(
        local_stiffness(mesh, kappa), dim1=-2, dim2=-1))


def _applyK_fixed(mesh: FEMesh, kappa):
    """K·w with the element blocks assembled once, outside the loop (the
    1D banded apply is cheap as it is)."""
    if element_family(mesh) == "p1_line":
        return lambda w: stiffness_apply(mesh, kappa, w)
    Ke = local_stiffness(mesh, kappa)
    return lambda w: element_apply(mesh, Ke, w)


def jacobi(mesh: FEMesh, diag: torch.Tensor) -> torch.Tensor:
    """1/diag(K̃) of the eliminated operator (1 on Dirichlet rows)."""
    m = mesh.bc_mask
    diagA = m + (1.0 - m) * diag
    return 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))


def _with(mesh: FEMesh, nodes, bc_values) -> FEMesh:
    return dataclasses.replace(mesh, nodes=nodes, bc_values=bc_values)


class _IFTSolve(torch.autograd.Function):
    """u = A(θ)⁻¹b(θ) by PCG, with the implicit adjoint (module note).

    ``system(*theta)`` returns ``(A, b, Minv, x0)``: the operator and the
    preconditioner as functions, the right-hand side and the start."""

    @staticmethod
    def forward(ctx, system, tol, maxiter, *theta):
        A, b, Minv, x0 = system(*theta)
        u = pcg(A, b, Minv, x0, tol, maxiter, dot=_DOT)
        ctx.cfg = (system, tol, maxiter)
        ctx.save_for_backward(u, *theta)
        return u

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the CG solves are differentiable once: their backward "
                "takes no create_graph; use method='dense' or 'lu' for "
                "higher derivatives")
        system, tol, maxiter = ctx.cfg
        u, *theta = ctx.saved_tensors
        A, _, Minv, _ = system(*theta)
        lam = pcg(A, g, Minv, torch.zeros_like(g), tol, maxiter, dot=_DOT)
        need = ctx.needs_input_grad[3:]
        grads = [None] * len(theta)
        if any(need):
            with torch.enable_grad():
                th = [t.detach().requires_grad_(n)
                      for t, n in zip(theta, need)]
                A_, b_, _, _ = system(*th)
                residual = b_ - A_(u)
                wrt = [i for i, n in enumerate(need) if n]
                got = torch.autograd.grad(residual, [th[i] for i in wrt],
                                          lam, allow_unused=True)
            for i, gi in zip(wrt, got):
                grads[i] = gi
        return (None, None, None, *grads)


def _tensor(mesh: FEMesh, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=mesh.dtype, device=mesh.device)


def _poisson_system(mesh: FEMesh):
    def system(nodes, bc_values, kappa, F):
        ms = _with(mesh, nodes, bc_values)
        applyK = _applyK_fixed(ms, kappa)
        b = dirichlet_rhs(ms, applyK, F)
        Minv = jacobi(ms, stiffness_diag(ms, kappa))
        return (lambda v: apply_dirichlet_operator(ms, applyK, v), b,
                lambda r: Minv * r, (ms.bc_mask * ms.bc_values).expand(
                    b.shape))
    return system


def solve_poisson_cg(mesh: FEMesh, kappa, F, tol: float = 0.0,
                     maxiter: Optional[int] = None) -> torch.Tensor:
    """Solve the BC-eliminated system K̃u = F̃ by matrix-free Jacobi-PCG.

    ``F`` is the assembled load (…, n_nodes) (ops/assembly.py:
    ``assemble_load``); κ any form ``local_stiffness`` takes, a diffusion
    tensor included, with leading batch axes.  ``tol=0`` runs exactly
    ``maxiter`` iterations (default n_nodes), the fixed-trip mode of
    batched solves.  Differentiable once wrt κ, F, the node coordinates
    and the Dirichlet values."""
    maxiter = mesh.n_nodes if maxiter is None else maxiter
    return _IFTSolve.apply(_poisson_system(mesh), tol, maxiter, mesh.nodes,
                           mesh.bc_values, _tensor(mesh, kappa),
                           _tensor(mesh, F))


def cg_diagnostics(mesh: FEMesh, kappa, F, tol: float = 0.0,
                   maxiter: Optional[int] = None):
    """Convergence report of the CG solve, not differentiable:
    ``(u, iterations_used, final_relative_residual)``, the residual
    relative to ‖F̃‖ over the whole array."""
    maxiter = mesh.n_nodes if maxiter is None else maxiter
    with torch.no_grad():
        A, b, Minv, x0 = _poisson_system(mesh)(
            mesh.nodes, mesh.bc_values, _tensor(mesh, kappa),
            _tensor(mesh, F))
        x, iters, r = pcg(A, b, Minv, x0, tol, maxiter, dot=_DOT,
                          with_diagnostics=True)
        rel = torch.sqrt((r * r).sum() / (b * b).sum().clamp_min(1e-30))
    return x, iters, rel


def _robin_system(mesh: FEMesh, rows, cols):
    def system(nodes, bc_values, kappa, F, vals, load):
        ms = _with(mesh, nodes, bc_values)
        rb = RobinBC(rows=rows, cols=cols, vals=vals, load=load)
        applyK0 = _applyK_fixed(ms, kappa)

        def applyK(w):
            return applyK0(w) + robin_apply(rb, w)

        b = dirichlet_rhs(ms, applyK, F + load)
        Minv = jacobi(ms, stiffness_diag(ms, kappa) + robin_diag(ms, rb))
        return (lambda v: apply_dirichlet_operator(ms, applyK, v), b,
                lambda r: Minv * r, (ms.bc_mask * ms.bc_values).expand(
                    b.shape))
    return system


def solve_poisson_cg_robin(mesh: FEMesh, kappa, F, robin: RobinBC,
                           tol: float = 0.0,
                           maxiter: Optional[int] = None) -> torch.Tensor:
    """Matrix-free PCG solve of (K + ∮αuv ds)u = F + ∮rv ds with Dirichlet
    elimination; ``robin`` from ops/robin.py, its ``vals``/``load`` with
    leading batch axes or not.  Differentiable once wrt κ, F, α, r, the
    node coordinates and the Dirichlet values."""
    maxiter = mesh.n_nodes if maxiter is None else maxiter
    return _IFTSolve.apply(
        _robin_system(mesh, robin.rows, robin.cols), tol, maxiter,
        mesh.nodes, mesh.bc_values, _tensor(mesh, kappa), _tensor(mesh, F),
        robin.vals, robin.load)


def _shifted_system(mesh: FEMesh):
    def system(nodes, bc_values, kappa, mass, tau, F):
        ms = _with(mesh, nodes, bc_values)
        m = ms.bc_mask
        p = 1.0 - m
        mg = m * ms.bc_values
        applyK = _applyK_fixed(ms, kappa)

        def A(v):
            pv = p * v
            return m * v + p * (mass * pv + tau * applyK(pv))

        b = mg + p * (F - (mass * mg + tau * applyK(mg)))
        Minv = jacobi(ms, mass + tau * stiffness_diag(ms, kappa))
        return A, b, lambda r: Minv * r, mg.expand(b.shape)
    return system


def solve_shifted_cg(mesh: FEMesh, kappa, mass, tau, F, tol: float = 0.0,
                     maxiter: Optional[int] = None) -> torch.Tensor:
    """Solve (diag(mass) + τ·K(κ))u = F with Dirichlet elimination by
    matrix-free Jacobi-PCG (the implicit time step of the heat equation);
    differentiable once wrt κ, mass, τ, F, the node coordinates and the
    Dirichlet values."""
    maxiter = mesh.n_nodes if maxiter is None else maxiter
    return _IFTSolve.apply(_shifted_system(mesh), tol, maxiter, mesh.nodes,
                           mesh.bc_values, _tensor(mesh, kappa),
                           _tensor(mesh, mass), _tensor(mesh, tau),
                           _tensor(mesh, F))
