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

The eliminated operator is held as data, :class:`ElementOperator` (the
element blocks, or κ/h a P1 line element, the connectivity, the mask and
the optional shift, time step and Robin triplet), so that a tol-gated
solve runs as the ``torch.library`` op ``difffe::element_cg_gated``: the
loop on CPU and CUDA tensors alike, one node of an exported program
(ops/pcg.py).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..mesh import FEMesh
from .assembly import (assemble_tridiag_1d, element_family,
                       element_geometry_1d, kappa_on_elements,
                       local_stiffness, scatter_add_nodes)
from .kernels._build import kernel_op
from .pcg import batched_dot, gated_iters, pcg
from .robin import RobinBC, robin_apply, robin_diag

_DOT = batched_dot(1)


def stiffness_diag(mesh: FEMesh, kappa) -> torch.Tensor:
    """diag(K) (…, n_nodes), the Jacobi preconditioner's source."""
    if element_family(mesh) == "p1_line":
        d, _ = assemble_tridiag_1d(mesh, kappa)
        return d
    return scatter_add_nodes(mesh, torch.diagonal(
        local_stiffness(mesh, kappa), dim1=-2, dim2=-1))


class ElementOperator(NamedTuple):
    """The eliminated operator Ãv = m⊙v + P·(s⊙Pv + τ·K(Pv) + R(Pv)) as
    tensors.  ``Ke`` holds the element blocks (…, ne, k, k), or on a P1
    line (``line``) κ_e/h_e (…, ne); ``shift`` (s), ``tau`` (τ) and the
    Robin triplet ``robin`` = (rows, cols, vals) are None where absent."""
    Ke: torch.Tensor
    line: bool
    elements: torch.Tensor
    m: torch.Tensor
    shift: Optional[torch.Tensor] = None
    tau: Optional[torch.Tensor] = None
    robin: Optional[tuple] = None


def _element_K(Ke, line, elements, w):
    """K·w from the operator's element data (the assembly's element apply,
    or the line's banded apply), batched over leading axes."""
    n = w.shape[-1]
    if line:
        i, j = elements[:, 0], elements[:, 1]
        du = Ke * (w[..., i] - w[..., j])
        out = du.new_zeros(du.shape[:-1] + (n,))
        return out.index_add(-1, i, du).index_add(-1, j, -du)
    kue = torch.einsum("...epq,...eq->...ep", Ke, w[..., elements])
    out = kue.new_zeros(kue.shape[:-2] + (n,))
    for p in range(elements.shape[1]):
        out = out.index_add(-1, elements[:, p], kue[..., p])
    return out


def apply_K(op: ElementOperator, w: torch.Tensor) -> torch.Tensor:
    """K(κ)·w, the stiffness (with the shift, τ and the Robin term) before
    elimination."""
    out = _element_K(op.Ke, op.line, op.elements, w)
    if op.tau is not None:
        out = op.tau * out
    if op.shift is not None:
        out = op.shift * w + out
    if op.robin is not None:
        rows, cols, vals = op.robin
        out = out + robin_apply(RobinBC(rows, cols, vals, None), w)
    return out


def apply_eliminated(op: ElementOperator, v: torch.Tensor) -> torch.Tensor:
    """Ãv = m⊙v + P·K(P·v)."""
    p = 1.0 - op.m
    return op.m * v + p * apply_K(op, p * v)


def element_operator(mesh: FEMesh, kappa) -> ElementOperator:
    """The Poisson operator of ``mesh`` at κ, its element blocks assembled
    once, outside the loop (the hoisting of the JAX ``_applyK_fixed``)."""
    if element_family(mesh) == "p1_line":
        ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
        return ElementOperator(ke, True, mesh.elements, mesh.bc_mask)
    return ElementOperator(local_stiffness(mesh, kappa), False,
                           mesh.elements, mesh.bc_mask)


def _loop(op, b, Minv, x0, tol, maxiter):
    return pcg(lambda v: apply_eliminated(op, v), b, lambda r: Minv * r, x0,
               tol, maxiter, dot=_DOT, with_diagnostics=True)


def _element_cg_gated(Ke, elements, m, b, Minv, x0, shift, tau, rrows,
                      rcols, rvals, line, tol, maxiter):
    """The tol-gated solve, the op's implementation on CPU and CUDA
    tensors alike: (x, the recurrence's residual r, iterations as a 0-dim
    int64 tensor)."""
    robin = None if rvals is None else (rrows, rcols, rvals)
    op = ElementOperator(Ke, bool(line), elements, m, shift, tau, robin)
    x, iters, r = _loop(op, b, Minv, x0, tol, maxiter)
    gated_iters.append(iters)
    return x, r, torch.tensor(iters, dtype=torch.int64)


def _like_b(Ke, elements, m, b, Minv, x0, *_):
    shape = torch.broadcast_shapes(b.shape, x0.shape)
    return (b.new_empty(shape), b.new_empty(shape),
            torch.empty((), dtype=torch.int64))


#: the tol-gated element CG as the op ``difffe::element_cg_gated``
element_cg_gated = kernel_op(
    "element_cg_gated",
    "(Tensor Ke, Tensor elements, Tensor m, Tensor b, Tensor Minv, "
    "Tensor x0, Tensor? shift, Tensor? tau, Tensor? rrows, Tensor? rcols, "
    "Tensor? rvals, int line, float tol, int maxiter) "
    "-> (Tensor, Tensor, Tensor)",
    _element_cg_gated, _element_cg_gated, _like_b)


def solve_element(op: ElementOperator, b, Minv, x0, tol: float,
                  maxiter: int, diagnostics: bool = False):
    """Jacobi-PCG on ``op`` with per-scenario dots: x, or (x, iterations,
    r) when ``diagnostics``; tol-gated solves through
    ``difffe::element_cg_gated``."""
    if tol > 0.0:
        rrows, rcols, rvals = op.robin or (None, None, None)
        x, r, iters = element_cg_gated(
            op.Ke, op.elements, op.m, b, Minv, x0, op.shift, op.tau, rrows,
            rcols, rvals, int(op.line), float(tol), int(maxiter))
        iters = int(iters) if diagnostics else iters
    else:
        x, iters, r = _loop(op, b, Minv, x0, tol, maxiter)
    return (x, iters, r) if diagnostics else x


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

    ``system(*theta)`` returns ``(A, b, Minv, x0)``: the operator, an
    :class:`ElementOperator` or a function, the right-hand side, the
    Jacobi vector and the start."""

    @staticmethod
    def forward(ctx, system, tol, maxiter, *theta):
        A, b, Minv, x0 = system(*theta)
        u = _solve(A, b, Minv, x0, tol, maxiter)
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
        lam = _solve(A, g, Minv, torch.zeros_like(g), tol, maxiter)
        need = ctx.needs_input_grad[3:]
        grads = [None] * len(theta)
        if any(need):
            with torch.enable_grad():
                th = [t.detach().requires_grad_(n)
                      for t, n in zip(theta, need)]
                A_, b_, _, _ = system(*th)
                residual = b_ - _apply(A_, u)
                wrt = [i for i, n in enumerate(need) if n]
                got = torch.autograd.grad(residual, [th[i] for i in wrt],
                                          lam, allow_unused=True)
            for i, gi in zip(wrt, got):
                grads[i] = gi
        return (None, None, None, *grads)


def _apply(A, v):
    return apply_eliminated(A, v) if isinstance(A, ElementOperator) else A(v)


def _solve(A, b, Minv, x0, tol, maxiter):
    if isinstance(A, ElementOperator):
        return solve_element(A, b, Minv, x0, tol, maxiter)
    return pcg(A, b, lambda r: Minv * r, x0, tol, maxiter, dot=_DOT)


def _tensor(mesh: FEMesh, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=mesh.dtype, device=mesh.device)


def _rhs(op: ElementOperator, mesh: FEMesh, F):
    """m⊙g + P(F − K(m⊙g)), and the start m⊙g."""
    p = 1.0 - mesh.bc_mask
    mg = mesh.bc_mask * mesh.bc_values
    b = mg + p * (F - apply_K(op, mg))
    return b, mg.expand(b.shape)


def _poisson_system(mesh: FEMesh):
    def system(nodes, bc_values, kappa, F):
        ms = _with(mesh, nodes, bc_values)
        op = element_operator(ms, kappa)
        b, x0 = _rhs(op, ms, F)
        return op, b, jacobi(ms, stiffness_diag(ms, kappa)), x0
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
        x, iters, r = solve_element(A, b, Minv, x0, tol, maxiter,
                                    diagnostics=True)
        rel = torch.sqrt((r * r).sum() / (b * b).sum().clamp_min(1e-30))
    return x, iters, rel


def _robin_system(mesh: FEMesh, rows, cols):
    def system(nodes, bc_values, kappa, F, vals, load):
        ms = _with(mesh, nodes, bc_values)
        op = element_operator(ms, kappa)._replace(robin=(rows, cols, vals))
        b, x0 = _rhs(op, ms, F + load)
        rb = RobinBC(rows=rows, cols=cols, vals=vals, load=load)
        Minv = jacobi(ms, stiffness_diag(ms, kappa) + robin_diag(ms, rb))
        return op, b, Minv, x0
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
        op = element_operator(ms, kappa)._replace(shift=mass, tau=tau)
        b, x0 = _rhs(op, ms, F)
        Minv = jacobi(ms, mass + tau * stiffness_diag(ms, kappa))
        return op, b, Minv, x0
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
