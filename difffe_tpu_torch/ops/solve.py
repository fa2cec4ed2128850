"""Dirichlet BC application and differentiable dense linear solves.

PyTorch counterpart of ``difffe_tpu/ops/solve.py``.  Mask elimination on
the full vector keeps every shape static:

    K̃ = P K P + diag(m),   F̃ = m⊙g + P(F − K(m⊙g)),   P = diag(1−m).

``cholesky_solve`` and ``lu_solve`` are ``torch.autograd.Function``s whose
backward reuses the factorization: one more solve λ = K̃⁻ᵀḡ and the rank-1
contraction ∂K̃ = −λuᵀ.  Under ``create_graph`` the backward solves through
the same Function instead, so second derivatives (the Newton polish of
``recover_kappa_scalar``) see λ's dependence on K.  The factorizations
are PyTorch's library calls, as the JAX package leaves them to XLA.

Everything batches over leading axes of K, F and the Dirichlet values
(the JAX package ``vmap``s one solve per scenario).
"""

from __future__ import annotations

import torch

from ..mesh import FEMesh


def apply_dirichlet_dense(mesh: FEMesh, K: torch.Tensor, F: torch.Tensor,
                          bc_values=None):
    """Eliminate Dirichlet BCs from dense (K (…, n, n), F (…, n)) without
    changing shapes.  ``bc_values`` (…, n) overrides the mesh's values."""
    m = mesh.bc_mask
    g = mesh.bc_values if bc_values is None else bc_values
    p = 1.0 - m
    mg = m * g
    Kg = (K @ mg[..., None])[..., 0]
    F_mod = mg + p * (F - Kg)
    K_mod = p[:, None] * K * p[None, :] + torch.diag(m)
    return K_mod, F_mod


def apply_dirichlet_operator(mesh: FEMesh, apply_K, v: torch.Tensor):
    """Matrix-free eliminated operator K̃v = m⊙v + P·K(P·v) for a function
    ``apply_K``: u ↦ K·u (no BCs)."""
    m = mesh.bc_mask
    p = 1.0 - m
    return m * v + p * apply_K(p * v)


def dirichlet_rhs(mesh: FEMesh, apply_K, F: torch.Tensor):
    """Matrix-free eliminated right-hand side F̃ = m⊙g + P(F − K(m⊙g))."""
    m = mesh.bc_mask
    p = 1.0 - m
    mg = m * mesh.bc_values
    return mg + p * (F - apply_K(mg))


def _outer(lam, u):
    return lam[..., :, None] * u[..., None, :]


class _CholeskySolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, F):
        L = torch.linalg.cholesky(K)
        u = torch.cholesky_solve(F[..., None], L)[..., 0]
        ctx.save_for_backward(K, L, u)
        ctx.F_shape = F.shape
        return u

    @staticmethod
    def backward(ctx, g):
        K, L, u = ctx.saved_tensors
        if torch.is_grad_enabled():
            lam = cholesky_solve(K, g)
        else:    # K symmetric ⇒ the adjoint solve reuses the factor
            lam = torch.cholesky_solve(g[..., None], L)[..., 0]
        return (-_outer(lam, u)).sum_to_size(K.shape), \
            lam.sum_to_size(ctx.F_shape)


class _LUSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, K, F):
        LU, piv = torch.linalg.lu_factor(K)
        u = torch.linalg.lu_solve(LU, piv, F[..., None])[..., 0]
        ctx.save_for_backward(K, LU, piv, u)
        ctx.F_shape = F.shape
        return u

    @staticmethod
    def backward(ctx, g):
        K, LU, piv, u = ctx.saved_tensors
        if torch.is_grad_enabled():
            lam = lu_solve(K.mT, g)
        else:    # Kᵀλ = ḡ from the same factors
            lam = torch.linalg.lu_solve(LU, piv, g[..., None],
                                        adjoint=True)[..., 0]
        return (-_outer(lam, u)).sum_to_size(K.shape), \
            lam.sum_to_size(ctx.F_shape)


def cholesky_solve(K: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """u = K⁻¹F for SPD K (…, n, n), F (…, n) by Cholesky; the adjoint
    reuses the factor."""
    return _CholeskySolve.apply(K, F)


def lu_solve(K: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """u = K⁻¹F by LU (general K, the reference-parity path); the adjoint
    reuses the factors."""
    return _LUSolve.apply(K, F)


def solve_dense(mesh: FEMesh, K: torch.Tensor, F: torch.Tensor,
                factor: str = "cholesky", bc_values=None) -> torch.Tensor:
    """Apply Dirichlet BCs to assembled (K, F) and solve.

    factor: 'cholesky' (SPD fast path) or 'lu' (reference parity).
    ``bc_values`` (…, n) overrides the mesh's Dirichlet values (the JAX
    package substitutes them into the mesh).
    """
    if factor not in ("cholesky", "lu"):
        raise ValueError(f"Unknown factor {factor!r}")
    K_mod, F_mod = apply_dirichlet_dense(mesh, K, F, bc_values)
    lead = torch.broadcast_shapes(K_mod.shape[:-2], F_mod.shape[:-1])
    n = F_mod.shape[-1]
    K_mod = K_mod.expand(lead + (n, n))
    F_mod = F_mod.expand(lead + (n,))
    if factor == "cholesky":
        return cholesky_solve(K_mod, F_mod)
    return lu_solve(K_mod, F_mod)
