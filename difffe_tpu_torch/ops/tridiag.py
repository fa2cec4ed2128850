"""Batched symmetric tridiagonal solver by parallel cyclic reduction (PCR).

PyTorch counterpart of ``difffe_tpu/ops/tridiag.py`` and the oracle every
1D path of this package is checked against.  ``tridiag_solve`` is a
``torch.autograd.Function``: the matrix is symmetric, so the backward pass
is one more PCR solve λ = T⁻¹ḡ followed by the elementwise contractions

    ∂F = λ,   ∂d = −λ⊙u,   ∂e_i = −(λ_i u_{i+1} + λ_{i+1} u_i).

All functions act on the last axis and broadcast over leading batch axes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F_

from ..mesh import FEMesh


def tridiag_matvec(d: torch.Tensor, e: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """y = T x for symmetric tridiagonal T (diag d (…, n), off-diag e
    (…, n−1))."""
    return (d * x + F_.pad(e * x[..., 1:], (0, 1))
            + F_.pad(e * x[..., :-1], (1, 0)))


def _shift_down(x, s, fill):
    """y_i = x_{i+s} (tail padded with fill)."""
    return F_.pad(x[..., s:], (0, s), value=fill)


def _shift_up(x, s, fill):
    """y_i = x_{i−s} (head padded with fill)."""
    return F_.pad(x[..., :-s], (s, 0), value=fill)


def _pcr(a, b, c, r):
    """Parallel cyclic reduction for a_i x_{i−1} + b_i x_i + c_i x_{i+1} = r_i
    with a[..., 0] = c[..., −1] = 0, over ⌈log₂n⌉ strides."""
    n = b.shape[-1]
    steps = max(1, math.ceil(math.log2(n))) if n > 1 else 0
    s = 1
    for _ in range(steps):
        b_up, b_dn = _shift_up(b, s, 1.0), _shift_down(b, s, 1.0)
        a_up, c_dn = _shift_up(a, s, 0.0), _shift_down(c, s, 0.0)
        c_up, a_dn = _shift_up(c, s, 0.0), _shift_down(a, s, 0.0)
        r_up, r_dn = _shift_up(r, s, 0.0), _shift_down(r, s, 0.0)
        alpha = -a / b_up
        gamma = -c / b_dn
        a = alpha * a_up
        c = gamma * c_dn
        b = b + alpha * c_up + gamma * a_dn
        r = r + alpha * r_up + gamma * r_dn
        s *= 2
    return r / b


def _tridiag_solve_impl(d, e, F):
    shape = torch.broadcast_shapes(d.shape, F.shape)
    e = e.expand(shape[:-1] + e.shape[-1:])
    a = F_.pad(e, (1, 0))                      # sub-diagonal
    c = F_.pad(e, (0, 1))                      # super-diagonal
    return _pcr(a, d.expand(shape), c, F.expand(shape))


class _TridiagSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d, e, F):
        u = _tridiag_solve_impl(d, e, F)
        ctx.save_for_backward(d, e, u)
        ctx.shapes = (d.shape, e.shape, F.shape)
        return u

    @staticmethod
    def backward(ctx, g):
        d, e, u = ctx.saved_tensors
        d_shape, e_shape, F_shape = ctx.shapes
        lam = _tridiag_solve_impl(d, e, g)     # T symmetric ⇒ Tλ = ḡ
        grad_d = -lam * u
        grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
        return (grad_d.sum_to_size(d_shape), grad_e.sum_to_size(e_shape),
                lam.sum_to_size(F_shape))


def tridiag_solve(d: torch.Tensor, e: torch.Tensor,
                  F: torch.Tensor) -> torch.Tensor:
    """Solve T u = F for symmetric tridiagonal T = tridiag(e, d, e)."""
    return _TridiagSolve.apply(d, e, F)


def dirichlet_elimination(mesh: FEMesh, d: torch.Tensor, e: torch.Tensor,
                          bc_values=None):
    """The band-form Dirichlet elimination of ``solve_poisson_tridiag``,
    split at what depends on the bands alone:

        d̃ = p⊙d + m,  ẽ_i = p_i p_{i+1} e_i,  F̃ = m⊙g + p(F − T(m⊙g)).

    Returns (d̃, ẽ, p, rhs) with p = 1 − m and rhs(F) = F̃; T(m⊙g) is
    computed once, and rhs is affine in F, so a time loop over one system
    can eliminate the loads of all its steps at once.  ``bc_values``
    optionally overrides the mesh's Dirichlet values and may carry leading
    batch axes."""
    m = mesh.bc_mask
    g = mesh.bc_values if bc_values is None else \
        torch.as_tensor(bc_values, dtype=mesh.dtype, device=mesh.device)
    p = 1.0 - m
    d_mod = p * d + m
    e_mod = p[..., :-1] * p[..., 1:] * e
    mg = m * g
    Tmg = tridiag_matvec(d, e, mg)

    def rhs(F):
        return (mg + p * (F - Tmg)).expand(F.shape)

    return d_mod, e_mod, p, rhs


def solve_eliminated(d_mod: torch.Tensor, e_mod: torch.Tensor,
                     F_mod: torch.Tensor, backend: str = "xla",
                     chunk: int = 64) -> torch.Tensor:
    """Solve an eliminated band system on ``backend`` (as in
    ``solve_poisson_tridiag``)."""
    if backend not in ("xla", "pallas", "spike"):
        raise ValueError(f"unknown tridiagonal backend {backend!r} "
                         "(expected 'xla', 'pallas', or 'spike')")
    if backend == "xla":
        return tridiag_solve(d_mod, e_mod, F_mod)
    # the other backends take explicitly batched bands (stride-0 views of a
    # band shared by every scenario; K2 reads them in place)
    bshape = F_mod.shape[:-1]
    d_mod = d_mod.expand(bshape + d_mod.shape[-1:])
    e_mod = e_mod.expand(bshape + e_mod.shape[-1:])
    if backend == "spike":
        from .spike import tridiag_solve_spike
        return tridiag_solve_spike(d_mod, e_mod, F_mod, chunk)
    from .kernels.tridiag_kernel import tridiag_solve_kernel
    return tridiag_solve_kernel(d_mod, e_mod, F_mod)


def solve_poisson_tridiag(mesh: FEMesh, d: torch.Tensor, e: torch.Tensor,
                          F: torch.Tensor, backend: str = "xla",
                          bc_values=None, chunk: int = 64) -> torch.Tensor:
    """Eliminate the Dirichlet rows of banded (d, e, F) on a chain mesh and
    solve (``dirichlet_elimination``, then ``solve_eliminated``).

    ``bc_values`` optionally overrides the mesh's Dirichlet values and may
    carry leading batch axes.  ``backend``: ``"xla"`` (the elementwise PCR
    sweeps above), ``"pallas"`` (kernel K2, ops/kernels/tridiag_kernel.py)
    or ``"spike"`` (the partitioned solver of ops/spike.py, ``chunk`` rows
    a chunk); the last two take the bands broadcast to F's batch shape.
    """
    d_mod, e_mod, _, rhs = dirichlet_elimination(mesh, d, e, bc_values)
    return solve_eliminated(d_mod, e_mod, rhs(F), backend, chunk)
