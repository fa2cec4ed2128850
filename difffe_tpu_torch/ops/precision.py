"""Mixed-precision solves: bf16 inner solves under f32 iterative refinement.

PyTorch counterpart of ``difffe_tpu/ops/precision.py``.  Iterative
refinement (Wilkinson): solve in low precision, compute the residual in
the working precision, solve the correction in low precision again and
accumulate in the working precision.  Each pass multiplies the error by
O(cond(A)·ε_lo), so with bf16 (ε ≈ 2⁻⁸) and a well-conditioned
BC-eliminated P1 system a few passes recover f32 accuracy while the inner
solver reads and writes half the bytes.

bf16 rounding: torch rounds every bf16 operation to bf16, where XLA on the
CPU may keep f32 between fused bf16 operations, so the inner solves do not
agree with the JAX module bit for bit; the refined results are held to the
f64 oracle at the tolerances the docstrings state.

Gradients: the refined solve converges to the same u = A⁻¹b as the
working-precision path, so the backward passes are the implicit-function-
theorem adjoints with a refined adjoint solve (first order only, as the
JAX custom VJPs).
"""

from __future__ import annotations

import torch

from .pcg import first_order_only, pcg
from .stencil import (boundary_mask_grid, load_grid, residual_vjp_manual,
                      stencil_apply, stencil_coefficients)
from .tridiag import _tridiag_solve_impl, tridiag_matvec


def _dot_f32acc(u, v):
    """Inner product with f32 accumulation, cast back to the CG state's
    dtype: bf16 CG stalls if α/β come from bf16-accumulated reductions
    (~2⁻⁸ relative error over thousands of terms).  Per scenario over the
    trailing two (grid) axes, keepdims, as ``pcg.batched_dot(2)``: an
    unbatched call gets the JAX module's global dot, a batched one its
    vmapped per-scenario dots."""
    acc = (u.float() * v.float()).sum(dim=(-2, -1), keepdim=True)
    return acc.to(u.dtype)


def refine(solve_lo, matvec_hi, b: torch.Tensor,
           iters: int = 2) -> torch.Tensor:
    """Generic iterative refinement.

    ``solve_lo(r)`` approximately solves A x = r in any precision (its
    output is cast to ``b.dtype``); ``matvec_hi(x)`` applies A in the
    precision of ``b``.  Returns x after ``iters`` correction passes."""
    x = solve_lo(b).to(b.dtype)
    for _ in range(iters):
        r = b - matvec_hi(x)
        x = x + solve_lo(r).to(b.dtype)
    return x


def _band_solve_bf16(d, e, F, iters):
    """Refined tridiagonal solve: bf16 PCR inner, f32 residual and
    accumulation.

    The band is symmetrically Jacobi-scaled (D^-1/2 T D^-1/2, unit
    diagonal) before the cast: raw-magnitude PCR in bf16 cancels reduced
    diagonals to exact zero by sweep ~4, while the unit-diagonal system
    keeps every reduced diagonal in [~0.5, 1]."""
    s = 1.0 / d.abs().sqrt()
    d_lo = (d * s * s).to(torch.bfloat16)
    e_lo = (e * s[..., :-1] * s[..., 1:]).to(torch.bfloat16)

    def solve_lo(r):
        u_hat = _tridiag_solve_impl(d_lo, e_lo, (r * s).to(torch.bfloat16))
        return u_hat.to(r.dtype) * s

    return refine(solve_lo, lambda x: tridiag_matvec(d, e, x), F, iters)


class _TridiagRefined(torch.autograd.Function):
    @staticmethod
    def forward(ctx, refine_iters, d, e, F):
        u = _band_solve_bf16(d, e, F, refine_iters)
        ctx.refine_iters = refine_iters
        ctx.shapes = (d.shape, e.shape, F.shape)
        ctx.save_for_backward(d, e, u)
        return u

    @staticmethod
    def backward(ctx, g):
        d, e, u = ctx.saved_tensors
        d_shape, e_shape, F_shape = ctx.shapes
        # T symmetric ⇒ Tλ = ḡ, by the same refined solve
        lam = _band_solve_bf16(d, e, g, ctx.refine_iters)
        grad_d = -lam * u
        grad_e = -(lam[..., :-1] * u[..., 1:] + lam[..., 1:] * u[..., :-1])
        return (None, grad_d.sum_to_size(d_shape),
                grad_e.sum_to_size(e_shape), lam.sum_to_size(F_shape))


def tridiag_solve_refined(d: torch.Tensor, e: torch.Tensor, F: torch.Tensor,
                          refine_iters: int = 3) -> torch.Tensor:
    """Solve T u = F with a bf16 PCR inner solver under f32 refinement.

    Same contract as ``tridiag.tridiag_solve`` (symmetric T, leading batch
    axes broadcast); the band and right-hand side stay in ``F.dtype`` for
    the residual and the accumulation, the log₂n PCR sweeps run in bf16.

    Refinement contracts iff cond(T)·ε_bf16 < 1 (cond ≈ (n/π)² for the P1
    Laplacian).  The JAX module measured, against the f64 oracle at
    κ = 1.37: n = 30 reaches 1.3e-6 relative in 3 passes, n = 128 1.8e-5
    in 4, n = 1024 diverges; beyond n ≈ 128 use the f32 path."""
    return _TridiagRefined.apply(int(refine_iters), d, e, F)


# ---------------------------------------------------------------------------
# 2D: bf16-storage stencil CG under f32 refinement
# ---------------------------------------------------------------------------


def _bf16_inner(C, m, inner_iters):
    """The bf16 inner solve r ↦ ≈A⁻¹r of the BC-eliminated operator: Jacobi
    PCG on bf16 planes with f32-accumulated per-scenario dots."""
    p = 1.0 - m
    diagA = m + p * C[..., 0, :, :]
    Minv = 1.0 / torch.where(diagA.abs() > 1e-30, diagA,
                             torch.ones_like(diagA))
    C_lo, m_lo, p_lo, Minv_lo = (t.to(torch.bfloat16)
                                 for t in (C, m, p, Minv))

    def A(v):
        return m_lo * v + p_lo * stencil_apply(C_lo, p_lo * v)

    def solve_lo(r):
        r_lo = r.to(torch.bfloat16)
        # stagnation_floor=0: the default (4ε_bf16)² freeze would stop the
        # inner CG at ~3e-2 relative, inside the working range the outer
        # refinement depends on
        return pcg(A, r_lo, lambda s: Minv_lo * s, torch.zeros_like(r_lo),
                   0.0, inner_iters, dot=_dot_f32acc,
                   stagnation_floor=0.0)

    return solve_lo


def _refined_stencil(C, m, b, x, inner_iters, refine_iters):
    """x + one bf16 pass, then ``refine_iters`` correction passes, on the
    working-precision operator."""
    p = 1.0 - m
    solve_lo = _bf16_inner(C, m, inner_iters)

    def A(v):
        return m * v + p * stencil_apply(C, p * v)

    x = x + solve_lo(b - A(x)).to(b.dtype)
    for _ in range(refine_iters):
        x = x + solve_lo(b - A(x)).to(b.dtype)
    return x


def _stencil_solve_bf16(grid, kappa_lu, f, g, inner_iters, refine_iters):
    """Refined structured-grid solve: bf16 CG inner passes, f32 outer.
    Returns (u, C)."""
    kl, ku = kappa_lu
    C = stencil_coefficients(grid, kl, ku)
    m = boundary_mask_grid(grid, f.dtype, f.device)
    p = 1.0 - m
    b = m * g + p * (load_grid(grid, f) - stencil_apply(C, m * g))
    x0 = (m * g).expand(b.shape)
    return _refined_stencil(C, m, b, x0, inner_iters, refine_iters), C


class _StencilBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, inner_iters, refine_iters, kl, ku, f, g):
        u, C = _stencil_solve_bf16(grid, (kl, ku), f, g, inner_iters,
                                   refine_iters)
        ctx.cfg = (grid, inner_iters, refine_iters)
        ctx.C = C
        ctx.save_for_backward(kl, ku, f, g, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        first_order_only("solve_poisson_structured_bf16")
        grid, inner_iters, refine_iters = ctx.cfg
        kl, ku, f, g, u = ctx.saved_tensors
        C = ctx.C
        m = boundary_mask_grid(grid, gbar.dtype, gbar.device)
        # the adjoint A λ = ḡ (A symmetric) by the same refined solve, from 0
        lam = _refined_stencil(C, m, gbar, torch.zeros_like(gbar),
                               inner_iters, refine_iters)
        (gl, gu), gf, gg = residual_vjp_manual(grid, (kl, ku), f, g, u, lam,
                                               C=C)
        return None, None, None, gl, gu, gf, gg


def solve_poisson_structured_bf16(grid, kappa_lu, f: torch.Tensor,
                                  g: torch.Tensor, inner_iters: int = 48,
                                  refine_iters: int = 2) -> torch.Tensor:
    """Structured 2D Poisson solve with bf16 CG inner passes (f32 refined).

    Same contract as ``stencil.solve_poisson_structured``, with leading
    scenario axes on κ and f solved as independent scenarios (per-scenario
    f32-accumulated dots, the JAX module's vmapped behaviour).  The stencil
    planes, preconditioner and CG state are bf16; the outer residual and
    correction loop runs in ``f.dtype``: ``inner_iters`` CG iterations a
    pass, one pass plus ``refine_iters`` correction passes.

    The JAX module measured a contraction of ~0.09-0.15 a pass at 32² and
    64² (CPU, f64 oracle): at 64², 48 inner iterations × (1 + 3) passes
    reach 5.1e-4 relative.  The bf16 path targets ~1e-3-1e-4 gradient-step
    accuracy, not f32 roundoff.

    Backward: the implicit-function-theorem adjoint with a refined adjoint
    solve and the closed-form residual VJP, first order only.
    """
    kl, ku = kappa_lu
    return _StencilBf16.apply(grid, int(inner_iters), int(refine_iters),
                              kl, ku, f, g)
