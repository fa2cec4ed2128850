"""Kernels K4a/K4b: whole-CG Jacobi-PCG on structured 3D boxes.

PyTorch counterpart of ``difffe_tpu/ops/pallas/stencil3d_cg_kernel.py``.
The Dirichlet elimination is folded into the stencil outside the kernel
(D_k = p·C_k·shift(p) + diag(m)), so the kernel's operator is a plain
7-point stencil apply on (B, Dz, H, W) node boxes.

Each solve has two implementations behind one wrapper:

* the CUDA kernels in ``csrc/stencil3d_cg.cu`` (one thread block per
  scenario, CG vectors in shared memory or a global workspace), launched
  for CUDA tensors;
* the plain PyTorch versions below (the same per-scenario fixed-trip PCG
  with the same freeze rule, ``ops/pcg.py`` with per-scenario dots), taken
  only for CPU tensors, and the reference the kernels are checked against.

Names mapped from the JAX module: ``_cg3_pallas`` → :func:`_cg3` (K4a),
``_cg3_2_pallas`` → :func:`_cg3_2` (K4b), ``solve_structured_pallas_3d``
→ :func:`solve_structured_kernel_3d`, ``fused_kappa_mse_step_3d_pallas``
→ :func:`fused_kappa_mse_step_3d_kernel`.  Nothing is padded: the TPU
folded the box to (Dz, H·W) lanes padded to 128 and B to ``block_b``;
here the planes are (B, Dz, H, W) as they are.  ``block_b`` stays in the
signatures for the JAX callers' sake and changes nothing (it must be
≥ 1).  The TPU's VMEM sizing (``vmem_bytes_fused3``, ``fused_fits``) and
its batch chunking for the remote compile helper have no counterpart.

``operand_dtype=torch.bfloat16`` stores the 7 folded planes and M⁻¹ in
bf16; both versions upcast them at use, so the CG arithmetic, right-hand
side, state and outputs stay in the working dtype.  The warm state of
:func:`fused_kappa_mse_step_3d_kernel` is an opaque ``(x, λ)`` pair of
(B, Dz, H, W) boxes, to be handed back unchanged as ``warm_state``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..pcg import batched_dot, pcg
from ..stencil3d import (
    OFFSETS3,
    StructuredGrid3,
    _jacobi,
    _shift3d,
    boundary_mask_box,
    load_box,
    residual_vjp_manual_3d,
    stencil3d_apply,
    stencil3d_coefficients,
)
from .stencil_cg_kernel import _check_block_b

#: Kernel launches made by the wrappers, by kernel ("cg3" K4a, "cg3_2" K4b).
launches = {"cg3": 0, "cg3_2": 0}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and reference)
# ---------------------------------------------------------------------------


def _apply7(D, v):
    out = D[0] * v
    for k, off in enumerate(OFFSETS3[1:], start=1):
        out = out + D[k] * _shift3d(v, *off)
    return out


def _cg3_plain(D, b, Minv, x, iters):
    """Plain version of K4a: ``iters`` fixed PCG iterations per scenario
    on (B, Dz, H, W) boxes, from x; D and M⁻¹ upcast to b's dtype."""
    D, Minv = D.to(b.dtype), Minv.to(b.dtype)
    return pcg(lambda v: _apply7(D, v), b, lambda r: Minv * r, x, 0.0,
               iters, dot=batched_dot(3))


def _cg3_2_plain(D, b, Minv, x0, lam0, ud, scale, iters):
    """Plain version of K4b: (x, λ), each (B, Dz, H, W)."""
    x = _cg3_plain(D, b, Minv, x0, iters)
    lam = _cg3_plain(D, scale * (x - ud), Minv, lam0, iters)
    return x, lam


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_COEFF_DTYPES = (torch.float32, torch.bfloat16)


def _check_cuda_planes(D, Minv, planes) -> tuple:
    """Validate what the kernels take; returns (B, Dz, H, W)."""
    if not D.is_cuda:
        raise ValueError(f"K4 runs on CPU (plain) or CUDA tensors, got "
                         f"device {D.device}")
    if D.ndim != 5 or D.shape[0] != 7:
        raise ValueError(f"D must be the (7, B, Dz, H, W) folded planes, "
                         f"got {tuple(D.shape)}")
    _, B, Dz, H, W = D.shape
    if Dz * H * W > 2 ** 28:
        raise ValueError(f"box of {Dz}×{H}×{W} nodes is too large for K4")
    if D.dtype not in _COEFF_DTYPES or Minv.dtype != D.dtype:
        raise TypeError(f"the CUDA K4 kernels take D and Minv both float32 "
                        f"or both bfloat16, got {D.dtype} and {Minv.dtype}")
    for t in planes:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA K4 kernels take float32 right-hand "
                            f"sides and states, got {t.dtype}")
    for t in (D, Minv, *planes):
        if t.device != D.device or not t.is_contiguous():
            raise ValueError(f"K4 planes must be contiguous and on "
                             f"{D.device}")
    for t in (Minv, *planes):
        if tuple(t.shape) != (B, Dz, H, W):
            raise ValueError(f"K4 planes must be (B, Dz, H, W) = "
                             f"{(B, Dz, H, W)}, got {tuple(t.shape)}")
    return B, Dz, H, W


def _workspace(lib, B, Dz, H, W, device):
    per = lib.difffe_stencil3d_cg_work(Dz, H, W)
    if per == 0:
        return None
    return torch.empty(B * per, dtype=torch.float32, device=device)


def _launch_cg3(D, b, Minv, x0, iters):
    from ._build import load_library

    B, Dz, H, W = _check_cuda_planes(D, Minv, (b, x0))
    out = torch.empty_like(b)
    if B == 0:
        return out
    lib = load_library()
    work = _workspace(lib, B, Dz, H, W, D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_stencil3d_cg(
            D.data_ptr(), b.data_ptr(), Minv.data_ptr(), x0.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(),
            B, Dz, H, W, int(iters), int(D.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"K4a stencil3d_cg launch failed: CUDA error {rc}")
    launches["cg3"] += 1
    return out


def _launch_cg3_2(D, b, Minv, x0, lam0, ud, scale, iters):
    from ._build import load_library

    B, Dz, H, W = _check_cuda_planes(D, Minv, (b, x0, lam0, ud))
    x = torch.empty_like(b)
    lam = torch.empty_like(b)
    if B == 0:
        return x, lam
    lib = load_library()
    work = _workspace(lib, B, Dz, H, W, D.device)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_stencil3d_cg2(
            D.data_ptr(), b.data_ptr(), Minv.data_ptr(), x0.data_ptr(),
            lam0.data_ptr(), ud.data_ptr(), x.data_ptr(), lam.data_ptr(),
            None if work is None else work.data_ptr(),
            B, Dz, H, W, int(iters), float(scale),
            int(D.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"K4b stencil3d_cg2 launch failed: CUDA error "
                           f"{rc}")
    launches["cg3_2"] += 1
    return x, lam


def _cg3(D, b, Minv, x0, iters: int, block_b: int = 1):
    """K4a: ``iters`` fixed PCG iterations per scenario.

    D: (7, B, Dz, H, W) folded planes; b/Minv/x0: (B, Dz, H, W); D and
    Minv may be bf16.  Plain version on CPU tensors, the kernel on CUDA."""
    _check_block_b(block_b)
    if D.device.type == "cpu":
        return _cg3_plain(D, b, Minv, x0, iters)
    return _launch_cg3(D, b, Minv, x0, iters)


def _cg3_2(D, b, Minv, x0, lam0, ud, scale: float, iters: int,
           block_b: int = 1):
    """K4b: forward solve from x0, ḡ = scale·(x − u_data), adjoint solve
    from λ0.  Returns (x, λ).  Plain version on CPU tensors, the kernel on
    CUDA."""
    _check_block_b(block_b)
    if D.device.type == "cpu":
        return _cg3_2_plain(D, b, Minv, x0, lam0, ud, scale, iters)
    return _launch_cg3_2(D, b, Minv, x0, lam0, ud, scale, iters)


# ---------------------------------------------------------------------------
# Operand preparation
# ---------------------------------------------------------------------------


def _fold_bc_planes_3d(C, m):
    """Fold the BC elimination into the stencil: A(v) = m⊙v + p⊙K(p⊙v) has
    planes D_0 = m + p·C_0·p and D_k = p·C_k·shift(p, off_k); (…, 7, Dz,
    H, W) → (7, …, Dz, H, W)."""
    p = 1.0 - m
    planes = [m + p * C[..., 0, :, :, :] * p]
    for k, off in enumerate(OFFSETS3[1:], start=1):
        planes.append(p * C[..., k, :, :, :] * _shift3d(p, *off))
    return torch.stack(planes, dim=0)


def _prepare3(grid: StructuredGrid3, kappa, f, g, block_b=1,
              operand_dtype=None):
    """Kernel inputs: (C (B', 7, Dz, H, W), D (7, B, Dz, H, W), b, M⁻¹, x0,
    B), the last three (B, Dz, H, W), all contiguous and unpadded; D and
    M⁻¹ in ``operand_dtype`` when given.  The backward pass reuses C, D
    and M⁻¹, so it never re-assembles."""
    _check_block_b(block_b)
    C = stencil3d_coefficients(grid, kappa)
    if C.ndim == 4:
        C = C[None]
    if f.ndim == 3:
        f = f[None]
    B = max(C.shape[0], f.shape[0])
    shape = (B,) + grid.node_shape
    m = boundary_mask_box(grid, f.dtype, f.device)
    p = 1.0 - m
    mg = m * g
    b = (mg + p * (load_box(grid, f) - stencil3d_apply(C, mg))).expand(
        shape).contiguous()
    Minv = _jacobi(C, m).expand(shape).contiguous()
    x0 = mg.expand(shape).contiguous()
    D = _fold_bc_planes_3d(C.expand((B, 7) + grid.node_shape), m)
    if operand_dtype is not None:
        D, Minv = D.to(operand_dtype), Minv.to(operand_dtype)
    return C, D.contiguous(), b, Minv, x0, B


# ---------------------------------------------------------------------------
# Differentiable solve
# ---------------------------------------------------------------------------


class _SolveStructuredKernel3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, iters, block_b, operand_dtype, kappa, f, g):
        C, D, b, Minv, x0, B = _prepare3(grid, kappa, f, g, block_b,
                                         operand_dtype)
        x = _cg3(D, b, Minv, x0, iters, block_b)
        u = x[0] if f.ndim == 3 and x.shape[0] == 1 else x
        ctx.cfg = (grid, iters, block_b, B)
        ctx.prepared = (C, D, Minv)
        ctx.save_for_backward(kappa, f, g, u)
        return u

    @staticmethod
    def backward(ctx, gbar):
        # first order only, as the JAX custom VJP: refuse a graph of this
        # backward (create_graph) outright, since one that skipped λ's
        # dependence on κ would give wrong second derivatives without a word
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "the K4a route (solve_structured_kernel_3d) is differentiable "
                "once: its backward takes no create_graph; use "
                "solve_poisson_structured_3d for higher derivatives")
        grid, iters, block_b, B = ctx.cfg
        C, D, Minv = ctx.prepared
        kappa, f, g, u = ctx.saved_tensors
        # adjoint solve through the same kernel: A λ = ḡ (A symmetric, zero
        # initial guess) on the forward's prepared planes
        gb = (gbar if gbar.ndim == 4 else gbar[None]).expand(
            (B,) + grid.node_shape).contiguous()
        lam = _cg3(D, gb, Minv, torch.zeros_like(gb), iters, block_b)
        if gbar.ndim == 3:
            lam = lam[0]
        Cr = C[0] if (C.shape[0] == 1 and gbar.ndim == 3) else C
        gk, gf, gg = residual_vjp_manual_3d(grid, kappa, f, g, u, lam, C=Cr)
        return None, None, None, None, gk, gf, gg


def solve_structured_kernel_3d(grid: StructuredGrid3, kappa, f: torch.Tensor,
                               g: torch.Tensor, iters: int = 64,
                               block_b: int = 1,
                               operand_dtype=None) -> torch.Tensor:
    """Batched box Poisson solve on the whole-CG kernel K4a.

    kappa: per-tet field, flat (…, 6·nx·ny·nz) in FEMesh.box order or
    (…, nz, ny, nx, 6); f: node box or (B,) + node box; g: node box
    Dirichlet values.  Runs exactly ``iters`` Jacobi-PCG iterations per
    scenario (converged scenarios are NaN-safe).  ``operand_dtype=
    torch.bfloat16`` stores the folded planes and M⁻¹ in bf16; the adjoint
    uses the same stored operator.  Differentiable wrt κ, f and g: the
    backward runs one adjoint solve through K4a on the forward's prepared
    planes.
    """
    return _SolveStructuredKernel3d.apply(grid, int(iters), block_b,
                                          operand_dtype, kappa, f, g)


# ---------------------------------------------------------------------------
# Fused gradient step: both CG solves in one launch (K4b)
# ---------------------------------------------------------------------------


def fused_kappa_mse_step_3d_kernel(grid: StructuredGrid3, kappa,
                                   f: torch.Tensor, g: torch.Tensor,
                                   u_data: torch.Tensor,
                                   scale: Optional[float] = None,
                                   iters: int = 16, block_b: int = 1,
                                   warm_state=None,
                                   return_state: bool = False,
                                   operand_dtype=None):
    """Whole 3D per-tet-κ MSE gradient step in one K4b launch.

    For loss = scale/2 · Σ_{b,node} (u_b − u_data_b)² with
    u_b = A(κ_b)⁻¹ b(f, g, κ_b) (default ``scale = 2/(B·n_nodes)``, the
    mean), returns ``(loss_parts (B,), ∂κ, u)`` [+ the warm state when
    ``return_state``].  Both CG solves (forward and IFT adjoint) run in
    one launch; the κ cotangent comes from the closed-form residual VJP.
    Not differentiable: it is the gradient step.

    ``warm_state`` (a previous call's state) starts both solves from the
    previous (u, λ) instead of (m·g, 0).
    """
    batched = f.ndim == 4
    with torch.no_grad():
        C, D, b, Minv, x0, B = _prepare3(grid, kappa, f, g, block_b,
                                         operand_dtype)
        shape = (B,) + grid.node_shape
        if scale is None:
            scale = 2.0 / b.numel()
        ud = (u_data if u_data.ndim == 4 else u_data[None]).expand(shape)
        if warm_state is not None:
            x0, lam0 = warm_state
        else:
            lam0 = torch.zeros_like(b)
        x, lam = _cg3_2(D, b, Minv, x0, lam0, ud.contiguous(), float(scale),
                        iters, block_b)
        state = (x, lam)
        u = x
        diff = u - ud
        loss_parts = (diff * diff).sum(dim=(1, 2, 3))
        if not batched and u.shape[0] == 1:
            u, lam = u[0], lam[0]
            C = C[0] if C.shape[0] == 1 else C
        gk, _, _ = residual_vjp_manual_3d(grid, kappa, f, g, u, lam, C=C)
    if return_state:
        return loss_parts, gk, u, state
    return loss_parts, gk, u
