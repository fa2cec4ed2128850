"""Kernel K7: the scalar-κ 1D grad step as two dense products with W = Ã⁻¹.

PyTorch counterpart of ``difffe_tpu/ops/pallas/fused_grad_mxu_kernel.py``.
For one scalar κ per scenario the Dirichlet-eliminated system factors
exactly as T̃(κ) = D_κ Ã with D_κ = diag(m + κ·p) and Ã = T̃(κ = 1), so with
W = Ã⁻¹ computed once per mesh (in float64 on the host, then cast)

    u = W (D_κ⁻¹ r),   λ = W (D_κ⁻¹ ḡ)        (T̃ symmetric)

and the step is elementwise work around two (n × n)·(n × B) products.  The
bodies of the JAX module are kept as ``version``:

* 1 — explicit right-hand side and the four-term κ contraction;
* 2 — the folded right-hand side D_κ⁻¹r = (m g − t₀) + κ⁻¹ p F, and
  ∂log κ = −scale · Σ λ ⊙ p F;
* 3 — version 2 with ``refine`` tridiagonal residual passes per solve,
  u ← u + W (y − T̃₁ u).  On the TPU they repaired bf16 single-pass
  products; here every product is full float32, and the passes repair
  the float32 rounding of W instead: each residual is formed in float64
  and rounded once (mixed-precision refinement), so the passes converge
  to the solution of the float32 system; a float32 residual, as the TPU
  body forms it, would add rounding noise of the size it removes
  (``difffe_tpu_torch/probes/k7_residual.py`` measures both on the card).

The CUDA kernel (``csrc/fused_grad_mxu.cu``) holds W in shared memory and
runs one scenario per thread; the plain PyTorch version below, taken only
for CPU tensors, uses ``torch.matmul``.  Meshes above ``MXU_MAX_NODES``
nodes go to kernel K5a (``fused_grad_kernel.fused_kappa_mse_step``), as in
the JAX module.  The TPU's probe-only ablation switches (``_V2_PRECISION``,
``_V2_SKIP_MATMUL``) are not carried over: K7's ablations, the port of the
TPU probe ``scripts/probe_mxu_kernel.py``, are kernels of their own
(``difffe_tpu_torch/probes/k7_ablation.py``, ``csrc/k7_ablation.cu``).
Not differentiable: it is the gradient step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import fused_grad_kernel as _k5
from ..tridiag import _shift_down, _shift_up
from .fused_grad_kernel import (_as_dtype, _check_block_lanes,
                                _check_planes, _plane, check_cuda,
                                mesh_constants, rows_view, scalar_columns,
                                storage_code)

# Largest mesh the dense-inverse path takes before routing to K5a (the JAX
# module's cutoff: its matmul parity was validated up to N ≈ 136, and W
# grows as n²).
MXU_MAX_NODES = 136

#: Kernel launches made by the wrapper.
launches = {"k7": 0}


def _inverse(mesh) -> torch.Tensor:
    """W = Ã⁻¹ of the unit-κ eliminated system, inverted in float64 on the
    host and cast to the mesh dtype, on the mesh's device."""
    m, _, d0, _, c0 = scalar_columns(mesh)[:5].cpu().numpy().astype(
        np.float64)
    e = c0[:-1]
    A = np.diag(m + d0) + np.diag(e, 1) + np.diag(e, -1)
    return torch.as_tensor(np.linalg.inv(A), dtype=mesh.dtype,
                           device=mesh.device).contiguous()


def mxu_inverse(mesh) -> torch.Tensor:
    """Cached :func:`_inverse` of ``mesh``."""
    return mesh_constants(mesh, "mxu_inverse", _inverse)


def _k7_plain(log_k, F, ud, cols, W, scale: float, version: int,
              refine: int):
    """Plain version of K7 on (B, n) rows: (loss (B,), ∂log κ (B,))."""
    m, p, d0, a0, c0, mg, t0, rhs0 = cols
    dtype = cols.dtype
    f, ud = F.to(dtype), ud.to(dtype)
    kappa = torch.exp(log_k)[:, None]
    kinv = 1.0 / kappa
    dinv = m + p * kinv

    def solve(y):
        u = y @ W.T
        if version == 3:
            md, a0d, c0d = (m + d0).double(), a0.double(), c0.double()
            for _ in range(refine):
                # the residual y − T̃₁u in float64, rounded once
                u64 = u.double()
                T1u = (md * u64 + a0d * _shift_up(u64, 1, 0.0)
                       + c0d * _shift_down(u64, 1, 0.0))
                u = u + (y.double() - T1u).to(dtype) @ W.T
        return u

    if version == 1:
        r = mg + p * f - kappa * t0
        u = solve(dinv * r)
        diff = u - ud
        lam = solve(dinv * diff)
        u_im1, u_ip1 = _shift_up(u, 1, 0.0), _shift_down(u, 1, 0.0)
        gk = -(lam * (t0 + a0 * u_im1 + d0 * u + c0 * u_ip1)).sum(-1)
        return (diff * diff).sum(-1), (scale * kappa[:, 0]) * gk
    pf = p * f
    u = solve(rhs0 + kinv * pf)
    diff = u - ud
    lam = solve(dinv * diff)
    return (diff * diff).sum(-1), -scale * (lam * pf).sum(-1)


def _launch(log_k, F, ud, cols, W, scale: float, version: int, refine: int,
            block_lanes: int):
    from ._build import load_library

    dtype, dev = log_k.dtype, log_k.device
    check_cuda(dtype, dev, "K7", F, ud, cols, W)
    B, n = log_k.shape[0], ud.shape[-1]
    lk, sL = rows_view(log_k[:, None], 1)
    F, sF = rows_view(F, n)
    ud, sU = rows_view(ud, n)
    f_code = storage_code(F, dtype, "F")
    u_code = storage_code(ud, dtype, "u_data")
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty(B, dtype=dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_fused_mxu(
            lk.data_ptr(), sL, F.data_ptr(), sF, f_code, ud.data_ptr(), sU,
            u_code, cols.data_ptr(), W.data_ptr(), loss.data_ptr(),
            grad.data_ptr(), B, n, block_lanes, version, refine,
            float(scale), int(dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"K7 fused_mxu launch failed: CUDA error {rc}")
    launches["k7"] += 1
    return loss, grad


def fused_kappa_mse_step_mxu(mesh, log_k, F, u_data,
                             scale: Optional[float] = None,
                             block_lanes: int = 1024,
                             operand_dtype=None, version: int = 2,
                             refine: int = 3):
    """Dense-inverse variant of ``fused_kappa_mse_step`` — per-scenario
    scalar κ only (kernel K7).

    Same contract and return values as
    ``fused_grad_kernel.fused_kappa_mse_step``: (loss_parts (B,),
    ∂log κ (B,)) for the objective scale/2 · Σ_b ‖u_b − u_data_b‖², with
    ``scale`` defaulting to 2/(B·n).  ``F`` of shape (n,) is one load
    shared by the batch (read in place, never streamed per scenario);
    ``operand_dtype=torch.bfloat16`` stores the streamed u_data (and a
    per-scenario F) in bf16, with float32 compute — compare against a
    reference fed the same quantized data.  ``version`` 1/2/3 and
    ``refine`` select the body (module note).  Meshes above
    ``MXU_MAX_NODES`` nodes route to K5a, which ignores ``operand_dtype``.
    """
    if version not in (1, 2, 3):
        raise ValueError(f"version must be 1, 2 or 3, got {version}")
    if int(refine) < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    dtype, dev = mesh.dtype, mesh.device
    log_k = _as_dtype(log_k, dtype, dev)
    B, n = log_k.shape[0], mesh.n_nodes
    if scale is None:
        scale = 2.0 / (B * n)
    if n > MXU_MAX_NODES:
        return _k5.fused_kappa_mse_step(mesh, log_k, F, u_data, scale=scale)
    store = dtype if operand_dtype is None else operand_dtype
    F = torch.as_tensor(F, device=dev)
    F = F.to(dtype) if F.ndim == 1 else _plane(F, dtype, store, dev)
    u_data = _plane(u_data, dtype, store, dev)
    _check_planes(B, n, F, u_data, tuple(log_k.shape), "K7")
    block_lanes = _check_block_lanes(block_lanes)
    cols, W = scalar_columns(mesh), mxu_inverse(mesh)
    with torch.no_grad():
        if log_k.device.type == "cpu":
            return _k7_plain(log_k, F, u_data.expand(B, n), cols, W,
                             float(scale), version, int(refine))
        return _launch(log_k, F, u_data, cols, W, scale, version,
                       int(refine), block_lanes)
