"""Kernel K6: the fused per-element-κ 1D grad step by Thomas elimination.

PyTorch counterpart of ``difffe_tpu/ops/pallas/fused_grad_thomas_kernel.py``.
The contract is K5b's (``fused_grad_kernel.fused_kappa_mse_step_general_pcr``):
κ_e (B, n_elements), F (B, n) or shared (n,), u_data (B, n) → (loss_parts
(B,), ∂κ (B, n_elements)), on a uniform mesh.  The two solves, forward and
adjoint, share ONE factorization: the sweep factors (c′_i, 1/b′_i) are
computed once and each solve is forward and back substitution.

The CUDA kernel (``csrc/fused_grad_thomas.cu``) runs one scenario per
thread; the plain PyTorch version below runs the same row recurrences on
(B,) vectors and is taken only for CPU tensors.  The TPU's (N, 8, B/8)
packing and its SMEM constant columns have no counterpart: the kernel reads
the caller's (B, n) rows, staged through shared memory.  ``block_lanes``
caps the scenarios a thread block holds.  Not differentiable: it is the
gradient step, and its outputs never require grad.
"""

from __future__ import annotations

from typing import Optional

import torch

from .fused_grad_kernel import (_as_dtype, _check_block_lanes, _check_planes,
                                _plane, check_cuda, general_constants,
                                rows_view, storage_code)

#: Kernel launches made by the wrapper.
launches = {"k6": 0}


def _k6_plain(kappa_e, F, ud, cols, inv_h: float, scale: float):
    """Plain version of K6: Thomas on (B,) rows → (loss (B,), ∂κ (B, ne))."""
    m, p, mg = (c.unbind() for c in cols[:3])
    B, n = ud.shape
    dtype = kappa_e.dtype
    zero = kappa_e.new_zeros(B)

    def ke(i):
        return kappa_e[:, i] if i < n - 1 else zero

    def f(i):
        return F[i] if F.ndim == 1 else F[:, i].to(dtype)

    def a_row(i):               # a_i = e_{i−1} = −κ_{i−1}/h · p_{i−1} p_i
        return ke(i - 1) * (-inv_h * p[i - 1] * p[i])

    def r_row(i):
        ke_prev = ke(i - 1) if i > 0 else zero
        mg_next = mg[i + 1] if i < n - 1 else 0.0
        mg_prev = mg[i - 1] if i > 0 else 0.0
        Kmg = ((ke_prev + ke(i)) * mg[i] - ke(i) * mg_next
               - ke_prev * mg_prev) * inv_h
        return mg[i] + p[i] * (f(i) - Kmg)

    # the factorization: cp_i = c′_i, bi_i = 1/b′_i
    bi = [1.0 / (m[0] + p[0] * ke(0) * inv_h)]
    cp = []
    for i in range(1, n):
        d_i = m[i] + p[i] * (ke(i - 1) + ke(i)) * inv_h
        cp.append(a_row(i) * bi[i - 1])
        bi.append(1.0 / (d_i - a_row(i) * cp[i - 1]))

    def solve(rhs):
        y = [rhs(0) * bi[0]]
        for i in range(1, n):
            y.append((rhs(i) - a_row(i) * y[i - 1]) * bi[i])
        for i in range(n - 2, -1, -1):
            y[i] = y[i] - cp[i] * y[i + 1]
        return y

    u = solve(r_row)
    loss = zero
    for i in range(n):
        d = u[i] - ud[:, i].to(dtype)
        loss = loss + d * d
    lam = solve(lambda i: scale * (u[i] - ud[:, i].to(dtype)))
    grad = [-inv_h * (p[e] * lam[e] - p[e + 1] * lam[e + 1])
            * ((mg[e] + p[e] * u[e]) - (mg[e + 1] + p[e + 1] * u[e + 1]))
            for e in range(n - 1)]
    return loss, torch.stack(grad, dim=1)


def _launch(kappa_e, F, ud, cols, inv_h: float, scale: float,
            block_lanes: int):
    from ._build import load_library

    dtype, dev = kappa_e.dtype, kappa_e.device
    check_cuda(dtype, dev, "K6", F, ud, cols)
    B, n = kappa_e.shape[0], ud.shape[-1]
    kap, sK = rows_view(kappa_e, n - 1)
    F, sF = rows_view(F, n)
    ud, sU = rows_view(ud, n)
    f_code = storage_code(F, dtype, "F")
    u_code = storage_code(ud, dtype, "u_data")
    loss = torch.empty(B, dtype=dtype, device=dev)
    grad = torch.empty((B, n - 1), dtype=dtype, device=dev)
    lib = load_library()
    is_double = int(dtype == torch.float64)
    with torch.cuda.device(dev):
        words = lib.difffe_thomas_workspace(B, n, block_lanes, is_double)
        ws = (torch.empty(words, dtype=dtype, device=dev) if words > 0
              else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.difffe_fused_thomas(
            kap.data_ptr(), sK, F.data_ptr(), sF, f_code, ud.data_ptr(), sU,
            u_code, cols.data_ptr(), loss.data_ptr(), grad.data_ptr(),
            None if ws is None else ws.data_ptr(), B, n, block_lanes,
            float(inv_h), float(scale), is_double, stream)
    if rc != 0:
        raise RuntimeError(f"K6 fused_thomas launch failed: CUDA error {rc}")
    launches["k6"] += 1
    return loss, grad


def fused_kappa_mse_step_general(mesh, kappa_e, F, u_data,
                                 scale: Optional[float] = None,
                                 block_lanes: int = 512,
                                 operand_dtype=None):
    """Fused loss-partials + ∂κ for per-element-κ 1D inversion (kernel K6).

    For every scenario b with per-element field κ_b (n_elements,):
    assemble T(κ_b), solve, MSE against u_data, adjoint through the SAME
    Thomas factorization, per-element gradient in closed form:

        loss_parts[b] = Σ_i (u_b − u_data_b)_i²
        grad[b]       = ∂/∂κ_b of  scale/2 · Σ_b loss_parts[b]

    κ_e: (B, n_elements); F: (B, n) or shared (n,) assembled load;
    u_data: (B, n).  Returns (loss_parts (B,), grad (B, n_elements)).
    ``operand_dtype=torch.bfloat16`` stores the streamed F and u_data
    planes in bf16 (a shared F stays in the mesh dtype); κ and all solve
    state stay in the mesh dtype.  Requires a uniform mesh.  Not
    differentiable: it is the gradient step.
    """
    dtype, dev = mesh.dtype, mesh.device
    cols, inv_h = general_constants(mesh)
    kappa_e = _as_dtype(kappa_e, dtype, dev)
    B, n = kappa_e.shape[0], mesh.n_nodes
    if tuple(kappa_e.shape) != (B, mesh.n_elements):
        raise ValueError(f"K6: κ_e must be (B, n_elements), got "
                         f"{tuple(kappa_e.shape)}")
    store = dtype if operand_dtype is None else operand_dtype
    F = torch.as_tensor(F, device=dev)
    F = F.to(dtype) if F.ndim == 1 else _plane(F, dtype, store, dev)
    u_data = _plane(u_data, dtype, store, dev)
    _check_planes(B, n, F, u_data, tuple(kappa_e.shape), "K6")
    block_lanes = _check_block_lanes(block_lanes)
    if scale is None:
        scale = 2.0 / (B * n)
    with torch.no_grad():
        if kappa_e.device.type == "cpu":
            return _k6_plain(kappa_e, F.expand(B, n) if F.ndim == 2 else F,
                             u_data.expand(B, n), cols, inv_h, float(scale))
        return _launch(kappa_e, F, u_data, cols, inv_h, scale, block_lanes)
