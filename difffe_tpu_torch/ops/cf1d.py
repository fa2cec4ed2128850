"""Closed-form prefix-sum solves for the 1-D per-element-κ FEM system.

PyTorch counterpart of ``difffe_tpu/ops/cf1d.py``.  With P1 elements and
Dirichlet at both chain ends, the element fluxes w_e = (κ_e/h_e)Δu_e
telescope (w_{e+1} = w_1 − Σ_{i≤e} F_i), so the tridiagonal solve is two
prefix sums and a rank-1 correction:

    s_e = h_e/κ_e,  P_e = Σ_{i<e} F_i,  S = cumsum(s),  T = cumsum(s·P)
    w_1 = ((u_R − u_L) + T_n)/S_n,      u_i = u_L + w_1·S_i − T_i.

The adjoint K λ = r is the same closed form (K is symmetric) and the
per-element gradient is elementwise in the two flux fields:
∂L/∂κ_e = −(h_e/κ_e²)·w_e·w_e^λ.  Plain autograd through ``torch.cumsum``
is exact here (the VJP of a cumsum is the reversed cumsum, which is the
closed-form adjoint), so no custom autograd function is needed.

This module is also the plain per-scenario-load path that ``fit_kappa``
takes when the forcing differs between scenarios.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .assembly import assemble_load

__all__ = [
    "mesh_supports_cf",
    "solve_poisson_cf_batched",
    "kappa_mse_step_cf",
]


def _element_widths(mesh) -> np.ndarray:
    """Element widths h_e as a host float64 array; nodes must be sorted."""
    nodes = mesh.nodes[:, 0].detach().cpu().numpy().astype(np.float64)
    hs = np.diff(nodes)
    if np.any(hs <= 0):
        raise ValueError("closed-form 1D solve requires sorted nodes")
    return hs


def mesh_supports_cf(mesh) -> bool:
    """True iff the closed-form chain solve applies: 1-D P1 mesh with
    Dirichlet exactly at the two endpoint nodes."""
    if mesh.dim != 1 or mesh.n_nodes != mesh.n_elements + 1:
        return False
    m = mesh.bc_mask.detach().cpu().numpy() > 0.5
    want = np.zeros_like(m)
    want[0] = want[-1] = True
    return bool(np.array_equal(m, want))


def _require_cf(mesh):
    if not mesh_supports_cf(mesh):
        raise ValueError(
            "closed-form 1D solve needs Dirichlet at exactly the two "
            "endpoint nodes (FEMesh.line factory meshes); use the "
            "tridiag path for general Dirichlet masks")


def _cf_solve_interior(s: torch.Tensor, F_int: torch.Tensor,
                       du: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Core closed form.  s: (B, ne) element resistances h_e/κ_e;
    F_int: (B, ne−1) interior load rows; du: (B,) u_R − u_L.
    Returns (u_int − u_L (B, ne−1), fluxes w (B, ne))."""
    P = torch.cat([s.new_zeros(s.shape[0], 1),
                   torch.cumsum(F_int, dim=-1)], dim=-1)
    S = torch.cumsum(s, dim=-1)
    T = torch.cumsum(s * P, dim=-1)
    w1 = (du + T[:, -1]) / S[:, -1]
    u_rel = w1[:, None] * S[:, :-1] - T[:, :-1]
    return u_rel, w1[:, None] - P


def _widths(mesh) -> torch.Tensor:
    return torch.as_tensor(_element_widths(mesh), dtype=mesh.dtype,
                           device=mesh.device)


def solve_poisson_cf_batched(mesh, kappa_e, f,
                             bc_values=None) -> torch.Tensor:
    """Exact batched 1-D solve by the closed-form chain factorization.

    kappa_e : (B, n_elements), or (n_elements,) promoted to B = 1.  The
        batch size B is taken from κ alone, as the JAX version does.
    f : (B, n_nodes) or (n_nodes,) nodal forcing (load assembled here).
    bc_values : optional (B, n_nodes) or (n_nodes,) Dirichlet values
        overriding ``mesh.bc_values`` (only the two end entries are read).
    Returns u (B, n_nodes); differentiable by autograd.
    """
    _require_cf(mesh)
    dt, dev = mesh.dtype, mesh.device
    kappa_e = torch.as_tensor(kappa_e, dtype=dt, device=dev)
    if kappa_e.ndim == 1:
        kappa_e = kappa_e[None]
    B = kappa_e.shape[0]
    f = torch.as_tensor(f, dtype=dt, device=dev)
    if f.ndim == 1:
        f = f[None]
    F = assemble_load(mesh, f).expand(B, mesh.n_nodes)
    bv = mesh.bc_values if bc_values is None else \
        torch.as_tensor(bc_values, dtype=dt, device=dev)
    if bv.ndim == 1:
        bv = bv[None]
    a = bv[:, 0].expand(B)
    b = bv[:, -1].expand(B)
    s = _widths(mesh)[None, :] / kappa_e
    u_rel, _ = _cf_solve_interior(s, F[:, 1:-1], b - a)
    return torch.cat([a[:, None], a[:, None] + u_rel, b[:, None]], dim=-1)


def kappa_mse_step_cf(mesh, kappa_e, F, u_data,
                      scale: Optional[float] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loss partials and ∂κ for per-element-κ 1-D inversion, closed form.

    κ_e (B, n_elements); F (B, n_nodes) or shared (n_nodes,) *assembled*
    load; u_data (B, n_nodes) or shared.  Returns

        loss_parts[b] = Σ_i (u_b − u_data_b)_i²            (B,)
        grad          = ∂/∂κ of  scale/2 · Σ_b loss_parts   (B, ne)

    with ``scale`` defaulting to 2/(B·n).
    """
    _require_cf(mesh)
    dt, dev = mesh.dtype, mesh.device
    kappa_e = torch.as_tensor(kappa_e, dtype=dt, device=dev)
    B, ne = kappa_e.shape
    n = mesh.n_nodes
    if scale is None:
        scale = 2.0 / (B * n)
    F = torch.as_tensor(F, dtype=dt, device=dev)
    if F.ndim == 1:
        F = F[None]
    u_data = torch.as_tensor(u_data, dtype=dt, device=dev)
    if u_data.ndim == 1:
        u_data = u_data[None]

    a = mesh.bc_values[0].expand(B)
    b = mesh.bc_values[-1].expand(B)
    hs = _widths(mesh)
    s = hs[None, :] / kappa_e
    u_rel, w = _cf_solve_interior(s, F[:, 1:-1].expand(B, ne - 1), b - a)
    u = torch.cat([a[:, None], a[:, None] + u_rel, b[:, None]], dim=-1)
    d = u - u_data
    loss_parts = (d * d).sum(dim=-1)

    # adjoint: K λ = scale·d on interior nodes, λ = 0 at the ends
    _, wl = _cf_solve_interior(s, scale * d[:, 1:-1], torch.zeros_like(a))
    grad = -(s * s / hs[None, :]) * w * wl
    return loss_parts, grad
