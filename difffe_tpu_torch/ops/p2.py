"""Quadratic (P2) elements on lines and triangles.

PyTorch counterpart of ``difffe_tpu/ops/p2.py``.  The element family is
read from the connectivity width (ops/assembly.py: dim 1 with 3 nodes a
P2 line, dim 2 with 6 nodes a P2 triangle), and everything goes through
the same gather → local blocks → scatter-add as P1, batched over leading
axes of κ and f and differentiable:

* P2 lines (ends and midpoint): the exact local stiffness
  κ/(3h)·[[7,−8,1],[−8,16,−8],[1,−8,7]] and the consistent load
  h/30·[[4,2,−1],[2,16,2],[−1,2,4]]·f;
* P2 triangles (vertices, then the midpoints of edges 12, 23, 31): the
  stiffness and the load by the three-edge-midpoint rule, exact for the
  degree-2 integrands on straight triangles, and the HRZ lumped mass
  (row sums vanish at the vertices).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..mesh import FEMesh, _device, default_dtype
from .assembly import (DEGENERATE_AREA_TOL, kappa_on_elements,
                       scatter_add_nodes)

# barycentric coordinates of the three edge midpoints
_MID_QUAD = ((0.5, 0.5, 0.0), (0.0, 0.5, 0.5), (0.5, 0.0, 0.5))


# ---------------------------------------------------------------------------
# 1D P2
# ---------------------------------------------------------------------------


def element_length_p2(mesh: FEMesh) -> torch.Tensor:
    x = mesh.nodes[:, 0]
    return x[mesh.elements[:, 2]] - x[mesh.elements[:, 0]]


def local_stiffness_p2_1d(mesh: FEMesh, kappa) -> torch.Tensor:
    """(…, ne, 3, 3) local stiffness blocks κ_e/(3h_e)·S."""
    h = element_length_p2(mesh)
    ke = kappa_on_elements(mesh, kappa)
    S = torch.tensor([[7.0, -8.0, 1.0], [-8.0, 16.0, -8.0],
                      [1.0, -8.0, 7.0]], dtype=mesh.dtype, device=mesh.device)
    return (ke / (3.0 * h))[..., None, None] * S


def load_p2_1d(mesh: FEMesh, f) -> torch.Tensor:
    """Consistent P2 load F_e = M_e f_e, M_e = h/30·[[4,2,−1],…]."""
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    h = element_length_p2(mesh)
    M = torch.tensor([[4.0, 2.0, -1.0], [2.0, 16.0, 2.0],
                      [-1.0, 2.0, 4.0]], dtype=mesh.dtype, device=mesh.device)
    Fe = torch.einsum("pq,...eq->...ep", M, f[..., mesh.elements]) \
        * (h / 30.0)[:, None]
    return scatter_add_nodes(mesh, Fe)


# ---------------------------------------------------------------------------
# 2D P2
# ---------------------------------------------------------------------------


def _p1_geometry_from_vertices(mesh: FEMesh):
    """b, c, area from the triangles' three vertex nodes."""
    p = mesh.nodes[mesh.elements[:, :3]]           # (ne, 3, 2)
    x, y = p[..., 0], p[..., 1]
    xi, xj, xk = x[:, 0], x[:, 1], x[:, 2]
    yi, yj, yk = y[:, 0], y[:, 1], y[:, 2]
    area = 0.5 * ((xj - xi) * (yk - yi) - (xk - xi) * (yj - yi)).abs()
    b = torch.stack([yj - yk, yk - yi, yi - yj], dim=1)
    c = torch.stack([xk - xj, xi - xk, xj - xi], dim=1)
    return b, c, area


def _p2_shape_gradients(b, c, area, lam) -> torch.Tensor:
    """∇N_a (ne, 6, 2) at one barycentric point ``lam`` (3 floats): vertex
    a (4λ_a − 1)∇λ_a, edge (a, b) 4(λ_a∇λ_b + λ_b∇λ_a), ∇λ_a =
    (b_a, c_a)/(2A); degenerate triangles divide by 1, not 0."""
    safe_area = torch.where(area < DEGENERATE_AREA_TOL,
                            torch.ones_like(area), area)
    grad_lam = torch.stack([b, c], dim=-1) / (2.0 * safe_area)[:, None,
                                                                None]
    vert = torch.stack([(4.0 * lam[a] - 1.0) * grad_lam[:, a]
                        for a in range(3)], dim=1)
    mids = torch.stack([4.0 * (lam[a] * grad_lam[:, e]
                               + lam[e] * grad_lam[:, a])
                        for a, e in ((0, 1), (1, 2), (2, 0))], dim=1)
    return torch.cat([vert, mids], dim=1)


def _p2_shape_values(lam, dtype, device) -> torch.Tensor:
    """N_a(λ) of the six P2 shape functions at one barycentric point."""
    l0, l1, l2 = lam
    return torch.tensor([l0 * (2 * l0 - 1), l1 * (2 * l1 - 1),
                         l2 * (2 * l2 - 1), 4 * l0 * l1, 4 * l1 * l2,
                         4 * l2 * l0], dtype=dtype, device=device)


def local_stiffness_p2_2d(mesh: FEMesh, kappa) -> torch.Tensor:
    """(…, ne, 6, 6) local stiffness by the exact three-midpoint rule."""
    b, c, area = _p1_geometry_from_vertices(mesh)
    ke = kappa_on_elements(mesh, kappa)
    w = area / 3.0
    K = 0.0
    for lam in _MID_QUAD:
        G = _p2_shape_gradients(b, c, area, lam)
        K = K + w[:, None, None] * torch.einsum("ead,ebd->eab", G, G)
    scale = torch.where(area < DEGENERATE_AREA_TOL, torch.zeros_like(ke), ke)
    return scale[..., None, None] * K


def lumped_mass_p2_2d(mesh: FEMesh) -> torch.Tensor:
    """HRZ lumped mass (n_nodes,) of P2 triangles: A·3/57 at each vertex,
    A·16/57 at each midside node (row sums are zero at the vertices)."""
    _, _, area = _p1_geometry_from_vertices(mesh)
    area = torch.where(area < DEGENERATE_AREA_TOL, torch.zeros_like(area),
                       area)
    w = torch.stack([area * (3.0 / 57.0)] * 3 + [area * (16.0 / 57.0)] * 3,
                    dim=-1)
    return scatter_add_nodes(mesh, w)


def load_p2_2d(mesh: FEMesh, f) -> torch.Tensor:
    """Load by the three-midpoint rule (exact for degree-2 integrands)."""
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    _, _, area = _p1_geometry_from_vertices(mesh)
    area = torch.where(area < DEGENERATE_AREA_TOL, torch.zeros_like(area),
                       area)
    fe = f[..., mesh.elements]                     # (..., ne, 6)
    w = area / 3.0
    Fe = 0.0
    for lam in _MID_QUAD:
        N = _p2_shape_values(lam, mesh.dtype, mesh.device)
        contrib = w * torch.einsum("a,...ea->...e", N, fe)
        Fe = Fe + N * contrib[..., None]
    return scatter_add_nodes(mesh, Fe)


# ---------------------------------------------------------------------------
# Mesh factories
# ---------------------------------------------------------------------------


def line_p2(n_elements: int = 10, x_left: float = 0.0, x_right: float = 1.0,
            bc_left: Optional[float] = 0.0, bc_right: Optional[float] = 0.0,
            dtype: Optional[torch.dtype] = None, device=None) -> FEMesh:
    """Uniform 1D P2 mesh: 2N+1 nodes, elements (2i, 2i+1, 2i+2),
    Dirichlet at each end whose value is not None."""
    mesh = FEMesh.line(2 * n_elements, x_left, x_right, bc_left, bc_right,
                       dtype=dtype, device=device)
    i = 2 * torch.arange(n_elements, device=mesh.device)
    return FEMesh(nodes=mesh.nodes,
                  elements=torch.stack([i, i + 1, i + 2], dim=1),
                  bc_mask=mesh.bc_mask, bc_values=mesh.bc_values)


def rectangle_p2(nx: int = 4, ny: int = 4, x_range=(0.0, 1.0),
                 y_range=(0.0, 1.0), bc_value: float = 0.0,
                 dtype: Optional[torch.dtype] = None, device=None) -> FEMesh:
    """2D P2 triangulated grid on the (2nx+1)×(2ny+1) refined node
    lattice: the coarse quads and split of ``FEMesh.rectangle``, each
    triangle [v1, v2, v3, m12, m23, m31]; Dirichlet on the boundary, found
    by index; no grid metadata."""
    dtype = dtype or default_dtype()
    device = _device(device)
    NX, NY = 2 * nx + 1, 2 * ny + 1
    xs = torch.linspace(x_range[0], x_range[1], NX, dtype=dtype,
                        device=device)
    ys = torch.linspace(y_range[0], y_range[1], NY, dtype=dtype,
                        device=device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    nodes = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)

    def nid(r, c):
        return (r * NX + c).reshape(-1)

    i = 2 * torch.arange(ny, device=device)[:, None]
    j = 2 * torch.arange(nx, device=device)[None, :]
    a, b = nid(i, j), nid(i, j + 2)
    c, d = nid(i + 2, j + 2), nid(i + 2, j)
    m_ab, m_bd, m_da = nid(i, j + 1), nid(i + 1, j + 1), nid(i + 1, j)
    m_bc, m_cd = nid(i + 1, j + 2), nid(i + 2, j + 1)
    lower = torch.stack([a, b, d, m_ab, m_bd, m_da], dim=1)
    upper = torch.stack([b, c, d, m_bc, m_cd, m_bd], dim=1)
    elements = torch.stack([lower, upper], dim=1).reshape(-1, 6)
    rows = torch.arange(NY, device=device)[:, None]
    cols = torch.arange(NX, device=device)[None, :]
    bc_mask = ((rows == 0) | (rows == NY - 1) | (cols == 0)
               | (cols == NX - 1)).reshape(-1).to(dtype)
    return FEMesh(nodes=nodes, elements=elements, bc_mask=bc_mask,
                  bc_values=bc_mask * bc_value)
