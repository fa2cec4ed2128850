"""Vectorized finite-element assembly: stiffness K, load F, lumped mass.

PyTorch counterpart of ``difffe_tpu/ops/assembly.py``: gather element
values, build per-element local matrices, scatter-add (``index_add``).
Leading batch axes of κ, f and u are kept where the JAX package
``vmap``s.  Semantics kept:

* P1 lines: local stiffness κ_e/h_e·[[1,-1],[-1,1]] and the trapezoidal
  nodal load F_i += h_e/2·f_i; the dense stiffness and the bands in their
  banded fast forms;
* P1 triangles: K_e[p,q] = κ_e(b_p b_q + c_p c_q)/(4A_e), or
  (b_p, c_p) A_e (b_q, c_q)ᵀ/(4A_e) for a diffusion tensor A, and the
  centroid load F_p += A_e/3·mean(f over the element);
* P1 tetrahedra: K_e[p,q] = κ_e V_e ∇φ_p·∇φ_q (V_e ∇φ_p A_e ∇φ_q for a
  tensor), the gradients from the edge-vector cross products, and the
  centroid load F_p += V_e/4·mean(f);
* P2 lines and triangles: ops/p2.py;
* degenerate elements (area or |det| below 1e-15) contribute nothing,
  through ``where`` guards that keep node-coordinate gradients finite:
  node coordinates are not detached, so ∂/∂nodes flows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

from ..mesh import FEMesh

DEGENERATE_AREA_TOL = 1e-15

_FAMILIES = {(1, 2): "p1_line", (1, 3): "p2_line", (2, 3): "p1_tri",
             (2, 6): "p2_tri", (3, 4): "p1_tet"}


def element_family(mesh: FEMesh) -> str:
    """'p1_line' | 'p2_line' | 'p1_tri' | 'p2_tri' | 'p1_tet' from (dim,
    nodes/elem)."""
    key = (mesh.dim, mesh.elements.shape[1])
    if key in _FAMILIES:
        return _FAMILIES[key]
    raise NotImplementedError(
        f"unsupported element family: dim={key[0]}, nodes/elem={key[1]}")


# ---------------------------------------------------------------------------
# κ normalization
# ---------------------------------------------------------------------------


def kappa_on_elements(mesh: FEMesh, kappa) -> torch.Tensor:
    """Normalize κ to per-element values ``(..., n_elements)``.

    Accepts a scalar, per-element ``(..., n_elements)``, or per-node
    ``(..., n_nodes)`` (averaged over each element's nodes).
    """
    kappa = torch.as_tensor(kappa, dtype=mesh.dtype, device=mesh.device)
    if is_tensor_kappa(mesh, kappa):
        raise ValueError(
            "tensor-valued kappa reached a scalar-diffusion path; tensor "
            "diffusivity is supported on P1 triangle/tetrahedral meshes "
            "via method='dense'/'lu'/'cg' only (the structured stencil "
            "reductions are isotropic-only — method='auto' already routes "
            "tensor κ to the general paths)")
    ne, nn = mesh.n_elements, mesh.n_nodes
    if kappa.ndim == 0:
        return kappa.expand(ne)
    if kappa.shape[-1] == ne:
        return kappa
    if kappa.shape[-1] == nn:
        return kappa[..., mesh.elements].mean(dim=-1)
    raise ValueError(
        f"kappa shape {tuple(kappa.shape)} matches neither "
        f"n_elements={ne} nor n_nodes={nn}")


def is_tensor_kappa(mesh: FEMesh, kappa) -> bool:
    """True when κ is a dim×dim diffusion tensor: any shape with trailing
    dims (d, d) on a 2D/3D mesh."""
    shape = tuple(torch.as_tensor(kappa).shape)
    d = mesh.dim
    return d in (2, 3) and len(shape) >= 2 and shape[-2:] == (d, d)


def kappa_tensor_on_elements(mesh: FEMesh, A) -> torch.Tensor:
    """Normalize a diffusion tensor to per-element ``(..., n_elements, d,
    d)``: constant (d, d), per-element (..., n_elements, d, d) or per-node
    (..., n_nodes, d, d) (averaged over each element's vertices)."""
    A = torch.as_tensor(A, dtype=mesh.dtype, device=mesh.device)
    ne, nn, d = mesh.n_elements, mesh.n_nodes, mesh.dim
    if A.ndim == 2:
        return A.expand(ne, d, d)
    if A.shape[-3] == ne:
        return A
    if A.shape[-3] == nn:
        return A[..., mesh.elements, :, :].mean(dim=-3)
    raise ValueError(
        f"tensor kappa shape {tuple(A.shape)} matches neither "
        f"(n_elements={ne}, {d}, {d}) nor (n_nodes={nn}, {d}, {d})")


# ---------------------------------------------------------------------------
# Per-element geometry and local matrices
# ---------------------------------------------------------------------------


def element_geometry_1d(mesh: FEMesh) -> torch.Tensor:
    """Element lengths h_e = x_j − x_i (signed)."""
    x = mesh.nodes[:, 0]
    return x[mesh.elements[:, 1]] - x[mesh.elements[:, 0]]


def element_geometry_2d(mesh: FEMesh):
    """P1 triangle geometry ``(b, c, area)``: b, c (n_elements, 3) the
    basis-gradient coefficients of φ_p = (a_p + b_p x + c_p y)/(2A), area
    (n_elements,) unsigned."""
    p = mesh.nodes[mesh.elements]                  # (ne, 3, 2)
    x, y = p[..., 0], p[..., 1]
    xi, xj, xk = x[:, 0], x[:, 1], x[:, 2]
    yi, yj, yk = y[:, 0], y[:, 1], y[:, 2]
    area = 0.5 * ((xj - xi) * (yk - yi) - (xk - xi) * (yj - yi)).abs()
    b = torch.stack([yj - yk, yk - yi, yi - yj], dim=1)
    c = torch.stack([xk - xj, xi - xk, xj - xi], dim=1)
    return b, c, area


def element_geometry_3d(mesh: FEMesh):
    """P1 tetrahedron geometry ``(grads, volume)``: grads (n_elements, 4,
    3) the constant basis gradients, from e_i = p_i − p_0,
    det = e_1·(e_2×e_3): ∇φ_1 = (e_2×e_3)/det, ∇φ_2 = (e_3×e_1)/det,
    ∇φ_3 = (e_1×e_2)/det, ∇φ_0 = −(∇φ_1+∇φ_2+∇φ_3); volume |det|/6.
    Degenerate tets (|det| < 1e-15) get zero gradients."""
    p = mesh.nodes[mesh.elements]                  # (ne, 4, 3)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    e3 = p[:, 3] - p[:, 0]
    c23 = torch.linalg.cross(e2, e3)
    det = (e1 * c23).sum(dim=-1)
    vol = det.abs() / 6.0
    degenerate = det.abs() < DEGENERATE_AREA_TOL
    safe_det = torch.where(degenerate, torch.ones_like(det), det)[:, None]
    g1 = c23 / safe_det
    g2 = torch.linalg.cross(e3, e1) / safe_det
    g3 = torch.linalg.cross(e1, e2) / safe_det
    g0 = -(g1 + g2 + g3)
    grads = torch.stack([g0, g1, g2, g3], dim=1)
    grads = torch.where(degenerate[:, None, None], torch.zeros_like(grads),
                        grads)
    return grads, vol


def local_stiffness_2d(mesh: FEMesh, kappa) -> torch.Tensor:
    """Per-element 3×3 triangle stiffness blocks ``(..., n_elements, 3,
    3)``, scalar/field or tensor κ; zero for degenerate triangles."""
    b, c, area = element_geometry_2d(mesh)
    tiny = area < DEGENERATE_AREA_TOL
    safe_area = torch.where(tiny, torch.ones_like(area), area)
    if is_tensor_kappa(mesh, kappa):
        A = kappa_tensor_on_elements(mesh, kappa)
        g = torch.stack([b, c], dim=-1)            # (ne, 3, 2)
        gram = torch.einsum("epi,...eij,eqj->...epq", g, A, g)
        scale = torch.where(tiny, torch.zeros_like(area),
                            1.0 / (4.0 * safe_area))
        return scale[:, None, None] * gram
    ke = kappa_on_elements(mesh, kappa)
    gram = b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]
    scale = torch.where(tiny, torch.zeros_like(ke), ke / (4.0 * safe_area))
    return scale[..., None, None] * gram


def local_stiffness_3d(mesh: FEMesh, kappa) -> torch.Tensor:
    """Per-element 4×4 tet stiffness blocks ``(..., n_elements, 4, 4)``:
    κ_e V_e ∇φ_p·∇φ_q, or V_e ∇φ_p A_e ∇φ_q for a tensor."""
    grads, vol = element_geometry_3d(mesh)
    if is_tensor_kappa(mesh, kappa):
        A = kappa_tensor_on_elements(mesh, kappa)
        gram = torch.einsum("epi,...eij,eqj->...epq", grads, A, grads)
        return vol[:, None, None] * gram
    ke = kappa_on_elements(mesh, kappa)
    gram = torch.einsum("epi,eqi->epq", grads, grads)
    return (ke * vol)[..., None, None] * gram


def local_stiffness(mesh: FEMesh, kappa) -> torch.Tensor:
    """Per-element stiffness blocks ``(..., n_elements, k, k)`` of any
    supported family."""
    fam = element_family(mesh)
    if fam == "p1_line":
        ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
        S = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=mesh.dtype,
                         device=mesh.device)
        return ke[..., None, None] * S
    if fam == "p1_tri":
        return local_stiffness_2d(mesh, kappa)
    if fam == "p1_tet":
        return local_stiffness_3d(mesh, kappa)
    from . import p2
    if fam == "p2_line":
        return p2.local_stiffness_p2_1d(mesh, kappa)
    return p2.local_stiffness_p2_2d(mesh, kappa)


# ---------------------------------------------------------------------------
# Dense assembly, load and mass
# ---------------------------------------------------------------------------


def dense_from_local(mesh: FEMesh, Ke: torch.Tensor) -> torch.Tensor:
    """Scatter per-element blocks (…, ne, k, k) into dense (…, n, n)."""
    n = mesh.n_nodes
    k = Ke.shape[-1]
    elems = mesh.elements
    rows = elems.repeat_interleave(k, dim=1).reshape(-1)
    cols = elems.repeat(1, k).reshape(-1)
    lead = Ke.shape[:-3]
    K = Ke.new_zeros(lead + (n * n,))
    K = K.index_add(-1, rows * n + cols, Ke.reshape(lead + (-1,)))
    return K.reshape(lead + (n, n))


def assemble_stiffness_dense(mesh: FEMesh, kappa) -> torch.Tensor:
    """Dense stiffness matrix (…, n_nodes, n_nodes), no BCs applied; the
    banded fast form of the generic scatter for P1 lines."""
    if element_family(mesh) != "p1_line":
        return dense_from_local(mesh, local_stiffness(mesh, kappa))
    n = mesh.n_nodes
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    i, j = mesh.elements[:, 0], mesh.elements[:, 1]
    K = ke.new_zeros(ke.shape[:-1] + (n * n,))
    K = K.index_add(-1, i * n + i, ke).index_add(-1, j * n + j, ke)
    K = K.index_add(-1, i * n + j, -ke).index_add(-1, j * n + i, -ke)
    return K.reshape(ke.shape[:-1] + (n, n))


def scatter_add_nodes(mesh: FEMesh, Fe: torch.Tensor) -> torch.Tensor:
    """Add per-element node values (…, n_elements, k) into (…, n_nodes)."""
    out = Fe.new_zeros(Fe.shape[:-2] + (mesh.n_nodes,))
    for p in range(mesh.elements.shape[1]):
        out = out.index_add(-1, mesh.elements[:, p], Fe[..., p])
    return out


def _scatter_elements(mesh: FEMesh, contrib: torch.Tensor) -> torch.Tensor:
    """Add each element's value (…, n_elements) to each of its nodes."""
    k = mesh.elements.shape[1]
    return scatter_add_nodes(mesh, contrib[..., None].expand(
        contrib.shape + (k,)))


def assemble_load(mesh: FEMesh, f) -> torch.Tensor:
    """Load vector F from nodal forcing ``f`` (..., n_nodes), leading
    batch axes kept: the trapezoidal nodal rule on P1 lines, the centroid
    rule on triangles (A_e/3) and tetrahedra (V_e/4), the consistent
    rules of ops/p2.py on P2 elements."""
    f = torch.as_tensor(f, dtype=mesh.dtype, device=mesh.device)
    fam = element_family(mesh)
    if fam in ("p2_line", "p2_tri"):
        from . import p2
        return (p2.load_p2_1d if fam == "p2_line" else p2.load_p2_2d)(mesh,
                                                                      f)
    if fam == "p1_line":
        h = element_geometry_1d(mesh)
        i, j = mesh.elements[:, 0], mesh.elements[:, 1]
        F = f.new_zeros(f.shape[:-1] + (mesh.n_nodes,))
        F = F.index_add(-1, i, h / 2.0 * f[..., i])
        return F.index_add(-1, j, h / 2.0 * f[..., j])
    fe = f[..., mesh.elements].mean(dim=-1)        # (..., ne)
    if fam == "p1_tri":
        _, _, area = element_geometry_2d(mesh)
        area = torch.where(area < DEGENERATE_AREA_TOL,
                           torch.zeros_like(area), area)
        return _scatter_elements(mesh, (area / 3.0) * fe)
    _, vol = element_geometry_3d(mesh)
    return _scatter_elements(mesh, (vol / 4.0) * fe)


def assemble_lumped_mass(mesh: FEMesh) -> torch.Tensor:
    """Lumped mass entries (n_nodes,): row sums ``assemble_load(mesh, 1)``,
    HRZ scaling on P2 triangles (their vertex row sums are zero)."""
    if element_family(mesh) == "p2_tri":
        from .p2 import lumped_mass_p2_2d
        return lumped_mass_p2_2d(mesh)
    return assemble_load(mesh, torch.ones(mesh.n_nodes, dtype=mesh.dtype,
                                          device=mesh.device))


# ---------------------------------------------------------------------------
# Matrix-free operator
# ---------------------------------------------------------------------------


def element_apply(mesh: FEMesh, Ke: torch.Tensor,
                  u: torch.Tensor) -> torch.Tensor:
    """Matrix-free K·u from per-element blocks Ke (…, ne, k, k): gather
    the element values of u (…, n_nodes), apply the blocks, scatter-add.
    Leading axes of Ke and u broadcast."""
    kue = torch.einsum("...epq,...eq->...ep", Ke, u[..., mesh.elements])
    return scatter_add_nodes(mesh, kue)


def stiffness_apply(mesh: FEMesh, kappa, u: torch.Tensor) -> torch.Tensor:
    """Matrix-free K(κ)·u for any supported family, batched over leading
    axes."""
    if element_family(mesh) != "p1_line":
        return element_apply(mesh, local_stiffness(mesh, kappa), u)
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    i, j = mesh.elements[:, 0], mesh.elements[:, 1]
    du = ke * (u[..., i] - u[..., j])
    out = du.new_zeros(du.shape[:-1] + (mesh.n_nodes,))
    return out.index_add(-1, i, du).index_add(-1, j, -du)


def assemble_tridiag_1d(mesh: FEMesh, kappa):
    """Stiffness of a chain mesh (elements (i, i+1)) as bands ``(d, e)``:
    d (..., n) on the diagonal, e (..., n−1) on both off-diagonals."""
    if element_family(mesh) != "p1_line":
        raise ValueError("tridiagonal assembly requires P1 line elements "
                         "(P2 line meshes are pentadiagonal — use "
                         "method='dense' or 'cg')")
    ke = kappa_on_elements(mesh, kappa) / element_geometry_1d(mesh)
    d = F_.pad(ke, (0, 1)) + F_.pad(ke, (1, 0))
    return d, -ke
